"""The port's rank-1 factor update forms against the JAX package's, on the
CPU: the packed sweep over Algorithm 2's 1-D array, the dense lower forms
(one sample, guarded, member-batched, a window), the transposed forms (one
sample, guarded, a window with a per-row decay), the refresh from a lower
factor, and the identity padding.

Every dense and transposed form of the port is the plain version of K3
(``core.ridge.cholupdate_window_t``) on the factor or its transpose; the
packed form is its own sweep over gathered columns.

Tolerances:
  * every update form: max |dL| <= 1e-5 of max |L| - the same rotations in
    the same order, each divided by c;
  * the guard's ok flags: equal;
  * the refresh from a factor: rtol 1e-4 / atol 1e-5 (two triangular
    solves in LAPACK in both packages, fp32);
  * the identity padding: exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ridge as rridge
from repro_torch.core import ridge

REL = 1e-5
LAPACK_TOL = dict(rtol=1e-4, atol=1e-5)


def _factor(rng, s, k=None):
    lead = () if k is None else (k,)
    M = rng.normal(size=(*lead, s, 2 * s))
    B = M @ np.swapaxes(M, -1, -2) + s * np.eye(s)
    return np.linalg.cholesky(B).astype(np.float32)


def _rows(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    """A tensor of its own: the port's packed forms write in place, and an
    array read from JAX may share the reference's buffer."""
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("s", [7, 31])
def test_dense_lower_forms_match_reference(s, sign):
    rng = np.random.default_rng(s)
    L = _factor(rng, s)
    x = _rows(rng, s, scale=0.5)
    want = rridge.cholupdate_dense(jnp.asarray(L), jnp.asarray(x), sign)
    assert _rel(ridge.cholupdate_dense(_t(L), _t(x), sign), want) <= REL
    got, ok = ridge.cholupdate_dense_guarded(_t(L), _t(x), sign)
    rgot, rok = rridge.cholupdate_dense_guarded(jnp.asarray(L),
                                                jnp.asarray(x), sign)
    assert _rel(got, rgot) <= REL and bool(ok) == bool(rok)
    Lk, xk = _factor(rng, s, k=3), _rows(rng, 3, s, scale=0.5)
    got = ridge.cholupdate_dense_batched(_t(Lk), _t(xk), sign)
    want = rridge.cholupdate_dense_batched(jnp.asarray(Lk), jnp.asarray(xk),
                                           sign)
    assert _rel(got, want) <= REL
    X = _rows(rng, 4, s, scale=0.3)
    X[2] = 0.0  # a zero row is a no-op in both
    got = ridge.cholupdate_window(_t(L), _t(X), sign)
    want = rridge.cholupdate_window(jnp.asarray(L), jnp.asarray(X), sign)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("s", [7, 31])
def test_transposed_forms_match_reference(s, sign):
    rng = np.random.default_rng(100 + s)
    U = np.ascontiguousarray(_factor(rng, s).T)
    x = _rows(rng, s, scale=0.5)
    want = rridge.cholupdate_dense_t(jnp.asarray(U), jnp.asarray(x), sign)
    assert _rel(ridge.cholupdate_dense_t(_t(U), _t(x), sign), want) <= REL
    got, ok = ridge.cholupdate_dense_t_guarded(_t(U), _t(x), sign)
    rgot, rok = rridge.cholupdate_dense_t_guarded(jnp.asarray(U),
                                                  jnp.asarray(x), sign)
    assert _rel(got, rgot) <= REL and bool(ok) == bool(rok)
    X = _rows(rng, 4, s, scale=0.3)
    scale = np.asarray([0.97, 1.0, 0.9, 0.97], np.float32)
    got = ridge.cholupdate_window_t_decay(_t(U), _t(X), _t(scale), sign)
    want = rridge.cholupdate_window_t_decay(jnp.asarray(U), jnp.asarray(X),
                                            jnp.asarray(scale), sign)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_packed_update_matches_reference(sign):
    s = 31
    rng = np.random.default_rng(7)
    L = _factor(rng, s)
    P = np.asarray(rridge.pack_lower(jnp.asarray(L)))
    x = _rows(rng, s, scale=0.5)
    want = rridge.cholupdate_packed_jax(jnp.asarray(P), jnp.asarray(x), s,
                                        sign)
    tP = _t(P)
    got = ridge.cholupdate_packed(tP, _t(x), s, sign)
    assert got is tP  # the packed factor is rotated in place
    assert _rel(got, want) <= REL
    assert _rel(got, rridge.cholupdate_packed_numpy(P, x, s, sign)) <= REL
    # the same rotations as the dense form, on the unpacked factor
    dense = ridge.cholupdate_dense(_t(L), _t(x), sign)
    assert _rel(ridge.unpack_lower(got, s), dense) <= REL


def test_guard_flags_and_indefinite_downdate():
    s = 13
    rng = np.random.default_rng(3)
    L = _factor(rng, s)
    # a downdate by a row the factor cannot carry: x^T B^-1 x >> 1
    x = (20.0 * L[:, 0]).astype(np.float32)
    got, ok = ridge.cholupdate_dense_guarded(_t(L), _t(x), -1.0)
    rgot, rok = rridge.cholupdate_dense_guarded(jnp.asarray(L),
                                                jnp.asarray(x), -1.0)
    assert not bool(ok) and not bool(rok)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, rgot) <= REL
    U = np.ascontiguousarray(L.T)
    _, ok_t = ridge.cholupdate_dense_t_guarded(_t(U), _t(x), -1.0)
    _, rok_t = rridge.cholupdate_dense_t_guarded(jnp.asarray(U),
                                                 jnp.asarray(x), -1.0)
    assert bool(ok_t) == bool(rok_t) is False
    # a downdate the factor carries keeps ok in both
    _, ok = ridge.cholupdate_dense_guarded(_t(L), _t(0.01 * x), -1.0)
    _, rok = rridge.cholupdate_dense_guarded(jnp.asarray(L),
                                             jnp.asarray(0.01 * x), -1.0)
    assert bool(ok) and bool(rok)
    P = np.asarray(rridge.pack_lower(jnp.asarray(L)))
    with pytest.raises(np.linalg.LinAlgError, match="indefinite downdate"):
        ridge.cholupdate_packed_numpy(P, x, s, sign=-1.0)
    # the packed sweep on tensors clamps as the reference's jitted form
    got = ridge.cholupdate_packed(_t(P), _t(x), s, -1.0)
    want = rridge.cholupdate_packed_jax(jnp.asarray(P), jnp.asarray(x), s,
                                        -1.0)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= REL


def test_solve_from_factor_matches_reference():
    s, ny = 31, 5
    rng = np.random.default_rng(9)
    L = _factor(rng, s)
    A = _rows(rng, ny, s)
    np.testing.assert_allclose(
        ridge.ridge_solve_from_factor(_t(A), _t(L)).numpy(),
        np.asarray(rridge.ridge_solve_from_factor(jnp.asarray(A),
                                                  jnp.asarray(L))),
        **LAPACK_TOL)
    Lk, Ak = _factor(rng, s, k=3), _rows(rng, 3, ny, s)
    np.testing.assert_allclose(
        ridge.ridge_solve_from_factor_batched(_t(Ak), _t(Lk)).numpy(),
        np.asarray(rridge.ridge_solve_from_factor_batched(jnp.asarray(Ak),
                                                          jnp.asarray(Lk))),
        **LAPACK_TOL)


@pytest.mark.parametrize("pad", [0, 3])
def test_pad_factor_identity_matches_reference(pad):
    F = _factor(np.random.default_rng(pad), 5, k=2)
    np.testing.assert_array_equal(
        ridge.pad_factor_identity(_t(F), pad).numpy(),
        np.asarray(rridge.pad_factor_identity(jnp.asarray(F), pad)))
