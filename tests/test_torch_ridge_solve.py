"""The port's ridge solves against the JAX package's.

On the CPU the tile functions of ``repro_torch.kernels.cholesky`` run their
plain versions (``kernels.ref.chol_tile_ref``, ``trsm_lower_t_ref``,
``trsm_lower_ref``), so these tests hold the plain tiles and the blocked
solve over them (``repro_torch.kernels.ridge_solve``) against the
reference's Pallas tile kernels and its blocked solve in interpret mode, on
the same inputs made with numpy.  The CUDA kernels K4a and K4b are held
against the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances:
  * tiles: rtol 1e-5 / atol 1e-5 (Cholesky) and rtol 1e-4 / atol 1e-4
    (triangular solves) on well-conditioned inputs.  The Cholesky runs the
    same column loop in both packages; the solves take each dot product in
    another order (a matrix-vector product against the reference's XLA dot),
    and each column's error feeds the next.
  * blocked solve: max |dW| <= 2e-4 max |W|, the reference's own bound for
    its blocked solve against the dense oracle (tests/test_kernels.py).
  * dispatch and the unblocked solves: rtol 1e-4 / atol 1e-5 (LAPACK in
    both packages, fp32).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ridge as rridge
from repro.kernels import cholesky as rchol
from repro.kernels import ops as rops
from repro.kernels import ridge_solve as rsolve
from repro_torch.core import ridge
from repro_torch.kernels import cholesky as kchol
from repro_torch.kernels import ops
from repro_torch.kernels import ridge_solve as ksolve

CHOL_TOL = dict(rtol=1e-5, atol=1e-5)
TRSM_TOL = dict(rtol=1e-4, atol=1e-4)
SOLVE_REL = 2e-4
LAPACK_TOL = dict(rtol=1e-4, atol=1e-5)


def _spd(rng, n, k=None):
    lead = () if k is None else (k,)
    M = rng.normal(size=(*lead, n, 2 * n)).astype(np.float32)
    return (M @ np.swapaxes(M, -1, -2)
            + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _factor(rng, n, k=None):
    a = _spd(rng, n, k).astype(np.float64)
    return np.linalg.cholesky(a).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [16, 64])
def test_chol_tile_matches_reference(n):
    a = _spd(np.random.default_rng(n), n)
    got = kchol.chol_block(torch.from_numpy(a))
    _close(got, rchol.chol_block(jnp.asarray(a), interpret=True), CHOL_TOL)
    assert bool((torch.triu(got, 1) == 0).all())


def test_chol_tile_batched_matches_reference():
    a = _spd(np.random.default_rng(3), 32, k=3)
    got = kchol.chol_block_batched(torch.from_numpy(a))
    want = rchol.chol_block_batched(jnp.asarray(a), interpret=True)
    _close(got, want, CHOL_TOL)


@pytest.mark.parametrize("m,n", [(8, 32), (128, 64)])
def test_trsm_tiles_match_reference(m, n):
    rng = np.random.default_rng(m * n)
    L = _factor(rng, n)
    a = rng.normal(size=(m, n)).astype(np.float32)
    tL, ta = torch.from_numpy(L), torch.from_numpy(a)
    jL, ja = jnp.asarray(L), jnp.asarray(a)
    bm = min(128, m)
    _close(kchol.trsm_lower_t(ta, tL),
           rchol.trsm_lower_t(ja, jL, block_m=bm, interpret=True), TRSM_TOL)
    _close(kchol.trsm_lower(ta, tL),
           rchol.trsm_lower(ja, jL, block_m=bm, interpret=True), TRSM_TOL)


def test_trsm_tiles_batched_match_reference():
    rng = np.random.default_rng(11)
    k, m, n = 3, 16, 32
    L = _factor(rng, n, k)
    a = rng.normal(size=(k, m, n)).astype(np.float32)
    tL, ta = torch.from_numpy(L), torch.from_numpy(a)
    jL, ja = jnp.asarray(L), jnp.asarray(a)
    _close(kchol.trsm_lower_t_batched(ta, tL),
           rchol.trsm_lower_t_batched(ja, jL, block_m=m, interpret=True),
           TRSM_TOL)
    _close(kchol.trsm_lower_batched(ta, tL),
           rchol.trsm_lower_batched(ja, jL, block_m=m, interpret=True),
           TRSM_TOL)


def _system(s, ny=7, seed=None):
    rng = np.random.default_rng(s if seed is None else seed)
    R = rng.normal(size=(s, 2 * s)).astype(np.float32)
    B = (R @ R.T + 0.1 * np.eye(s, dtype=np.float32)).astype(np.float32)
    A = rng.normal(size=(ny, s)).astype(np.float32)
    return A, B


@pytest.mark.parametrize("s,block", [(100, 64), (257, 128)])
def test_blocked_solve_matches_reference(s, block):
    A, B = _system(s)
    got = ksolve.ridge_solve_blocked(torch.from_numpy(A), torch.from_numpy(B),
                                     block=block)
    want = rsolve.ridge_solve_blocked(jnp.asarray(A), jnp.asarray(B),
                                      block=block, interpret=True)
    assert _rel_err(got, want) <= SOLVE_REL
    C = ksolve.cholesky_blocked(torch.from_numpy(B), block=block)
    Cr = rsolve.cholesky_blocked(jnp.asarray(B), block=block, interpret=True)
    assert _rel_err(C, Cr) <= SOLVE_REL


def test_blocked_solve_batched_matches_reference():
    pairs = [_system(100, ny=5, seed=i) for i in range(2)]
    A = np.stack([a for a, _ in pairs])
    B = np.stack([b for _, b in pairs])
    got = ksolve.ridge_solve_blocked_batched(
        torch.from_numpy(A), torch.from_numpy(B), block=64)
    want = rsolve.ridge_solve_blocked_batched(
        jnp.asarray(A), jnp.asarray(B), block=64, interpret=True)
    for i in range(2):
        assert _rel_err(got[i], want[i]) <= SOLVE_REL


def test_non_spd_tile_gives_nan_in_both_packages():
    a = _spd(np.random.default_rng(5), 16)
    a[6, 6] = -a[6, 6]  # a negative pivot from column 6 on
    got = kchol.chol_block(torch.from_numpy(a)).numpy()
    want = np.asarray(rchol.chol_block(jnp.asarray(a), interpret=True))
    # from the failed pivot on, the trailing lower triangle is NaN in both;
    # the reference's full-square update also multiplies that NaN by the
    # zero rows of the solved columns (0 * NaN), so it has NaN in more places
    tail = np.tril(np.ones((16, 16), bool)) & (np.arange(16) >= 6)[None, :]
    assert np.isnan(got[tail]).all() and np.isnan(want[tail]).all()
    assert not (np.isnan(got) & ~np.isnan(want)).any()
    finite = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **CHOL_TOL)
    # the blocked solve of a system that is not positive definite is not
    # finite in either package: fit_ridge skips such a beta
    A, B = _system(100)
    B[40, 40] = -1.0
    got = ksolve.ridge_solve_blocked(torch.from_numpy(A), torch.from_numpy(B),
                                     block=64)
    want = rsolve.ridge_solve_blocked(jnp.asarray(A), jnp.asarray(B),
                                      block=64, interpret=True)
    assert not np.isfinite(np.asarray(want)).all()
    assert not bool(torch.isfinite(got).all())
    assert not bool(torch.isfinite(ops.ridge_solve(
        torch.from_numpy(A), torch.from_numpy(B))).all())


def test_ops_dispatch_matches_reference_xla_branch():
    A, B = _system(90)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    _close(ops.ridge_solve(tA, tB, block=64),
           rops.ridge_solve(jnp.asarray(A), jnp.asarray(B), backend="xla"),
           LAPACK_TOL)
    _close(ops.cholesky(tB, block=64),
           rops.cholesky(jnp.asarray(B), backend="xla"), LAPACK_TOL)
    with pytest.raises(ValueError):
        ops.ridge_solve(tA, tB, backend="cuda")


@pytest.mark.parametrize("method", ["gaussian", "cholesky_blocked"])
def test_core_ridge_solve_methods_match_reference(method):
    A, B = _system(60, ny=4)
    got = ridge.ridge_solve(torch.from_numpy(A), torch.from_numpy(B), method)
    want = rridge.ridge_solve(jnp.asarray(A), jnp.asarray(B), method)
    assert _rel_err(got, want) <= SOLVE_REL
    Ab = np.stack([A, 2 * A])
    Bb = np.stack([B, B + np.eye(60, dtype=np.float32)])
    got = ridge.ridge_solve_batched(torch.from_numpy(Ab), torch.from_numpy(Bb),
                                    method)
    want = rridge.ridge_solve_batched(jnp.asarray(Ab), jnp.asarray(Bb),
                                      method)
    for i in range(2):
        assert _rel_err(got[i], want[i]) <= SOLVE_REL


def test_unported_and_unknown_ridge_methods_raise():
    """'cholesky_packed', once unported, now solves (within the blocked
    solve's limit of the reference's packed solve); an unknown method, and
    the packed method on a batch (as in the reference), raise."""
    A, B = _system(20, ny=2)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    got = ridge.ridge_solve(tA, tB, "cholesky_packed")
    want = rridge.ridge_cholesky_packed(jnp.asarray(A), jnp.asarray(B))
    assert _rel_err(got, want) <= SOLVE_REL
    with pytest.raises(ValueError):
        ridge.ridge_solve(tA, tB, "lu")
    with pytest.raises(ValueError):
        ridge.ridge_solve_batched(tA[None], tB[None], "cholesky_packed")
