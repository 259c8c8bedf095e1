"""The port's other gradient paths and reservoir forms against the JAX
package's, on the CPU: the paper's manual truncated gradients (Eq. 25-26,
33-36), full BPTT, the Table 7 storage counters and their benchmark rows,
the node-by-node reservoir step and the pre-modular reservoir of
Eq. (8)-(9).

The same inputs, made with numpy, go through both packages; the cases are
those of tests/test_backprop.py (Nx = 6, Ny = 4, T = 9, tanh, batches of
one and two, with and without lengths).

Tolerances:
  * gradients and losses against the reference's, and the manual form
    against the port's autograd and K1 forms: rtol 1e-4 / atol 1e-5
    (tests/test_backprop.py's, the same fp32 terms in another order);
  * full BPTT's W and b gradients against the truncated ones: rtol 1e-4 /
    atol 1e-6 (tests/test_backprop.py: the truncation changes only p, q);
  * the reservoir step and the legacy reservoir: rtol 1e-5 / atol 1e-5;
  * the counters and the Table 7 rows: equal.
"""
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import backprop as rbp
from repro.core import reservoir as rres
from repro.core.types import DFRConfig as RConfig
from repro.core.types import DFRParams as RParams
from repro_torch.core import backprop as bp
from repro_torch.core import reservoir as res
from repro_torch.core.types import DFRConfig, DFRParams

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import bench_truncation as rbench  # noqa: E402
from benchmarks_torch import bench_truncation  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
WB_TOL = dict(rtol=1e-4, atol=1e-6)
RES_TOL = dict(rtol=1e-5, atol=1e-5)
NX, NY, T = 6, 4, 9


def _case(batched: bool, seed: int = 0):
    """(params, j_seq, onehot, f) of each package on the same draws."""
    rng = np.random.default_rng(seed)
    W = (0.05 * rng.normal(size=(NY, NX * (NX + 1)))).astype(np.float32)
    b = np.full(NY, 0.01, np.float32)
    j = rng.normal(size=(2, T, NX)).astype(np.float32)
    onehot = np.eye(NY, dtype=np.float32)[[1, 3]]
    if not batched:
        j, onehot = j[0], onehot[0]
    params = DFRParams(p=torch.tensor(0.15), q=torch.tensor(0.45),
                       W=torch.from_numpy(W), b=torch.from_numpy(b))
    rparams = RParams(p=jnp.float32(0.15), q=jnp.float32(0.45),
                      W=jnp.asarray(W), b=jnp.asarray(b))
    f = DFRConfig(n_in=3, n_classes=NY, n_nodes=NX, nonlinearity="tanh").f()
    rf = RConfig(n_in=3, n_classes=NY, n_nodes=NX, nonlinearity="tanh").f()
    return ((params, torch.from_numpy(j), torch.from_numpy(onehot), f),
            (rparams, jnp.asarray(j), jnp.asarray(onehot), rf))


def _close(got: DFRParams, want, tol, names="pqWb"):
    for n in names:
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   np.asarray(getattr(want, n)), **tol,
                                   err_msg=n)


def _fprime(z):
    return 1 - jnp.tanh(z) ** 2


CASES = [(False, None), (True, None), (True, [5, 9])]


@pytest.mark.parametrize("batched,lengths", CASES)
def test_manual_grads_match_reference_and_autograd(batched, lengths):
    (prm, j, oh, f), (rprm, rj, roh, rf) = _case(batched)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    loss, g = bp.grads_truncated_manual(prm, j, oh, f, None, tl)
    rloss, rg = rbp.grads_truncated_manual(rprm, rj, roh, rf, _fprime, rl)
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    _close(g, rg, TOL)
    if batched:  # the port's autograd and K1 forms take batches
        loss2, g2 = bp.grads_truncated(prm, j, oh, f, tl)
        np.testing.assert_allclose(float(loss), float(loss2), **TOL)
        _close(g, g2, TOL)
        _, g3 = bp.grads_truncated_fused(prm, j, oh, f, tl)
        _close(g, g3, TOL)


@pytest.mark.parametrize("batched,lengths", CASES)
def test_full_bptt_matches_reference(batched, lengths):
    (prm, j, oh, f), (rprm, rj, roh, rf) = _case(batched, seed=1)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    loss, g = bp.grads_full_bptt(prm, j, oh, f, tl)
    rloss, rg = rbp.grads_full_bptt(rprm, rj, roh, rf, rl)
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    _close(g, rg, TOL)
    _, gm = bp.grads_truncated_manual(prm, j, oh, f, None, tl)
    _close(g, gm, WB_TOL, names="Wb")  # truncation changes only (p, q)
    assert not np.allclose(g.q.numpy(), gm.q.numpy(), **TOL)


def test_storage_words_and_table7_equal_reference():
    for nx, ny, t in [(30, 10, 93), (30, 2, 1918), (8, 95, 136)]:
        cfg = DFRConfig(n_in=1, n_classes=ny, n_nodes=nx)
        rcfg = RConfig(n_in=1, n_classes=ny, n_nodes=nx)
        assert (bp.storage_words_naive(cfg, t)
                == rbp.storage_words_naive(rcfg, t))
        assert (bp.storage_words_truncated(cfg, t)
                == rbp.storage_words_truncated(rcfg, t))
    assert bench_truncation.run() == rbench.run()


def test_naive_step_matches_reference_and_matrix_form():
    rng = np.random.default_rng(5)
    x, jk = (rng.normal(size=NX).astype(np.float32) for _ in range(2))
    cfg = DFRConfig(n_in=1, n_classes=2, n_nodes=NX, nonlinearity="tanh")
    rcfg = RConfig(n_in=1, n_classes=2, n_nodes=NX, nonlinearity="tanh")
    p, q = 0.3, -0.4
    got = res.reservoir_step_naive(torch.tensor(p), torch.tensor(q), cfg.f(),
                                   torch.from_numpy(jk), torch.from_numpy(x))
    want = rres.reservoir_step_naive(jnp.float32(p), jnp.float32(q),
                                     rcfg.f(), jnp.asarray(jk),
                                     jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RES_TOL)
    gemm = res.reservoir_step(torch.tensor(p), torch.tensor(q), cfg.f(),
                              torch.from_numpy(jk), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), gemm.numpy(), **RES_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_legacy_reservoir_matches_reference(batched):
    rng = np.random.default_rng(6)
    j = rng.normal(size=(3, T, NX) if batched else (T, NX)).astype(
        np.float32)
    eta, gamma, theta = 0.7, 0.5, 0.2

    def f_ref(x, jk):  # eta * mg(x + gamma j), the reference's form
        z = x + gamma * jk
        return eta * z / (1.0 + jnp.abs(z) ** 2)

    def f(x, jk):
        z = x + gamma * jk
        return eta * z / (1.0 + torch.abs(z) ** 2)

    got = res.run_reservoir_legacy(eta, gamma, theta, torch.from_numpy(j), f)
    want = rres.run_reservoir_legacy(eta, gamma, theta, jnp.asarray(j),
                                     f_ref)
    assert got.shape == j.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RES_TOL)
