"""The port's kernel wrappers (K1, K2) against the JAX package's kernels.

On the CPU the wrappers run their plain PyTorch versions (``kernels.ref``),
so these tests hold the plain versions, on the port's logical shapes,
against the reference's Pallas kernels in interpret mode and against its
XLA path, on the same inputs made with numpy.  The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Tolerance: both sides accumulate the same fp32 DPRR sums in different
orders (the Pallas kernel in (n_pad, n_pad) tiles, the port one time step
at a time), so values agree to fp32 rounding of sums over up to T terms:
rtol 1e-4 / atol 1e-4, the bound the reference's own interpret-vs-XLA test
uses (tests/test_kernels.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.types import cached_nonlinearity
from repro.kernels import ops as rops
from repro_torch.core.types import Nonlinearity
from repro_torch.kernels import ops

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, t, nx, ny, seed, lengths=None, n_sys=None):
    rng = np.random.default_rng(seed)
    lead = () if n_sys is None else (n_sys,)
    j = rng.normal(size=(*lead, b, t, nx)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, t + 1, (*lead, b))
    lens = np.asarray(lengths, np.int32).reshape(*lead, b)
    W = (0.01 * rng.normal(size=(*lead, ny, nx * (nx + 1)))).astype(np.float32)
    bias = rng.normal(size=(*lead, ny)).astype(np.float32)
    return j, lens, W, bias


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K2: the streaming step (reservoir -> DPRR -> readout)
# ---------------------------------------------------------------------------

# the cases of tests/test_kernels.py:157-160, plus q < 0 with ragged lengths
# that include 1, and Mackey-Glass
K2_CASES = [
    (3, 50, 30, 4, 64, "linear", 0.3, None),
    (2, 130, 17, 9, 128, "linear", 0.3, None),
    (4, 64, 8, 2, 64, "tanh", 0.3, None),
    (4, 20, 8, 3, 8, "linear", -0.45, [20, 1, 7, 13]),
    (3, 12, 6, 5, 8, "mackey_glass", -0.3, [1, 12, 5]),
]


@pytest.mark.parametrize("b,t,nx,ny,chunk,f_name,q,lengths", K2_CASES)
def test_streaming_plain_matches_reference(b, t, nx, ny, chunk, f_name, q,
                                           lengths):
    j, lens, W, bias = _inputs(b, t, nx, ny, seed=b * t + nx,
                               lengths=lengths)
    p = 0.02 if f_name == "linear" else 0.4
    f_ref = cached_nonlinearity(f_name, 1.0)
    args = (jnp.asarray(j), jnp.asarray(lens), jnp.float32(p),
            jnp.float32(q), jnp.asarray(W), jnp.asarray(bias), nx)
    want_interp = rops.streaming_logits(*args, f=f_ref, chunk_t=chunk,
                                        backend="interpret")
    want_xla = rops.streaming_logits(*args, f=f_ref, backend="xla")
    got = ops.streaming_logits(
        _t(j), _t(lens), torch.tensor(p), torch.tensor(q), _t(W), _t(bias),
        Nonlinearity(f_name), backend="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want_interp), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


def test_streaming_slots_per_slot_params_match_reference():
    """Every slot reads its own (p, q, W, b) in one call (one launch on the
    card), against the reference's vmapped slots wrapper."""
    n_sys, b, t, nx, ny = 3, 2, 12, 6, 4
    j, lens, W, bias = _inputs(b, t, nx, ny, seed=11, n_sys=n_sys)
    lens[1, 0] = 1
    p = np.asarray([0.05, 0.2, 0.5], np.float32)
    q = np.asarray([0.3, -0.6, 0.1], np.float32)
    f_ref = cached_nonlinearity("tanh", 1.0)
    args = tuple(jnp.asarray(a) for a in (j, lens, p, q, W, bias))
    want_interp = rops.streaming_logits_slots(*args, nx, f=f_ref, chunk_t=8,
                                              backend="interpret")
    want_xla = rops.streaming_logits_slots(*args, nx, f=f_ref, backend="xla")
    got = ops.streaming_logits_slots(
        *(_t(a) for a in (j, lens, p, q, W, bias)), Nonlinearity("tanh"))
    assert got.shape == (n_sys, b, ny)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_interp), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


# ---------------------------------------------------------------------------
# K1: the fused training forward (r, x(T), x(T-1), j(T))
# ---------------------------------------------------------------------------

K1_CASES = [
    (3, 11, 5, "tanh", 0.4, [11, 4, 1]),
    (3, 11, 5, "linear", -0.55, [1, 11, 6]),
    (2, 9, 7, "mackey_glass", 0.3, [9, 1]),
]


@pytest.mark.parametrize("b,t,nx,f_name,q,lengths", K1_CASES)
def test_train_forward_plain_matches_reference_kernel(b, t, nx, f_name, q,
                                                      lengths):
    """Against the reference's interpret-mode Pallas kernel, called as
    tests/test_train_fused.py calls it (chunk_t=8, block_b=2), so T crosses
    a chunk boundary and the batch a block boundary; lengths include 1."""
    j, lens, _, _ = _inputs(b, t, nx, 1, seed=t + nx, lengths=lengths)
    p = 0.3
    want = rops.train_forward(
        jnp.asarray(j), jnp.asarray(lens), jnp.float32(p), jnp.float32(q),
        nx, f=cached_nonlinearity(f_name, 1.0), backend="interpret",
        chunk_t=8, block_b=2)
    got = ops.train_forward(_t(j), _t(lens), torch.tensor(p),
                            torch.tensor(q), Nonlinearity(f_name))
    for g, w, name in zip(got, want, ("r", "x_last", "x_prev", "j_last")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    # length 1: x(T-1) is the initial state, exactly zero
    one = int(np.argmin(lens))
    assert lens[one] == 1 and not got[2][one].any()


def test_train_forward_slots_match_reference_per_slot():
    """The slot-batched call (per-slot p, q) equals the reference's XLA
    scan run slot by slot."""
    n_sys, b, t, nx = 3, 4, 10, 6
    j, lens, _, _ = _inputs(b, t, nx, 1, seed=3, n_sys=n_sys)
    lens[0, 0] = 1
    p = np.asarray([0.1, 0.3, 0.02], np.float32)
    q = np.asarray([0.2, -0.4, 0.5], np.float32)
    got = ops.train_forward(_t(j), _t(lens), _t(p), _t(q), Nonlinearity())
    for s in range(n_sys):
        want = rops.train_forward(
            jnp.asarray(j[s]), jnp.asarray(lens[s]), jnp.float32(p[s]),
            jnp.float32(q[s]), nx, f=cached_nonlinearity("linear", 1.0),
            backend="xla")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[s].numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# dispatch: no silent fallback
# ---------------------------------------------------------------------------


def test_cuda_backend_on_cpu_tensor_raises():
    j, lens, W, bias = _inputs(2, 5, 4, 3, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.train_forward(_t(j), _t(lens), torch.tensor(0.1),
                          torch.tensor(0.1), backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.streaming_logits(_t(j), _t(lens), torch.tensor(0.1),
                             torch.tensor(0.1), _t(W), _t(bias),
                             backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.train_forward(_t(j), _t(lens), torch.tensor(0.1),
                          torch.tensor(0.1), backend="xla")
