"""The port's unfused reservoir and DPRR (K6, K7) against the JAX package's.

On the CPU ``ops.reservoir_states`` and ``ops.dprr_features`` run their
plain versions (``kernels.ref.reservoir_ref``, ``dprr_ref``); these tests
hold them against the reference's Pallas kernels in interpret mode and its
XLA branch on the same inputs made with numpy, with ragged lengths.  The
CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: rtol 1e-4 / atol 1e-5, the reference's own bound for its
interpret-mode reservoir against its XLA path (tests/test_kernels.py): both
packages run the same fp32 recurrence, the ring matvec and the DPRR sums
taken in another order.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.types import cached_nonlinearity
from repro.kernels import ops as rops
from repro_torch.core.types import Nonlinearity
from repro_torch.kernels import ops

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(b, t, nx, seed):
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(b, t, nx)).astype(np.float32)
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[:2] = (1, t)
    return j, lens


@pytest.mark.parametrize("nx,t,f_name", [(8, 24, "linear"), (17, 40, "tanh"),
                                         (30, 32, "linear")])
def test_reservoir_states_match_reference(nx, t, f_name):
    j, lens = _inputs(6, t, nx, seed=nx + t)
    p, q = 0.2, 0.5
    f = Nonlinearity(f_name, 0.8)
    rf = cached_nonlinearity(f_name, 0.8)
    got = ops.reservoir_states(torch.from_numpy(j), torch.from_numpy(lens),
                               torch.tensor(p), torch.tensor(q), nx, f=f)
    jj, jl = jnp.asarray(j), jnp.asarray(lens)
    for backend, kw in (("interpret", dict(chunk_t=8, block_b=8)),
                        ("xla", {})):
        want = rops.reservoir_states(jj, jl, jnp.float32(p), jnp.float32(q),
                                     nx, f=rf, backend=backend, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=backend)


def test_reservoir_rows_past_length_hold_the_frozen_state():
    nx, t = 12, 20
    j, lens = _inputs(5, t, nx, seed=1)
    lens[2] = 7
    got = ops.reservoir_states(torch.from_numpy(j), torch.from_numpy(lens),
                               0.3, -0.4, nx).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(got[i, n:], np.broadcast_to(
            got[i, n - 1], (t - n, nx)))
    want = rops.reservoir_states(jnp.asarray(j), jnp.asarray(lens),
                                 jnp.float32(0.3), jnp.float32(-0.4), nx,
                                 chunk_t=8, block_b=8, backend="interpret")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("nx,t", [(8, 40), (17, 33), (30, 64)])
def test_dprr_features_match_reference(nx, t):
    rng = np.random.default_rng(nx * t)
    x = rng.normal(size=(4, t, nx)).astype(np.float32)
    lens = rng.integers(1, t + 1, 4).astype(np.int32)
    lens[:2] = (1, t)
    got = ops.dprr_features(torch.from_numpy(x), torch.from_numpy(lens), nx)
    assert got.shape == (4, nx * (nx + 1))
    xj, lj = jnp.asarray(x), jnp.asarray(lens)
    for backend in ("interpret", "xla"):
        want = rops.dprr_features(xj, lj, nx, block_t=32, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=backend)


def test_dprr_ignores_rows_past_length():
    """Whatever the rows past a length hold, they add nothing: only the
    mask on the x(k) side keeps them out."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 16, 6)).astype(np.float32)
    lens = np.array([5, 16, 1], np.int32)
    y = x.copy()
    for i, n in enumerate(lens):
        y[i, n:] = 1e3 * rng.normal(size=y[i, n:].shape)
    a = ops.dprr_features(torch.from_numpy(x), torch.from_numpy(lens), 6)
    b = ops.dprr_features(torch.from_numpy(y), torch.from_numpy(lens), 6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_reservoir_then_dprr_is_the_reference_feature_path():
    """The two ops chained (DFRModel.features) against the reference's."""
    nx, t = 10, 30
    j, lens = _inputs(5, t, nx, seed=9)
    x = ops.reservoir_states(torch.from_numpy(j), torch.from_numpy(lens),
                             0.05, 0.3, nx)
    got = ops.dprr_features(x, torch.from_numpy(lens), nx)
    xr = rops.reservoir_states(jnp.asarray(j), jnp.asarray(lens),
                               jnp.float32(0.05), jnp.float32(0.3), nx,
                               backend="xla")
    want = rops.dprr_features(xr, jnp.asarray(lens), nx, backend="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_reject_what_they_do_not_take():
    x = torch.zeros(2, 5, 4)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.dprr_features(x, lens, 5)
    with pytest.raises(ValueError):
        ops.reservoir_states(x, lens, 0.1, 0.1, 3)
    with pytest.raises(ValueError):
        ops.reservoir_states(x, lens, 0.1, 0.1, 4, backend="cuda")


def _lane_scan(v, q):
    """Five rounds of the kernel's scan over 32 lanes (scan_step in
    kernels/csrc/dfr_step.cuh): lane n adds q^(2^s) times lane n - 2^s."""
    qs = np.float32(q)
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(v)
        up[..., d:] = v[..., :-d]
        v = (qs * up + v).astype(np.float32)
        qs = np.float32(qs * qs)
    return v


@pytest.mark.parametrize("nx", [1, 7, 30, 32])
@pytest.mark.parametrize("q", [0.3, -0.6, 0.01])
def test_ring_mix_as_a_lane_scan_matches_reference_ring_matrix(nx, q):
    """K6's ring mix: the delay line's recurrence x_n = q x_{n-1} + a_n
    taken as a 5-round scan over the lanes, with the wrap added as
    q^(n+1) x(k-1)_{Nx-1} and q^(n+1) itself the scan of (q, 0, ..., 0),
    equals the reference's closed form L(q) a + q^(1..Nx) x(k-1)_{Nx-1}
    (repro.core.reservoir.ring_matrix, ring_powers) in fp32, within
    rtol 1e-5 / atol 1e-6 (the sums reassociated)."""
    from repro.core.reservoir import ring_matrix, ring_powers
    rng = np.random.default_rng(nx)
    a = np.zeros((6, 32), np.float32)
    a[:, :nx] = rng.normal(size=(6, nx))
    wrap = rng.normal(size=(6, 1)).astype(np.float32)
    unit = np.zeros(32, np.float32)
    unit[0] = q
    qpow = _lane_scan(unit, q)
    got = _lane_scan(a, q) + qpow * wrap
    L = np.asarray(ring_matrix(jnp.float32(q), nx))
    want = a[:, :nx] @ L.T + wrap * np.asarray(ring_powers(jnp.float32(q), nx))
    np.testing.assert_allclose(got[:, :nx], want, rtol=1e-5, atol=1e-6)
