"""The port's reservoir paths past one warp (Nx > 32) against the JAX
package's, on the CPU.

On the CPU the port's ``kernels.ops`` run the kernels' plain versions
(``kernels.ref``), which take any Nx; on the card K1, K2, K6 and K7 take
1 <= Nx <= 128 (``tests/test_torch_cuda.py`` holds them against these
plain versions).  The reference pads the node axis to its 128-lane tile
(``repro.kernels.ops._ring_padded``), so Nx = 33, 48, 64 and 100 run its
Pallas kernels on one or two lane tiles.

* ``train_forward``, ``streaming_logits_slots``, ``reservoir_states`` and
  ``dprr_features`` at Nx in {33, 48, 64, 100}, T <= 20, ragged lengths
  (1 and T among them): against the reference's XLA branch, and at
  Nx = 64 against its Pallas kernel in interpret mode too, within rtol
  1e-4 / atol 1e-5 (the reference's own limit for its kernels against its
  XLA path: the same fp32 recurrence, sums in another order).
* ``DFRModel.fit`` for one SGD epoch and the ridge refit on 64 JPVOW
  samples at Nx = 40 (s = 1641): (p, q) within rtol 1e-3 (each of the 16
  steps' rounding feeds the next step's features, as in
  ``tests/test_torch_dfr.py``), the same beta, and predictions on the test
  split agreeing on at least 0.98.
* A two-stream ``StreamServer`` episode at Nx = 40 in both refresh modes
  (``'recompute'`` and ``'incremental'``, the live factor's rank-1 folds):
  predictions agree on at least 0.98 of served samples, every stream's
  final state within rtol 1e-4 / atol 1e-5 (tests/test_torch_stream_server
  .py's limits), except the incremental mode's readout (W, b), held to
  1e-3 of max |W|: its solve through a live fp32 factor of s = 1641 at
  beta = 1e-2 is conditioned so that the reference's own two refresh
  modes give readouts 4.1e-4 of max |W| apart on this episode (the port's
  and the reference's incremental readouts are 7.8e-4 apart, its
  recompute readouts 3.5e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dfr as rdfr
from repro.core import masking as rmasking
from repro.core import ridge as rridge
from repro.core.types import DFRConfig as RConfig
from repro.core.types import cached_nonlinearity
from repro.data import load as rload
from repro.kernels import ops as rops
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro_torch import convert
from repro_torch.core import dfr, ridge
from repro_torch.core.types import DFRConfig, Nonlinearity
from repro_torch.data import load
from repro_torch.kernels import ops
from repro_torch.runtime import StreamRequest, StreamServer

TOL = dict(rtol=1e-4, atol=1e-5)
EPOCH_TOL = dict(rtol=1e-3, atol=1e-5)
AGREE = 0.98
WIDTHS = (33, 48, 64, 100)
INTERPRET_NX = 64  # the slice's width: one case of each kernel in Pallas
P, Q = 0.15, 0.45


def _samples(b, t, nx, seed):
    rng = np.random.default_rng(seed)
    j = (0.5 * rng.normal(size=(b, t, nx))).astype(np.float32)
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[:2] = (1, t)
    return j, lens


def _backends(nx):
    return ("xla", "interpret") if nx == INTERPRET_NX else ("xla",)


@pytest.mark.parametrize("nx", WIDTHS)
def test_train_forward_matches_reference(nx):
    t = 20 if nx < 100 else 12
    j, lens = _samples(5, t, nx, seed=nx)
    f, rf = Nonlinearity("tanh", 0.9), cached_nonlinearity("tanh", 0.9)
    got = ops.train_forward(torch.from_numpy(j), torch.from_numpy(lens),
                            torch.tensor(P), torch.tensor(Q), nx, f=f)
    for backend in _backends(nx):
        want = rops.train_forward(jnp.asarray(j), jnp.asarray(lens),
                                  jnp.float32(P), jnp.float32(Q), nx, f=rf,
                                  backend=backend)
        for name, g, w in zip(("r", "x_last", "x_prev", "j_last"), got,
                              want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f"{backend} {name}")


@pytest.mark.parametrize("nx", WIDTHS)
def test_streaming_logits_slots_match_reference(nx):
    n_sys, bsz, ny = 2, 3, 4
    t = 16 if nx < 100 else 10
    j, lens = _samples(n_sys * bsz, t, nx, seed=2 * nx)
    j, lens = j.reshape(n_sys, bsz, t, nx), lens.reshape(n_sys, bsz)
    rng = np.random.default_rng(nx)
    p = np.array([P, 0.1], np.float32)
    q = np.array([Q, -0.3], np.float32)
    W = (0.02 * rng.normal(size=(n_sys, ny, nx * (nx + 1)))).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(n_sys, ny))).astype(np.float32)
    got = ops.streaming_logits_slots(*map(torch.from_numpy,
                                          (j, lens, p, q, W, b)), nx)
    for backend in _backends(nx):
        want = rops.streaming_logits_slots(*map(jnp.asarray,
                                                (j, lens, p, q, W, b)), nx,
                                           backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=backend)


@pytest.mark.parametrize("nx", WIDTHS)
def test_reservoir_states_match_reference(nx):
    t = 20 if nx < 100 else 12
    j, lens = _samples(6, t, nx, seed=3 * nx)
    got = ops.reservoir_states(torch.from_numpy(j), torch.from_numpy(lens),
                               torch.tensor(P), torch.tensor(Q), nx)
    for backend in _backends(nx):
        kw = dict(chunk_t=8, block_b=8) if backend == "interpret" else {}
        want = rops.reservoir_states(jnp.asarray(j), jnp.asarray(lens),
                                     jnp.float32(P), jnp.float32(Q), nx,
                                     backend=backend, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=backend)


@pytest.mark.parametrize("nx", WIDTHS)
def test_dprr_features_match_reference(nx):
    t = 20
    x, lens = _samples(4, t, nx, seed=4 * nx)
    got = ops.dprr_features(torch.from_numpy(x), torch.from_numpy(lens), nx)
    assert got.shape == (4, nx * (nx + 1))
    for backend in _backends(nx):
        want = rops.dprr_features(jnp.asarray(x), jnp.asarray(lens), nx,
                                  block_t=8, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=backend)


# ---------------------------------------------------------------------------
# the paths at Nx = 40
# ---------------------------------------------------------------------------

NX = 40


def _chosen_beta(solve, A, B, W, betas):
    """The beta of the sweep whose solve gave W (None: no beta did)."""
    for beta in betas:
        if np.array_equal(solve(A, B, beta)[:, :-1], W):
            return beta
    return None


def test_fit_matches_reference_at_40_nodes():
    train, test = load("JPVOW", size_cap=64)
    rtrain, rtest = rload("JPVOW", size_cap=64)
    kw = dict(n_in=12, n_classes=9, n_nodes=NX, epochs=1)
    rm = rdfr.DFRModel.create(RConfig(**kw))
    m = dfr.DFRModel(DFRConfig(**kw), convert.mask_from_numpy(
        convert.mask_to_numpy(rm.mask)), device="cpu")
    got = m.fit(train, minibatch=4, select="final")
    want = rm.fit(rtrain, minibatch=4, select="final")
    np.testing.assert_allclose(float(got.p), float(want.p), **EPOCH_TOL)
    np.testing.assert_allclose(float(got.q), float(want.q), **EPOCH_TOL)
    agree = float((m.predict(test, got).numpy()
                   == np.asarray(rm.predict(rtest, want))).mean())
    assert agree >= AGREE, agree
    # the same beta: each package's W against its own solves
    A, B = m.ridge_statistics(train, got)
    beta = _chosen_beta(
        lambda A, B, beta: ridge.ridge_solve(
            A, ridge.regularize(B, beta), "cholesky_blocked").numpy(),
        A, B, got.W.numpy(), m.cfg.betas)
    rr = np.asarray(rm.features(rtrain, want))
    rt = np.concatenate([rr, np.ones((rr.shape[0], 1), np.float32)], -1)
    oh = np.eye(9, dtype=np.float32)[np.asarray(rtrain.label)]
    rbeta = _chosen_beta(
        lambda A, B, beta: np.asarray(rridge.ridge_solve(
            jnp.asarray(A), rridge.regularize(jnp.asarray(B),
                                              jnp.float32(beta)))),
        oh.T @ rt, rt.T @ rt, np.asarray(want.W), rm.cfg.betas)
    assert beta is not None and beta == rbeta


SERVER = dict(t_max=12, max_streams=2, window=2, phase_steps=2,
              refresh_every=3)
STREAMS = (6, 5)
STATE_LEAVES = ("params_p", "params_q", "params_W", "params_b", "ridge_A",
                "ridge_B", "ridge_count", "step")
INC_W_REL = 1e-3  # the incremental readout's limit (module docstring)


def _serve(server_cls, request_cls, cfg, mask, **kw):
    srv = server_cls(cfg, mask=mask, **SERVER, **kw)
    for rid, n in enumerate(STREAMS):
        r = np.random.default_rng(rid)
        u = r.normal(size=(n, SERVER["t_max"], 2)).astype(np.float32)
        length = r.integers(4, SERVER["t_max"] + 1, n).astype(np.int32)
        label = r.integers(0, 3, n).astype(np.int32)
        srv.submit(request_cls(rid=rid, u=u, length=length, label=label))
    return {r.rid: r for r in srv.run_until_drained()}


@pytest.mark.parametrize("mode", ["recompute", "incremental"])
def test_stream_episode_matches_reference_at_40_nodes(mode):
    rcfg = RConfig(n_in=2, n_classes=3, n_nodes=NX)
    mask = np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(rcfg.mask_seed), NX, 2, jnp.float32))
    want = _serve(RServer, RRequest, rcfg, mask, refresh_mode=mode)
    got = _serve(StreamServer, StreamRequest,
                 DFRConfig(n_in=2, n_classes=3, n_nodes=NX), mask,
                 refresh_mode=mode, device="cpu")
    assert sorted(got) == sorted(want)
    total = agree = 0
    for rid, r in want.items():
        assert len(got[rid].preds) == len(r.preds) == r.n_samples
        total += len(r.preds)
        agree += sum(int(a == b) for a, b in zip(got[rid].preds, r.preds))
        w = convert.state_leaves(r.final_state)
        g = convert.state_leaves(got[rid].final_state)
        w_max = np.abs(w["params_W"]).max()
        for name in STATE_LEAVES:
            tol = dict(rtol=0, atol=INC_W_REL * w_max) if (
                mode == "incremental" and name in ("params_W", "params_b")
            ) else TOL
            np.testing.assert_allclose(
                g[name].astype(np.float64), w[name].astype(np.float64),
                **tol, err_msg=f"{mode} stream {rid}: {name}")
    assert agree / total >= AGREE
