"""Pipelining and step blocking in the port's StreamServer, and the in-place
round that the card captures as CUDA graphs, on the CPU.

The episode is tests/test_torch_stream_server.py's (Nx=8, 3 classes, t_max
16; 3 slots, window 2, phase_steps 2, refresh_every 3; five streams of 8,
6, 10, 4 and 7 samples, the reference's mask) in three modes: recompute,
incremental, and int8 with the incremental refresh.

Contracts, the reference's (tests/test_stream_pipeline.py,
tests/test_stream_quant.py):
  * ``pipeline_depth`` in {1, 2} serves depth 0's predictions, final states
    and retirement snapshots bit for bit: the ring defers only the
    bookkeeping;
  * ``step_block`` in {2, 4} serves ``step_block=1``'s bit for bit: the
    clamp keeps the admission schedule, and each sub-step is one round;
  * both compose with int8;
  * the in-place round (``runtime.graphs.RoundGraphs`` without capture:
    the bodies the card captures, run eagerly) serves the eager round's
    episode bit for bit;
  * each port episode matches the reference's episode with the same knobs
    at tests/test_torch_stream_server.py's tolerances: predictions agree on
    >= 0.98 of served samples (an argmax flips only on a near tie), final
    params and ridge leaves to rtol 1e-4 / atol 1e-5.
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import masking as rmasking
from repro.core.types import DFRConfig as RConfig
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro_torch import convert
from repro_torch.core.types import DFRConfig, map_leaves
from repro_torch.runtime import StreamRequest, StreamServer
from repro_torch.runtime.graphs import RoundGraphs

RCFG = RConfig(n_in=2, n_classes=3, n_nodes=8)
CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
SERVER = dict(t_max=16, max_streams=3, window=2, phase_steps=2,
              refresh_every=3)
STREAM_SIZES = (8, 6, 10, 4, 7)
STATE_LEAVES = ("params_p", "params_q", "params_W", "params_b", "ridge_A",
                "ridge_B", "ridge_count", "ridge_factor_beta", "step")
MODES = {
    "recompute": {},
    "incremental": {"refresh_mode": "incremental"},
    "int8": {"refresh_mode": "incremental", "quantize": "int8"},
}


def _stream_arrays(n, seed, t=16, n_in=2, n_classes=3):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, t, n_in)).astype(np.float32),
            r.integers(4, t + 1, n).astype(np.int32),
            r.integers(0, n_classes, n).astype(np.int32))


def _mask():
    return np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(RCFG.mask_seed), RCFG.n_nodes, RCFG.n_in,
        jnp.float32))


def _server(server_cls, request_cls, cfg, server=SERVER, **kw):
    srv = server_cls(cfg, mask=_mask(), **server, **kw)
    streams = []
    for rid, n in enumerate(STREAM_SIZES):
        u, length, label = _stream_arrays(n, seed=rid)
        streams.append(request_cls(rid=rid, u=u, length=length, label=label))
        srv.submit(streams[-1])
    return srv, streams


def _episode(graphs=False, **kw):
    """The port's episode on the CPU; ``graphs`` serves it through the
    in-place round bodies."""
    srv, _ = _server(StreamServer, StreamRequest, CFG, device="cpu", **kw)
    if graphs:
        srv._graphs = RoundGraphs(capture=False)
    done = srv.run_until_drained()
    return {r.rid: r for r in done}, srv


def _leaves(state):
    out = []
    map_leaves(out.append, state)
    return out


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def _assert_same_episode(got, want):
    """Predictions, rolling accuracy, retirement snapshots and the server's
    final state, bit for bit."""
    (g, gs), (w, ws) = got, want
    assert sorted(g) == sorted(w)
    for rid, r in w.items():
        assert g[rid].preds == r.preds
        assert g[rid].correct == r.correct and g[rid].done
        _assert_bitwise(g[rid].final_state, r.final_state)
    _assert_bitwise(gs.states, ws.states)
    assert gs.global_step == ws.global_step
    assert gs.served_int8 == ws.served_int8


_EPISODES = {}


def _base(mode):
    """The synchronous, unblocked eager episode of ``mode``."""
    if mode not in _EPISODES:
        _EPISODES[mode] = _episode(**MODES[mode])
    return _EPISODES[mode]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_serving_is_bitwise_the_synchronous_path(depth, mode):
    got = _episode(pipeline_depth=depth, **MODES[mode])
    _assert_same_episode(got, _base(mode))
    assert got[1].pipeline_depth == depth


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("block", [2, 4])
def test_step_blocking_serves_the_unblocked_episode(block, mode):
    got = _episode(step_block=block, **MODES[mode])
    _assert_same_episode(got, _base(mode))
    # blocks took several rounds each: fewer dispatches than rounds
    assert len(got[1].step_times_s) < got[1].global_step


def test_step_blocking_composes_with_pipelining_and_int8():
    got = _episode(step_block=3, pipeline_depth=2, **MODES["int8"])
    _assert_same_episode(got, _base("int8"))
    assert got[1].served_int8 > 0


def test_blocked_episode_reads_predictions_once_per_block():
    """A block is one dispatch with one blocking prediction read, however
    many rounds it ran."""
    _, srv = _episode(step_block=4)
    dispatches = len(srv.step_times_s)
    assert len(srv.drain_times_s) == len(srv.dispatch_times_s) == dispatches
    assert dispatches < srv.global_step
    _, srv1 = _episode()
    assert len(srv1.drain_times_s) == srv1.global_step == srv.global_step


@pytest.mark.parametrize("mode,kw", [
    ("recompute", {}),
    ("incremental", {}),
    ("int8", {}),
    ("int8", {"step_block": 3, "pipeline_depth": 2}),
])
def test_in_place_round_serves_the_eager_episode(mode, kw):
    """The bodies the card captures (admission reset before the step, the
    statistics added in place without the dead-slot select, every other
    leaf copied back, the refresh in place, predictions through the host
    ring) serve the eager round's episode bit for bit."""
    got = _episode(graphs=True, **MODES[mode], **kw)
    assert got[1]._graphs.eager_calls >= got[1].global_step
    _assert_same_episode(got, _base(mode))


_REFERENCE = {}


@pytest.mark.parametrize("mode,kw", [
    ("recompute", {"pipeline_depth": 2}),
    ("recompute", {"step_block": 4}),
    ("incremental", {"step_block": 2, "pipeline_depth": 1}),
    ("int8", {"step_block": 3, "pipeline_depth": 2}),
])
def test_episode_matches_reference_with_the_same_knobs(mode, kw):
    key = (mode, tuple(sorted(kw.items())))
    if key not in _REFERENCE:
        srv, _ = _server(RServer, RRequest, RCFG, **MODES[mode], **kw)
        _REFERENCE[key] = {r.rid: r for r in srv.run_until_drained()}
    want = _REFERENCE[key]
    got, srv = _episode(**MODES[mode], **kw)
    assert sorted(got) == sorted(want)
    total = agree = 0
    for rid, r in want.items():
        assert len(got[rid].preds) == len(r.preds) == r.n_samples
        total += len(r.preds)
        agree += sum(int(a == b) for a, b in zip(got[rid].preds, r.preds))
    assert agree / total >= 0.98
    for rid, r in want.items():
        w = convert.state_leaves(r.final_state)
        g = convert.state_leaves(got[rid].final_state)
        for name in STATE_LEAVES:
            np.testing.assert_allclose(
                g[name].astype(np.float64), w[name].astype(np.float64),
                rtol=1e-4, atol=1e-5, err_msg=f"stream {rid}: {name}")
    assert (srv.served_int8 > 0) == (mode == "int8")


def test_drain_after_truncation_is_idempotent_and_resumable():
    """After a ``max_steps`` cut, ``drain()`` has nothing left to book (the
    cut flushed the ring) and the server resumes to a clean finish."""
    srv, streams = _server(
        StreamServer, StreamRequest, CFG, device="cpu",
        server=dict(SERVER, max_streams=2, phase_steps=1),
        pipeline_depth=2)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        srv.run_until_drained(max_steps=3)
    assert not srv._inflight
    counts = {r.rid: len(r.preds) for r in streams}
    srv.drain()
    srv.drain()
    assert {r.rid: len(r.preds) for r in streams} == counts
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        done = srv.run_until_drained()
    assert not [x for x in w if issubclass(x.category, RuntimeWarning)]
    assert sorted(r.rid for r in done) == sorted(r.rid for r in streams)
    for r in done:
        assert r.done and len(r.preds) == r.n_samples


def test_latency_records_are_bounded_and_split():
    """Each dispatch records its enqueue and, when read, its blocking read;
    the records ride bounded rings."""
    srv, _ = _server(
        StreamServer, StreamRequest, CFG, device="cpu",
        server=dict(SERVER, max_streams=2, phase_steps=1),
        pipeline_depth=1, latency_window=8)
    srv.run_until_drained()
    assert srv.global_step > 8
    assert len(srv.step_times_s) == len(srv.dispatch_times_s) == 8
    assert 0 < len(srv.drain_times_s) <= 8
    lat = srv.latency_percentiles_ms()
    for key in ("p50_ms", "p99_ms", "dispatch_p50_ms", "dispatch_p99_ms",
                "drain_p50_ms", "drain_p99_ms"):
        assert key in lat and lat[key] >= 0.0
    assert lat["dispatch_p50_ms"] <= lat["p50_ms"] + 1e-6


def test_step_block_needs_device_staging():
    with pytest.raises(ValueError, match="staging='device'"):
        StreamServer(CFG, t_max=16, device="cpu", step_block=2,
                     staging="host")
    StreamServer(CFG, t_max=16, device="cpu", step_block=2,
                 pipeline_depth=1, staging="device")
    with pytest.raises(ValueError):
        StreamServer(CFG, t_max=16, device="cpu", pipeline_depth=-1)
