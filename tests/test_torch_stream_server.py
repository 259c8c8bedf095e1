"""The whole slice: a StreamServer episode in both packages, plus the port's
isolation and no-fallback contracts.

The episode has the shapes of tests/test_stream_quant.py (Nx=8, 3 classes,
t_max 16; 3 slots, window 2, phase_steps 2, refresh_every 3; five streams of
8, 6, 10, 4 and 7 samples) and both servers use the reference's mask, so
they serve the same model on the same data: admissions, phase switches,
refreshes and slot refill all happen on both sides.

Tolerances: predictions agree on >= 0.98 of served samples (an argmax
flips only on a near tie); final params and ridge leaves of every stream
match to rtol 1e-4 / atol 1e-5 - a few fp32 SGD steps and Cholesky solves of
an s=73 system in two frameworks.
"""
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.core.types import DFRConfig
from repro_torch.runtime import StreamRequest, StreamServer

REPO = Path(__file__).resolve().parents[1]
RCFG = RConfig(n_in=2, n_classes=3, n_nodes=8)
CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
SERVER = dict(t_max=16, max_streams=3, window=2, phase_steps=2,
              refresh_every=3)
STREAM_SIZES = (8, 6, 10, 4, 7)
STATE_LEAVES = ("params_p", "params_q", "params_W", "params_b", "ridge_A",
                "ridge_B", "ridge_count", "ridge_factor_beta", "step")


def _stream_arrays(n, seed, t=16, n_in=2, n_classes=3):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, t, n_in)).astype(np.float32),
            r.integers(4, t + 1, n).astype(np.int32),
            r.integers(0, n_classes, n).astype(np.int32))


def _mask():
    return np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(RCFG.mask_seed), RCFG.n_nodes, RCFG.n_in,
        jnp.float32))


def _serve(server_cls, request_cls, cfg, **kw):
    srv = server_cls(cfg, mask=_mask(), **SERVER, **kw)
    for rid, n in enumerate(STREAM_SIZES):
        u, length, label = _stream_arrays(n, seed=rid)
        srv.submit(request_cls(rid=rid, u=u, length=length, label=label))
    done = srv.run_until_drained()
    return {r.rid: r for r in done}, srv


_REFERENCE = {}


def _reference_episode(staging, cohorts):
    key = (staging, cohorts)
    if key not in _REFERENCE:
        _REFERENCE[key] = _serve(RServer, RRequest, RCFG, staging=staging,
                                 refresh_cohorts=cohorts)[0]
    return _REFERENCE[key]


def _agreement(got, want):
    total = agree = 0
    for rid, r in want.items():
        assert len(got[rid].preds) == len(r.preds) == r.n_samples
        total += len(r.preds)
        agree += sum(int(a == b) for a, b in zip(got[rid].preds, r.preds))
    return agree / total


@pytest.mark.parametrize("staging", ["device", "host"])
@pytest.mark.parametrize("cohorts", [1, 3])
def test_episode_matches_reference(staging, cohorts):
    want = _reference_episode(staging, cohorts)
    got, srv = _serve(StreamServer, StreamRequest, CFG, staging=staging,
                      refresh_cohorts=cohorts, device="cpu")
    assert not srv.fused_infer and not srv.fused   # the CPU keeps XLA's path
    assert sorted(got) == sorted(want)
    assert _agreement(got, want) >= 0.98
    for rid, r in want.items():
        w = convert.state_leaves(r.final_state)
        g = convert.state_leaves(got[rid].final_state)
        for name in STATE_LEAVES:
            np.testing.assert_allclose(
                g[name].astype(np.float64), w[name].astype(np.float64),
                rtol=1e-4, atol=1e-5, err_msg=f"stream {rid}: {name}")
        assert got[rid].online_accuracy == pytest.approx(
            r.online_accuracy, abs=0.15)
    lat = srv.latency_percentiles_ms()
    assert np.isfinite(lat["p50_ms"]) and np.isfinite(lat["drain_p99_ms"])


def test_episode_through_plain_k2_matches_reference():
    """``fused_infer=True`` on the CPU serves the logits through K2's plain
    version (the path the card takes through the kernel)."""
    want = _reference_episode("device", 1)
    got, srv = _serve(StreamServer, StreamRequest, CFG, fused_infer=True,
                      device="cpu")
    assert srv.fused_infer
    assert _agreement(got, want) >= 0.98


# ---------------------------------------------------------------------------
# isolation, device choice and unported knobs
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'repro' "
        "or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert StreamServer(CFG, t_max=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamServer(CFG, t_max=16)


@pytest.mark.parametrize("kw", [
    {"devices": 2},
])
def test_unported_knobs_raise(kw):
    """Multi-device serving is ported (tests/test_torch_sharded.py): two
    blocks of 2 slots on the CPU serve the one-block episode of 4 slots bit
    for bit, predictions and final states."""
    def episode(**extra):
        srv = StreamServer(CFG, mask=_mask(), device="cpu",
                           **{**SERVER, "max_streams": 4}, **extra)
        for rid, n in enumerate(STREAM_SIZES):
            u, length, label = _stream_arrays(n, seed=rid)
            srv.submit(StreamRequest(rid=rid, u=u, length=length,
                                     label=label))
        return {r.rid: r for r in srv.run_until_drained()}, srv

    one, srv1 = episode()
    got, srv = episode(**kw)
    assert len(srv.blocks) == kw["devices"] and len(srv1.blocks) == 1
    assert {rid: r.preds for rid, r in got.items()} == {
        rid: r.preds for rid, r in one.items()}
    for rid, r in one.items():
        w = convert.state_leaves(r.final_state)
        g = convert.state_leaves(got[rid].final_state)
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    w, g = convert.state_leaves(srv1.states), convert.state_leaves(srv.states)
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_config_auto_plans_the_unset_knobs(monkeypatch):
    """config='auto' is ported (tests/test_torch_planner.py): the unset
    knobs come from the planner's search on the server's calibration,
    explicit ones win."""
    from repro_torch.runtime import planner

    cal = planner.Calibration(
        c_dispatch=1e-3, c_flop=1e-9, c_byte=1e-9, c_rot=1e-12, c_sub=1e-9,
        c_chol=1e-6, c_quant=1e-9)
    monkeypatch.setattr(planner, "get_calibration", lambda *a, **k: cal)
    srv = StreamServer(CFG, t_max=16, device="cpu", config="auto")
    assert (srv.refresh_mode, srv.step_block) == ("incremental", 8)
    assert srv.plan.knobs()["refresh_mode"] == "incremental"
    srv = StreamServer(CFG, t_max=16, device="cpu", config="auto",
                       step_block=2, refresh_mode="recompute")
    assert (srv.refresh_mode, srv.step_block) == ("recompute", 2)


def test_unported_dtype_and_autotuner_raise():
    """bf16 and the autotuner are ported (tests/test_torch_bf16.py,
    tests/test_torch_autotuner.py): a bf16 server serves in bf16 with the
    incremental refresh and refuses the recompute refresh (no bf16
    Cholesky, in either package)."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="incremental"):
        StreamServer(cfg, t_max=16, device="cpu")
    srv = StreamServer(cfg, t_max=16, device="cpu",
                       refresh_mode="incremental", max_streams=2, window=2,
                       phase_steps=1, refresh_every=2)
    u, length, label = _stream_arrays(6, seed=0)
    srv.submit(StreamRequest(rid=0, u=u, length=length, label=label))
    (done,) = srv.run_until_drained()
    assert len(done.preds) == 6
    assert srv.states.ridge.Lt.dtype == srv.pool.u.dtype == torch.bfloat16


def test_int8_needs_device_staging():
    """As in the reference: the int8 scale fold rides the device-staged
    step's refresh."""
    with pytest.raises(ValueError, match="staging='device'"):
        StreamServer(CFG, t_max=16, device="cpu", quantize="int8",
                     staging="host")
    StreamServer(CFG, t_max=16, device="cpu", quantize="int8")


def test_unknown_knob_values_raise_value_error():
    for kw in ({"refresh_mode": "bogus"}, {"retirement": "bogus"},
               {"staging": "bogus"}, {"quantize": "int4"},
               {"config": "manual"}, {"step_block": 0}):
        with pytest.raises(ValueError):
            StreamServer(CFG, t_max=16, device="cpu", **kw)
