"""The port's calibrated planner (``repro_torch.runtime.planner``) against the
reference's (``repro.runtime.planner``), on the CPU.

The reference's tests (tests/test_planner.py) on the port, on the same
synthetic ``Calibration``: the model's structure, the lattice and the
search, the calibration file's persistence (on ``tmp_path``, never in the
repository), ``StreamServer(config='auto')``'s wiring with
``get_calibration`` patched, and the replay gate.  Then parity: with
``program_cost`` patched in both packages to the same (flops, bytes) and
the same calibration, ``predict_step_cost`` and
``predict_refresh_spike_s`` agree to 1e-12 relative (the same formula in
float64 on both sides), and ``lattice``, ``search`` and
``replay_bench_tables`` give equal results over a grid of knobs.  And the
port's own work counts: ``program_cost`` is ``launch.kernel_cost``'s K2
and K5.
"""
import dataclasses
import itertools
import json
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.types import DFRConfig as RConfig
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro.runtime import planner as rplanner
from repro_torch.core.types import DFRConfig
from repro_torch.launch import kernel_cost
from repro_torch.runtime import StreamRequest, StreamServer, planner
from repro_torch.runtime.planner import (Calibration, Plan, Planner,
                                         predict_step_cost,
                                         replay_bench_tables)

REL = 1e-12   # the same float64 formula in both packages


#: flat synthetic coefficients: every primitive 1 ns a unit, dispatch 1 us
def _cal(cls=Calibration, **over):
    kw = dict(c_dispatch=1e-6, c_flop=1e-9, c_byte=1e-9, c_rot=1e-9,
              c_sub=1e-9, c_chol=1e-9, c_quant=1e-9, backend="cpu",
              fingerprint={"backend": "cpu"})
    kw.update(over)
    return cls(**kw)


NX, S, W, T = 4, 2, 1, 8


def _predict(cal, **over):
    kw = dict(Nx=NX, S=S, window=W, retirement="none",
              refresh_mode="recompute", cohorts=1, step_block=1,
              quantize="none", n_classes=3, t_len=T, refresh_every=5,
              cal=cal)
    kw.update(over)
    return predict_step_cost(**kw)


# -- the model's structural claims -------------------------------------------


def test_step_block_amortizes_dispatch():
    cal = _cal(c_dispatch=1e-3)
    t1 = _predict(cal, step_block=1)
    t4 = _predict(cal, step_block=4)
    t8 = _predict(cal, step_block=8)
    assert t8 < t4 < t1
    free = _cal(c_dispatch=0.0)
    assert _predict(free, step_block=8) == pytest.approx(
        _predict(free, step_block=1))


def test_refresh_mode_winner_flips_with_rotation_cost():
    rot_cheap = _cal(c_rot=1e-12, c_chol=1e-8)
    assert _predict(rot_cheap, refresh_mode="incremental") < _predict(
        rot_cheap, refresh_mode="recompute")
    rot_dear = _cal(c_rot=1e-6, c_chol=1e-12)
    assert _predict(rot_dear, refresh_mode="recompute", window=8) < _predict(
        rot_dear, refresh_mode="incremental", window=8)


def test_window_retirement_doubles_rotations():
    cal = _cal(c_rot=1e-6)
    inc = _predict(cal, refresh_mode="incremental")
    win = _predict(cal, refresh_mode="incremental", retirement="window")
    assert win > inc


def test_quantize_costs_extra_on_calibrated_cpu():
    cal = _cal()
    assert _predict(cal, quantize="int8") > _predict(cal, quantize="none")


def test_backend_mismatch_raises():
    with pytest.raises(ValueError, match="backend"):
        _predict(_cal(backend="cpu"), backend="cuda")


def test_more_cohorts_shrink_predicted_refresh_spike():
    cal = _cal()
    spikes = [planner.predict_refresh_spike_s(8, 16, "recompute", c,
                                              n_classes=3, cal=cal)
              for c in (1, 2, 4)]
    assert spikes[0] > spikes[1] > spikes[2]


# -- the feasibility lattice and the search ----------------------------------


def _mk_planner(cal, module=planner, **over):
    kw = dict(Nx=NX, S=S, window=W, t_len=T, n_classes=3, refresh_every=5,
              cal=cal)
    kw.update(over)
    return module.Planner(**kw)


def test_lattice_respects_window_retirement():
    pl = _mk_planner(_cal(), retirement="window")
    assert {m for m, _, _, _ in pl.lattice()} == {"incremental"}


def test_lattice_restricts_host_staging_to_unblocked():
    pl = _mk_planner(_cal(), staging="host")
    assert {b for _, _, b, _ in pl.lattice()} == {1}


def test_lattice_searches_chunk_t_only_where_it_lowers_differently():
    """The port's kernels have no time chunks: the default lattice holds
    chunk_t=None only; an explicit chunk_ts always wins."""
    pl = _mk_planner(_cal())
    assert {ct for _, _, _, ct in pl.lattice()} == {None}
    explicit = {ct for _, _, _, ct in pl.lattice(chunk_ts=(None, 32))}
    assert explicit == {None, 32}


def test_search_ties_resolve_chunk_t_to_none():
    pl = _mk_planner(_cal())
    plan = pl.search(chunk_ts=(None, 64, 128))
    assert plan.chunk_t is None


def test_search_returns_lattice_argmin():
    pl = _mk_planner(_cal(c_dispatch=1e-3))
    plan = pl.search()
    assert isinstance(plan, Plan)
    best = min(pl.predict(m, c, b, ct) for m, c, b, ct in pl.lattice())
    assert plan.predicted_s_per_sample == pytest.approx(best)
    assert plan.predicted_samples_per_s == pytest.approx(
        1.0 / plan.predicted_s_per_sample)
    assert plan.knobs().keys() == {"refresh_mode", "refresh_cohorts",
                                   "step_block", "chunk_t"}


# -- calibration persistence -------------------------------------------------


def _here():
    return planner._host_fingerprint("cpu")


def test_calibration_json_roundtrip():
    cal = _cal(c_flop=3.25e-10)
    doc = json.loads(json.dumps(cal.to_json()))
    assert Calibration.from_json(doc) == cal
    assert doc["schema"] == rplanner.CAL_SCHEMA == planner.CAL_SCHEMA


def test_calibration_schema_mismatch_raises():
    doc = _cal().to_json()
    doc["schema"] = 999
    with pytest.raises(ValueError, match="schema"):
        Calibration.from_json(doc)


def test_fingerprint_names_the_device_and_host():
    fp = _here()
    assert fp["backend"] == fp["device"] == "cpu"
    assert fp["torch"] == torch.__version__ and fp["cores"] >= 1
    assert {"power_limit", "cuda", "machine"} <= fp.keys()


def test_default_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv(planner.CAL_ENV, raising=False)
    assert planner.default_cal_path().endswith(
        ".planner_calibration_torch.json")
    assert planner.CAL_ENV != rplanner.CAL_ENV
    assert planner.DEFAULT_CAL_FILE != rplanner.DEFAULT_CAL_FILE
    monkeypatch.setenv(planner.CAL_ENV, str(tmp_path / "x.json"))
    assert planner.default_cal_path() == str(tmp_path / "x.json")


def test_get_calibration_reuses_matching_file(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    cal = _cal(c_flop=1.25e-4, fingerprint=_here(), backend="cpu")
    path.write_text(json.dumps(cal.to_json()))
    monkeypatch.setattr(planner, "calibrate",
                        lambda *a, **k: pytest.fail("re-measured"))
    monkeypatch.setattr(planner, "_CAL_CACHE", {})
    got = planner.get_calibration(str(path), device="cpu")
    assert got.c_flop == 1.25e-4
    path.unlink()
    assert planner.get_calibration(str(path), device="cpu").c_flop == 1.25e-4


def test_get_calibration_rejects_foreign_fingerprint(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    foreign = _cal(fingerprint={"backend": "not-this-host", "cores": -1})
    path.write_text(json.dumps(foreign.to_json()))
    fresh = _cal(c_flop=7.5e-7, fingerprint=_here())
    monkeypatch.setattr(planner, "calibrate", lambda *a, **k: fresh)
    monkeypatch.setattr(planner, "_CAL_CACHE", {})
    got = planner.get_calibration(str(path), device="cpu")
    assert got.c_flop == 7.5e-7
    assert json.loads(path.read_text())["c_flop"] == 7.5e-7


def test_get_calibration_recovers_from_torn_file(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    good = json.dumps(_cal().to_json())
    path.write_text(good[: len(good) // 2])
    fresh = _cal(c_flop=3.5e-8, fingerprint=_here())
    monkeypatch.setattr(planner, "calibrate", lambda *a, **k: fresh)
    monkeypatch.setattr(planner, "_CAL_CACHE", {})
    got = planner.get_calibration(str(path), device="cpu")
    assert got.c_flop == 3.5e-8
    assert json.loads(path.read_text())["c_flop"] == 3.5e-8
    assert [p.name for p in tmp_path.iterdir()] == ["cal.json"]


def test_get_calibration_concurrent_writers_never_tear(tmp_path, monkeypatch):
    import threading

    path = str(tmp_path / "cal.json")
    fresh = _cal(c_flop=9e-9, fingerprint=_here())
    monkeypatch.setattr(planner, "calibrate", lambda *a, **k: fresh)
    monkeypatch.setattr(planner, "_CAL_CACHE", {})
    stop = threading.Event()
    errors = []

    def writer():
        for _ in range(50):
            planner._CAL_CACHE.clear()
            try:
                planner.get_calibration(path, device="cpu")
            except Exception as e:             # pragma: no cover
                errors.append(e)

    def reader():
        while not stop.is_set():
            try:
                with open(path) as fh:
                    Calibration.from_json(json.load(fh))
            except FileNotFoundError:
                pass
            except Exception as e:             # pragma: no cover
                errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    rt = threading.Thread(target=reader)
    rt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    rt.join()
    assert not errors
    assert json.loads(open(path).read())["c_flop"] == 9e-9


# -- StreamServer(config='auto') wiring --------------------------------------


CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=4)


def _stream(cls=StreamRequest, rid=0, n=6, t=T, seed=0):
    r = np.random.default_rng(seed)
    return cls(
        rid=rid,
        u=r.normal(size=(n, t, 2)).astype(np.float32),
        length=r.integers(4, t + 1, n).astype(np.int32),
        label=r.integers(0, 3, n).astype(np.int32),
    )


@pytest.fixture()
def synthetic_host_cal(monkeypatch):
    cal = _cal(c_dispatch=1e-3)
    monkeypatch.setattr(planner, "get_calibration", lambda *a, **k: cal)
    return cal


def _server(**kw):
    return StreamServer(CFG, t_max=T, max_streams=S, window=W, device="cpu",
                        **kw)


def test_config_auto_fills_unset_knobs(synthetic_host_cal):
    srv = _server(config="auto")
    assert srv.plan is not None
    assert srv.refresh_mode == srv.plan.refresh_mode
    assert srv.step_block == srv.plan.step_block
    assert srv.cohorts.n_cohorts >= 1
    srv.submit(_stream())
    done = srv.run_until_drained()
    assert len(done) == 1 and done[0].done


def test_config_auto_explicit_knobs_override(synthetic_host_cal):
    auto = _server(config="auto")
    assert auto.plan.step_block > 1
    srv = _server(config="auto", refresh_mode="recompute",
                  refresh_cohorts=1, step_block=1)
    assert (srv.refresh_mode, srv.cohorts.n_cohorts, srv.step_block) == (
        "recompute", 1, 1)


def test_config_auto_respects_window_retirement(synthetic_host_cal):
    srv = _server(config="auto", retirement="window", retire_window=8)
    assert srv.refresh_mode == "incremental"


def test_config_auto_serves_the_explicit_plan(synthetic_host_cal):
    """An auto server serves what an explicit server with its plan's knobs
    serves, bit for bit."""
    auto = _server(config="auto")
    explicit = _server(**{k: v for k, v in auto.plan.knobs().items()
                          if v is not None})
    out = []
    for srv in (auto, explicit):
        for rid in range(3):
            srv.submit(_stream(rid=rid, n=5 + rid, seed=rid))
        out.append({r.rid: r.preds for r in srv.run_until_drained()})
    assert out[0] == out[1]
    assert torch.equal(auto.states.params.W, explicit.states.params.W)


def test_default_config_keeps_historical_defaults():
    srv = _server()
    assert srv.plan is None
    assert (srv.refresh_mode, srv.cohorts.n_cohorts, srv.step_block) == (
        "recompute", 1, 1)


def test_unknown_config_raises():
    with pytest.raises(ValueError, match="config"):
        _server(config="fast")


def test_bf16_config_auto_follows_the_plan_in_both_packages(monkeypatch):
    """The planner does not see cfg.dtype, in either package.  Where it
    plans the incremental refresh a bf16 auto server serves in both; where
    it plans recompute, the port refuses at construction and the reference
    at its first refresh (no bf16 Cholesky in either)."""
    rcfg = RConfig(n_in=2, n_classes=3, n_nodes=4, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    for cal_kw, mode in ((dict(c_rot=1e-12, c_chol=1e-6), "incremental"),
                         (dict(c_rot=1e-6, c_chol=1e-12), "recompute")):
        pcal, rcal = _cal(**cal_kw), _cal(rplanner.Calibration, **cal_kw)
        monkeypatch.setattr(planner, "get_calibration", lambda *a, **k: pcal)
        monkeypatch.setattr(rplanner, "get_calibration",
                            lambda *a, **k: rcal)
        ref = RServer(rcfg, t_max=T, max_streams=S, window=W, config="auto")
        assert ref.refresh_mode == mode
        ref.submit(_stream(RRequest))
        if mode == "incremental":
            srv = StreamServer(cfg, t_max=T, max_streams=S, window=W,
                               device="cpu", config="auto")
            assert srv.refresh_mode == mode
            srv.submit(_stream())
            assert srv.run_until_drained()[0].done
            assert ref.run_until_drained()[0].done
        else:
            with pytest.raises(ValueError, match="incremental"):
                StreamServer(cfg, t_max=T, max_streams=S, window=W,
                             device="cpu", config="auto")
            with pytest.raises(NotImplementedError, match="bfloat16"):
                ref.run_until_drained()


# -- the replay gate ---------------------------------------------------------


def _bench_doc(rows):
    return {"bench": "stream_quant", "rows": rows}


def _quant_row(cell="S2/Nx4/W1", **sps):
    row = {"table": "stream-quant", "cell": cell, "t_len": T}
    for name, v in sps.items():
        row[f"{name}_samples_per_s"] = v
    return row


def test_replay_passes_when_model_ranks_like_the_bench(tmp_path):
    (tmp_path / "BENCH_stream_quant.json").write_text(json.dumps(_bench_doc(
        [_quant_row(fp32=1000.0, int8=300.0, fp32_b4=1400.0, int8_b4=350.0)]
    )))
    res = replay_bench_tables(str(tmp_path), cal=_cal(c_dispatch=1e-3))
    assert len(res) == 1
    assert res[0]["ok"] is True
    assert res[0]["pick"] == "fp32_b4" == res[0]["best"]
    assert res[0]["best_over_pick_ratio"] == pytest.approx(1.0)


def test_replay_fails_when_pick_misses_the_gate(tmp_path):
    (tmp_path / "BENCH_stream_quant.json").write_text(json.dumps(_bench_doc(
        [_quant_row(fp32=1000.0, int8=300.0, fp32_b4=500.0, int8_b4=200.0)]
    )))
    res = replay_bench_tables(str(tmp_path), cal=_cal(c_dispatch=1e-3))
    assert res[0]["ok"] is False
    assert res[0]["pick"] == "fp32_b4"
    assert res[0]["best"] == "fp32"
    assert res[0]["best_over_pick_ratio"] == pytest.approx(2.0)


def test_replay_no_table_is_empty(tmp_path):
    assert replay_bench_tables(str(tmp_path), cal=_cal()) == []


def test_replay_parses_real_tracked_table_if_present():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.exists(os.path.join(root, "BENCH_stream_quant.json")):
        pytest.skip("no tracked quant table")
    res = replay_bench_tables(root, cal=_cal(c_dispatch=1e-3))
    assert res, "tracked table produced no replay rows"
    for row in res:
        assert set(row) >= {"cell", "pick", "best", "best_over_pick_ratio",
                            "ok"}
        assert row["best_over_pick_ratio"] >= 1.0
        assert not math.isnan(row["best_over_pick_ratio"])


# -- parity with the reference -----------------------------------------------


def _fake_program_cost(n_nodes, n_classes, n_streams, window, t_len,
                       quantize="none", chunk_t=None):
    """Synthetic (flops, bytes) of one logits round, the same in both
    packages: the int8 round costs more flops and fewer bytes."""
    base = n_streams * window * t_len * n_nodes * (3 * n_nodes + 7)
    if quantize == "int8":
        return 3.0 * base + 17.0, 0.25 * base + 5.0
    return float(base), 2.0 * base + 11.0


@pytest.fixture()
def same_program_cost(monkeypatch):
    monkeypatch.setattr(planner, "program_cost", _fake_program_cost)
    monkeypatch.setattr(rplanner, "program_cost", _fake_program_cost)


CALS = (
    dict(),
    dict(c_dispatch=1e-3, c_rot=3e-11, c_chol=2e-9, c_sub=5e-10),
    dict(c_dispatch=2e-5, c_rot=1e-8, c_chol=1e-12, c_flop=7e-13,
         c_byte=3e-13, c_quant=4e-11),
)


@pytest.mark.parametrize("cal_kw", CALS)
def test_predictions_match_the_reference(same_program_cost, cal_kw):
    pcal, rcal = _cal(**cal_kw), _cal(rplanner.Calibration, **cal_kw)
    for (nx, s_, w, t_len, ny, every, ret, mode, c, b, q) in itertools.product(
            (4, 30), (2, 32), (1, 4), (8, 93), (3, 10), (5,),
            ("none", "forget", "window"), ("recompute", "incremental"),
            (1, 5), (1, 2, 4, 8), ("none", "int8")):
        kw = dict(chunk_t=None, n_classes=ny, t_len=t_len,
                  refresh_every=every)
        got = predict_step_cost(nx, s_, w, ret, mode, c, b, q, cal=pcal, **kw)
        want = rplanner.predict_step_cost(nx, s_, w, ret, mode, c, b, q,
                                          cal=rcal, **kw)
        assert got == pytest.approx(want, rel=REL)
        got = planner.predict_refresh_spike_s(nx, s_, mode, c, n_classes=ny,
                                              cal=pcal)
        want = rplanner.predict_refresh_spike_s(nx, s_, mode, c,
                                                n_classes=ny, cal=rcal)
        assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("cal_kw", CALS)
def test_lattice_and_plans_match_the_reference(same_program_cost, cal_kw):
    pcal, rcal = _cal(**cal_kw), _cal(rplanner.Calibration, **cal_kw)
    for ret, q, staging, nx in itertools.product(
            ("none", "forget", "window", "adaptive"), ("none", "int8"),
            ("device", "host"), (4, 30)):
        kw = dict(Nx=nx, S=32, window=4, t_len=93, n_classes=10,
                  refresh_every=5, retirement=ret, quantize=q,
                  staging=staging)
        pl = Planner(cal=pcal, **kw)
        rpl = rplanner.Planner(cal=rcal, **kw)
        assert pl.lattice() == rpl.lattice()
        for search_kw in ({}, dict(refresh_modes=("incremental",)),
                          dict(cohorts=(1, 2, 5), step_blocks=(1, 4))):
            got = dataclasses.asdict(pl.search(**search_kw))
            want = dataclasses.asdict(rpl.search(**search_kw))
            for key in ("predicted_s_per_sample", "predicted_samples_per_s",
                        "predicted_refresh_spike_s"):
                assert got.pop(key) == pytest.approx(want.pop(key), rel=REL)
            assert got == want


@pytest.mark.parametrize("cal_kw", CALS)
def test_replay_rows_match_the_reference(tmp_path, same_program_cost,
                                         cal_kw):
    rows = [_quant_row(fp32=1000.0, int8=300.0, fp32_b4=1400.0,
                       int8_b4=350.0),
            _quant_row(cell="S32/Nx30/W4", fp32=5.0e4, int8=4.0e4,
                       fp32_b4=6.0e4, int8_b4=5.5e4),
            _quant_row(cell="S8/Nx16/W2", fp32=900.0, int8_b4=1500.0),
            _quant_row(cell="S8/W2", fp32=1.0, int8=2.0),
            {"table": "other", "cell": "S2/Nx4/W1"}]
    (tmp_path / "BENCH_stream_quant.json").write_text(json.dumps(
        _bench_doc(rows)))
    got = replay_bench_tables(str(tmp_path), cal=_cal(**cal_kw))
    want = rplanner.replay_bench_tables(
        str(tmp_path), cal=_cal(rplanner.Calibration, **cal_kw))
    assert len(got) == 3
    assert got == want


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_program_cost_is_kernel_costs_formula(quantize):
    nx, ny, s_, w, t_len = 30, 10, 32, 4, 93
    flops, nbytes = planner.program_cost(nx, ny, s_, w, t_len, quantize)
    n = s_ * w
    live = n * t_len
    nr = nx * (nx + 1)
    if quantize == "int8":
        assert nbytes == (live * nx * 4 + n * 4
                          + s_ * (nx * nx + 4 * nx + 16 + ny * nr + 4 * ny)
                          + 4 * n * ny)
        assert flops == (live * 12 * nx + n * ny * (4 * nr + 1)
                         + live * 2 * (nx * nx + nx * (nx + 1)))
        work = kernel_cost.streaming_logits_q8(live, s_, n, nx, ny)
    else:
        assert nbytes == (live * nx * 4 + n * 4 + 8 * s_
                          + 4 * (s_ * ny * nr + s_ * ny + n * ny))
        assert flops == (live * (3 * nx * nx + 7 * nx)
                         + n * ny * (2 * nr + 1))
        work = kernel_cost.streaming_logits(live, s_, n, nx, ny)
    assert (flops, nbytes) == (work.flops + work.int_ops, work.nbytes)
    # chunk_t is a TPU tiling knob: the count ignores it
    assert planner.program_cost(nx, ny, s_, w, t_len, quantize, 64) == (
        flops, nbytes)
    ms, by = work.bound()
    assert ms > 0 and by in ("bytes", "operations")
