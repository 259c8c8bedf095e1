"""Slot-sharded serving in the port: ``StreamServer(devices=N)``.

The twin of tests/test_stream_sharded.py.  The port splits the slots into N
contiguous blocks on a slot mesh whose entries here all name the CPU (the
counterpart of the reference's forced host-device split), and serves each
block's round in turn.  Nothing crosses blocks, so the contract is exact:
an N-block episode serves the one-block episode's predictions and ends with
its final states, window rings and retirement snapshots bit for bit,
across the retirement modes, pipeline depths, staggered cohorts, pool
growth, int8 and step blocking.  The reference's own forced-8-device lane
fails in the tier-1 runs (ROADMAP.md, Queue 3), so the port holds its N-block
episodes against its own one-block episode.  The cohort-schedule and
placement properties are host-only and compare with the reference's
scheduler too.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # the deterministic grid variants below still run
    HAVE_HYPOTHESIS = False

from repro.runtime.scheduler import RefreshCohorts as RRefreshCohorts
from repro_torch.core.types import DFRConfig, map_leaves
from repro_torch.runtime import (RefreshCohorts, SlotScheduler,
                                 StreamRequest, StreamServer,
                                 WarmPoolAutotuner)
from repro_torch.runtime.graphs import RoundGraphs

CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=6)
INC = {"refresh_mode": "incremental"}
MODES = {
    "recompute": {},
    "none": INC,
    "forget": {**INC, "retirement": "forget", "forget": 0.9},
    "window": {**INC, "retirement": "window", "retire_window": 6},
    "adaptive": {**INC, "retirement": "adaptive"},
}


def _make_stream(rid, n, t=10, seed=0):
    r = np.random.default_rng(seed)
    return StreamRequest(
        rid=rid,
        u=r.normal(size=(n, t, CFG.n_in)).astype(np.float32),
        length=r.integers(3, t + 1, n).astype(np.int32),
        label=r.integers(0, CFG.n_classes, n).astype(np.int32),
    )


def _episode_streams(seed0=0):
    """More streams than slots, ragged lengths: admission, tail windows,
    retirement and refill all fire."""
    return [_make_stream(i, n, seed=seed0 + i)
            for i, n in enumerate([7, 5, 9, 4, 6, 8, 5, 4, 7, 6, 5, 9])]


def _server(devices, depth=0, cohorts=1, captured=False, cfg=CFG, **kw):
    srv = StreamServer(cfg, t_max=10, max_streams=8, window=2,
                       phase_steps=3, refresh_every=4,
                       refresh_cohorts=cohorts, pipeline_depth=depth,
                       devices=devices, device="cpu", **kw)
    if captured:
        # the captured round's in-place bodies, run eagerly on the CPU
        for blk in srv.blocks:
            blk.graphs = RoundGraphs(capture=False)
    return srv


def _serve(devices, depth=0, cohorts=1, streams=None, **kw):
    srv = _server(devices, depth, cohorts, **kw)
    for s in (streams if streams is not None else _episode_streams()):
        srv.submit(s)
    done = srv.run_until_drained(strict=True)
    return {r.rid: list(r.preds) for r in done}, srv


def _leaves(tree):
    out = []
    map_leaves(out.append, tree)
    return out


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _assert_same_episode(srv_1, srv_n):
    _assert_bitwise(srv_1.states, srv_n.states)
    if srv_1.win is not None:
        _assert_bitwise(srv_1.win, srv_n.win)
    for a, b in zip(sorted(srv_1.completed, key=lambda r: r.rid),
                    sorted(srv_n.completed, key=lambda r: r.rid)):
        assert a.rid == b.rid and a.correct == b.correct and b.done
        _assert_bitwise(a.final_state, b.final_state)
        assert all(bool(torch.isfinite(x.double()).all())
                   for x in _leaves(b.final_state))


_BASELINES = {}


def _baseline(mode):
    """The one-block depth-0 episode of a mode, computed once."""
    if mode not in _BASELINES:
        _BASELINES[mode] = _serve(1, **MODES[mode])
    return _BASELINES[mode]


# ---------------------------------------------------------------------------
# Bit for bit: block counts x retirement modes x pipeline depths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("devices", [2, 4, 8])
def test_sharded_episode_is_bitwise_single_device(devices, mode):
    """N blocks serve the one-block admission/retire episode bit for bit:
    the predictions, the final slot-batched state (and window rings) and
    every retirement snapshot."""
    preds_1, srv_1 = _baseline(mode)
    preds_n, srv_n = _serve(devices, **MODES[mode])
    assert len(srv_n.blocks) == devices
    assert preds_1 == preds_n
    _assert_same_episode(srv_1, srv_n)


@pytest.mark.parametrize("mode", ["recompute", "forget", "window"])
@pytest.mark.parametrize("depth", [1, 2])
def test_sharded_pipelined_is_bitwise_synchronous(depth, mode):
    """Pipelining composes with the blocks: 8-block depth-1/2 episodes
    equal the one-block depth-0 episode."""
    preds_1, srv_1 = _baseline(mode)
    preds_d, srv_d = _serve(8, depth=depth, **MODES[mode])
    assert preds_1 == preds_d
    _assert_same_episode(srv_1, srv_d)


@pytest.mark.parametrize("knobs", [
    {},
    {"quantize": "int8", **INC},
    MODES["window"],
], ids=["recompute", "int8", "window"])
def test_sharded_in_place_round_is_bitwise(knobs):
    """The captured round's in-place bodies (each block its own
    ``RoundGraphs``, run eagerly on the CPU), also pipelined and blocked,
    serve the one-block eager episode: the card's captured blocks run the
    same bodies."""
    preds_1, srv_1 = _serve(1, **knobs)
    for extra in ({}, {"depth": 2, "step_block": 3}):
        preds_n, srv_n = _serve(2, captured=True, **extra, **knobs)
        assert all(blk.graphs.eager_calls > 0 for blk in srv_n.blocks)
        assert preds_1 == preds_n
        _assert_same_episode(srv_1, srv_n)


def test_sharded_staggered_cohorts_match():
    """Uneven refresh cohorts (C=3 over 8 slots: the block-local row lists
    need padding to a common width) refresh the same slots on the same
    steps as the one-block schedule."""
    preds_1, srv_1 = _serve(1, cohorts=3)
    for devices in (2, 8):
        preds_n, srv_n = _serve(devices, cohorts=3)
        assert preds_1 == preds_n
        _assert_same_episode(srv_1, srv_n)


def test_sharded_pool_growth_mid_service():
    """A longer stream submitted mid-episode grows every block's staged
    pool; the blocks keep serving the one-block episode."""
    def run(devices):
        srv = StreamServer(CFG, t_max=10, max_streams=4, window=2,
                           phase_steps=2, refresh_every=3, devices=devices,
                           device="cpu")
        for s in _episode_streams()[:4]:
            srv.submit(s)
        for _ in range(2):
            srv.step()
        srv.submit(_make_stream(99, 13, seed=42))   # forces _grow_pool
        done = srv.run_until_drained(strict=True)
        return {r.rid: list(r.preds) for r in done}, srv

    preds_1, srv_1 = run(1)
    preds_4, srv_4 = run(4)
    assert srv_4.pool.capacity == srv_1.pool.capacity > 10
    assert all(blk.pool.capacity == srv_1.pool.capacity
               for blk in srv_4.blocks)
    assert preds_1 == preds_4
    _assert_same_episode(srv_1, srv_4)


@pytest.mark.parametrize("devices", [2, 8])
def test_sharded_quantized_episode_is_bitwise_single_device(devices):
    """quantize='int8' composes with the blocks: the scale folds ride each
    block's refresh, quant leaves included."""
    preds_1, srv_1 = _serve(1, quantize="int8")
    preds_n, srv_n = _serve(devices, quantize="int8")
    assert preds_1 == preds_n
    assert srv_1.served_int8 == srv_n.served_int8 > 0
    _assert_same_episode(srv_1, srv_n)


def test_sharded_blocked_quantized_parity():
    """step_block composes with the blocks and int8: the 8-block blocked
    episode equals the one-block blocked one, and both serve the unblocked
    predictions."""
    preds_u, _ = _serve(1, quantize="int8")
    preds_1, srv_1 = _serve(1, quantize="int8", step_block=3)
    preds_8, srv_8 = _serve(8, quantize="int8", step_block=3)
    assert preds_u == preds_1 == preds_8
    _assert_same_episode(srv_1, srv_8)


def test_sharded_bf16_autotuned_and_planned():
    """The remaining knobs compose: bf16 with the incremental refresh, an
    attached autotuner (its stats and swaps the same), and config='auto'
    (the planner plans all S slots and takes devices as a constraint)."""
    from repro_torch.runtime import planner

    bf16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    preds_1, srv_1 = _serve(1, cfg=bf16, **INC)
    preds_2, srv_2 = _serve(2, cfg=bf16, **INC)
    assert preds_1 == preds_2
    _assert_same_episode(srv_1, srv_2)

    def tuned(devices):
        srv = _server(devices, **INC)
        tuner = WarmPoolAutotuner(srv, history=8, interval=2, margin=0.0,
                                  seed=0)
        srv.attach_autotuner(tuner)
        # streams long enough for the tuner's history of 8 past phase 1
        for i, n in enumerate([30, 26, 34, 28, 32, 24, 30, 28, 26, 22]):
            srv.submit(_make_stream(i, n, seed=50 + i))
        done = srv.run_until_drained(strict=True)
        return {r.rid: list(r.preds) for r in done}, srv, tuner.stats()

    preds_1, srv_1, stats_1 = tuned(1)
    preds_4, srv_4, stats_4 = tuned(4)
    assert stats_1 == stats_4 and stats_1["swaps_applied"] > 0
    assert preds_1 == preds_4
    _assert_same_episode(srv_1, srv_4)

    cal = planner.Calibration(
        c_dispatch=1e-3, c_flop=1e-9, c_byte=1e-9, c_rot=1e-12, c_sub=1e-9,
        c_chol=1e-6, c_quant=1e-9)
    real = planner.get_calibration
    planner.get_calibration = lambda *a, **k: cal
    try:
        auto = _server(2, config="auto")
    finally:
        planner.get_calibration = real
    assert auto.plan is not None and len(auto.blocks) == 2
    explicit = dict(refresh_mode=auto.refresh_mode,
                    step_block=auto.step_block,
                    cohorts=auto.cohorts.n_cohorts)
    preds_e, srv_e = _serve(1, **explicit)
    for s in _episode_streams():
        auto.submit(s)
    done = auto.run_until_drained(strict=True)
    assert {r.rid: list(r.preds) for r in done} == preds_e
    _assert_same_episode(srv_e, auto)


# ---------------------------------------------------------------------------
# Placement: each block holds its own contiguous slots
# ---------------------------------------------------------------------------


def test_sharded_state_trees_stay_in_their_blocks():
    """Every block's leaves hold S/n slots on its own mesh entry after
    serving steps, and block d's rows are slots [d*S/n, (d+1)*S/n) of the
    one-block server's state; the constants are copies on each block."""
    def run(devices):
        srv = _server(devices, **MODES["window"])
        for s in _episode_streams()[:6]:
            srv.submit(s)
        for _ in range(3):
            srv.step()
        srv.drain()
        return srv

    srv_1, srv_8 = run(1), run(8)
    assert srv_8.mesh.axis_names == ("slot",) and srv_8.mesh.size == 8
    one = [srv_1.blocks[0].states, srv_1.blocks[0].win,
           srv_1.blocks[0].pool]
    for d, blk in enumerate(srv_8.blocks):
        assert (blk.lo, blk.n) == (d, 1)
        assert blk.device == srv_8.mesh.devices[d]
        for tree, whole in zip((blk.states, blk.win, blk.pool), one):
            for leaf, full in zip(_leaves(tree), _leaves(whole)):
                assert leaf.shape[0] == 1 and leaf.device == blk.device
                assert torch.equal(leaf, full[d:d + 1])
        assert torch.equal(blk.mask, srv_8.mask)
    # a live slot's owner is fixed: slot // (S/n)
    for i in range(8):
        blk, row = srv_8._owner(i)
        assert blk is srv_8.blocks[i] and row == 0


def test_sharded_validation():
    """Misconfigurations fail fast: host staging, an indivisible S,
    devices < 1, and a default mesh with more devices than the process sees
    CUDA devices."""
    with pytest.raises(ValueError, match="staging='device'"):
        StreamServer(CFG, t_max=10, devices=2, staging="host", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        StreamServer(CFG, t_max=10, max_streams=6, devices=4, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        StreamServer(CFG, t_max=10, devices=0, device="cpu")
    n = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match="available"):
        StreamServer(CFG, t_max=10, max_streams=2 * n, devices=n)
    srv = _server(2)
    with pytest.raises(ValueError, match="own RoundGraphs"):
        srv._graphs = RoundGraphs(capture=False)
    srv._graphs = None     # every block eager: allowed
    assert all(blk.graphs is None for blk in srv.blocks)


# ---------------------------------------------------------------------------
# Host-only properties: placement never migrates, refresh work is bounded
# ---------------------------------------------------------------------------


def _check_no_migration(rng, n_slots, n_shards, n_ops):
    """Random admit/retire schedule: a request's slot index, hence its
    block (slot // (S/n)), never changes while the request is live."""
    s_loc = n_slots // n_shards
    sched = SlotScheduler(n_slots)
    placed = {}
    next_rid = 0
    for _ in range(n_ops):
        op = rng.choice(["submit", "admit", "retire"])
        if op == "submit":
            sched.submit(next_rid)
            next_rid += 1
        elif op == "admit":
            sched.admit(lambda i, rid: placed.setdefault(
                rid, (i, i // s_loc)))
        else:
            live = sched.live()
            if live:
                i, rid = live[int(rng.integers(len(live)))]
                sched.retire(i)
                del placed[rid]
        for i, rid in sched.live():
            slot0, dev0 = placed[rid]
            assert i == slot0 and i // s_loc == dev0


def _check_cohort_schedule(n_slots, refresh_every, n_cohorts, n_shards):
    """The shard-local refresh schedule is the unsharded schedule re-based:
    the same due steps, local rows in range and distinct per shard, the
    ok'd global ids exactly the due cohort, per-block work bounded by
    ceil(S/n / C), and the same arrays as the reference's scheduler."""
    s_loc = n_slots // n_shards
    coh = RefreshCohorts(n_slots, refresh_every, n_cohorts)
    ref = RRefreshCohorts(n_slots, refresh_every, n_cohorts)
    c_eff = coh.n_cohorts
    for step in range(refresh_every):
        due_g, _, _ = coh.due_rows_fixed(step)
        due_s, rows, ok = coh.due_rows_fixed_sharded(step, n_shards)
        r_due, r_rows, r_ok = ref.due_rows_fixed_sharded(step, n_shards)
        assert due_s == due_g == r_due
        np.testing.assert_array_equal(rows, r_rows)
        np.testing.assert_array_equal(ok, r_ok)
        assert rows.shape == ok.shape and rows.shape[0] % n_shards == 0
        r_loc = rows.shape[0] // n_shards
        global_ok = set()
        for d in range(n_shards):
            blk = rows[d * r_loc:(d + 1) * r_loc]
            okb = ok[d * r_loc:(d + 1) * r_loc]
            assert ((blk >= 0) & (blk < s_loc)).all()
            assert len(set(blk.tolist())) == r_loc   # scatter-safe
            assert int(okb.sum()) <= -(-s_loc // c_eff)
            global_ok |= {d * s_loc + int(j) for j, o in zip(blk, okb) if o}
        expect = coh.due_slots(step)
        assert global_ok == set(expect if due_g else [])


if HAVE_HYPOTHESIS:

    @settings(max_examples=60, deadline=None)
    @given(st.data())
    def test_property_live_slot_never_changes_block(data):
        n_slots = data.draw(st.sampled_from([4, 8, 16]), label="n_slots")
        n_shards = data.draw(
            st.sampled_from([d for d in (1, 2, 4, 8) if n_slots % d == 0]),
            label="n_shards")
        seed = data.draw(st.integers(0, 2**31 - 1), label="seed")
        n_ops = data.draw(st.integers(4, 30), label="ops")
        _check_no_migration(
            np.random.default_rng(seed), n_slots, n_shards, n_ops)

    @settings(max_examples=60, deadline=None)
    @given(
        n_slots=st.sampled_from([4, 8, 16, 24]),
        refresh_every=st.integers(1, 12),
        n_cohorts=st.integers(1, 6),
        n_shards=st.sampled_from([1, 2, 4, 8]),
    )
    def test_property_sharded_cohort_schedule(n_slots, refresh_every,
                                              n_cohorts, n_shards):
        if n_slots % n_shards:
            n_shards = 1
        _check_cohort_schedule(n_slots, refresh_every, n_cohorts, n_shards)


def test_grid_live_slot_never_changes_block():
    """The migration property on a fixed grid (runs with or without
    hypothesis)."""
    for n_slots, n_shards in ((4, 1), (4, 2), (8, 4), (8, 8), (16, 4)):
        for seed in range(5):
            _check_no_migration(
                np.random.default_rng(1000 * n_slots + seed),
                n_slots, n_shards, n_ops=25)


def test_grid_sharded_cohort_schedule():
    """The schedule property on the full small grid of slots x period x
    cohorts x shards."""
    for n_slots in (4, 8, 16, 24):
        for refresh_every in (1, 3, 5, 8):
            for n_cohorts in (1, 2, 3, 5):
                for n_shards in (1, 2, 4, 8):
                    if n_slots % n_shards:
                        continue
                    _check_cohort_schedule(
                        n_slots, refresh_every, n_cohorts, n_shards)


def test_sharded_cohort_schedule_rejects_indivisible():
    with pytest.raises(ValueError, match="divisible"):
        RefreshCohorts(6, 4, 2).due_rows_fixed_sharded(0, 4)


def _sharded_fixed_corners():
    """(n_slots, refresh_every, n_cohorts, n_shards): one cohort (r_loc ==
    s_loc), one-slot shards, cohorts clamped to the period, cohort strides
    misaligned with the blocks, the most padding."""
    return [
        (4, 3, 1, 1), (4, 3, 1, 2), (4, 3, 1, 4),
        (8, 5, 2, 2), (8, 5, 2, 8),
        (8, 2, 5, 2),
        (6, 4, 2, 2), (6, 6, 4, 3), (12, 5, 5, 4),
        (16, 8, 8, 2), (24, 12, 5, 8),
    ]


@pytest.mark.parametrize("corner", _sharded_fixed_corners())
def test_sharded_fixed_blocks_are_duplicate_free_and_in_range(corner):
    """Every (cohort, shard) block holds r_loc DISTINCT local indices in
    [0, s_loc), the ok'd ones exactly the cohort's local members; r_loc <=
    s_loc, so the pad pool never runs out; the reference builds the same."""
    n_slots, refresh_every, n_cohorts, n_shards = corner
    coh = RefreshCohorts(n_slots, refresh_every, n_cohorts)
    s_loc = n_slots // n_shards
    r_loc, fixed = coh._sharded_fixed(n_shards)
    r_ref, fixed_ref = RRefreshCohorts(
        n_slots, refresh_every, n_cohorts)._sharded_fixed(n_shards)
    assert r_loc == r_ref and set(fixed) == set(fixed_ref)
    assert 1 <= r_loc <= s_loc
    assert set(fixed) == set(coh.offsets)
    for c, phase in enumerate(coh.offsets):
        rows, ok = fixed[phase]
        np.testing.assert_array_equal(rows, fixed_ref[phase][0])
        np.testing.assert_array_equal(ok, fixed_ref[phase][1])
        assert rows.shape == ok.shape == (n_shards * r_loc,)
        for d in range(n_shards):
            blk = rows[d * r_loc:(d + 1) * r_loc].tolist()
            okb = ok[d * r_loc:(d + 1) * r_loc].tolist()
            assert all(0 <= j < s_loc for j in blk)
            assert len(set(blk)) == r_loc
            want = {i - d * s_loc for i in range(n_slots)
                    if coh.cohort_of_slot[i] == c
                    and d * s_loc <= i < (d + 1) * s_loc}
            assert {j for j, o in zip(blk, okb) if o} == want


def test_sharded_fixed_single_cohort_is_full_permutation():
    """n_cohorts=1: each shard block is a permutation of range(s_loc), all
    ok."""
    for n_slots, n_shards in ((4, 1), (4, 2), (8, 4), (8, 8), (24, 3)):
        coh = RefreshCohorts(n_slots, 5, 1)
        s_loc = n_slots // n_shards
        r_loc, fixed = coh._sharded_fixed(n_shards)
        assert r_loc == s_loc
        (rows, ok), = fixed.values()
        assert ok.all()
        for d in range(n_shards):
            assert sorted(rows[d * s_loc:(d + 1) * s_loc].tolist()) \
                == list(range(s_loc))


def test_sharded_fixed_misaligned_stride_flags():
    """6 slots, 2 shards, 2 cohorts: cohort 0 = {0, 2, 4} has 2 members in
    shard 0 and 1 in shard 1, whose block needs one distinct ok=False
    pad."""
    coh = RefreshCohorts(6, 4, 2)
    r_loc, fixed = coh._sharded_fixed(2)
    assert r_loc == 2
    rows, ok = fixed[coh.offsets[0]]
    s0, o0 = rows[:2].tolist(), ok[:2].tolist()
    s1, o1 = rows[2:].tolist(), ok[2:].tolist()
    assert sorted(j for j, o in zip(s0, o0) if o) == [0, 2]
    assert sorted(j for j, o in zip(s1, o1) if o) == [1]   # global slot 4
    assert len(set(s1)) == 2
