"""The stream server's retirement modes in the port, on the CPU.

``retirement='forget'`` (the forgetting factor), ``'window'`` (a ring of
retained samples, evicted by downdate) and ``'adaptive'`` (a drift detector
that anneals a slot's statistics), with the pieces under them: the plain K3
with its scale and guard-flag operands, ``reset_statistics(forget=...)``,
``adaptive_anneal`` and the drift fixtures.

The episode: Nx=8, 2 inputs, 3 classes, t_max 16; 3 slots, windows of 4,
phase_steps 2, refresh_every 3; the reference's mask; four streams of 40,
34, 37 and 29 samples (tail windows partly live) of normal inputs, whose
labels a fixed linear rule of the first steps sets and which drift at
sample 20 (every label moves to the next class), so that the detector
trips.  (The reference's NARMA drift streams have one input and make B + beta
I about 3000 times ill-conditioned, which carries fp32 rounding into W
beyond 1e-4 even without retirement; those streams serve here only to
hold the fixtures equal.)

Tolerances:
  * port episodes against the reference's with the same knobs: predictions
    agree on >= 0.98 of served samples (an argmax flips only on a near
    tie), final params, ridge leaves (the live factor included) and the
    detector's EMAs to rtol 1e-4 / atol 1e-5 - the same arithmetic, except
    that the window's evicted rows leave (A, B) in one product here and one
    by one in the reference.  Forget runs at the reference benchmark's
    lambda, 0.95.  A ring shorter than a window (3 rows, windows of 4)
    downdates every row soon after its fold; there the reference's factor
    factors its statistics to 1.5e-5 (max |Lt^T Lt - (B + beta I)| / max
    |B + beta I|) and the port's to 7.2e-6, and B's condition number
    (about 300) carries that into W's smallest entries, so that mode holds
    W to 1e-4 of its largest entry (6.4e-5 measured) and the port's factor
    to its own statistics at 1e-5, every other leaf as above;
  * inside the port, bit for bit: forget at lambda = 1, a window at least
    as long as every stream and a detector that never trips each serve
    'none'; the captured round's in-place bodies, run eagerly, serve the
    eager round;
  * the window's statistics against a from-scratch fit of its retained
    samples: 2e-3 (A, B) and 5e-3 (the readout), as the reference's test;
  * the plain K3's scale and flags against the reference's
    ``cholupdate_window_t_decay`` and ``cholupdate_dense_t_guarded``: 1e-5
    of max |Lt|, flags equal;
  * ``adaptive_anneal``: trips equal, EMAs and statistics to 1e-6;
  * the drift fixtures: equal arrays.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import masking as rmasking
from repro.core import online as ronline
from repro.core import ridge as rridge
from repro.core.types import DFRConfig as RConfig
from repro.data import timeseries as rts
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro_torch import convert
from repro_torch.core import dprr, masking, online, reservoir, ridge
from repro_torch.core.types import DFRConfig, map_leaves
from repro_torch.data import timeseries as pts
from repro_torch.runtime import StreamRequest, StreamServer
from repro_torch.runtime.graphs import RoundGraphs

RCFG = RConfig(n_in=2, n_classes=3, n_nodes=8)
CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
SERVER = dict(t_max=16, max_streams=3, window=4, phase_steps=2,
              refresh_every=3)
STREAM_SIZES = (40, 34, 37, 29)
SWITCH = 20
BETA = 1e-2   # the server's default ridge beta
STATE_LEAVES = ("params_p", "params_q", "params_W", "params_b", "ridge_A",
                "ridge_B", "ridge_count", "ridge_Lt", "ridge_factor_beta",
                "step", "loss_fast", "loss_slow")
INC = {"refresh_mode": "incremental"}
MODES = {
    "forget": {**INC, "retirement": "forget", "forget": 0.95},
    "forget_recompute": {"retirement": "forget", "forget": 0.95},
    "window": {**INC, "retirement": "window", "retire_window": 10},
    # a ring shorter than a window: rows evict this window's own rows
    "window_short": {**INC, "retirement": "window", "retire_window": 3},
    "adaptive": {**INC, "retirement": "adaptive"},
    "adaptive_int8": {**INC, "retirement": "adaptive", "quantize": "int8"},
    "adaptive_recompute": {"retirement": "adaptive", "adapt_warmup": 0,
                           "adapt_forget": 0.5},
}


def _streams():
    out = []
    for rid, n in enumerate(STREAM_SIZES):
        u, length, _ = _stream_arrays(n, seed=rid)
        # every length is >= 4: the rule reads live steps only
        score = u[:, :4].sum(axis=1) @ np.array([1.0, -1.0], np.float32)
        label = np.digitize(score, [-1.0, 1.0]).astype(np.int32)
        label[SWITCH:] = (label[SWITCH:] + 1) % CFG.n_classes
        out.append(dict(u=u, length=length, label=label))
    return out


def _stream_arrays(n, seed, t=16, n_in=2, n_classes=3):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, t, n_in)).astype(np.float32),
            r.integers(4, t + 1, n).astype(np.int32),
            r.integers(0, n_classes, n).astype(np.int32))


def _mask():
    return np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(RCFG.mask_seed), RCFG.n_nodes, RCFG.n_in,
        jnp.float32))


def _server(server_cls, request_cls, cfg, **kw):
    srv = server_cls(cfg, mask=_mask(), **SERVER, **kw)
    for rid, arrays in enumerate(_streams()):
        srv.submit(request_cls(rid=rid, **arrays))
    return srv


def _episode(graphs=False, **kw):
    """The port's episode on the CPU; ``graphs`` serves it through the
    in-place round bodies the card captures, run eagerly."""
    srv = _server(StreamServer, StreamRequest, CFG, device="cpu", **kw)
    if graphs:
        srv._graphs = RoundGraphs(capture=False)
    done = srv.run_until_drained()
    return {r.rid: r for r in done}, srv


_PORT = {}


def _port(**kw):
    """The port's eager episode of ``kw``, served once per worker."""
    key = tuple(sorted(kw.items()))
    if key not in _PORT:
        _PORT[key] = _episode(**kw)
    return _PORT[key]


def _leaves(state, skip=()):
    if skip:
        state = dataclasses.replace(
            state, **{k: torch.zeros_like(getattr(state, k)) for k in skip})
    out = []
    map_leaves(out.append, state)
    return out


def _assert_same_episode(got, want, skip=()):
    """Predictions, rolling accuracy, retirement snapshots and the server's
    final state (and window rings), bit for bit; ``skip`` names state
    leaves left out."""
    (g, gs), (w, ws) = got, want
    assert sorted(g) == sorted(w)
    for rid, r in w.items():
        assert g[rid].preds == r.preds
        assert g[rid].correct == r.correct and g[rid].done
        for x, y in zip(_leaves(g[rid].final_state, skip),
                        _leaves(r.final_state, skip)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(_leaves(gs.states, skip), _leaves(ws.states, skip)):
        assert torch.equal(x, y)
    if gs.win is not None and ws.win is not None:
        for x, y in zip(_leaves(gs.win), _leaves(ws.win)):
            assert torch.equal(x, y)
    assert gs.global_step == ws.global_step


# ---------------------------------------------------------------------------
# Episodes against the reference
# ---------------------------------------------------------------------------


_REFERENCE = {}


def _reference(kw):
    """The reference's episode of ``kw``: its streams, and its window
    rings as numpy (None without a window)."""
    key = tuple(sorted(kw.items()))
    if key not in _REFERENCE:
        srv = _server(RServer, RRequest, RCFG, **kw)
        done = {r.rid: r for r in srv.run_until_drained()}
        win = None if srv.win is None else convert.window_leaves(srv.win)
        _REFERENCE[key] = done, win
    return _REFERENCE[key]


def _assert_matches_reference(got, want, short_ring=False):
    """``short_ring``: W to 1e-4 of its largest entry, and the factor to its
    own statistics (module docstring)."""
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
            tol = dict(rtol=1e-4, atol=1e-5)
            if short_ring and name == "params_W":
                tol = dict(rtol=0, atol=1e-4 * np.abs(w[name]).max())
            np.testing.assert_allclose(
                g[name].astype(np.float64), w[name].astype(np.float64),
                **tol, err_msg=f"stream {rid}: {name}")
        if short_ring:
            Lt = g["ridge_Lt"].astype(np.float64)
            M = g["ridge_B"].astype(np.float64) + BETA * np.eye(CFG.s)
            res = np.abs(Lt.T @ Lt - M).max() / np.abs(M).max()
            assert res <= 1e-5, f"stream {rid}: factor residual {res:.3e}"


def _short(mode):
    return mode == "window_short"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_episode_matches_reference(mode):
    kw = MODES[mode]
    got, srv = _port(**kw)
    want, want_win = _reference(kw)
    _assert_matches_reference(got, want, short_ring=_short(mode))
    if want_win is not None:
        # the rings the server ends with: cursors and labels exact, rows to
        # the statistics' tolerance
        ring = convert.window_leaves(srv.win)
        np.testing.assert_array_equal(ring["pos"], want_win["pos"])
        np.testing.assert_array_equal(ring["onehot"], want_win["onehot"])
        np.testing.assert_allclose(ring["rows"], want_win["rows"], rtol=1e-4,
                                   atol=1e-5)
        back = convert.window_from_leaves(want_win)
        assert back.rows.shape == srv.win.rows.shape
        assert back.pos.dtype == srv.win.pos.dtype
    if mode.startswith("adaptive"):
        # the detector ran: every stream's slow EMA was seeded
        assert all(float(r.final_state.loss_slow) > 0 for r in got.values())
    if kw.get("quantize") == "int8":
        assert srv.served_int8 > 0


@pytest.mark.parametrize("mode,kw", [
    ("forget", {"step_block": 3, "pipeline_depth": 2}),
    ("adaptive", {"staging": "host", "pipeline_depth": 1}),
])
def test_blocked_pipelined_and_host_episodes_match_reference(mode, kw):
    knobs = {**MODES[mode], **kw}
    got, _ = _port(**knobs)
    _assert_matches_reference(got, _reference(knobs)[0],
                              short_ring=_short(mode))


@pytest.mark.parametrize("mode", ["adaptive", "adaptive_recompute"])
def test_adaptive_trips_at_the_drift(mode):
    """The detector trips on the drifting streams and anneals: the
    episode's statistics differ from a silent detector's, which moves only
    its two EMA leaves."""
    tripping, _ = _port(**MODES[mode])
    silent, _ = _port(**{**MODES[mode], "adapt_ratio": 1e9})
    assert any(not torch.equal(tripping[rid].final_state.ridge.B,
                               silent[rid].final_state.ridge.B)
               for rid in silent)


# ---------------------------------------------------------------------------
# Bit for bit inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base", [{}, INC])
def test_forget_at_lambda_one_serves_none(base):
    """Every decay and scale is a multiply by exactly 1.0."""
    got = _episode(**base, retirement="forget", forget=1.0)
    _assert_same_episode(got, _port(**base))


def test_window_longer_than_every_stream_serves_none():
    """The ring never wraps, so every eviction is of a zero row: an exact
    no-op in (A, B), the count and the downdate."""
    got = _episode(**INC, retirement="window",
                   retire_window=max(STREAM_SIZES))
    _assert_same_episode(got, _port(**INC))


@pytest.mark.parametrize("extra", [
    {}, {"step_block": 4}, {"quantize": "int8"}, {"staging": "host"},
    {"refresh_mode": "recompute"}])
def test_silent_adaptive_serves_none(extra):
    """A ratio no error rate can reach never trips: every anneal factor is
    1.0, and only the detector's two EMA leaves move."""
    knobs = {**INC, **extra}
    got = _port(**knobs, retirement="adaptive", adapt_ratio=1e9)
    assert any(float(r.final_state.loss_slow) > 0 for r in got[0].values())
    _assert_same_episode(got, _port(**knobs),
                         skip=("loss_fast", "loss_slow"))


@pytest.mark.parametrize("mode,kw", [
    ("forget", {}),
    ("forget_recompute", {}),
    ("window_short", {"step_block": 3, "pipeline_depth": 2}),
    ("adaptive", {}),
    ("adaptive_int8", {"step_block": 4}),
])
def test_in_place_round_serves_the_eager_episode(mode, kw):
    """The bodies the card captures (admission and ring reset before the
    step, statistics and ring updated in place, the guard rebuild and the
    anneal as conditional bodies, here run unconditionally) serve the
    synchronous, unblocked eager round's episode bit for bit, blocked and
    pipelined too."""
    got = _episode(graphs=True, **MODES[mode], **kw)
    assert got[1]._graphs.eager_calls >= got[1].global_step
    _assert_same_episode(got, _port(**MODES[mode]))


# ---------------------------------------------------------------------------
# The window's semantics and its guard
# ---------------------------------------------------------------------------


def test_window_matches_from_scratch_ridge_on_last_samples():
    """After an episode, a slot's (A, B) are the statistics of exactly its
    last ``retire_window`` retained samples, and the factor's readout is a
    from-scratch ridge fit on them (the reference's
    ``test_window_matches_from_scratch_ridge_on_last_w_samples``)."""
    n, window, phase_steps, cap, beta = 24, 2, 3, 8, 1e-2
    u, length, label = _stream_arrays(n, seed=9)
    srv = StreamServer(CFG, t_max=16, max_streams=1, window=window,
                       phase_steps=phase_steps, refresh_every=4, beta=beta,
                       mask=_mask(), device="cpu", **INC,
                       retirement="window", retire_window=cap)
    srv.submit(StreamRequest(rid=0, u=u, length=length, label=label))
    st = srv.run_until_drained()[0].final_state
    assert int(st.ridge.count) == cap
    # the frozen phase's last cap samples; lr = 0 there, so the final
    # (p, q) made every retained row
    retained = np.arange(n)[phase_steps * window:][-cap:]
    ln = torch.from_numpy(length[retained])
    j_seq = masking.apply_mask(srv.mask, torch.from_numpy(u[retained]))
    x = reservoir.run_reservoir(st.params.p, st.params.q, j_seq,
                                f=CFG.f(), lengths=ln)
    rt = dprr.r_tilde(dprr.compute_dprr(x, lengths=ln)).numpy()
    onehot = np.eye(CFG.n_classes, dtype=np.float32)[label[retained]]
    A_ref, B_ref = onehot.T @ rt, rt.T @ rt
    for got, want in ((st.ridge.A, A_ref), (st.ridge.B, B_ref)):
        np.testing.assert_allclose(
            got.numpy(), want, rtol=2e-3,
            atol=2e-3 * max(1.0, np.abs(want).max()))
    W_win = ridge.ridge_solve_from_factor_t(st.ridge.A, st.ridge.Lt).numpy()
    W_ref = np.linalg.solve(B_ref.astype(np.float64) + beta * np.eye(CFG.s),
                            A_ref.T.astype(np.float64)).T
    np.testing.assert_allclose(W_win, W_ref, rtol=5e-3,
                               atol=5e-3 * max(1.0, np.abs(W_ref).max()))


@pytest.mark.parametrize("graphs", [False, True])
def test_window_guard_rebuilds_the_factor(graphs):
    """A downdate that would break the live factor (engineered by
    shrinking it mid-episode, so the evicted rows carry more than it
    holds) trips the guard; the slot's factor is rebuilt from B + beta I
    in the same round, and the stream completes (the reference's
    ``test_window_guard_refactorizes_on_indefinite_eviction``)."""
    n, window, cap, beta = 24, 2, 6, 1e-2
    u, length, label = _stream_arrays(n, seed=4)
    srv = StreamServer(CFG, t_max=16, max_streams=1, window=window,
                       phase_steps=2, refresh_every=4, beta=beta,
                       mask=_mask(), device="cpu", **INC,
                       retirement="window", retire_window=cap)
    if graphs:
        srv._graphs = RoundGraphs(capture=False)
    srv.submit(StreamRequest(rid=0, u=u, length=length, label=label))
    while srv.slot_pos[0] < (2 + cap // window + 2) * window:
        srv.step()
    srv.states.ridge.Lt.mul_(0.05)
    srv.run_until_drained()
    done = srv.completed[0]
    Lt = done.final_state.ridge.Lt.double()
    assert bool(torch.isfinite(Lt).all()) and bool((Lt.diagonal() > 0).all())
    rhs = done.final_state.ridge.B.double() + beta * torch.eye(CFG.s)
    np.testing.assert_allclose((Lt.T @ Lt).numpy(), rhs.numpy(), rtol=5e-4,
                               atol=5e-4 * max(1.0, float(rhs.abs().max())))
    assert len(done.preds) == n


# ---------------------------------------------------------------------------
# The pieces: plain K3's operands, the soft reset, the detector, fixtures
# ---------------------------------------------------------------------------


def _factors(k, s, seed):
    g = np.random.default_rng(seed)
    x = g.normal(size=(k, 3 * s, s)).astype(np.float32)
    B = x.transpose(0, 2, 1) @ x / (3 * s) + 0.1 * np.eye(s, dtype=np.float32)
    return np.linalg.cholesky(B).transpose(0, 2, 1).astype(np.float32)


@pytest.mark.parametrize("w", [1, 4])
def test_plain_k3_scale_matches_reference_decay(w):
    k, s = 3, 13
    Lt = _factors(k, s, 0)
    rng = np.random.default_rng(1)
    X = (0.5 * rng.normal(size=(k, w, s))).astype(np.float32)
    X[:, -1] *= np.array([1.0, 0.0, 1.0], np.float32)[:, None]   # a gated row
    scale = np.where(X[..., -1] != 0, np.sqrt(np.float32(0.9)),
                     np.float32(1.0)).astype(np.float32)
    got = ridge.cholupdate_window_t(torch.from_numpy(Lt), torch.from_numpy(X),
                                    1.0, scale=torch.from_numpy(scale))
    want = np.asarray(jax.vmap(rridge.cholupdate_window_t_decay)(
        jnp.asarray(Lt), jnp.asarray(X), jnp.asarray(scale)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # all-ones is bit for bit the unscaled fold
    ones = ridge.cholupdate_window_t(torch.from_numpy(Lt),
                                     torch.from_numpy(X), 1.0,
                                     scale=torch.ones(k, w))
    assert torch.equal(ones, ridge.cholupdate_window_t(
        torch.from_numpy(Lt), torch.from_numpy(X), 1.0))


def test_plain_k3_flags_match_reference_guard():
    """A flagged downdate: one factor takes a row it can hold, one a row
    past its diagonal (the guard skips), one a zero row."""
    k, s = 3, 11
    Lt = _factors(k, s, 2)
    rng = np.random.default_rng(3)
    X = (0.05 * rng.normal(size=(k, 1, s))).astype(np.float32)
    X[1, 0, 4] = 3.0 * Lt[1, 4, 4]
    X[2] = 0.0
    flags = torch.full((k,), 7, dtype=torch.int32)
    got = ridge.cholupdate_window_t(torch.from_numpy(Lt), torch.from_numpy(X),
                                    -1.0, flags=flags)
    for i in range(k):
        want, ok = rridge.cholupdate_dense_t_guarded(
            jnp.asarray(Lt[i]), jnp.asarray(X[i, 0]), -1.0)
        want = np.asarray(want)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert int(flags[i]) == int(not bool(ok))
    assert flags.tolist() == [0, 1, 0]


def test_reset_statistics_forget_matches_reference_and_validates():
    rng = np.random.default_rng(5)
    leaves = convert.state_leaves(online.init_state(CFG, factor_beta=0.01))
    leaves["ridge_A"] = rng.normal(size=leaves["ridge_A"].shape).astype(
        np.float32)
    leaves["ridge_B"] = rng.normal(size=leaves["ridge_B"].shape).astype(
        np.float32)
    st = convert.state_from_leaves(leaves)
    rst = ronline.init_state(RCFG, factor_beta=0.01)
    rst = dataclasses.replace(rst, ridge=dataclasses.replace(
        rst.ridge, A=jnp.asarray(leaves["ridge_A"]),
        B=jnp.asarray(leaves["ridge_B"])))
    got = convert.state_leaves(online.reset_statistics(st, forget=0.8))
    want = convert.state_leaves(ronline.reset_statistics(rst, forget=0.8))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=0, err_msg=name)
    same = online.reset_statistics(st, forget=1.0)
    for x, y in zip(_leaves(same), _leaves(st)):
        assert torch.equal(x, y)
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="forget"):
            online.reset_statistics(st, forget=bad)
    with pytest.raises(ValueError, match="exclusive"):
        online.reset_statistics(st, factor_beta=0.1, forget=0.9)


def test_adaptive_anneal_matches_reference():
    S = 6
    rng = np.random.default_rng(7)
    single = convert.state_leaves(online.init_state(CFG, factor_beta=0.01))
    leaves = {k: np.broadcast_to(v, (S,) + v.shape).copy()
              for k, v in single.items()}
    leaves["ridge_A"] = rng.normal(size=leaves["ridge_A"].shape).astype(
        np.float32)
    leaves["ridge_B"] = rng.normal(size=leaves["ridge_B"].shape).astype(
        np.float32)
    leaves["loss_fast"] = np.array([0.9, 0.2, 0.1, 0.8, 0.5, 0.3],
                                   np.float32)
    leaves["loss_slow"] = np.array([0.1, 0.0, 0.1, 0.2, 0.4, 0.3],
                                   np.float32)
    err = np.array([0.95, 0.5, 0.05, 0.9, 0.4, 0.9], np.float32)
    update = np.array([1, 1, 1, 1, 0, 1], bool)
    armed = np.array([1, 1, 1, 0, 1, 1], bool)
    st = convert.state_from_leaves(leaves)
    new, trip = online.adaptive_anneal(
        st, torch.from_numpy(err), torch.from_numpy(update),
        torch.from_numpy(armed), 1.2, 0.5)
    rst = _reference_state(leaves)
    rnew, rtrip = ronline.adaptive_anneal(
        rst, jnp.asarray(err), jnp.asarray(update), jnp.asarray(armed), 1.2,
        jnp.float32(0.5))
    assert trip.tolist() == np.asarray(rtrip).tolist()
    assert any(trip.tolist()) and not all(trip.tolist())
    got, want = convert.state_leaves(new), convert.state_leaves(rnew)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # the input state is untouched
    assert torch.equal(st.ridge.B, torch.from_numpy(leaves["ridge_B"]))


def _reference_state(leaves):
    """The reference's slot-batched OnlineState from ``state_leaves``
    arrays (the port's ``state_from_leaves``, on the other side)."""
    from repro.core.types import DFRParams, QuantParams, RidgeState
    j = {k: jnp.asarray(v) for k, v in leaves.items()}
    return ronline.OnlineState(
        params=DFRParams(p=j["params_p"], q=j["params_q"], W=j["params_W"],
                         b=j["params_b"]),
        ridge=RidgeState(A=j["ridge_A"], B=j["ridge_B"],
                         count=j["ridge_count"], Lt=j["ridge_Lt"],
                         factor_beta=j["ridge_factor_beta"]),
        step=j["step"], loss_ema=j["loss_ema"],
        quant=QuantParams(Wq=j["quant_Wq"], w_scale=j["quant_w_scale"],
                          x_scale=j["quant_x_scale"],
                          x_absmax=j["quant_x_absmax"]),
        loss_fast=j["loss_fast"], loss_slow=j["loss_slow"])


def test_drift_fixtures_equal_the_reference():
    got, got_sw = pts.make_drift_label_streams(3, 64, 16, 4, seed=2)
    want, want_sw = rts.make_drift_label_streams(3, 64, 16, 4, seed=2)
    assert got_sw == want_sw
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    for n, sw, win in ((160, 80, 4), (64, 32, 2), (100, 50, 8)):
        assert pts.drift_segment_bounds(n, sw, win) == \
            rts.drift_segment_bounds(n, sw, win)
    with pytest.raises(ValueError):
        pts.drift_segment_bounds(40, 2, 4)
    tr, te = pts.make_narma10(12, 6, 8, seed=1)
    rtr, rte = rts.make_narma10(12, 6, 8, seed=1)
    for g, w in ((tr, rtr), (te, rte)):
        for k in ("u", "length", "y"):
            np.testing.assert_array_equal(getattr(g, k),
                                          np.asarray(getattr(w, k)))


def test_retirement_knobs_raise_the_reference_value_errors():
    for kw, msg in (
        ({"retirement": "forget", "forget": 0.0}, "forget"),
        ({"retirement": "forget", "forget": 1.5}, "forget"),
        ({"retirement": "adaptive", "adapt_forget": 0.0}, "adapt_forget"),
        ({"retirement": "adaptive", "adapt_ratio": 1.0}, "adapt_ratio"),
        ({"retirement": "adaptive", "adapt_warmup": -1}, "adapt_warmup"),
        ({"retirement": "window", "retire_window": 4}, "incremental"),
        ({**INC, "retirement": "window", "retire_window": 0},
         "retire_window"),
        ({"retirement": "bogus"}, "retirement"),
    ):
        with pytest.raises(ValueError, match=msg):
            StreamServer(CFG, t_max=16, device="cpu", **kw)
    # the knobs of other modes are not read
    StreamServer(CFG, t_max=16, device="cpu", forget=5.0, adapt_ratio=0.5)
