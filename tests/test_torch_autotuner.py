"""The port's warm-pool autotuner (``repro_torch.runtime.autotuner``) and
``StreamServer.attach_autotuner``, on the CPU.

Contracts:
  * ``_evaluate_triples`` matches the reference's on the same inputs
    (nrmse rtol 1e-4, accuracy equal, each member's Wt to 1e-3 of its
    largest entry) at
    betas where the (s, s) systems are well posed (1e-2 .. 1);
  * ``_swap_slot_row`` writes the winner into the live state in place (no
    leaf changes its tensor or address, which the card's captured round
    needs) and re-seeds the statistics so Lt^T Lt == B + factor_beta I;
  * the reference's tuner episode (tests/test_adaptive.py: BAD_CFG, the
    NARMA drift requests, refresh_cohorts=2, population 8, history 32,
    interval 2, margin 0.02) swaps and gains at least 0.03 accuracy over
    the untuned episode, and every live factor still factors its
    statistics to 2e-3 (the reference's thresholds; the port's draws come
    from its own generator, not jax.random, so the episodes differ);
  * a tuner that never swaps (margin=10) serves the untuned episode bit
    for bit;
  * a tuned episode at pipeline_depth=2, step_block=4, and one through the
    in-place round bodies the card captures (``RoundGraphs(capture=False)``)
    serve the synchronous eager tuned episode's predictions, final states
    and tuner stats bit for bit, with the incremental refresh (and the
    pipelined one with int8, whose swapped slots disarm); these episodes use
    Nx=8 and streams of 64 samples to stay quick;
  * the reference's ValueErrors.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import masking as rmasking
from repro.core.types import DFRConfig as RConfig
from repro.runtime import autotuner as rtuner
from repro_torch.core.types import DFRConfig, map_leaves
from repro_torch.data import make_drift_label_streams
from repro_torch.runtime import StreamRequest, StreamServer, WarmPoolAutotuner
from repro_torch.runtime import autotuner
from repro_torch.runtime.graphs import RoundGraphs

# the reference's deliberately bad init (tests/test_adaptive.py)
BAD_CFG = DFRConfig(n_in=1, n_classes=4, n_nodes=16, p_init=0.5, q_init=0.5)
SMALL_CFG = dataclasses.replace(BAD_CFG, n_nodes=8)
SERVER_KW = dict(t_max=16, max_streams=4, window=4,
                 refresh_mode="incremental", refresh_every=5,
                 refresh_cohorts=2, device="cpu")
TUNER_KW = dict(population=8, history=32, interval=2, margin=0.02, seed=1)
MODES = {"incremental": {}, "int8": {"quantize": "int8"}}
# the other rounds of a tuned episode: pipelined and blocked, and the
# in-place bodies of the captured round run eagerly
ROUNDS = {"pipelined": dict(pipeline_depth=2, step_block=4),
          "in_place": dict(graphs=True)}
SHORT = 64   # samples a stream in the Nx=8 episodes


def _episode(cfg, tuner_kw=None, graphs=False, n=160, **kw):
    arrays, _ = make_drift_label_streams(4, n, 16, 4, seed=0)
    srv = StreamServer(cfg, **SERVER_KW, **kw)
    if graphs:
        srv._graphs = RoundGraphs(capture=False)
    if tuner_kw is not None:
        srv.attach_autotuner(WarmPoolAutotuner(srv, **tuner_kw))
    for rid, a in enumerate(arrays):
        srv.submit(StreamRequest(rid=rid, **a))
    srv.run_until_drained(strict=True)
    done = sorted(srv.completed, key=lambda r: r.rid)
    acc = float(np.mean([(np.asarray(r.preds) == r.label).mean()
                         for r in done]))
    return srv, done, acc


def _leaves(tree):
    out = []
    map_leaves(out.append, tree)
    return out


def _assert_same_episode(a, b):
    (sa, da, _), (sb, db, _) = a, b
    for ra, rb in zip(da, db):
        assert ra.preds == rb.preds
        for x, y in zip(_leaves(ra.final_state), _leaves(rb.final_state)):
            assert torch.equal(x, y)
    for x, y in zip(_leaves(sa.states), _leaves(sb.states)):
        assert torch.equal(x, y)
    if sa._autotuner is not None:
        assert sa._autotuner.stats() == sb._autotuner.stats()


def _assert_invariant(states, tol):
    rs = states.ridge
    s = rs.B.shape[-1]
    for i in range(rs.B.shape[0]):
        Lt = rs.Lt[i].double()
        want = rs.B[i].double() + float(rs.factor_beta[i]) * torch.eye(
            s, dtype=torch.float64)
        np.testing.assert_allclose((Lt.T @ Lt).numpy(), want.numpy(),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# _evaluate_triples against the reference
# ---------------------------------------------------------------------------


def test_evaluate_triples_matches_reference():
    nx, k, hist, n_val = 8, 8, 32, 8
    rcfg = RConfig(n_in=1, n_classes=4, n_nodes=nx)
    cfg = DFRConfig(n_in=1, n_classes=4, n_nodes=nx)
    arrays, _ = make_drift_label_streams(1, 160, 16, 4, seed=0)
    u = arrays[0]["u"][40:40 + hist]
    length = arrays[0]["length"][40:40 + hist]
    y = np.eye(4, dtype=np.float32)[arrays[0]["label"][40:40 + hist]]
    rng = np.random.default_rng(0)
    ps = (10.0 ** rng.uniform(-3.0, -0.5, k)).astype(np.float32)
    qs = (10.0 ** rng.uniform(-2.5, -0.5, k)).astype(np.float32)
    betas = (10.0 ** rng.uniform(-2.0, 0.0, k)).astype(np.float32)
    mask = np.array(rmasking.make_mask(jax.random.PRNGKey(0), nx, 1,
                                       jnp.float32))
    nf = hist - n_val
    args = (ps, qs, betas, u[:nf], length[:nf], y[:nf], u[nf:], length[nf:],
            y[nf:])
    want = rtuner._evaluate_triples(rcfg, jnp.asarray(mask),
                                    *(jnp.asarray(a) for a in args))
    got = autotuner._evaluate_triples(cfg, torch.from_numpy(mask),
                                      *(torch.from_numpy(a) for a in args))
    nrmse, acc, Wt = (np.asarray(w) for w in want)
    assert np.all(np.isfinite(nrmse))
    np.testing.assert_allclose(got[0].numpy(), nrmse, rtol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), acc)
    # W of a member with beta ~1e-2 on 24 samples (s = 73) amplifies the
    # features' rounding: each member's W to 1e-3 of its largest entry
    for g, w in zip(got[2].numpy(), Wt):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max())


# ---------------------------------------------------------------------------
# The in-place swap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["incremental", "recompute"])
def test_swap_slot_row_is_in_place_and_keeps_invariant(mode):
    cfg = SMALL_CFG
    kw = dict(SERVER_KW, refresh_mode=mode, quantize="int8")
    srv = StreamServer(cfg, **kw)
    arrays, _ = make_drift_label_streams(4, 40, 16, 4, seed=0)
    for rid, a in enumerate(arrays):
        srv.submit(StreamRequest(rid=rid, **a))
    for _ in range(6):
        srv.step()
    before = [(leaf, leaf.data_ptr(), leaf.clone())
              for leaf in _leaves(srv.states)]
    step = srv.states.step.clone()
    W = torch.randn(cfg.n_classes, cfg.n_rep)
    b = torch.randn(cfg.n_classes)
    autotuner._swap_slot_row(srv.states, 1, 0.03, 0.07, W, b, 0.25,
                             maintain_factor=mode == "incremental")
    for (leaf, ptr, _), now in zip(before, _leaves(srv.states)):
        assert now is leaf and now.data_ptr() == ptr
    st = srv.states
    assert float(st.params.p[1]) == np.float32(0.03)
    assert float(st.params.q[1]) == np.float32(0.07)
    assert torch.equal(st.params.W[1], W) and torch.equal(st.params.b[1], b)
    for leaf in (st.ridge.A, st.ridge.B, st.ridge.count, st.quant.Wq,
                 st.quant.w_scale, st.quant.x_scale, st.quant.x_absmax,
                 st.loss_fast, st.loss_slow):
        assert not leaf[1].any()
    s = cfg.s
    if mode == "incremental":
        assert float(st.ridge.factor_beta[1]) == np.float32(0.25)
        assert torch.equal(st.ridge.Lt[1], torch.sqrt(torch.tensor(
            0.25)) * torch.eye(s))
        _assert_invariant(st, 1e-4)
    else:
        assert not st.ridge.Lt[1].any() and float(st.ridge.factor_beta[1]) == 0
    # the other rows and the step counters are untouched
    for (leaf, _, old), now in zip(before, _leaves(srv.states)):
        keep = [i for i in range(srv.max_streams) if i != 1]
        assert torch.equal(now[keep], old[keep])
    assert torch.equal(st.step, step)


# ---------------------------------------------------------------------------
# Episodes
# ---------------------------------------------------------------------------


def test_autotuner_improves_bad_init_and_keeps_invariant():
    """The reference's episode and thresholds (tests/test_adaptive.py)."""
    _, _, acc0 = _episode(BAD_CFG)
    srv, done, acc1 = _episode(BAD_CFG, TUNER_KW)
    stats = srv._autotuner.stats()
    assert stats["swaps_applied"] > 0
    assert acc1 > acc0 + 0.03
    _assert_invariant(srv.states, 2e-3)
    ps = np.asarray([float(r.final_state.params.p) for r in done])
    qs = np.asarray([float(r.final_state.params.q) for r in done])
    assert ((ps != np.float32(BAD_CFG.p_init))
            | (qs != np.float32(BAD_CFG.q_init))).any()


def test_autotuner_never_swapping_is_bitwise_noop():
    """margin=10 asks for an 11x NRMSE win, so the tuner only reads the
    server's state and the episode is the untuned one bit for bit."""
    untuned = _episode(SMALL_CFG, n=SHORT)
    tuned = _episode(SMALL_CFG, dict(TUNER_KW, margin=10.0), n=SHORT)
    stats = tuned[0]._autotuner.stats()
    assert stats["swaps_applied"] == 0 and stats["rounds_run"] > 0
    _assert_same_episode(untuned, tuned)


@pytest.fixture(scope="module")
def synchronous():
    """The synchronous eager tuned episode of each mode, by mode."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _episode(SMALL_CFG, TUNER_KW, n=SHORT,
                                   **MODES[mode])
            assert cache[mode][0]._autotuner.stats()["swaps_applied"] > 0
        return cache[mode]
    return get


@pytest.mark.parametrize("mode, rounds", [
    ("incremental", "pipelined"), ("incremental", "in_place"),
    ("int8", "pipelined")])
def test_tuned_episode_rounds_serve_synchronous(synchronous, mode, rounds):
    sync = synchronous(mode)
    other = _episode(SMALL_CFG, TUNER_KW, n=SHORT, **ROUNDS[rounds],
                     **MODES[mode])
    _assert_same_episode(sync, other)
    if mode == "int8":
        assert sync[0].served_int8 == other[0].served_int8 > 0
    if rounds == "in_place":
        assert other[0]._graphs.eager_calls > 0


def test_autotuner_validation():
    srv = StreamServer(BAD_CFG, **SERVER_KW)
    other = StreamServer(BAD_CFG, **SERVER_KW)
    with pytest.raises(ValueError):
        srv.attach_autotuner(WarmPoolAutotuner(other))
    with pytest.raises(ValueError):
        WarmPoolAutotuner(srv, population=1)
    with pytest.raises(ValueError):
        WarmPoolAutotuner(srv, history=4)
    with pytest.raises(ValueError):
        WarmPoolAutotuner(srv, val_frac=1.0)
