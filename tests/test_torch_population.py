"""The port's hyperparameter search against the reference: candidates,
population engine, grid search, OnlineEnsemble and PopulationTrainer.

Fixtures are the reference's (tests/test_population.py): JPVOW at
size_cap=36 with Nx=8 (9 classes, 36 train and 36 test samples, s=73) and
NARMA10 (120/60 windows of 24 steps) with Nx=8.  Both packages get the same
numpy data and the reference's mask.  The reference draws its jitter from
``jax.random``; where a test holds a random function against it, the
reference's own draws are injected: into the port's draw-taking helpers
(``candidates._seed_from_draws``, ``_adapted_from_draws``), or through
``candidates._normals``, which every random function of the port draws
from.

Tolerances (float32 in two frameworks; K1's sums run in another order than
the reference's scan):
  * grid points and candidates, survivor parents: equal;
  * sampling covariance, seeds and clones from the same draws: 1e-5
    (survivors pass through bit for bit);
  * evaluate_population, primal and dual, at the healthy betas (1e-1, 1;
    the fixture has fewer samples than s, so smaller betas leave the
    float32 systems degenerate, as tests/test_population.py documents):
    nrmse tables rtol 1e-4, beta_idx equal, Wt to 1e-3 of its largest
    entry, accuracy tables equal in primal and within one test sample in
    dual (an argmax on a near tie);
  * refine_population (K=4, one epoch, ce and mse), train_population and
    the OnlineEnsemble (K=3) episode: 1e-3;
  * grid searches: the same best (p, q, beta), accuracy within one test
    sample.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import OnlineEnsemble as ROnlineEnsemble
from repro.core import candidates as rcand
from repro.core import masking as rmasking
from repro.core import population as rpop
from repro.core.grid_search import grid_search as rgrid_search
from repro.core.grid_search import grid_search_serial as rgrid_serial
from repro.core.grid_search import grid_search_until as rgrid_until
from repro.core.types import DFRConfig as RConfig
from repro.data import load as rload
from repro.data import make_narma10 as rnarma
from repro_torch import convert
from repro_torch.core import OnlineDFR, OnlineEnsemble, candidates
from repro_torch.core import online, population
from repro_torch.core.grid_search import (grid_search, grid_search_serial,
                                          grid_search_until)
from repro_torch.core.types import DFRConfig, TimeSeriesBatch
from repro_torch.data import make_narma10
from repro_torch.runtime import PopulationTrainer, PopulationTrainerConfig

HEALTHY_BETAS = (1e-1, 1e0)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cls_setup():
    train, test = rload("JPVOW", size_cap=36)
    rcfg = RConfig(n_in=12, n_classes=9, n_nodes=8, betas=HEALTHY_BETAS)
    cfg = DFRConfig(n_in=12, n_classes=9, n_nodes=8, betas=HEALTHY_BETAS)
    mask = np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(rcfg.mask_seed), rcfg.n_nodes, rcfg.n_in,
        rcfg.dtype))
    ttrain, ttest = (TimeSeriesBatch(u=T(b.u), length=T(b.length),
                                     label=T(b.label)) for b in (train, test))
    return rcfg, cfg, mask, (train, test), (ttrain, ttest)


@pytest.fixture(scope="module")
def narma():
    rcfg = RConfig(n_in=1, n_classes=1, n_nodes=8, betas=HEALTHY_BETAS)
    cfg = DFRConfig(n_in=1, n_classes=1, n_nodes=8, betas=HEALTHY_BETAS)
    mask = np.asarray(rmasking.make_mask(jax.random.PRNGKey(0), 8, 1,
                                         jnp.float32))
    return rcfg, cfg, mask, rnarma(n_train=120, n_test=60, t_len=24, seed=0)


def _onehot(label, n):
    return np.eye(n, dtype=np.float32)[np.asarray(label)]


def _inject(monkeypatch, draws):
    """Make the port's random functions draw ``draws`` (numpy arrays) in
    order."""
    it = iter(draws)

    def normals(generator, shape):
        d = next(it)
        assert tuple(d.shape) == tuple(shape)
        return torch.from_numpy(np.array(d, np.float32))
    monkeypatch.setattr(candidates, "_normals", normals)


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def test_grid_points_and_candidates_equal():
    for divs in (1, 2, 3, 5):
        np.testing.assert_array_equal(
            candidates.grid_points(divs, *candidates.P_LOG_RANGE),
            rcand.grid_points(divs, *rcand.P_LOG_RANGE))
        for got, want in zip(candidates.grid_candidates(divs),
                             rcand.grid_candidates(divs)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k, frac", [(1, 0.5), (5, 0.5), (8, 0.25),
                                     (8, 0.7)])
def test_survivor_parents_equal(k, frac):
    rng = np.random.default_rng(k)
    # -accuracy fitness: ties among members
    fitness = -rng.integers(0, 4, k).astype(np.float32) / 4
    got = candidates.survivor_parents(T(fitness), frac)
    want = rcand.survivor_parents(jnp.asarray(fitness), frac)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2]


@pytest.mark.parametrize("d, n_keep", [(2, 1), (2, 3), (3, 4)])
def test_sampling_cov_chol(d, n_keep):
    rng = np.random.default_rng(d + n_keep)
    coords = np.log(10.0 ** rng.uniform(-3, 0, (d, 6))).astype(np.float32)
    keep = np.arange(6) < n_keep
    got = candidates.sampling_cov_chol(T(coords), T(keep), 0.2)
    want = rcand.sampling_cov_chol(jnp.asarray(coords), jnp.asarray(keep),
                                   0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_seed_candidates_with_reference_draws():
    for k, p0, q0 in ((6, 0.01, 0.02), (4, 0.9, 0.9), (1, 0.01, 0.01)):
        key = jax.random.PRNGKey(k)
        eps = np.array(jax.random.normal(key, (2, k), jnp.float32))
        want = rcand.seed_candidates(key, k, p0, q0, jitter=0.5)
        got = candidates._seed_from_draws(eps, p0, q0, 0.5,
                                          candidates.P_LOG_RANGE,
                                          candidates.Q_LOG_RANGE)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
        # the anchor is exact, even outside the box
        assert float(got[0][0]) == np.float32(p0)
        assert float(got[1][0]) == np.float32(q0)


def test_adapted_and_jitter_clones_with_reference_draws(monkeypatch):
    rng = np.random.default_rng(3)
    coords = (10.0 ** rng.uniform(-3, -0.5, (3, 8))).astype(np.float32)
    keep = np.arange(8) < 4
    ranges = (rcand.P_LOG_RANGE, rcand.Q_LOG_RANGE, (-4.0, 0.0))
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (3, 8), jnp.float32))
    want = np.asarray(rcand.adapted_clones(key, jnp.asarray(coords),
                                           jnp.asarray(keep), 0.3, ranges))
    got = candidates._adapted_from_draws(eps, T(coords), T(keep), 0.3,
                                         ranges).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got[:, :4], coords[:, :4])
    # jitter_clones draws through the same helper
    want_p, want_q = rcand.jitter_clones(key, jnp.asarray(coords[0]),
                                         jnp.asarray(coords[1]),
                                         jnp.asarray(keep), 0.3)
    _inject(monkeypatch, [np.array(jax.random.normal(key, (2, 8),
                                                       jnp.float32))])
    got_p, got_q = candidates.jitter_clones(None, T(coords[0]), T(coords[1]),
                                            T(keep), 0.3)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5)


def test_cull_population_with_reference_draws(monkeypatch):
    k = 8
    rcfg = RConfig(n_in=1, n_classes=2, n_nodes=4)
    cfg = DFRConfig(n_in=1, n_classes=2, n_nodes=4)
    ps = np.linspace(0.01, 0.1, k, dtype=np.float32)
    qs = np.linspace(0.02, 0.2, k, dtype=np.float32)
    rng = np.random.default_rng(0)
    W = rng.normal(size=(k, 2, cfg.n_rep)).astype(np.float32)
    fitness = rng.normal(size=k).astype(np.float32)
    rp = rpop.init_population(rcfg, jnp.asarray(ps), jnp.asarray(qs))
    rp = dataclasses.replace(rp, W=jnp.asarray(W))
    key = jax.random.PRNGKey(0)
    want = rpop.cull_population(rp, jnp.asarray(fitness), key,
                                survive_frac=0.5, jitter=0.2)
    tp = population.init_population(cfg, T(ps), T(qs))
    tp = dataclasses.replace(tp, W=T(W))
    _inject(monkeypatch, [np.array(jax.random.normal(key, (2, k),
                                                       jnp.float32))])
    got = population.cull_population(tp, T(fitness), None, survive_frac=0.5,
                                     jitter=0.2)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-5)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-5)
    np.testing.assert_array_equal(got.p[:4].numpy(), np.asarray(want.p[:4]))
    np.testing.assert_array_equal(got.W.numpy(), np.asarray(want.W))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))


# ---------------------------------------------------------------------------
# evaluate / refine / train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["primal", "dual"])
def test_evaluate_population_matches_reference(cls_setup, solver):
    rcfg, cfg, mask, (train, test), _ = cls_setup
    ps, qs = rpop.grid_candidates(2)
    y_tr, y_ev = (_onehot(b.label, 9) for b in (train, test))
    args = (ps, qs, train.u, train.length, y_tr, test.u, test.length, y_ev)
    want = rpop.evaluate_population(rcfg, jnp.asarray(mask),
                                    *(jnp.asarray(a) for a in args),
                                    solver=solver)
    got = population.evaluate_population(cfg, T(mask), *(T(a) for a in args),
                                         solver=solver)
    w_nrmse = np.asarray(want.nrmse_all)
    fin = np.isfinite(w_nrmse)
    assert fin.sum() >= 6
    np.testing.assert_array_equal(np.isfinite(got.nrmse_all.numpy()), fin)
    np.testing.assert_allclose(got.nrmse_all.numpy()[fin], w_nrmse[fin],
                               rtol=1e-4)
    np.testing.assert_array_equal(got.beta_idx.numpy(),
                                  np.asarray(want.beta_idx))
    atol = 0.0 if solver == "primal" else 1.0 / test.batch + 1e-7
    np.testing.assert_allclose(got.acc_all.numpy(), np.asarray(want.acc_all),
                               rtol=0, atol=atol)
    for g, w, ok in zip(got.Wt.numpy(), np.asarray(want.Wt),
                        np.isfinite(np.asarray(want.nrmse))):
        if ok:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("task", ["ce", "mse"])
def test_refine_population_matches_reference(cls_setup, narma, task):
    if task == "ce":
        rcfg, cfg, mask, (train, _), _ = cls_setup
        u, length, y = train.u, train.length, _onehot(train.label, 9)
        mb = 6
    else:
        rcfg, cfg, mask, (train, _) = narma
        u, length, y = train.u, train.length, train.y
        mb = 8
    ps, qs = rpop.grid_candidates(2)
    rng = np.random.default_rng(1)
    W = (0.01 * rng.normal(size=(4, cfg.n_classes, cfg.n_rep))).astype(
        np.float32)
    rp = dataclasses.replace(rpop.init_population(rcfg, ps, qs),
                             W=jnp.asarray(W))
    tp = dataclasses.replace(population.init_population(cfg, T(ps), T(qs)),
                             W=T(W))
    want, wl = rpop.refine_population(
        rcfg, jnp.asarray(mask), rp, jnp.asarray(u), jnp.asarray(length),
        jnp.asarray(y), jnp.float32(0.1), jnp.float32(0.1), steps=1,
        minibatch=mb, loss=task)
    got, gl = population.refine_population(
        cfg, T(mask), tp, T(u), T(length), T(y), torch.tensor(0.1),
        torch.tensor(0.1), steps=1, minibatch=mb, loss=task)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-3)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-3)
    for g, w in zip(got.W.numpy(), np.asarray(want.W)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max())
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-3)
    if task == "ce":
        # the stored-states path (K6, K7) gives the same step
        unfused, _ = population.refine_population(
            cfg, T(mask), tp, T(u), T(length), T(y), torch.tensor(0.1),
            torch.tensor(0.1), steps=1, minibatch=mb, loss=task, fused=False)
        np.testing.assert_allclose(unfused.p.numpy(), got.p.numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(unfused.W.numpy(), got.W.numpy(),
                                   rtol=0,
                                   atol=1e-4 * np.abs(got.W.numpy()).max())


def _reference_cull_draws(seed, rounds, k):
    """The normals the reference's train_population draws: one (2, K) draw
    a round, from a key split off its seed's key."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, kc = jax.random.split(key)
        out.append(np.array(jax.random.normal(kc, (2, k), jnp.float32)))
    return out


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_train_population_matches_reference(cls_setup, narma, monkeypatch,
                                            task):
    kw = dict(divs=2, rounds=2, steps_per_round=1, seed=0)
    if task == "classification":
        rcfg, cfg, mask, (train, test), (ttrain, ttest) = cls_setup
        kw["minibatch"] = 6
        want = rpop.train_population_classification(
            rcfg, train, test, mask=jnp.asarray(mask), **kw)
        _inject(monkeypatch, _reference_cull_draws(0, 2, 4))
        got = population.train_population_classification(
            cfg, ttrain, ttest, mask=T(mask), device="cpu", **kw)
    else:
        rcfg, cfg, mask, (train, test) = narma
        kw["minibatch"] = 8
        want = rpop.train_population_regression(
            rcfg, train, test, mask=jnp.asarray(mask), **kw)
        _inject(monkeypatch, _reference_cull_draws(0, 2, 4))
        got = population.train_population_regression(
            cfg, train, test, mask=T(mask), device="cpu", **kw)
    assert len(got.history) == len(want.history) == 3
    for g, w in zip(got.history, want.history):
        for key in ("best_nrmse", "best_acc", "mean_nrmse", "refine_loss"):
            if w[key] is None:
                assert g[key] is None
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-3)
    np.testing.assert_allclose([got.best_p, got.best_q],
                               [want.best_p, want.best_q], rtol=1e-3)
    assert got.best_beta == want.best_beta
    np.testing.assert_allclose(got.population.p.numpy(),
                               np.asarray(want.population.p), rtol=1e-3)


# ---------------------------------------------------------------------------
# grid search
# ---------------------------------------------------------------------------


def _same_best(got, want, n_test):
    assert got["p"] == pytest.approx(want["p"], rel=1e-5)
    assert got["q"] == pytest.approx(want["q"], rel=1e-5)
    assert got["beta"] == want["beta"]
    assert got["acc"] == pytest.approx(want["acc"], abs=1.0 / n_test + 1e-7)
    assert got["n_points"] == want["n_points"]


def test_grid_searches_match_reference(cls_setup):
    rcfg, cfg, mask, (train, test), (ttrain, ttest) = cls_setup
    kw = dict(divs=3, mask=T(mask), device="cpu")
    g_pop = grid_search(cfg, ttrain, ttest, **kw)
    g_ser = grid_search_serial(cfg, ttrain, ttest, **kw)
    _same_best(g_pop, rgrid_search(rcfg, train, test, 3,
                                   mask=jnp.asarray(mask)), test.batch)
    _same_best(g_ser, rgrid_serial(rcfg, train, test, 3,
                                   mask=jnp.asarray(mask)), test.batch)
    # the two port searches: features through K1 against K6 + K7
    _same_best(g_pop, g_ser, test.batch)
    np.testing.assert_allclose(g_pop["acc_all"], g_ser["acc_all"], rtol=0,
                               atol=1.0 / test.batch + 1e-7)


def test_grid_search_until_matches_reference():
    # grid_search_until draws the default mask in each package, so the two
    # runs hold the same (p, q, beta) path on different masks only through
    # the protocol: pass the reference's mask on the port's side
    train, test = rload("JPVOW", size_cap=36)
    rcfg = RConfig(n_in=12, n_classes=9, n_nodes=8, betas=HEALTHY_BETAS)
    cfg = DFRConfig(n_in=12, n_classes=9, n_nodes=8, betas=HEALTHY_BETAS)
    mask = np.asarray(rmasking.make_mask(jax.random.PRNGKey(0), 8, 12,
                                         jnp.float32))
    ttrain, ttest = (TimeSeriesBatch(u=T(b.u), length=T(b.length),
                                     label=T(b.label)) for b in (train, test))
    want = rgrid_until(rcfg, train, test, target_acc=0.5, max_divs=3)
    got = grid_search_until(cfg, ttrain, ttest, target_acc=0.5, max_divs=3,
                            mask=T(mask), device="cpu")
    assert got["divs"] == want["divs"]
    _same_best(got, want, test.batch)
    assert got["total_time_s"] >= got["time_s"] > 0


# ---------------------------------------------------------------------------
# OnlineEnsemble
# ---------------------------------------------------------------------------


def _window(seed, b=4, t=12, n_in=2, n_classes=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, n_in)).astype(np.float32),
            rng.integers(4, t + 1, b).astype(np.int32),
            rng.integers(0, n_classes, b).astype(np.int32))


def test_ensemble_k1_matches_online_dfr_bit_for_bit():
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    u, ln, lab = (T(a) for a in _window(0))
    single = OnlineDFR(cfg, device="cpu")
    ens = OnlineEnsemble(cfg, 1, device="cpu")
    s1, se = single.init(), ens.init()
    for i in range(6):
        p1 = single.infer(s1, u, ln)
        assert torch.equal(p1, ens.infer(se, u, ln))
        assert torch.equal(p1, ens.infer_members(se, u, ln)[0])
        s1, m1 = single.step(s1, u, ln, lab, 0.2, 0.2)
        se, me = ens.step(se, u, ln, lab, 0.2, 0.2)
        assert torch.equal(m1["loss"], me["loss"][0])
        if i == 2:
            s1 = single.reset_statistics(s1)
            se = online.reset_statistics(se)
        for a, b in zip(convert.state_leaves(s1).values(),
                        convert.state_leaves(se).values()):
            np.testing.assert_array_equal(a, b[0])
    s1 = single.refresh_output(s1, 1e-2)
    se = ens.refresh_output(se, 1e-2)
    np.testing.assert_allclose(se.params.W[0].numpy(), s1.params.W.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(single.infer(s1, u, ln), ens.infer(se, u, ln))


def test_ensemble_k3_matches_reference_with_its_seeds():
    rcfg = RConfig(n_in=2, n_classes=3, n_nodes=8)
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    ref = ROnlineEnsemble(rcfg, 3, seed_jitter=0.2)
    ens = OnlineEnsemble(cfg, 3, mask=convert.mask_from_numpy(
        convert.mask_to_numpy(ref.mask)), device="cpu")
    rs = ref.init()
    # the reference's jittered seeds, carried across
    ts = convert.state_from_leaves(convert.state_leaves(rs))
    for i in range(4):
        u, ln, lab = _window(i)
        rs, rm = ref.step(rs, jnp.asarray(u), jnp.asarray(ln),
                          jnp.asarray(lab), jnp.float32(0.2),
                          jnp.float32(0.2))
        ts, tm = ens.step(ts, T(u), T(ln), T(lab), 0.2, 0.2)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(rm["loss"]),
                                   rtol=1e-3)
    want, got = convert.state_leaves(rs), convert.state_leaves(ts)
    for name in ("params_p", "params_q", "params_W", "params_b", "ridge_A",
                 "ridge_B", "loss_ema"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=1e-3 * np.abs(want[name]).max())
    u, ln, _ = _window(9)
    np.testing.assert_allclose(
        ens.logits_members(ts, T(u), T(ln)).numpy(),
        np.asarray(ref.logits_members(rs, jnp.asarray(u), jnp.asarray(ln))),
        rtol=1e-3, atol=1e-4)


def test_ensemble_cull_reseeds_live_factor(monkeypatch):
    """The reference's regression (tests/test_stream_server.py): a culled
    member that inherited a live factor restarts from sqrt(beta) I, never
    zeros; survivors keep everything; (p, q) follow the reference's cull
    with its draws."""
    rcfg = RConfig(n_in=2, n_classes=2, n_nodes=6)
    cfg = DFRConfig(n_in=2, n_classes=2, n_nodes=6)
    ref = ROnlineEnsemble(rcfg, 4, seed_jitter=0.2)
    ens = OnlineEnsemble(cfg, 4, mask=T(np.asarray(ref.mask)), device="cpu")
    beta = 0.25
    st = ens.init(torch.Generator().manual_seed(0))
    st = dataclasses.replace(st, ridge=dataclasses.replace(
        st.ridge,
        Lt=torch.sqrt(torch.tensor(beta)) * torch.eye(cfg.s).expand(
            4, cfg.s, cfg.s).clone(),
        factor_beta=torch.full((4,), beta)))
    u, ln, lab = (T(a) for a in _window(1, b=3, t=10, n_classes=2))
    for _ in range(2):
        st, _ = ens.step(st, u, ln, lab, 0.2, 0.2)
    # a live factor of the accumulated statistics, then distinct EMAs
    B = st.ridge.B + beta * torch.eye(cfg.s)
    st = dataclasses.replace(
        st, loss_ema=torch.tensor([0.0, 0.1, 0.9, 1.0]),
        ridge=dataclasses.replace(st.ridge, Lt=torch.linalg.cholesky(B).mT,
                                  factor_beta=torch.full((4,), beta)))
    key = jax.random.PRNGKey(0)
    _inject(monkeypatch, [np.array(jax.random.normal(key, (2, 4),
                                                       jnp.float32))])
    culled = ens.cull(st, None, survive_frac=0.5)
    want = ref.cull(convert_state_to_reference(st, rcfg), key,
                    survive_frac=0.5)
    np.testing.assert_allclose(culled.params.p.numpy(),
                               np.asarray(want.params.p), rtol=1e-5)
    np.testing.assert_allclose(culled.params.q.numpy(),
                               np.asarray(want.params.q), rtol=1e-5)
    np.testing.assert_allclose(culled.ridge.factor_beta.numpy(), beta)
    assert torch.equal(culled.ridge.Lt[:2], st.ridge.Lt[:2])
    for i in (2, 3):
        assert torch.equal(culled.ridge.Lt[i],
                           torch.sqrt(torch.tensor(beta)) * torch.eye(cfg.s))
        assert not culled.ridge.B[i].any() and int(culled.ridge.count[i]) == 0
        Lt = culled.ridge.Lt[i]
        torch.testing.assert_close(Lt.T @ Lt, culled.ridge.B[i]
                                   + beta * torch.eye(cfg.s))


def convert_state_to_reference(state, rcfg):
    """The port's stacked state as the reference's ``OnlineState``."""
    from repro.core.online import OnlineState as ROnlineState
    from repro.core.types import DFRParams as RParams
    from repro.core.types import QuantParams as RQuant
    from repro.core.types import RidgeState as RRidge

    x = {k: jnp.asarray(v) for k, v in convert.state_leaves(state).items()}
    return ROnlineState(
        params=RParams(p=x["params_p"], q=x["params_q"], W=x["params_W"],
                       b=x["params_b"]),
        ridge=RRidge(A=x["ridge_A"], B=x["ridge_B"], count=x["ridge_count"],
                     Lt=x["ridge_Lt"], factor_beta=x["ridge_factor_beta"]),
        step=x["step"], loss_ema=x["loss_ema"],
        quant=RQuant(Wq=x["quant_Wq"], w_scale=x["quant_w_scale"],
                     x_scale=x["quant_x_scale"],
                     x_absmax=x["quant_x_absmax"]),
        loss_fast=x["loss_fast"], loss_slow=x["loss_slow"])


# ---------------------------------------------------------------------------
# PopulationTrainer
# ---------------------------------------------------------------------------


def test_population_trainer_regression_path():
    train, test = make_narma10(n_train=120, n_test=60, t_len=24, seed=0)
    cfg = DFRConfig(n_in=1, n_classes=1, n_nodes=6)
    pt = PopulationTrainer(PopulationTrainerConfig(
        divs=2, rounds=1, steps_per_round=1, minibatch=16))
    result = pt.fit(cfg, train, test, seed=0, device="cpu")
    assert len(pt.metrics_log) == 2   # round 0 (grid) + 1 refinement round
    assert np.isfinite(result.best_nrmse) and result.best_nrmse < 1.0
    direct = population.train_population_regression(
        cfg, train, test, divs=2, rounds=1, steps_per_round=1, minibatch=16,
        seed=0, device="cpu")
    assert result.history == direct.history


def test_population_trainer_checkpoints_not_ported(tmp_path):
    """``ckpt_dir`` as the reference's test_population_trainer_runtime_
    wrapper holds it (tests/test_torch_checkpoint.py holds the format): the
    winning member is saved with its scores and restores to the same
    parameters."""
    from repro_torch.checkpoint import CheckpointManager

    train, test = make_narma10(n_train=120, n_test=60, t_len=24, seed=0)
    cfg = DFRConfig(n_in=1, n_classes=1, n_nodes=6)
    pt = PopulationTrainer(PopulationTrainerConfig(
        divs=2, rounds=1, steps_per_round=1, minibatch=16,
        ckpt_dir=str(tmp_path / "pop_ckpt")))
    result = pt.fit(cfg, train, test, seed=0, device="cpu")
    assert len(pt.metrics_log) == 2
    restored = CheckpointManager(tmp_path / "pop_ckpt").restore_latest(
        result.best_params, device="cpu")
    assert restored is not None
    tree, step, meta = restored
    assert step == 1
    assert torch.equal(tree.W, result.best_params.W)
    assert float(tree.p) == float(result.best_params.p)
    assert meta["best_nrmse"] == pytest.approx(result.best_nrmse)
