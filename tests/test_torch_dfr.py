"""The port's offline recipe (``DFRModel``) and single-stream edge loop
(``OnlineDFR``) against the JAX package's, on the CPU.

Both packages run one system on the same weights: the reference's mask and
parameters cross over as numpy (``repro_torch.convert``), the data is the
same bytes (``data.load``), and the shuffles are the same numpy streams.
On the CPU the port's features run the plain versions of K6 and K7 and its
ridge solves the unblocked library solve, as the reference's do off the
TPU.

Tolerances:
  * features and one step: rtol 1e-4 / atol 1e-5 (the same fp32
    arithmetic, sums in another order);
  * one SGD epoch (18 minibatch steps): rtol 1e-3 / atol 1e-5 on (p, q, W,
    b): each step's rounding difference feeds the next step's features;
  * ridge refit: the same beta, and training logits within 5e-3 of the
    largest: at beta = 1e-6 with 72 samples the data part of B has rank at
    most 72 < s, so W is fixed only up to B's null space and the two LAPACK
    builds land on different W (up to 9% of max |W| apart); the logits see
    only the determined part.  At the edge loop's beta = 1e-2, max |dW| <=
    1e-3 max |W|;
  * whole fits: predictions agree on at least 0.98 of the test split, as
    card and CPU must in chip_smoke.py.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.core import dfr as rdfr
from repro.core import online as ronline
from repro.core.types import DFRConfig as RConfig
from repro.core.types import DFRParams as RParams
from repro.data import load as rload
from repro_torch import convert
from repro_torch.core import dfr, online, ridge
from repro_torch.core.types import DFRConfig, DFRParams
from repro_torch.data import load

TOL = dict(rtol=1e-4, atol=1e-5)
EPOCH_TOL = dict(rtol=1e-3, atol=1e-5)
W_REL = 1e-3
LOGIT_REL = 5e-3
AGREE = 0.98


@pytest.fixture(scope="module")
def jpvow():
    return load("JPVOW", size_cap=72), rload("JPVOW", size_cap=72)


def _pair(nx, epochs=25, **kw):
    rcfg = RConfig(n_in=12, n_classes=9, n_nodes=nx, epochs=epochs, **kw)
    cfg = DFRConfig(n_in=12, n_classes=9, n_nodes=nx, epochs=epochs, **kw)
    rm = rdfr.DFRModel.create(rcfg)
    m = dfr.DFRModel(cfg, convert.mask_from_numpy(convert.mask_to_numpy(
        rm.mask)), device="cpu")
    return m, rm


def _params(nx, seed=0):
    rng = np.random.default_rng(seed)
    leaves = {"p": np.float32(0.05), "q": np.float32(0.2),
              "W": (0.05 * rng.normal(size=(9, nx * (nx + 1)))).astype(
                  np.float32),
              "b": (0.1 * rng.normal(size=9)).astype(np.float32)}
    return (convert.params_from_leaves(leaves),
            RParams(**{k: jnp.asarray(v) for k, v in leaves.items()}))


def _close(got: DFRParams, want, tol):
    g, w = convert.params_leaves(got), convert.params_leaves(want)
    for k in g:
        np.testing.assert_allclose(g[k], w[k], **tol, err_msg=k)


def test_features_and_logits_match_reference(jpvow):
    (train, _), (rtrain, _) = jpvow
    m, rm = _pair(12)
    params, rparams = _params(12)
    np.testing.assert_allclose(m.features(train, params).numpy(),
                               np.asarray(rm.features(rtrain, rparams)),
                               **TOL)
    np.testing.assert_allclose(m.logits(train, params).numpy(),
                               np.asarray(rm.logits(rtrain, rparams)), **TOL)


def test_sgd_epoch_matches_reference(jpvow):
    (train, _), (rtrain, _) = jpvow
    m, rm = _pair(10)
    params, rparams = _params(10, seed=1)
    onehot = torch.nn.functional.one_hot(train.label.long(), 9).float()
    got, loss = m._epoch(params, train.u, train.length, onehot, 0.5, 0.1,
                         minibatch=4)
    want, rloss = rm._epoch(rparams, rtrain.u, rtrain.length,
                            jnp.asarray(onehot.numpy()), jnp.float32(0.5),
                            jnp.float32(0.1), minibatch=4)
    _close(got, want, EPOCH_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **EPOCH_TOL)


def _chosen_beta(solve, A, B, W, betas):
    """The beta of the sweep whose solve gave W (None: no beta did)."""
    for beta in betas:
        if np.array_equal(solve(A, B, beta)[:, :-1], W):
            return beta
    return None


def test_fit_ridge_matches_reference(jpvow):
    (train, _), (rtrain, _) = jpvow
    m, rm = _pair(12)
    params, rparams = _params(12, seed=2)
    got = m.fit_ridge(train, params)
    want = rm.fit_ridge(rtrain, rparams)
    W, rW = got.W.numpy(), np.asarray(want.W)
    lg = m.logits(train, got).numpy()
    rlg = np.asarray(rm.logits(rtrain, want))
    assert np.abs(lg - rlg).max() <= LOGIT_REL * np.abs(rlg).max()
    # the same beta: match each package's W against its own solves
    A, B = m.ridge_statistics(train, params)
    beta = _chosen_beta(
        lambda A, B, beta: ridge.ridge_solve(
            A, ridge.regularize(B, beta)).numpy(), A, B, W, m.cfg.betas)
    rr = np.asarray(rm.features(rtrain, rparams))
    rtil_r = np.concatenate([rr, np.ones((rr.shape[0], 1), np.float32)], -1)
    ohr = np.eye(9, dtype=np.float32)[np.asarray(rtrain.label)]
    from repro.core import ridge as rridge
    rbeta = _chosen_beta(
        lambda A, B, beta: np.asarray(rridge.ridge_solve(
            jnp.asarray(A), rridge.regularize(jnp.asarray(B),
                                              jnp.float32(beta)))),
        ohr.T @ rtil_r, rtil_r.T @ rtil_r, rW, rm.cfg.betas)
    assert beta is not None and beta == rbeta


@pytest.mark.parametrize("loss", ["cross_entropy", "mse"])
def test_grads_truncated_match_reference(loss):
    from repro.core import backprop as rbackprop
    from repro_torch.core import backprop

    rng = np.random.default_rng(6)
    nx, b, t, ny = 7, 5, 12, 3
    j = rng.normal(size=(b, t, nx)).astype(np.float32)
    lens = np.array([12, 1, 2, 7, 12], np.int32)
    target = rng.normal(size=(b, ny)).astype(np.float32)
    leaves = {"p": np.float32(0.2), "q": np.float32(-0.3),
              "W": (0.1 * rng.normal(size=(ny, nx * (nx + 1)))).astype(
                  np.float32),
              "b": (0.1 * rng.normal(size=ny)).astype(np.float32)}
    fns = {"cross_entropy": (backprop.loss_from_logits,
                             rbackprop.loss_from_logits),
           "mse": (backprop.loss_mse, rbackprop.loss_mse)}[loss]
    f = DFRConfig(n_in=1, n_classes=ny, n_nodes=nx,
                  nonlinearity="tanh").f()
    rf = RConfig(n_in=1, n_classes=ny, n_nodes=nx, nonlinearity="tanh").f()
    val, g = backprop.grads_truncated(
        convert.params_from_leaves(leaves), torch.from_numpy(j),
        torch.from_numpy(target), f, torch.from_numpy(lens), fns[0])
    rval, rg = rbackprop.grads_truncated(
        RParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        jnp.asarray(j), jnp.asarray(target), rf, jnp.asarray(lens), fns[1])
    np.testing.assert_allclose(float(val), float(rval), **TOL)
    _close(g, rg, TOL)


@pytest.mark.parametrize("select", ["final", "val"])
def test_fit_matches_reference(jpvow, select):
    (train, test), (rtrain, rtest) = jpvow
    m, rm = _pair(8, epochs=2)
    got = m.fit(train, minibatch=4, select=select)
    want = rm.fit(rtrain, minibatch=4, select=select)
    agree = float((m.predict(test, got).numpy()
                   == np.asarray(rm.predict(rtest, want))).mean())
    assert agree >= AGREE, agree
    np.testing.assert_allclose(float(got.p), float(want.p), **EPOCH_TOL)
    np.testing.assert_allclose(float(got.q), float(want.q), **EPOCH_TOL)


def test_online_dfr_episode_matches_reference(jpvow):
    """The edge loop of tests/test_dfr_end2end.py: stream the training set
    in windows of 8, refresh the readout at beta = 1e-2, infer."""
    (train, _), (rtrain, _) = jpvow
    rcfg = RConfig(n_in=12, n_classes=9, n_nodes=16)
    cfg = DFRConfig(n_in=12, n_classes=9, n_nodes=16)
    ro = ronline.OnlineDFR(rcfg)
    o = online.OnlineDFR(cfg, mask=convert.mask_from_numpy(
        np.asarray(ro.mask)), device="cpu")
    st, rst = o.init(), ro.init()
    for lo in range(0, train.batch - 7, 8):
        sl = slice(lo, lo + 8)
        st, met = o.step(st, train.u[sl], train.length[sl], train.label[sl],
                         0.5, 0.5)
        rst, rmet = ro.step(rst, rtrain.u[sl], rtrain.length[sl],
                            rtrain.label[sl], jnp.float32(0.5),
                            jnp.float32(0.5))
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               **EPOCH_TOL)
    got, want = convert.state_leaves(st), convert.state_leaves(rst)
    for k in ("params_p", "params_q", "params_W", "params_b", "ridge_A",
              "ridge_B", "ridge_count", "step"):
        np.testing.assert_allclose(got[k], want[k], **EPOCH_TOL, err_msg=k)
    st = o.refresh_output(st, 1e-2)
    rst = ro.refresh_output(rst, jnp.float32(1e-2))
    W, rW = st.params.W.numpy(), np.asarray(rst.params.W)
    assert np.abs(W - rW).max() <= W_REL * np.abs(rW).max()
    preds = o.infer(st, train.u, train.length).numpy()
    rpreds = np.asarray(ro.infer(rst, rtrain.u, rtrain.length))
    assert float((preds == rpreds).mean()) >= AGREE


def test_online_step_weight_and_unported_knobs(tmp_path):
    cfg = DFRConfig(n_in=3, n_classes=2, n_nodes=4)
    rcfg = RConfig(n_in=3, n_classes=2, n_nodes=4)
    rng = np.random.default_rng(4)
    u = rng.normal(size=(4, 6, 3)).astype(np.float32)
    length = np.array([6, 3, 1, 5], np.int32)
    label = np.array([0, 1, 1, 0], np.int32)
    weight = np.array([1, 0, 1, 1], np.float32)
    mask = rng.choice([-1.0, 0.0, 1.0], size=(4, 3)).astype(np.float32)
    st = online.init_state(cfg)
    rst = ronline.init_state(rcfg)
    new, met = online.online_step(cfg, torch.from_numpy(mask), st,
                                  torch.from_numpy(u),
                                  torch.from_numpy(length),
                                  torch.from_numpy(label), 0.3, 0.3,
                                  weight=torch.from_numpy(weight))
    rnew, rmet = ronline.online_step(rcfg, jnp.asarray(mask), rst,
                                     jnp.asarray(u), jnp.asarray(length),
                                     jnp.asarray(label), jnp.float32(0.3),
                                     jnp.float32(0.3),
                                     weight=jnp.asarray(weight))
    got, want = convert.state_leaves(new), convert.state_leaves(rnew)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_allclose(float(met["acc"]), float(rmet["acc"]), **TOL)
    # the reduction over a process group is ported: over one gloo rank
    # online_step is the step without a group, bit for bit (two ranks:
    # tests/test_torch_distributed.py)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        gnew, gmet = online.online_step(
            cfg, torch.from_numpy(mask), st, torch.from_numpy(u),
            torch.from_numpy(length), torch.from_numpy(label), 0.3, 0.3,
            group=dist.group.WORLD, weight=torch.from_numpy(weight))
    finally:
        dist.destroy_process_group()
    for k, leaf in convert.state_leaves(gnew).items():
        np.testing.assert_array_equal(leaf, got[k], err_msg=k)
    for k in met:
        assert torch.equal(gmet[k], met[k]), k
    # the soft reset scales the statistics as the reference's does
    soft = convert.state_leaves(online.reset_statistics(new, forget=0.9))
    rsoft = convert.state_leaves(ronline.reset_statistics(rnew, forget=0.9))
    for k in rsoft:
        np.testing.assert_allclose(soft[k], rsoft[k], **TOL, err_msg=k)
    fresh = online.reset_statistics(
        dataclasses.replace(new), factor_beta=0.5)
    assert float(fresh.ridge.B.abs().max()) == 0.0
    assert float(fresh.ridge.factor_beta) == 0.5


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = DFRConfig(n_in=3, n_classes=2, n_nodes=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        dfr.DFRModel.create(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        online.OnlineDFR(cfg)
