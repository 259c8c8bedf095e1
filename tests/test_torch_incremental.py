"""The port's incremental refresh against the reference.

Covers the live factor's pieces in ``repro_torch.core.ridge`` (seeding, the
guarded rotation, the plain version of K3 ``cholupdate_window_t``, the solve
from the factor), their use in ``repro_torch.core.online`` (the deferred
fold's rows, the refresh from the factor), ``kernels.ops.cholupdate_window``
against the reference's Pallas kernel in interpret mode, ``convert`` on a
state with a live factor and armed int8 codes, and 4-slot serving episodes
with ``refresh_mode='incremental'``, with and without ``quantize='int8'``.

Tolerances, each with its reason:
  * rotations: rtol 1e-5 / atol 1e-5 x max|Lt| - each rotation divides by c
    and d, and the two frameworks round the same fp32 operations; at these
    sizes (s <= 73, a few rows) that stays within a few ulps of the largest
    entry;
  * the invariant Lt^T Lt = B + beta I: rtol 1e-4 against max|B|, fp32;
  * solves and online leaves: rtol 1e-4 / atol 1e-5;
  * episodes: predictions agree on >= 0.98 of served samples and final
    params and ridge leaves to rtol 1e-4 / atol 1e-5, the bar of
    tests/test_torch_stream_server.py.
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
from repro.core.types import DFRParams as RParams
from repro.core.types import QuantParams as RQuant
from repro.core.types import RidgeState as RRidge
from repro.kernels import ops as rops
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro_torch import convert
from repro_torch.core import online, ridge
from repro_torch.core.types import DFRConfig
from repro_torch.kernels import ops
from repro_torch.runtime import StreamRequest, StreamServer

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _factor_case(seed, k=3, s=20, w=3, beta=0.5):
    """K live transposed factors of B + beta I (B from 3s random rows) and a
    window of W sample rows."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(k, 3 * s, s))
    B = np.einsum("kni,knj->kij", R, R) + beta * np.eye(s)
    Lt = np.swapaxes(np.linalg.cholesky(B), -1, -2).astype(np.float32)
    X = rng.normal(size=(k, w, s)).astype(np.float32)
    return np.ascontiguousarray(Lt), X


def _close_to_factor(got, want, rel=1e-5):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def test_seed_factor_and_init_state_match_reference():
    np.testing.assert_array_equal(
        ridge.seed_factor(7, 0.3).numpy(),
        np.asarray(rridge.seed_factor(7, 0.3)))
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=4)
    want = convert.state_leaves(ronline.init_state(
        RConfig(n_in=2, n_classes=3, n_nodes=4), factor_beta=0.25))
    got = convert.state_leaves(online.init_state(cfg, factor_beta=0.25))
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert float(online.init_state(cfg).ridge.factor_beta) == 0.0


def test_guarded_rotation_matches_reference():
    dk = np.asarray([2.0, 1.5, 3.0, 1.0, 0.7], np.float32)
    xk = np.asarray([0.0, 0.4, 2.9999, 1.2, -0.3], np.float32)
    for sign in (1.0, -1.0):
        want = rridge._guarded_rotation(jnp.asarray(dk), jnp.asarray(xk),
                                        jnp.float32(sign))
        got = ridge.guarded_rotation(_t(dk), _t(xk), sign)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # zero x: the identity rotation; downdate past the diagonal: guarded
    r, c, sk, bad = ridge.guarded_rotation(_t(dk), _t(xk), -1.0)
    assert r[0] == dk[0] and c[0] == 1.0 and sk[0] == 0.0
    assert bool(bad[3]) and r[3] == dk[3] and c[3] == 1.0 and sk[3] == 0.0


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cholupdate_window_t_matches_reference(sign):
    Lt, X = _factor_case(seed=0)
    X[:, 1] = 0.0                     # zero rows: exact no-ops
    if sign < 0:
        X *= 0.2                      # a valid downdate ...
        X[0, 2] = 0.0
        X[0, 2, 5] = 3.0 * Lt[0, 5, 5]   # ... with one guard-skipped row
    want = jax.vmap(lambda u, x: rridge.cholupdate_window_t(u, x, sign))(
        jnp.asarray(Lt), jnp.asarray(X))
    got = ops.cholupdate_window_t(_t(Lt), _t(X), sign)
    _close_to_factor(got.numpy(), np.asarray(want))
    assert torch.isfinite(got).all()
    # a window of only zero rows leaves the factor bit for bit
    same = ops.cholupdate_window_t(_t(Lt), torch.zeros(3, 2, Lt.shape[-1]),
                                   sign)
    np.testing.assert_array_equal(same.numpy(), Lt)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cholupdate_window_matches_reference_kernel(sign):
    """``ops.cholupdate_window`` on lower factors against the reference's
    Pallas tile kernel in interpret mode, batched over the slot axis."""
    Lt, X = _factor_case(seed=1, k=2, s=12, w=3)
    X[1, 0] = 0.0                     # a zero row
    if sign < 0:
        X *= 0.2
        X[0, 1] = 0.0
        X[0, 1, 4] = 3.0 * Lt[0, 4, 4]   # a guard-skipped downdate
    L = np.ascontiguousarray(np.swapaxes(Lt, -1, -2))
    want = rops.cholupdate_window(jnp.asarray(L), jnp.asarray(X), sign=sign,
                                  backend="interpret")
    got = ops.cholupdate_window(_t(L), _t(X), sign)
    _close_to_factor(got.numpy(), np.asarray(want))


def test_fold_keeps_the_factor_invariant_and_round_trips():
    """Seeded with sqrt(beta) I, folding rows keeps Lt^T Lt = B + beta I;
    downdating the same rows returns the seed."""
    rng = np.random.default_rng(3)
    s, beta = 21, 0.1
    X = rng.normal(size=(2, 5, s)).astype(np.float32)
    seed = ridge.seed_factor(s, beta).expand(2, s, s).contiguous()
    Lt = ops.cholupdate_window_t(seed, _t(X))
    B = np.einsum("kwi,kwj->kij", X.astype(np.float64), X) + beta * np.eye(s)
    got = np.einsum("kji,kjl->kil", Lt.double().numpy(), Lt.double().numpy())
    np.testing.assert_allclose(got, B, rtol=1e-4, atol=1e-4 * np.abs(B).max())
    np.testing.assert_allclose(torch.triu(Lt).numpy(), Lt.numpy())
    back = ops.cholupdate_window_t(Lt, _t(X), -1.0)
    np.testing.assert_allclose(back.numpy(), seed.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_cholupdate_window_t_writes_out_in_place():
    Lt, X = _factor_case(seed=4, k=2, s=9, w=2)
    want = ops.cholupdate_window_t(_t(Lt), _t(X))
    buf = _t(Lt.copy())
    got = ops.cholupdate_window_t(buf, _t(X), out=buf)
    assert got is buf
    np.testing.assert_array_equal(buf.numpy(), want.numpy())
    with pytest.raises(ValueError, match="sign"):
        ops.cholupdate_window_t(_t(Lt), _t(X), 0.5)
    with pytest.raises(ValueError, match="leading"):
        ops.cholupdate_window_t(_t(Lt), _t(X[:1]))


def test_ridge_solve_from_factor_t_batched_matches_reference():
    Lt, _ = _factor_case(seed=5, k=3, s=30)
    A = np.random.default_rng(5).normal(size=(3, 4, 30)).astype(np.float32)
    want = rridge.ridge_solve_from_factor_t_batched(jnp.asarray(A),
                                                    jnp.asarray(Lt))
    got = ridge.ridge_solve_from_factor_t_batched(_t(A), _t(Lt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# online engine
# ---------------------------------------------------------------------------

NX, N_IN, NY, S, B, T = 4, 2, 3, 3, 2, 9
RCFG = RConfig(n_in=N_IN, n_classes=NY, n_nodes=NX)
CFG = DFRConfig(n_in=N_IN, n_classes=NY, n_nodes=NX)


def _ref_live_state(seed):
    """A slot-batched reference state with live factors of B + beta I."""
    rng = np.random.default_rng(seed)
    s, beta = RCFG.s, 0.5
    R = rng.normal(size=(S, 2 * s, s))
    Bm = np.einsum("kni,knj->kij", R, R)
    Lt = np.swapaxes(np.linalg.cholesky(Bm + beta * np.eye(s)), -1, -2)
    single = ronline.init_state(RCFG, factor_beta=beta)
    st = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (S, *leaf.shape)), single)
    params = RParams(
        p=jnp.asarray([0.3, 0.1, 0.5], jnp.float32),
        q=jnp.asarray([0.2, -0.3, 0.4], jnp.float32),
        W=jnp.asarray(0.05 * rng.normal(size=(S, NY, RCFG.n_rep)),
                      jnp.float32),
        b=jnp.asarray(0.1 * rng.normal(size=(S, NY)), jnp.float32))
    ridge_st = RRidge(
        A=jnp.asarray(rng.normal(size=(S, NY, s)), jnp.float32),
        B=jnp.asarray(Bm, jnp.float32),
        count=jnp.asarray([0, 4, 8], jnp.int32),
        Lt=jnp.asarray(Lt, jnp.float32),
        factor_beta=jnp.full((S,), beta, jnp.float32))
    return dataclasses.replace(st, params=params, ridge=ridge_st,
                               step=jnp.asarray([0, 4, 9], jnp.int32))


def test_online_serve_step_defer_matches_reference():
    """'defer' keeps the factor live and untouched and hands the gated r~
    rows to the caller; folding them gives the reference's fold."""
    rng = np.random.default_rng(6)
    mask = rng.choice([-1.0, 1.0], size=(NX, N_IN)).astype(np.float32)
    u = rng.normal(size=(S, B, T, N_IN)).astype(np.float32)
    length = rng.integers(2, T + 1, (S, B)).astype(np.int32)
    label = rng.integers(0, NY, (S, B)).astype(np.int32)
    weight = np.asarray([[1, 1], [1, 0], [1, 1]], np.float32)
    lr = np.asarray([0.1, 0.0, 0.0], np.float32)
    accum = np.asarray([0.0, 1.0, 1.0], np.float32)
    rstate = _ref_live_state(seed=6)
    step = jax.vmap(lambda st, *a: ronline.online_serve_step(
        RCFG, jnp.asarray(mask), st, *a, maintain_factor="defer"))
    want, _, wm = step(rstate, *(jnp.asarray(a) for a in
                                 (u, length, label, lr, weight, accum)))
    state = convert.state_from_leaves(convert.state_leaves(rstate))
    got, _, gm = online.online_serve_step(
        CFG, _t(mask), state, *(_t(a) for a in
                                (u, length, label, lr, weight, accum)),
        maintain_factor="defer")
    np.testing.assert_allclose(gm["rt_rows"].numpy(),
                               np.asarray(wm["rt_rows"]), **TOL)
    assert torch.all(gm["rt_rows"][0] == 0)      # phase-1 slot: no rows
    assert torch.all(gm["rt_rows"][1, 1] == 0)   # dead sample: zero row
    g, w = convert.state_leaves(got), convert.state_leaves(want)
    np.testing.assert_array_equal(g["ridge_Lt"], w["ridge_Lt"])
    np.testing.assert_array_equal(g["ridge_factor_beta"],
                                  w["ridge_factor_beta"])
    np.testing.assert_allclose(g["ridge_B"], w["ridge_B"], **TOL)
    folded = ops.cholupdate_window_t(got.ridge.Lt, gm["rt_rows"])
    want_lt = jax.vmap(rridge.cholupdate_window_t)(want.ridge.Lt,
                                                   wm["rt_rows"])
    _close_to_factor(folded.numpy(), np.asarray(want_lt), rel=1e-4)
    # without 'defer' the live factor is dropped where statistics moved
    dropped, _, m = online.online_serve_step(
        CFG, _t(mask), state, *(_t(a) for a in
                                (u, length, label, lr, weight, accum)))
    assert "rt_rows" not in m
    np.testing.assert_array_equal(dropped.ridge.factor_beta.numpy(),
                                  [0.5, 0.0, 0.0])
    with pytest.raises(ValueError, match="maintain_factor"):
        online.online_serve_step(
            CFG, _t(mask), state, *(_t(a) for a in
                                    (u, length, label, lr, weight, accum)),
            maintain_factor=True)


def test_refresh_output_factor_rows_matches_reference():
    rstate = _ref_live_state(seed=7)
    rows = np.asarray([1, 2, 0], np.int32)
    el = np.asarray([True, False, True])
    want = ronline.refresh_output_factor_rows(rstate, jnp.asarray(rows),
                                              jnp.asarray(el))
    got = online.refresh_output_factor_rows(
        convert.state_from_leaves(convert.state_leaves(rstate)), _t(rows),
        _t(el))
    g, w = convert.state_leaves(got), convert.state_leaves(want)
    for name in ("params_W", "params_b"):
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **TOL)
    # the ineligible row keeps its readout bit for bit
    np.testing.assert_array_equal(g["params_W"][2],
                                  np.asarray(rstate.params.W[2]))


# ---------------------------------------------------------------------------
# serving episodes
# ---------------------------------------------------------------------------

EP_RCFG = RConfig(n_in=2, n_classes=3, n_nodes=8)
EP_CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
SERVER = dict(t_max=16, max_streams=4, window=2, phase_steps=2,
              refresh_every=3, refresh_mode="incremental")
STREAM_SIZES = (8, 6, 10, 4, 7, 9)
STATE_LEAVES = ("params_p", "params_q", "params_W", "params_b", "ridge_A",
                "ridge_B", "ridge_count", "ridge_factor_beta", "step")


def _episode(server_cls, request_cls, cfg, **kw):
    mask = np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(0), 8, 2, jnp.float32))
    srv = server_cls(cfg, mask=mask, **SERVER, **kw)
    for rid, n in enumerate(STREAM_SIZES):
        r = np.random.default_rng(rid)
        srv.submit(request_cls(
            rid=rid, u=r.normal(size=(n, 16, 2)).astype(np.float32),
            length=r.integers(4, 17, n).astype(np.int32),
            label=r.integers(0, 3, n).astype(np.int32)))
    return {r.rid: r for r in srv.run_until_drained()}, srv


_REFERENCE = {}


def _reference_episode(quantize):
    if quantize not in _REFERENCE:
        _REFERENCE[quantize] = _episode(RServer, RRequest, EP_RCFG,
                                        quantize=quantize)[0]
    return _REFERENCE[quantize]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_incremental_episode_matches_reference(quantize):
    want = _reference_episode(quantize)
    got, srv = _episode(StreamServer, StreamRequest, EP_CFG,
                        quantize=quantize, device="cpu")
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
                err_msg=f"stream {rid}: {name}", **TOL)
        _close_to_factor(g["ridge_Lt"], w["ridge_Lt"], rel=1e-4)
        # the live factor still factors the accumulated statistics
        Lt = g["ridge_Lt"].astype(np.float64)
        Bb = g["ridge_B"] + g["ridge_factor_beta"] * np.eye(Lt.shape[-1])
        np.testing.assert_allclose(Lt.T @ Lt, Bb, rtol=1e-4,
                                   atol=1e-4 * np.abs(Bb).max())
    assert (srv.served_int8 > 0) == (quantize == "int8")


def test_incremental_host_staging_serves_the_device_episode():
    want, _ = _episode(StreamServer, StreamRequest, EP_CFG, device="cpu")
    got, _ = _episode(StreamServer, StreamRequest, EP_CFG, staging="host",
                      device="cpu")
    for rid, r in want.items():
        assert got[rid].preds == r.preds
        np.testing.assert_array_equal(
            got[rid].final_state.ridge.Lt.numpy(),
            r.final_state.ridge.Lt.numpy())


def test_convert_carries_live_factor_and_armed_codes_both_ways():
    """An armed int8 + incremental state of the reference crosses to the
    port and back leaf for leaf, int8 codes included."""
    ref = _reference_episode("int8")
    rstate = max(ref.values(), key=lambda r: r.n_samples).final_state
    leaves = convert.state_leaves(rstate)
    assert leaves["quant_w_scale"] > 0 and leaves["ridge_factor_beta"] > 0
    port = convert.state_from_leaves(leaves)
    assert port.quant.Wq.dtype == torch.int8
    assert port.ridge.Lt.dtype == torch.float32
    back = convert.state_leaves(port)
    rebuilt = ronline.OnlineState(
        params=RParams(*(jnp.asarray(back[f"params_{k}"]) for k in "pqWb")),
        ridge=RRidge(*(jnp.asarray(back[f"ridge_{k}"]) for k in
                       ("A", "B", "count", "Lt", "factor_beta"))),
        step=jnp.asarray(back["step"]),
        loss_ema=jnp.asarray(back["loss_ema"]),
        quant=RQuant(*(jnp.asarray(back[f"quant_{k}"]) for k in
                       ("Wq", "w_scale", "x_scale", "x_absmax"))),
        loss_fast=jnp.asarray(back["loss_fast"]),
        loss_slow=jnp.asarray(back["loss_slow"]))
    for name, w in convert.state_leaves(rebuilt).items():
        assert w.dtype == leaves[name].dtype, name
        np.testing.assert_array_equal(w, leaves[name], err_msg=name)
