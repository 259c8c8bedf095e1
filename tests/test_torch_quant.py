"""The port's int8 serving path against the reference.

Covers the quantization primitives, the plain version of K5
(``kernels.ref.streaming_q8_ref`` through ``ops.streaming_logits[_slots]_q8``)
against ``repro.kernels.ops.streaming_logits_q8`` on both the reference's XLA
oracle and its Pallas kernel in interpret mode, the int8 parts of the online
engine (``track_state_absmax``, ``fold_quant_rows``) and an int8 serving
episode.

Tolerances, each with its reason:
  * primitives: exact - the same IEEE division and half-to-even rounding;
  * K5 logits: the same argmax everywhere, and each sample's logits to
    rtol 1e-5 / atol 1e-5 (readout sums in another order) - except for at
    most FLIPS[f] samples a call, each within 0.5% of the largest logit.
    Those are samples where a state code lands on the other side of a
    rounding tie and the recurrence carries it on: XLA on the CPU contracts
    the reference's ``y * (sx * sL) + x_prev * qpow`` into one FMA, while
    the port rounds the product and the sum separately, as its kernel does,
    and the two frameworks' tanh differ in the last bit.  Observed: linear
    f, 0 of 8 samples on both backends and 1 of 12 on the three-slot XLA
    call (0.14% of the largest logit); tanh, 3 of 8 on XLA (0.39%) and 0
    on the Pallas kernel in interpret mode;
  * the plain version's int32 accumulators against an independent numpy
    simulation: exact;
  * online leaves: rtol 1e-4 / atol 1e-5, as tests/test_torch_online.py;
  * the episode: predictions agree on >= 0.98 of served samples and final
    W to rtol 1e-4 / atol 1e-5, the bar of tests/test_torch_stream_server.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import masking as rmasking
from repro.core import online as ronline
from repro.core.types import DFRConfig as RConfig
from repro.core.types import QuantParams as RQuant
from repro.kernels import ops as rops
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro_torch import convert
from repro_torch.core import online
from repro_torch.core.types import DFRConfig, Nonlinearity, QuantParams
from repro_torch.kernels import ops
from repro_torch.runtime import StreamRequest, StreamServer

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LEAF_TOL = dict(rtol=1e-4, atol=1e-5)
FLIP_REL = 0.005
FLIPS = {"linear": 1, "tanh": 3}   # samples a call off by a flipped code


def _assert_q8_close(got, want, f_name="linear"):
    """K5's logits against the reference (tolerance in the docstring)."""
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, got.shape[-1])
    exact = np.all(np.isclose(got, want, **LOGIT_TOL), axis=-1)
    assert np.sum(~exact) <= FLIPS[f_name], np.abs(got - want).max(-1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLIP_REL * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_quant_primitives_match_reference():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, 7)).astype(np.float32)
    absmax = np.abs(v).max(axis=1)
    scale = np.asarray(rops.symmetric_scale(jnp.asarray(absmax)))
    np.testing.assert_array_equal(
        ops.symmetric_scale(_t(absmax)).numpy(), scale)
    # exact halves round to even in both: codes 2.5 -> 2, -3.5 -> -4
    v[0, :2] = np.float32(2.5) * scale[0], np.float32(-3.5) * scale[0]
    want = np.asarray(rops.quantize_symmetric(jnp.asarray(v),
                                              jnp.asarray(scale)[:, None]))
    got = ops.quantize_symmetric(_t(v), _t(scale)[:, None])
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.dequantize_symmetric(got, _t(scale)[:, None]).numpy(),
        np.asarray(rops.dequantize_symmetric(jnp.asarray(want),
                                             jnp.asarray(scale)[:, None])))
    zero = ops.symmetric_scale(torch.zeros(3))
    assert torch.all(zero > 0)
    assert torch.all(ops.quantize_symmetric(torch.zeros(3), zero) == 0)


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------


def _q8_operands(seed, nb=4, t=12, nx=8, ny=3, n_in=2):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(nb, t, n_in)).astype(np.float32)
    mask = rmasking.make_mask(jax.random.PRNGKey(0), nx, n_in, jnp.float32)
    j = np.asarray(rmasking.apply_mask(mask, jnp.asarray(u)))
    lengths = rng.integers(1, t + 1, nb).astype(np.int32)
    lengths[0] = 1
    W = (0.05 * rng.normal(size=(ny, nx * (nx + 1)))).astype(np.float32)
    w_scale = np.float32(np.abs(W).max() / 127.0)
    Wq = np.clip(np.round(W / w_scale), -127, 127).astype(np.int8)
    b = rng.normal(size=(ny,)).astype(np.float32)
    return j, lengths, Wq, w_scale, b


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("f_name,q", [("linear", 0.6), ("linear", -0.4),
                                      ("tanh", 0.5)])
def test_streaming_q8_plain_matches_reference(backend, f_name, q):
    j, lengths, Wq, w_scale, b = _q8_operands(seed=1, nb=8)
    nx = j.shape[-1]
    p, x_scale = np.float32(0.4), np.float32(0.02)
    rf = RConfig(n_in=2, n_classes=3, n_nodes=nx, nonlinearity=f_name).f()
    want = np.asarray(rops.streaming_logits_q8(
        jnp.asarray(j), jnp.asarray(lengths), jnp.float32(p), jnp.float32(q),
        jnp.asarray(Wq), jnp.float32(w_scale), jnp.float32(x_scale),
        jnp.asarray(b), nx, f=rf, backend=backend))
    got = ops.streaming_logits_q8(
        _t(j), _t(lengths), torch.tensor(p), torch.tensor(q, dtype=torch.float32),
        _t(Wq), torch.tensor(w_scale), torch.tensor(x_scale), _t(b), nx,
        f=Nonlinearity(f_name))
    assert got.dtype == torch.float32
    _assert_q8_close(got.numpy(), want, f_name)


def test_streaming_q8_slots_per_slot_scales_match_reference():
    """Per-slot codes and scales in one call, one slot unarmed (scales 0,
    which both sides replace by 1.0)."""
    S = 3
    ops_ = [_q8_operands(seed=10 + i) for i in range(S)]
    j, lengths, Wq, w_scale, b = (np.stack(a) for a in zip(*ops_))
    nx = j.shape[-1]
    w_scale[1] = 0.0
    x_scale = np.asarray([0.02, 0.0, 0.05], np.float32)
    p = np.asarray([0.4, 0.1, 0.3], np.float32)
    q = np.asarray([0.6, -0.2, 0.3], np.float32)
    want = np.asarray(rops.streaming_logits_slots_q8(
        *(jnp.asarray(a) for a in (j, lengths, p, q, Wq, w_scale, x_scale,
                                   b)), nx, backend="xla"))
    got = ops.streaming_logits_slots_q8(
        *(_t(a) for a in (j, lengths, p, q, Wq, w_scale, x_scale, b)), nx)
    _assert_q8_close(got.numpy(), want)


def _numpy_q8_acc(j, length, Lq, qpow, p, sx, sL):
    """Independent simulation of K5's integer contract for one sample, in
    numpy float32 (IEEE, one rounding per operation)."""
    f32 = np.float32
    nx = j.shape[-1]
    xq = np.zeros(nx, np.int64)
    acc = np.zeros((nx, nx + 1), np.int64)
    for k in range(length):
        x_prev = xq.astype(f32) * f32(sx)
        a = f32(p) * (j[k] + x_prev)
        aq = np.clip(np.round(a / f32(sx)), -127, 127).astype(np.int64)
        y = Lq.astype(np.int64) @ aq
        x = y.astype(f32) * (f32(sx) * f32(sL)) + x_prev[-1] * qpow
        xq_k = np.clip(np.round(x / f32(sx)), -127, 127).astype(np.int64)
        acc += np.outer(xq_k, np.append(xq, 1))
        xq = xq_k
    return acc


def test_streaming_q8_accumulators_are_exact():
    """The plain version's int32 DPRR accumulators equal an independent
    numpy simulation exactly, and its logits are their dequantized
    contraction with the readout codes."""
    j, lengths, Wq, w_scale, b = _q8_operands(seed=3, nb=5, t=16)
    nx = j.shape[-1]
    p, q, sx = np.float32(0.5), np.float32(-0.7), np.float32(0.03)
    logits, acc = ops.streaming_logits_slots_q8(
        _t(j)[None], _t(lengths)[None], torch.tensor([p]), torch.tensor([q]),
        _t(Wq)[None], torch.tensor([w_scale]), torch.tensor([sx]),
        _t(b)[None], nx, return_acc=True)
    assert acc.dtype == torch.int32 and acc.shape == (1, 5, nx, nx + 1)
    L = ops.core_res.ring_matrix(torch.tensor(q), nx)
    sL = ops.symmetric_scale(L.abs().max())
    Lq = ops.quantize_symmetric(L, sL).numpy()
    qpow = ops.core_res.ring_powers(torch.tensor(q), nx).numpy()
    for i in range(j.shape[0]):
        want = _numpy_q8_acc(j[i], lengths[i], Lq, qpow, p, sx, float(sL))
        np.testing.assert_array_equal(acc[0, i].numpy(), want)
    a = acc[0].double().numpy()
    r = np.concatenate([a[..., :nx].reshape(-1, nx * nx) * float(sx) ** 2,
                        a[..., nx] * float(sx)], axis=-1)
    want = r @ (Wq.astype(np.float64) * float(w_scale)).T + b
    np.testing.assert_allclose(logits[0].numpy(), want, **LOGIT_TOL)


def test_streaming_q8_zero_window_gives_the_bias():
    """All-zero inputs code to zero everywhere, armed or not: the logits
    are the bias and the accumulators are zero."""
    nx, ny = 6, 3
    b = torch.tensor([[0.1, -0.2, 0.3]] * 2)
    for scale in (0.0, 1e-3):
        logits, acc = ops.streaming_logits_slots_q8(
            torch.zeros(2, 3, 5, nx), torch.full((2, 3), 5, dtype=torch.int32),
            torch.tensor([0.4, 0.2]), torch.tensor([0.5, -0.5]),
            torch.zeros(2, ny, nx * (nx + 1), dtype=torch.int8),
            torch.full((2,), scale), torch.full((2,), scale), b, nx,
            return_acc=True)
        assert torch.all(acc == 0)
        torch.testing.assert_close(logits, b[:, None, :].expand(2, 3, ny))


def test_streaming_q8_rejects_too_long_windows():
    with pytest.raises(ValueError, match="T <="):
        ops.streaming_logits_slots_q8(
            torch.zeros(1, 1, ops.MAX_Q8_STEPS + 1, 2),
            torch.ones(1, 1, dtype=torch.int32), torch.ones(1),
            torch.ones(1), torch.zeros(1, 1, 6, dtype=torch.int8),
            torch.ones(1), torch.ones(1), torch.zeros(1, 1), 2)


# ---------------------------------------------------------------------------
# online engine: calibration and the scale fold
# ---------------------------------------------------------------------------

NX, N_IN, NY, S, B, T = 6, 2, 3, 3, 2, 10
RCFG = RConfig(n_in=N_IN, n_classes=NY, n_nodes=NX)
CFG = DFRConfig(n_in=N_IN, n_classes=NY, n_nodes=NX)


def _ref_slot_state(seed):
    rng = np.random.default_rng(seed)
    single = ronline.init_state(RCFG)
    st = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (S, *leaf.shape)), single)
    params = dataclasses.replace(
        st.params,
        p=jnp.asarray([0.3, 0.1, 0.5], jnp.float32),
        q=jnp.asarray([0.2, -0.3, 0.4], jnp.float32),
        W=jnp.asarray(0.05 * rng.normal(size=(S, NY, RCFG.n_rep)),
                      jnp.float32))
    quant = RQuant(
        Wq=jnp.asarray(rng.integers(-127, 128, (S, NY, RCFG.n_rep)),
                       jnp.int8),
        w_scale=jnp.asarray([0.0, 0.01, 0.0], jnp.float32),
        x_scale=jnp.asarray([0.0, 0.02, 0.0], jnp.float32),
        x_absmax=jnp.asarray([0.0, 0.7, 3.0], jnp.float32))
    return dataclasses.replace(
        st, params=params, quant=quant,
        step=jnp.asarray([0, 4, 9], jnp.int32))


def test_track_state_absmax_matches_reference():
    rng = np.random.default_rng(2)
    mask = rng.choice([-1.0, 1.0], size=(NX, N_IN)).astype(np.float32)
    u = rng.normal(size=(S, B, T, N_IN)).astype(np.float32)
    length = rng.integers(2, T + 1, (S, B)).astype(np.int32)
    label = rng.integers(0, NY, (S, B)).astype(np.int32)
    weight = np.asarray([[1, 1], [1, 0], [0, 0]], np.float32)
    lr = np.asarray([0.1, 0.0, 0.0], np.float32)
    accum = np.asarray([0.0, 1.0, 1.0], np.float32)
    rstate = _ref_slot_state(seed=4)
    step = jax.vmap(lambda st, u_, l_, y_, lr_, w_, a_: ronline.online_serve_step(
        RCFG, jnp.asarray(mask), st, u_, l_, y_, lr_, w_, a_,
        track_state_absmax=True))
    want, _, _ = step(rstate, *(jnp.asarray(a) for a in
                                (u, length, label, lr, weight, accum)))
    got, _, _ = online.online_serve_step(
        CFG, _t(mask), convert.state_from_leaves(convert.state_leaves(rstate)),
        *(_t(a) for a in (u, length, label, lr, weight, accum)),
        track_state_absmax=True)
    np.testing.assert_allclose(got.quant.x_absmax.numpy(),
                               np.asarray(want.quant.x_absmax), **LEAF_TOL)
    # slot 2 serves no live sample: its running max stays where it was
    assert float(got.quant.x_absmax[2]) == 3.0
    assert float(got.quant.x_absmax[0]) > 0.0


def test_fold_quant_rows_matches_reference():
    rstate = _ref_slot_state(seed=5)
    rows = np.asarray([2, 0], np.int32)
    el = np.asarray([True, False])
    want = ronline.fold_quant_rows(rstate, jnp.asarray(rows), jnp.asarray(el))
    got = online.fold_quant_rows(
        convert.state_from_leaves(convert.state_leaves(rstate)), _t(rows),
        _t(el))
    w, g = convert.state_leaves(want), convert.state_leaves(got)
    np.testing.assert_array_equal(g["quant_Wq"], w["quant_Wq"])
    for name in ("quant_w_scale", "quant_x_scale", "quant_x_absmax"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert g["quant_w_scale"][2] > 0 and g["quant_w_scale"][0] == 0


# ---------------------------------------------------------------------------
# an int8 episode (recompute refresh)
# ---------------------------------------------------------------------------

EP_RCFG = RConfig(n_in=2, n_classes=3, n_nodes=8)
EP_CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
SERVER = dict(t_max=16, max_streams=4, window=2, phase_steps=2,
              refresh_every=3)
STREAM_SIZES = (8, 6, 10, 4, 7, 9)


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


def test_int8_episode_matches_reference():
    want, _ = _episode(RServer, RRequest, EP_RCFG, quantize="int8")
    got, srv = _episode(StreamServer, StreamRequest, EP_CFG, quantize="int8",
                        device="cpu")
    total = sum(len(r.preds) for r in want.values())
    agree = sum(int(a == b) for rid, r in want.items()
                for a, b in zip(got[rid].preds, r.preds))
    assert agree / total >= 0.98
    assert 0 < srv.served_int8 < total   # slots arm at their first refresh
    for rid, r in want.items():
        w = convert.state_leaves(r.final_state)
        g = convert.state_leaves(got[rid].final_state)
        for name in ("params_W", "params_b", "quant_w_scale",
                     "quant_x_scale", "quant_x_absmax"):
            np.testing.assert_allclose(g[name], w[name], err_msg=name,
                                       **LEAF_TOL)
        assert np.abs(g["quant_Wq"].astype(int)
                      - w["quant_Wq"].astype(int)).max() <= 1
