"""The port's RWKV6 and Mamba2-SSD blocks (``repro_torch.models.rwkv``,
``repro_torch.models.ssm``) against the reference's, on the CPU.

Seeded numpy inputs, and the reference's own block parameters, go to
both packages:

* the chunk scans (``rwkv_attention_chunked``, ``ssd_chunked``) against
  the reference's and against a float64 token-by-token recurrence, at
  several chunk lengths: outputs and final states to rtol 1e-4 / atol
  1e-5 (the same fp32 chunk formula, sums in another order), the
  recurrence at ``tests/test_models_recurrent.py``'s 2e-3;
* the blocks (``rwkv_block_apply``, ``ssm_block_apply``) over a sequence
  and their decode steps, fp32 and bf16, against the reference's: fp32 to
  rtol 1e-4 / atol 1e-5, bf16 within 2e-2 of the largest entry;
* decode against prefill, as the reference's tests hold it: T decode
  steps equal one pass over the T tokens (2e-3 for RWKV, whose decode and
  chunk forms differ; 5e-3 for the SSD block).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as rrwkv
from repro.models import ssm as rssm
from repro.models.layers import is_pv
from repro_torch.models import rwkv as prwkv
from repro_torch.models import ssm as pssm

TOL = dict(rtol=1e-4, atol=1e-5)
SEQ_TOL = dict(rtol=2e-3, atol=2e-3)


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _vals(tree, dtype="float32"):
    """(reference values, the port's tensors) of an init tree."""
    ref = jax.tree_util.tree_map(lambda pv: pv.value, tree, is_leaf=is_pv)
    port = {k: _t(v, torch.float32 if np.asarray(v).dtype == np.float32
                  and k in ("a_log", "dt_bias", "d_skip")
                  else getattr(torch, dtype)) for k, v in ref.items()}
    return ref, port


def _close(got: torch.Tensor, want, dtype: str = "float32") -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def sequential_rwkv(r, k, v, w, bonus, s0):
    """Token-by-token float64 RWKV6 recurrence."""
    b, t, h, d = r.shape
    s = np.asarray(s0, np.float64)
    outs = np.zeros((b, t, h, d))
    for ti in range(t):
        kv = np.einsum("bhd,bhe->bhde", k[:, ti], v[:, ti])
        outs[:, ti] = np.einsum("bhd,bhde->bhe", r[:, ti] * bonus[None], kv) \
            + np.einsum("bhd,bhde->bhe", r[:, ti], s)
        s = w[:, ti][..., None] * s + kv
    return outs, s


def sequential_ssd(xh, a_log, bm, cm, s0):
    """Token-by-token float64 SSD recurrence."""
    b, t, h, p = xh.shape
    s = np.asarray(s0, np.float64)
    ys = np.zeros((b, t, h, p))
    for ti in range(t):
        s = np.exp(a_log[:, ti])[..., None, None] * s + np.einsum(
            "bn,bhp->bhnp", bm[:, ti], xh[:, ti])
        ys[:, ti] = np.einsum("bn,bhnp->bhp", cm[:, ti], s)
    return ys, s


@pytest.mark.parametrize("t,chunk", [(32, 8), (48, 16), (16, 16)])
def test_rwkv_chunked_matches_reference(t, chunk):
    rng = np.random.default_rng(t)
    b, h, d = 2, 3, 8
    r = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, h, d)).astype(np.float32) * 0.3
    v = rng.normal(size=(b, t, h, d)).astype(np.float32)
    w = rng.uniform(0.5, 0.99, size=(b, t, h, d)).astype(np.float32)
    bonus = rng.normal(size=(h, d)).astype(np.float32) * 0.1
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32) * 0.1
    want, s_want = rrwkv.rwkv_attention_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, bonus, s0)), chunk=chunk)
    got, s_got = prwkv.rwkv_attention_chunked(
        *(torch.from_numpy(a) for a in (r, k, v, w, bonus, s0)), chunk=chunk)
    _close(got, want)
    _close(s_got, s_want)
    seq, s_seq = sequential_rwkv(r, k, v, w, bonus, s0)
    np.testing.assert_allclose(got.numpy(), seq, **SEQ_TOL)
    np.testing.assert_allclose(s_got.numpy(), s_seq, **SEQ_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        prwkv.rwkv_attention_chunked(
            *(torch.from_numpy(a) for a in (r, k, v, w, bonus, s0)),
            chunk=t + 1)


@pytest.mark.parametrize("t,chunk", [(32, 8), (24, 24)])
def test_ssd_chunked_matches_reference(t, chunk):
    rng = np.random.default_rng(t)
    b, h, p, n = 2, 2, 4, 6
    xh = rng.normal(size=(b, t, h, p)).astype(np.float32)
    a_log = -rng.uniform(0.01, 0.5, size=(b, t, h)).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32) * 0.4
    cm = rng.normal(size=(b, t, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32) * 0.1
    want, s_want = rssm.ssd_chunked(
        *(jnp.asarray(a) for a in (xh, a_log, bm, cm, s0)), chunk=chunk)
    got, s_got = pssm.ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, a_log, bm, cm, s0)), chunk=chunk)
    _close(got, want)
    _close(s_got, s_want)
    seq, s_seq = sequential_ssd(xh, a_log, bm, cm, s0)
    np.testing.assert_allclose(got.numpy(), seq, **SEQ_TOL)
    np.testing.assert_allclose(s_got.numpy(), s_seq, **SEQ_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_block_and_decode_match_reference(dtype):
    """The block over 32 tokens in chunks of 8 from a non-zero state, then
    three decode steps from its state, against the reference's."""
    d, hd, b, t = 32, 8, 2, 32
    ref, port = _vals(rrwkv.rwkv_block_init(
        jax.random.PRNGKey(0), d, hd, lora_dim=8,
        dtype=getattr(jnp, dtype)), dtype)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, t + 3, d)).astype(np.float32)
    s0 = rng.normal(size=(b, d // hd, hd, hd)).astype(np.float32) * 0.1
    xl = rng.normal(size=(b, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rst = rrwkv.RwkvState(s=jnp.asarray(s0), x_last=jnp.asarray(xl, jdt))
    pst = prwkv.RwkvState(s=_t(s0), x_last=_t(xl, tdt))
    # jitted: an eager call traces and compiles the reference's scan anew
    block = jax.jit(functools.partial(rrwkv.rwkv_block_apply, head_dim=hd,
                                      chunk=8))
    step = jax.jit(functools.partial(rrwkv.rwkv_decode_step, head_dim=hd))
    want, rst = block(ref, jnp.asarray(x[:, :t], jdt), rst)
    got, pst = prwkv.rwkv_block_apply(port, _t(x[:, :t], tdt), pst,
                                      head_dim=hd, chunk=8)
    assert got.dtype == tdt
    _close(got, want, dtype)
    _close(pst.s, rst.s, dtype)
    for i in range(t, t + 3):
        xi = x[:, i:i + 1]
        want, rst = step(ref, jnp.asarray(xi, jdt), rst)
        got, pst = prwkv.rwkv_decode_step(port, _t(xi, tdt), pst,
                                          head_dim=hd)
        _close(got, want, dtype)
    _close(pst.s, rst.s, dtype)
    _close(pst.x_last, rst.x_last, dtype)


def test_rwkv_decode_matches_prefill():
    """T decode steps == one block pass over the same T tokens."""
    d, hd, b, t = 16, 8, 1, 8
    port = prwkv.rwkv_block_init(torch.Generator().manual_seed(2), d, hd,
                                 lora_dim=8, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, t, d)).astype(np.float32)) * 0.5

    def state():
        return prwkv.RwkvState(s=torch.zeros(b, d // hd, hd, hd),
                               x_last=torch.zeros(b, d))

    full, s_full = prwkv.rwkv_block_apply(port, x, state(), head_dim=hd,
                                          chunk=t)
    st, outs = state(), []
    for i in range(t):
        o, st = prwkv.rwkv_decode_step(port, x[:, i:i + 1], st, head_dim=hd)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **SEQ_TOL)
    np.testing.assert_allclose(st.s.numpy(), s_full.s.numpy(), **SEQ_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_and_decode_match_reference(dtype):
    """The block over 16 tokens in chunks of 8 from a non-zero state and
    conv tail, then three single-token steps, against the reference's."""
    d, n, hd, b, t = 32, 8, 16, 2, 16
    ref, port = _vals(rssm.ssm_block_init(jax.random.PRNGKey(0), d, n, hd, 2,
                                          dtype=getattr(jnp, dtype)), dtype)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, t + 3, d)).astype(np.float32) * 0.5
    st0 = rssm.ssm_state_init(b, d, n, hd, 2)
    s0 = rng.normal(size=st0.s.shape).astype(np.float32) * 0.1
    c0 = rng.normal(size=st0.conv.shape).astype(np.float32) * 0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rst = rssm.SsmState(s=jnp.asarray(s0), conv=jnp.asarray(c0))
    pst = pssm.SsmState(s=_t(s0), conv=_t(c0))
    kw = dict(ssm_state=n, head_dim=hd, expand=2)
    block = jax.jit(functools.partial(rssm.ssm_block_apply, chunk=8, **kw))
    step = jax.jit(functools.partial(rssm.ssm_block_apply, chunk=1, **kw))
    want, rst = block(ref, jnp.asarray(x[:, :t], jdt), rst)
    got, pst = pssm.ssm_block_apply(port, _t(x[:, :t], tdt), pst, chunk=8,
                                    **kw)
    assert got.dtype == tdt
    _close(got, want, dtype)
    _close(pst.s, rst.s, dtype)
    _close(pst.conv, rst.conv, dtype)
    for i in range(t, t + 3):
        want, rst = step(ref, jnp.asarray(x[:, i:i + 1], jdt), rst)
        got, pst = pssm.ssm_block_apply(port, _t(x[:, i:i + 1], tdt), pst,
                                        chunk=1, **kw)
        _close(got, want, dtype)
    _close(pst.s, rst.s, dtype)
    _close(pst.conv, rst.conv, dtype)


def test_ssm_decode_matches_prefill():
    """One block pass over T tokens == T single-token applies
    (``tests/test_models_recurrent.py``'s check, on the port)."""
    d, t, b = 32, 8, 1
    _, port = _vals(rssm.ssm_block_init(jax.random.PRNGKey(0), d, 8, 16, 2,
                                        dtype=jnp.float32))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, t, d)).astype(np.float32)) * 0.5
    kw = dict(ssm_state=8, head_dim=16, expand=2)
    full, _ = pssm.ssm_block_apply(port, x, pssm.ssm_state_init(b, d, 8, 16),
                                   chunk=t, **kw)
    st, outs = pssm.ssm_state_init(b, d, 8, 16), []
    for i in range(t):
        o, st = pssm.ssm_block_apply(port, x[:, i:i + 1], st, chunk=1, **kw)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)
