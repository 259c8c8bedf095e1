"""The port's attention against the reference's, on the CPU.

* The plain K8 (``ref.flash_attention_ref``, and ``ops.flash_attention`` on
  CPU tensors) against the reference's K8 run in interpret mode and its
  dense oracle, over four cases at D in {32, 64}: in fp32 within rtol/atol
  1e-5 (the same f32 products summed in another order); in bf16 within
  rtol/atol 2e-2, compared in f32 - both round the f32 result of the same
  bf16 inputs to bf16, so they differ by a bf16 step (2^-8 relative) at
  most where the f32 sums straddle a rounding boundary - and the argmax
  over D equal.
* ``blockwise_attention``, ``flash_attention`` (the model's flash route,
  blockwise on the CPU; its gradient against the blockwise route's),
  ``decode_attention`` and ``KVCache`` against the reference's at 1e-5 in
  fp32.
* The rule by which K8's bf16 route accepts an operand (the TMA unit's 16-
  byte alignment of the base and of every stride that is stepped), which
  the wrapper checks before any launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as ratt
from repro_torch.kernels import flash_attention as pflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as patt

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# (B, H, KV, Tq, Tk, causal, window); the kernel's tiles are 32, so the
# ragged case pads both axes and the windowed one skips whole tiles
K8_CASES = {
    "gqa_causal": (2, 4, 2, 64, 64, True, 0),
    "window": (1, 4, 2, 96, 96, True, 24),
    "noncausal": (1, 4, 2, 48, 80, False, 0),
    "ragged": (1, 4, 2, 70, 70, True, 0),
}
DTYPES = {"float32": (torch.float32, jnp.float32, FP32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("case", sorted(K8_CASES))
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_k8_matches_reference_kernel_and_oracle(case, d, dtype):
    b, h, kv, tq, tk, causal, window = K8_CASES[case]
    t_dt, j_dt, tol = DTYPES[dtype]
    arrays = _inputs([(b, h, tq, d), (b, kv, tk, d), (b, kv, tk, d)],
                     seed=d + tq)
    jq, jk, jv = (jnp.asarray(a, j_dt) for a in arrays)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(t_dt) for a in arrays)
    kw = dict(causal=causal, window=window)
    want_kernel = flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                         interpret=True, **kw)
    want_oracle = rref.flash_attention_ref(jq, jk, jv, **kw)
    got_ref = pref.flash_attention_ref(tq_, tk_, tv_, **kw)
    got_ops = ops.flash_attention(tq_, tk_, tv_, **kw)   # CPU: plain version
    assert got_ref.dtype == got_ops.dtype == t_dt
    for got in (got_ref, got_ops):
        for want in (want_kernel, want_oracle):
            np.testing.assert_allclose(_to_np(got), _to_np(want), **tol)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(_to_np(got).argmax(-1),
                                              _to_np(want).argmax(-1))


def test_plain_k8_fully_masked_rows_are_zero():
    """Rows with no live key give 0, as the kernels do (the reference's
    interpret-mode kernel too); the reference's dense oracle averages them
    instead, so only the live rows are held against it."""
    q, k, v = _inputs([(1, 2, 40, 32), (1, 1, 16, 32), (1, 1, 16, 32)], 9)
    kw = dict(causal=False, window=8)
    got = pref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   **kw).numpy()
    kernel = np.asarray(flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), block_q=16, block_k=16,
        interpret=True, **kw))
    oracle = np.asarray(rref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    live = 16 + 8 - 1                     # rows q < Tk + window - 1
    assert np.all(got[:, :, live:] == 0)
    np.testing.assert_allclose(got, kernel, **FP32)
    np.testing.assert_allclose(got[:, :, :live], oracle[:, :, :live], **FP32)


@pytest.mark.parametrize("causal,window,tq,tk,h,kv,q_offset", [
    (True, 0, 64, 64, 4, 4, 0),
    (True, 0, 96, 96, 8, 2, 0),       # GQA
    (True, 16, 64, 64, 4, 2, 0),      # sliding window
    (False, 0, 32, 80, 4, 4, 0),      # cross attention
    (True, 0, 37, 53, 2, 2, 16),      # odd lengths (padding), q offset
])
def test_blockwise_matches_reference(causal, window, tq, tk, h, kv,
                                     q_offset):
    q, k, v = _inputs([(2, tq, h, 16), (2, tk, kv, 16), (2, tk, kv, 16)],
                      seed=tq + tk)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=16,
              block_k=32)
    want = ratt.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    **kw)
    got = patt.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_flash_route_on_cpu_is_blockwise_and_forward_only():
    """On the CPU the flash route's forward is the blockwise route's, and
    its gradient (the recompute backward) is finite and equals autograd
    through the blockwise route within fp32's limits (1e-5)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        [(1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)], 2))
    got = patt.flash_attention(q, k, v)
    want = patt.blockwise_attention(q, k, v)
    assert torch.equal(got, want)
    grads = []
    for fn in (patt.flash_attention, patt.blockwise_attention):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*ts, block_q=16, block_k=16).square().sum().backward()
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), **FP32)
    with torch.no_grad():
        patt.flash_attention(q, k, v)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    b, s, h, kv, d = 3, 24, 4, 2, 8
    q, kc, vc = _inputs([(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)], 3)
    lens = np.asarray([24, 7, 1], np.int32)
    want = ratt.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens),
                                 window=window)
    got = patt.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(lens),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_kv_cache_append_matches_reference():
    """Per-row writes at each row's length (one past the end is clamped),
    then a chunked write at length[0]."""
    rng = np.random.default_rng(4)
    one = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    chunk = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    lens = np.asarray([0, 3, 8], np.int32)
    rc = ratt.KVCache.zeros(3, 8, 2, 4, dtype=jnp.float32)
    rc = ratt.KVCache(k=rc.k, v=rc.v, length=jnp.asarray(lens))
    pc = patt.KVCache.zeros(3, 8, 2, 4, dtype=torch.float32)
    pc = patt.KVCache(k=pc.k, v=pc.v, length=torch.from_numpy(lens))
    rc = rc.append(jnp.asarray(one), jnp.asarray(2 * one))
    pc = pc.append(torch.from_numpy(one), torch.from_numpy(2 * one))
    rc = ratt.KVCache(k=rc.k, v=rc.v, length=jnp.asarray([2, 2, 2]))
    pc = patt.KVCache(k=pc.k, v=pc.v, length=torch.tensor([2, 2, 2],
                                                          dtype=torch.int32))
    rc = rc.append(jnp.asarray(chunk), jnp.asarray(-chunk))
    pc = pc.append(torch.from_numpy(chunk), torch.from_numpy(-chunk))
    for got, want in ((pc.k, rc.k), (pc.v, rc.v), (pc.length, rc.length)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["bhtd", "bthd", "b1_odd_stride"])
def test_tma_operand_rule_accepts_the_model_layouts(layout):
    """Contiguous (B, H, T, D) tensors, the model's transposed (B, T, H, D)
    views, and a batch of 1 whose batch stride is never stepped."""
    if layout == "bhtd":
        t = torch.zeros(2, 9, 70, 64, dtype=torch.bfloat16)
    elif layout == "bthd":
        t = torch.zeros(2, 70, 9, 64, dtype=torch.bfloat16).transpose(1, 2)
    else:
        t = torch.zeros(1, 3, 70, 64, dtype=torch.bfloat16).as_strided(
            (1, 3, 70, 64), (1, 70 * 64, 64, 1))
    pflash._check_tma("q", t)


def test_tma_operand_rule_rejects_what_tma_cannot_read():
    flat = torch.zeros(2 * 9 * 70 * 64 + 8, dtype=torch.bfloat16)
    base = flat[(-flat.data_ptr() // 2) % 8:]      # a 16-byte aligned start
    pflash._check_tma("k", base[:2 * 9 * 70 * 64].view(2, 9, 70, 64))
    with pytest.raises(ValueError, match="^k's base address"):
        pflash._check_tma("k", base[1:1 + 2 * 9 * 70 * 64].view(2, 9, 70, 64))
    rows = torch.zeros(2, 9, 70, 72, dtype=torch.bfloat16)[..., :64]
    pflash._check_tma("v", rows)                   # rows 144 bytes apart
    with pytest.raises(ValueError, match="^v's strides"):
        pflash._check_tma("v", torch.zeros(2, 9, 70, 68,
                                           dtype=torch.bfloat16)[..., :64])
