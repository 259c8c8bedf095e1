"""Attention: GQA with blockwise online softmax, sliding windows, the flash
route through K8, and a KV-cache decode path.

The port of ``repro.models.attention``.  Layout: q (B, T, H, D), k/v
(B, S, KV, D) with H = G * KV (GQA groups); softmax statistics are f32.

* ``blockwise_attention`` is the plain route (the reference's
  ``attn_impl='xla'``): a loop over query blocks with an inner loop over KV
  blocks, each (block_q, block_k) tile scored in f32 with an online softmax.
* ``flash_attention`` is the counterpart of the reference's
  ``make_flash_scoped``: a ``torch.autograd.Function`` whose forward runs
  K8 (``kernels.flash_attention.flash_attention_k8``) on transposed views
  of CUDA tensors, and the blockwise route on the CPU, as the reference keeps
  non-TPU hosts off its kernel.  Its backward, on every device, is
  ``flash_attention_backward``: the reference's recompute (the scores
  rebuilt tile by tile from q, k and v; no Pallas backward exists), in
  plain PyTorch.  It takes no window: a config with a per-layer window
  schedule (gemma3) attends blockwise with the layer's window on every
  device, and takes the blockwise route's autograd, as the reference keeps
  such configs off its kernel (``use_kernel = not cfg.window_pattern``).
* ``local_heads`` runs an attention function on each rank's batch rows
  and heads under a mesh (``distributed.sharding``): batch over the data
  axes, query heads over 'model' where the heads divide, each rank's keys
  and values the KV heads its query heads read (GQA).  Attention is local
  per head, so the flash route runs K8 on each rank's local tensors.
* ``decode_attention`` and ``KVCache`` serve one token per row against a
  padded cache; ``decode_attend`` is a decode layer's attention with the
  cache append, on each rank's shard of a sharded cache.
  ``KVCache.append`` writes into the cache's buffers in
  place (the reference's functional update returns new arrays; the port
  keeps one buffer per layer instead of a copy per step).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.core.types import Tensor
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import flash_attention_k8

NEG_INF = -1e30
# the most elements of one (query rows x key block) score tile of the
# blockwise route: 2^26 f32, 256 MiB
_TILE_ELEMENTS = 1 << 26


def _pad_seq(x: Tensor, pad: int) -> Tensor:
    """Zero rows appended on the sequence axis (dim 1)."""
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))


def blockwise_attention(
    q: Tensor,                # (B, Tq, H, D)
    k: Tensor,                # (B, Tk, KV, D)
    v: Tensor,                # (B, Tk, KV, D)
    *,
    causal: bool = True,
    window: Union[int, Tensor] = 0,   # 0 = global; w > 0 = last w keys
    q_offset: int = 0,        # absolute position of q[0] (prefill chunks)
    block_q: int = 512,
    block_k: int = 1024,
    softmax_scale: Optional[float] = None,
) -> Tensor:
    """Online-softmax attention over KV blocks, the reference's arithmetic
    block for block (masked scores -1e30, the padding masked by position).
    Query blocks run through the key loop together while one score tile
    stays within ``_TILE_ELEMENTS``; each query row sees the same key
    blocks in the same order either way."""
    b, tq, h, d = q.shape
    _, tk, kv, _ = k.shape
    if h % kv:
        raise ValueError(f"{kv} KV heads do not divide {h} query heads")
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    pq, pk = (-tq) % block_q, (-tk) % block_k
    q, k, v = _pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk)
    tqp, tkp = tq + pq, tk + pk
    w = int(window)
    w_eff = w if w > 0 else tkp + tqp
    dev = q.device
    qf = q.reshape(b, tqp, kv, g, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    # query blocks go through the key loop together, as many as keep one
    # score tile within _TILE_ELEMENTS (each row's arithmetic is the same
    # whatever its neighbours)
    per_block = b * kv * block_q * g * block_k
    span = block_q * max(1, min(tqp // block_q, _TILE_ELEMENTS // per_block))
    outs = []
    for q0 in range(0, tqp, span):
        rows = min(span, tqp - q0)
        qi = qf[:, q0:q0 + rows]                           # (B, r, KV, G, D)
        q_pos = q_offset + q0 + torch.arange(rows, device=dev)
        acc = torch.zeros((b, kv, rows, g, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, kv, rows, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, rows, g), dtype=torch.float32, device=dev)
        for k0 in range(0, tkp, block_k):
            kj, vj = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            k_pos = k0 + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgd,bskd->bkqgs", qi, kj) * scale
            mask = (k_pos[None, :] <= q_pos[:, None]) if causal else \
                torch.ones((rows, block_k), dtype=torch.bool, device=dev)
            mask = mask & (k_pos[None, :] > q_pos[:, None] - w_eff)
            mask = mask & (k_pos[None, :] < tk)            # kv padding
            s = torch.where(mask[None, None, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))           # (B, KV, r, G)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkqgs,bskd->bkqgd",
                                                       p, vj)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=2)                           # (B, KV, Tq, G, D)
    out = out.permute(0, 2, 1, 3, 4).reshape(b, tqp, h, d)
    return out[:, :tq].to(q.dtype)


def flash_attention_backward(
    q: Tensor,                # (B, Tq, H, D)
    k: Tensor,                # (B, Tk, KV, D)
    v: Tensor,                # (B, Tk, KV, D)
    out: Tensor,              # (B, Tq, H, D): the forward's output
    dout: Tensor,             # (B, Tq, H, D): the output's cotangent
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (a slice of rows)
    block_q: int = 512,
    block_k: int = 1024,
    softmax_scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The flash backward, the dataflow of the reference's recompute
    (``make_flash_scoped``'s bwd): (dq, dk, dv) in the inputs' dtypes.

    For each block of ``block_q`` queries, a first pass over the key
    blocks rebuilds the masked scores S (the forward's mask: causal, -1e30)
    and the row statistics m and l, so lse = m + log l; a second pass
    rebuilds S again and forms P = exp(S - lse), dV += P^T dO,
    dP = dO V^T, dS = P (dP - D) with D = rowsum(dO O), dQ += scale dS K
    and dK += scale dS^T Q.  Everything is f32; dk and dv sum over the G
    query heads of each KV head.  The live memory is a few (block_q,
    block_k) tiles a head: the (T, T) scores are never formed.  Key blocks
    that the causal mask kills whole are skipped (they add exact zeros),
    and P is multiplied by the mask, so a query row with no live key would
    get zero gradient, matching the 0 that K8 outputs there."""
    b, tq, h, d = q.shape
    _, tk, kv, _ = k.shape
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    block_q, block_k = min(block_q, tq), min(block_k, tk)
    dev = q.device
    f32 = torch.float32
    qf = q.reshape(b, tq, kv, g, d).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    dof = dout.reshape(b, tq, kv, g, d).to(f32)
    # D = rowsum(dO * O), (B, KV, Tq, G) as the score tiles index rows
    dsum = (dof * out.reshape(b, tq, kv, g, d).to(f32)).sum(-1)
    dsum = dsum.permute(0, 2, 1, 3)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, tq, block_q):
        q1 = min(q0 + block_q, tq)
        qi, doi = qf[:, q0:q1], dof[:, q0:q1]
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        k_end = min(q_offset + q1, tk) if causal else tk

        def tile(k0):
            k1 = min(k0 + block_k, tk)
            s = torch.einsum("bqkgd,bskd->bkqgs", qi, kf[:, k0:k1]) * scale
            if not causal:
                return s, None
            k_pos = torch.arange(k0, k1, device=dev)
            mask = (k_pos[None, :] <= q_pos[:, None])[None, None, :, None]
            return torch.where(mask, s, NEG_INF), mask

        m = torch.full((b, kv, q1 - q0, g), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, kv, q1 - q0, g), dtype=f32, device=dev)
        for k0 in range(0, k_end, block_k):
            s, _ = tile(k0)
            m_new = torch.maximum(m, s.amax(-1))
            l = l * torch.exp(m - m_new) + \
                torch.exp(s - m_new[..., None]).sum(-1)
            m = m_new
        lse = (m + torch.log(l))[..., None]
        di = dsum[:, :, q0:q1, :, None]
        dqi = torch.zeros_like(qi)
        for k0 in range(0, k_end, block_k):
            k1 = min(k0 + block_k, tk)
            kj, vj = kf[:, k0:k1], vf[:, k0:k1]
            s, mask = tile(k0)
            p = torch.exp(s - lse)
            if mask is not None:
                p = p * mask
            dv[:, k0:k1] += torch.einsum("bkqgs,bqkgd->bskd", p, doi)
            dp = torch.einsum("bqkgd,bskd->bkqgs", doi, vj)
            ds = p * (dp - di)
            dqi += torch.einsum("bkqgs,bskd->bqkgd", ds, kj)
            dk[:, k0:k1] += torch.einsum("bkqgs,bqkgd->bskd", ds, qi) * scale
        dq[:, q0:q1] = dqi * scale
    return (dq.reshape(b, tq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """K8 forward (the blockwise route on the CPU), recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, q_offset):
        if q.is_cuda or is_fake(q):
            # K8 through its dispatcher op: the kernel on the card, the
            # output's shape alone on the dry run's fake tensors
            out = flash_attention_k8(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal, 0, q_offset).transpose(1, 2)
        else:
            out = blockwise_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, block_q=block_q,
                                      block_k=block_k)
        ctx.save_for_backward(q, k, v, out)
        ctx.tiles = (causal, block_q, block_k, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, block_q, block_k, q_offset = ctx.tiles
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout, causal=causal, q_offset=q_offset,
            block_q=block_q, block_k=block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: Tensor,                # (B, T, H, D)
    k: Tensor,                # (B, S, KV, D)
    v: Tensor,                # (B, S, KV, D)
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (a slice of rows)
    block_q: int = 512,
    block_k: int = 1024,
) -> Tensor:
    """The flash route (``attn_impl='pallas'``): K8 on CUDA tensors (K8
    picks its own tiles; a build or launch failure raises), the blockwise
    route at (``block_q``, ``block_k``) tiles on the CPU; under autograd
    the gradient is ``flash_attention_backward`` at those tiles on every
    device.  No window: configs with a window schedule stay on the
    blockwise route, as the reference keeps them off its kernel."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, q_offset)


def decode_attention(
    q: Tensor,            # (B, 1, H, D)
    k_cache: Tensor,      # (B, S, KV, D)
    v_cache: Tensor,      # (B, S, KV, D)
    cache_len: Union[int, Tensor],   # (B,) or scalar: valid cache entries
    *,
    window: Union[int, Tensor] = 0,
    softmax_scale: Optional[float] = None,
) -> Tensor:
    """Single-token decode attention against a (padded) KV cache."""
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = q.reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    lens = lens.expand(b, 1)
    w = int(window)
    w_eff = w if w > 0 else s + 1
    valid = (pos[None, :] < lens) & (pos[None, :] >= lens - w_eff)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


class KVCache(NamedTuple):
    k: Tensor  # (B, S_max, KV, D)
    v: Tensor  # (B, S_max, KV, D)
    length: Tensor  # (B,) int32 valid entries

    @classmethod
    def zeros(cls, batch: int, max_len: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, max_len, n_kv, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def append(self, k_new: Tensor, v_new: Tensor) -> "KVCache":
        """Append T_new tokens per row, in place in ``k`` and ``v``.

        T_new == 1 (decode): per-row write at each row's own length
        (continuous batching - rows are at different positions).
        T_new > 1 (chunked prefill): uniform position (length[0]).
        A start past the end is clamped so the write fits, as the
        reference's ``dynamic_update_slice`` clamps it.
        """
        b, t_new = k_new.shape[:2]
        s = self.k.shape[1]
        if t_new == 1:
            rows = torch.arange(b, device=self.k.device)
            pos = self.length.to(torch.int64).clamp(0, s - 1)
            self.k[rows, pos] = k_new[:, 0].to(self.k.dtype)
            self.v[rows, pos] = v_new[:, 0].to(self.v.dtype)
        else:
            pos = min(max(int(self.length[0]), 0), s - t_new)
            self.k[:, pos:pos + t_new] = k_new.to(self.k.dtype)
            self.v[:, pos:pos + t_new] = v_new.to(self.v.dtype)
        return KVCache(k=self.k, v=self.v, length=self.length + t_new)


def _head_split(h: int, kv: int) -> Tuple[bool, int]:
    """How attention's heads split over the active mesh's 'model' axis:
    (query heads sharded, KV heads each rank reads: 0 when the KV heads
    shard with the query heads, else the count of the slice a rank takes
    of the replicated KV heads).  The query heads shard where they divide
    and every rank's heads read one contiguous run of KV heads."""
    m = shd.current().axis_size("model")
    if m == 1 or h % m:
        return False, 0
    if kv % m == 0:
        return True, 0
    hl, g = h // m, h // kv
    if hl % g and g % hl:
        return False, 0
    return True, max(1, hl // g)


def _kv_slice(x: Tensor, h_local: int, g: int, count: int) -> Tensor:
    """This rank's run of KV heads (axis 2) for its query heads."""
    r = shd.current().mesh.device_mesh.get_local_rank("model")
    start = (r * h_local) // g
    return x[:, :, start:start + count]


def local_heads(fn, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """``fn(q, k, v, q_offset)`` (attention with q (B, T, H, D), k/v (B, S,
    KV, D), the output like q; ``q_offset`` the position of q's first row)
    on each rank's rows and heads when q is a DTensor under a mesh; ``fn(q,
    k, v, 0)`` otherwise.  Where the query heads do not split over 'model',
    the query rows split over 'model' instead, each rank attending all keys
    from its rows' offset."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, 0)
    h, kv = q.shape[2], k.shape[2]
    m = shd.current().axis_size("model")
    sharded, count = _head_split(h, kv)
    if not sharded and m > 1 and q.shape[1] % m == 0:
        def by_rows(q, k, v):
            r = shd.current().mesh.device_mesh.get_local_rank("model")
            return fn(q, k, v, r * q.shape[1])

        rows = ("batch", "q_rows", None, None)
        whole = ("batch", None, None, None)
        out = shd.local_region(by_rows, (rows, whole, whole), 0,
                               grad_partial=(1, 2),
                               rules={"q_rows": "model"})(q, k, v)
        # the rows gathered back: the output projection reads them whole
        return shd.relayout(out, whole)
    qa = ("batch", None, "heads" if sharded else None, None)
    kva = ("batch", None, "kv" if sharded and not count else None, None)
    if count:
        hl, g = h // m, h // kv

        def body(q, k, v):
            return fn(q, _kv_slice(k, hl, g, count),
                      _kv_slice(v, hl, g, count), 0)
    else:
        def body(q, k, v):
            return fn(q, k, v, 0)
    return shd.local_region(body, (qa, kva, kva), 0,
                            grad_partial=(1, 2) if count else ())(q, k, v)


def decode_attend(q: Tensor, cache: "KVCache", *, window=0,
                  new_kv: Optional[Tuple[Tensor, Tensor]] = None,
                  rope=None):
    """A decode layer's attention for one token a row, q (B, 1, H, D).
    With ``new_kv`` (k, v of the token) ``rope(q, k, length)`` ropes both
    (if given), the token is appended to the cache in place, and (out,
    cache advanced) is returned; without, the cache is attended as it is
    (cross attention) and out alone returned.  On DTensors under a mesh
    each step runs on the local shards: the rope and the append where the
    cache lives (its batch rows, and its KV heads or head_dim slice over
    'model'), the attention on local query heads where the KV heads shard
    with them, else with the cache gathered over 'model'."""
    def attend(q, kc, vc, length):
        return decode_attention(q, kc, vc, length, window=window)

    if new_kv is None:
        return local_heads_decode(attend, q, cache.k, cache.v, cache.length)
    k, v = new_kv
    if rope is not None:
        roped = shd.local_region(
            rope, (("batch", None, None, None), ("batch", None, None, None),
                   (None,)), (0, 1))
        q, k = roped(q, k, cache.length)
    cax = ("batch", None, "kv", "kv_alt")

    def append(kc, vc, length, k, v):
        return KVCache(kc, vc, length).append(k, v).length

    length = shd.local_region(
        append, (cax, cax, ("batch",), cax, cax), 2)(
            cache.k, cache.v, cache.length, k, v)
    cache = KVCache(k=cache.k, v=cache.v, length=length)
    return local_heads_decode(attend, q, cache.k, cache.v, cache.length), \
        cache


def local_heads_decode(fn, q, kc, vc, length):
    """``fn(q, kc, vc, length)`` on each rank's rows and heads (see
    ``local_heads``); the cache length goes with the rows."""
    if not isinstance(q, DTensor):
        return fn(q, kc, vc, length)
    h, kv = q.shape[2], kc.shape[2]
    sharded, count = _head_split(h, kv)
    sharded = sharded and not count
    qa = ("batch", None, "heads" if sharded else None, None)
    kva = ("batch", None, "kv" if sharded else None, None)
    return shd.local_region(fn, (qa, kva, kva, ("batch",)), 0)(
        q, kc, vc, length)
