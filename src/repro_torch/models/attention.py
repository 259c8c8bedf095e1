"""Attention: GQA with blockwise online softmax, sliding windows, the flash
route through K8, and a KV-cache decode path.

The port of ``repro.models.attention``.  Layout: q (B, T, H, D), k/v
(B, S, KV, D) with H = G * KV (GQA groups); softmax statistics are f32.

* ``blockwise_attention`` is the plain route (the reference's
  ``attn_impl='xla'``): a loop over query blocks with an inner loop over KV
  blocks, each (block_q, block_k) tile scored in f32 with an online softmax.
* ``flash_attention`` is the counterpart of the reference's
  ``make_flash_scoped``: a ``torch.autograd.Function`` whose forward runs
  K8 (``kernels.ops.flash_attention``) on transposed views of CUDA
  tensors, and the blockwise route on the CPU, as the reference keeps
  non-TPU hosts off its kernel.  Its backward, on every device, is
  ``flash_attention_backward``: the reference's recompute (the scores
  rebuilt tile by tile from q, k and v; no Pallas backward exists), in
  plain PyTorch.  It takes no window: a config with a per-layer window
  schedule (gemma3) attends blockwise with the layer's window on every
  device, and takes the blockwise route's autograd, as the reference keeps
  such configs off its kernel (``use_kernel = not cfg.window_pattern``).
* ``decode_attention`` and ``KVCache`` serve one token per row against a
  padded cache.  ``KVCache.append`` writes into the cache's buffers in
  place (the reference's functional update returns new arrays; the port
  keeps one buffer per layer instead of a copy per step).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels import ops as kops

NEG_INF = -1e30


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
    block for block (masked scores -1e30, the padding masked by position)."""
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
    outs = []
    for q0 in range(0, tqp, block_q):
        qi = qf[:, q0:q0 + block_q]                        # (B, bq, KV, G, D)
        q_pos = q_offset + q0 + torch.arange(block_q, device=dev)
        acc = torch.zeros((b, kv, block_q, g, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, kv, block_q, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, block_q, g), dtype=torch.float32, device=dev)
        for k0 in range(0, tkp, block_k):
            kj, vj = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            k_pos = k0 + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgd,bskd->bkqgs", qi, kj) * scale
            mask = (k_pos[None, :] <= q_pos[:, None]) if causal else \
                torch.ones((block_q, block_k), dtype=torch.bool, device=dev)
            mask = mask & (k_pos[None, :] > q_pos[:, None] - w_eff)
            mask = mask & (k_pos[None, :] < tk)            # kv padding
            s = torch.where(mask[None, None, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))           # (B, KV, bq, G)
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
        q_pos = torch.arange(q0, q1, device=dev)
        k_end = min(q1, tk) if causal else tk

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
    def forward(ctx, q, k, v, causal, block_q, block_k):
        if q.is_cuda:
            out = kops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=0, backend="cuda").transpose(1, 2)
        else:
            out = blockwise_attention(q, k, v, causal=causal,
                                      block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out)
        ctx.tiles = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, block_q, block_k = ctx.tiles
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout, causal=causal, block_q=block_q,
            block_k=block_k)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: Tensor,                # (B, T, H, D)
    k: Tensor,                # (B, S, KV, D)
    v: Tensor,                # (B, S, KV, D)
    *,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 1024,
) -> Tensor:
    """The flash route (``attn_impl='pallas'``): K8 on CUDA tensors (K8
    picks its own tiles; a build or launch failure raises), the blockwise
    route at (``block_q``, ``block_k``) tiles on the CPU; under autograd
    the gradient is ``flash_attention_backward`` at those tiles on every
    device.  No window: configs with a window schedule stay on the
    blockwise route, as the reference keeps them off its kernel."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


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
