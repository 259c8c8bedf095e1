"""Mamba-2 / SSD block (zamba2's backbone layer).

The port of ``repro.models.ssm``.  State-space duality recurrence per head
(state S in R^{N x P}, N = ssm_state, P = head dim):

    S_t = a_t S_{t-1} + b_t^T (dt_t x_t)        a_t = exp(-dt_t * A)
    y_t = c_t S_t + D x_t

with input-dependent (dt, b, c) projections, a depthwise causal conv on the
(x, b, c) stream and a gated output.  Training and prefill run the
reference's chunkwise-parallel scan; decode is the same block at T = 1
with chunk 1, the conv's tail carried in the state.

Layout: x (B, T, D); heads H = d_inner / P.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tensor
from repro_torch.distributed.sharding import (fsdp_gather, local_region,
                                              shard_act, zeros)
from repro_torch.models.layers import (dense_init, full_init, init_device,
                                       ones_init, rms_norm, with_axes,
                                       zeros_init)

CONV_K = 4  # depthwise conv kernel width


class SsmState(NamedTuple):
    s: Tensor       # (B, H, N, P) SSD state
    conv: Tensor    # (B, CONV_K - 1, conv_dim) conv tail


def ssm_block_init(generator: Optional[torch.Generator], d_model: int,
                   ssm_state: int = 64, head_dim: int = 64, expand: int = 2,
                   dtype=torch.bfloat16) -> Dict[str, Tensor]:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * ssm_state
    dev = init_device(generator)
    return {
        # fused input projection: [x (d_inner), z gate (d_inner), b (N),
        # c (N), dt (H)]
        "w_in": dense_init(generator,
                           (d_model, 2 * d_inner + 2 * ssm_state + n_heads),
                           ("embed", "mlp"), dtype),
        "conv_w": dense_init(generator, (CONV_K, conv_dim), ("conv", "mlp"),
                             dtype, scale=CONV_K ** -0.5),
        "conv_b": zeros_init((conv_dim,), ("mlp",), dtype, dev),
        "a_log": with_axes(torch.log(torch.linspace(
            1.0, 16.0, n_heads, device=dev)).to(torch.float32), ("heads",)),
        # softplus^-1(0.01)
        "dt_bias": full_init((n_heads,), -4.6, ("heads",), torch.float32,
                             dev),
        "d_skip": ones_init((n_heads,), ("heads",), torch.float32, dev),
        "norm_w": zeros_init((d_inner,), ("mlp",), dtype, dev),
        "w_out": dense_init(generator, (d_inner, d_model), ("mlp", "embed"),
                            dtype),
    }


def _depthwise_conv(x: Tensor, w: Tensor, b: Tensor, tail: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Causal depthwise conv along T.  x: (B, T, C), tail: (B, K-1, C).
    Returns (silu(conv), the new tail: the last K-1 inputs)."""
    k = w.shape[0]
    t = x.shape[1]
    xt = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, T+K-1, C)
    out = xt[:, 0:t, :] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xt[:, i:i + t, :] * w[i].to(x.dtype)
    out = out + b.to(x.dtype)
    new_tail = xt[:, -(k - 1):, :] if k > 1 else tail
    return F.silu(out.to(torch.float32)).to(x.dtype), new_tail


def ssd_chunked(
    xh: Tensor,     # (B, T, H, P) inputs (dt-scaled)
    a_log: Tensor,  # (B, T, H) log-decay per step (negative)
    bm: Tensor,     # (B, T, N) input matrix
    cm: Tensor,     # (B, T, N) output matrix
    s0: Tensor,     # (B, H, N, P)
    chunk: int = 128,
) -> Tuple[Tensor, Tensor]:
    """Chunkwise-parallel SSD scan (Mamba-2), in fp32.  Returns
    (y (B, T, H, P), s_T).  T must be a multiple of ``chunk``."""
    b, t, h, p = xh.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    c_idx = torch.arange(chunk, device=xh.device)
    causal = c_idx[:, None] >= c_idx[None, :]
    s = s0.to(torch.float32)
    ys = []
    for c0 in range(0, t, chunk):
        x_, a_, b_, c_ = (v[:, c0:c0 + chunk].to(torch.float32)
                          for v in (xh, a_log, bm, cm))
        cum_ = torch.cumsum(a_, dim=1)             # inclusive, (B, C, H)
        tot_ = cum_[:, -1:, :]
        # inter-chunk: y_t += c_t exp(cum_t) S_prev
        c_dec = c_[:, :, None, :] * torch.exp(cum_)[..., None]  # (B,C,H,N)
        y_inter = torch.einsum("bchn,bhnp->bchp", c_dec, s)
        # intra-chunk: y_t += sum_{u<=t} exp(cum_t - cum_u) (c_t . b_u) x_u
        scores = torch.einsum("bcn,bun->bcu", c_, b_)
        decay = torch.exp(cum_[:, :, None, :] - cum_[:, None, :, :])
        scores = torch.where(causal[None, :, :, None],
                             scores[..., None] * decay, 0.0)
        y_intra = torch.einsum("bcuh,buhp->bchp", scores, x_)
        # state: S = exp(total) S + sum_u exp(total - cum_u) b_u^T x_u
        b_dec = b_[:, :, None, :] * torch.exp(tot_ - cum_)[..., None]
        s = torch.exp(tot_)[:, 0, :, None, None] * s + torch.einsum(
            "bchn,bchp->bhnp", b_dec, x_)
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1), s


def ssm_block_apply(
    p, x: Tensor, state: SsmState, *, ssm_state: int = 64,
    head_dim: int = 64, expand: int = 2, chunk: int = 128,
    eps: float = 1e-5,
) -> Tuple[Tensor, SsmState]:
    """Mamba-2 block over a sequence (prefill/train) or one step (T=1)."""
    b, t, d = x.shape
    d_inner = expand * d
    n_heads = d_inner // head_dim
    n = ssm_state

    proj = x @ fsdp_gather(p["w_in"], ("embed", "mlp")).to(x.dtype)
    xz, z, bm, cm, dt = torch.split(
        proj, [d_inner, d_inner, n, n, n_heads], dim=-1)
    conv_in = torch.cat([xz, bm, cm], dim=-1)
    conv_out, new_tail = _depthwise_conv(conv_in, p["conv_w"], p["conv_b"],
                                         state.conv)
    xz, bm, cm = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])   # (B, T, H)
    a = -torch.exp(p["a_log"])                             # (H,) negative
    a_log_step = dt * a                                    # (B, T, H)
    xr = xz.reshape(b, t, n_heads, head_dim).to(torch.float32)
    xh = xr * dt[..., None]

    scan = local_region(
        functools.partial(ssd_chunked, chunk=min(chunk, t)),
        (("batch", None, "heads", None), ("batch", None, "heads"),
         ("batch", None, None), ("batch", None, None),
         ("batch", "heads", None, None)), (0, 4))
    y, s_new = scan(xh, a_log_step, bm, cm, state.s)
    y = y + p["d_skip"][None, None, :, None] * xr
    y = y.reshape(b, t, d_inner).to(x.dtype)
    y = rms_norm(y, p["norm_w"], eps)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    y = shard_act(y, ("batch", None, "act_model"))
    out = y @ fsdp_gather(p["w_out"], ("mlp", "embed")).to(x.dtype)
    return out, SsmState(s=s_new.to(state.s.dtype),
                         conv=new_tail.to(state.conv.dtype))


def ssm_state_init(batch: int, d_model: int, ssm_state: int = 64,
                   head_dim: int = 64, expand: int = 2,
                   dtype=torch.float32, device=None) -> SsmState:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * ssm_state
    return SsmState(
        s=zeros((batch, n_heads, ssm_state, head_dim),
                ("batch", "heads", None, None), dtype, device),
        conv=zeros((batch, CONV_K - 1, conv_dim), ("batch", None, "mlp"),
                   dtype, device),
    )
