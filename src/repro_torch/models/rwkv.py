"""RWKV-6 "Finch" block: token shift + data-dependent-decay linear
attention.

The port of ``repro.models.rwkv``.  Recurrence per head (state S in
R^{dk x dv}):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = q_t (diag(u) k_t^T v_t + S_{t-1})        (bonus u on the token)

with the per-channel decay w_t = exp(-exp(lambda_t)) from a low-rank MLP
of the token-shifted input.  Training and prefill run the reference's
chunkwise-parallel form (dense (C x C) products within a chunk, the state
carried across chunks), with its arithmetic as it stands: each chunk is
cast to fp32 inside the step, and k is scaled by exp(-cum) - large for a
chunk whose decays are strong, as in the reference, which the port does
not re-balance.  Decode runs the one-token recurrence on the (H, dk, dv)
state.  Head layout (B, T, H, D).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tensor
from repro_torch.distributed.sharding import (fsdp_gather, local_region,
                                              reduce_partial, shard_act,
                                              split_last)
from repro_torch.models.layers import (dense_init, full_init, init_device,
                                       rms_norm, zeros_init)


def rwkv_block_init(generator: Optional[torch.Generator], d_model: int,
                    head_dim: int = 64, lora_dim: int = 64,
                    dtype=torch.bfloat16) -> Dict[str, Tensor]:
    n_heads = d_model // head_dim
    dev = init_device(generator)

    def dense(shape, axes):
        return dense_init(generator, shape, axes, dtype)

    return {
        "w_r": dense((d_model, d_model), ("embed", "heads")),
        "w_k": dense((d_model, d_model), ("embed", "heads")),
        "w_v": dense((d_model, d_model), ("embed", "heads")),
        "w_g": dense((d_model, d_model), ("embed", "heads")),
        "w_o": dense((d_model, d_model), ("heads", "embed")),
        # data-dependent decay: low-rank lambda(x) = (tanh(x A)) B + bias
        "w_dec_a": dense((d_model, lora_dim), ("embed", None)),
        "w_dec_b": dense((lora_dim, d_model), (None, "heads")),
        "dec_bias": full_init((d_model,), -6.0, ("heads",), dtype, dev),
        "bonus": zeros_init((n_heads, head_dim), ("heads", "head_dim"),
                            dtype, dev),
        # token-shift mixing coefficients
        "mix": full_init((5, d_model), 0.5, (None, "embed_no_shard"), dtype,
                         dev),
        "ln_x": zeros_init((d_model,), ("embed_no_shard",), dtype, dev),
    }


def _token_shift(x: Tensor, x_prev: Tensor) -> Tensor:
    """shifted(x)[t] = x[t-1]; x_prev fills t = 0.  x: (B, T, D)."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


class RwkvState(NamedTuple):
    s: Tensor       # (B, H, dk, dv) linear-attention state
    x_last: Tensor  # (B, D) last token input (for token shift)


def _projections(p, x: Tensor, x_prev: Tensor, n_heads: int, head_dim: int):
    b, t, _ = x.shape
    xs = _token_shift(x, x_prev)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xd = (x * mix[i] + xs * (1 - mix[i]) for i in range(5))
    w_r, w_k, w_v, w_g = (fsdp_gather(p[n], ("embed", "heads"))
                          for n in ("w_r", "w_k", "w_v", "w_g"))
    r = split_last(xr @ w_r.to(x.dtype), n_heads, head_dim)
    k = split_last(xk @ w_k.to(x.dtype), n_heads, head_dim)
    v = split_last(xv @ w_v.to(x.dtype), n_heads, head_dim)
    g = F.silu((xg @ w_g.to(x.dtype)).to(torch.float32))
    lam = torch.tanh(xd @ p["w_dec_a"].to(x.dtype)) @ p["w_dec_b"].to(x.dtype)
    lam = reduce_partial(lam).to(torch.float32) + \
        p["dec_bias"].to(torch.float32)
    w = split_last(torch.exp(-torch.exp(lam)), n_heads, head_dim)
    return r, k, v, g, w


def rwkv_attention_chunked(
    r: Tensor, k: Tensor, v: Tensor, w: Tensor, bonus: Tensor,
    s0: Tensor, chunk: int = 128,
) -> Tuple[Tensor, Tensor]:
    """Chunkwise-parallel RWKV6 linear attention.

    r/k/v/w: (B, T, H, D) with decay w in (0, 1); bonus: (H, D).
    s0: (B, H, D, D) initial state.  Returns (out (B, T, H, D) in r's
    dtype, s_T in fp32).  T must be a multiple of ``chunk``.
    """
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    c_idx = torch.arange(chunk, device=r.device)
    causal = c_idx[:, None] > c_idx[None, :]
    s = s0.to(torch.float32)
    outs = []
    for c0 in range(0, t, chunk):
        rc_, kc_, vc_, wc_ = (a[:, c0:c0 + chunk].to(torch.float32)
                              for a in (r, k, v, w))
        log_w = torch.log(torch.clamp(wc_, min=1e-38))
        cum_ = torch.cumsum(log_w, dim=1)        # inclusive cumulative decay
        cume_ = cum_ - log_w                     # exclusive
        total_ = cum_[:, -1:, :, :]              # (B, 1, H, D)
        # inter-chunk: q decayed to chunk start attends the carried state
        q_dec = rc_ * torch.exp(cume_)
        o_inter = torch.einsum("bchd,bhde->bche", q_dec, s)
        # intra-chunk: causal (C x C) scores with relative decay
        k_s = kc_ * torch.exp(-cum_)
        scores = torch.einsum("bchd,buhd->bhcu", q_dec, k_s)
        scores = torch.where(causal[None, None], scores, 0.0)
        o_intra = torch.einsum("bhcu,buhe->bche", scores, vc_)
        # current-token bonus term: q_t diag(u) k_t^T v_t
        qk = torch.einsum("bchd,bchd->bch", rc_ * bonus[None, None], kc_)
        o_bonus = qk[..., None] * vc_
        # state: S = diag(exp(total)) S + sum_u (k_u exp(total-cum_u))^T v_u
        k_dec = kc_ * torch.exp(total_ - cum_)
        s = torch.exp(total_[:, 0, :, :, None]) * s + torch.einsum(
            "bchd,bche->bhde", k_dec, vc_)
        outs.append((o_inter + o_intra + o_bonus).to(r.dtype))
    return torch.cat(outs, dim=1), s


def rwkv_block_apply(
    p, x: Tensor, state: RwkvState, *, head_dim: int = 64,
    chunk: int = 128, eps: float = 1e-5,
) -> Tuple[Tensor, RwkvState]:
    """Full RWKV6 time-mix block over a sequence.  x: (B, T, D)."""
    b, t, d = x.shape
    n_heads = d // head_dim
    r, k, v, g, w = _projections(p, x, state.x_last, n_heads, head_dim)
    bonus = p["bonus"].to(torch.float32)
    heads = ("batch", None, "heads", None)
    scan = local_region(
        functools.partial(rwkv_attention_chunked, chunk=min(chunk, t)),
        (heads, heads, heads, heads, ("heads", None),
         ("batch", "heads", None, None)), (0, 5))
    out, s_new = scan(r, k, v, w, bonus, state.s)
    # per-head group norm (ln_x)
    out = rms_norm(out.reshape(b, t, d), p["ln_x"], eps)
    out = out * g.to(out.dtype)
    out = shard_act(out, ("batch", None, "act_model"))
    w_o = fsdp_gather(p["w_o"], ("heads", "embed"))
    y = out.to(x.dtype) @ w_o.to(x.dtype)
    return y, RwkvState(s=s_new.to(state.s.dtype), x_last=x[:, -1, :])


def _recur(rf: Tensor, kf: Tensor, vf: Tensor, wf: Tensor, bonus: Tensor,
           s: Tensor) -> Tuple[Tensor, Tensor]:
    """One token's recurrence, f32: o = q (diag(u) k^T v + S) (B, H, D)
    and the new state diag(w) S + k^T v (B, H, dk, dv)."""
    s = s.to(torch.float32)
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    o = torch.einsum("bhd,bhde->bhe", rf * bonus[None], kv) + torch.einsum(
        "bhd,bhde->bhe", rf, s)
    return o, wf[..., None] * s + kv


def rwkv_decode_step(
    p, x: Tensor, state: RwkvState, *, head_dim: int = 64,
    eps: float = 1e-5,
) -> Tuple[Tensor, RwkvState]:
    """Single token: x (B, 1, D); recurrent state update (O(d^2))."""
    b, _, d = x.shape
    n_heads = d // head_dim
    r, k, v, g, w = _projections(p, x, state.x_last, n_heads, head_dim)
    rf, kf, vf, wf = (a[:, 0].to(torch.float32) for a in (r, k, v, w))
    bonus = p["bonus"].to(torch.float32)
    heads = ("batch", "heads", None)
    o, s_new = local_region(
        _recur, (heads, heads, heads, heads, ("heads", None),
                 ("batch", "heads", None, None)), (0, 5))(
        rf, kf, vf, wf, bonus, state.s)
    out = rms_norm(o.reshape(b, 1, d).to(x.dtype), p["ln_x"], eps)
    out = out * g.to(out.dtype)
    y = out.to(x.dtype) @ p["w_o"].to(x.dtype)
    return y, RwkvState(s=s_new.to(state.s.dtype), x_last=x[:, -1, :])
