"""Plain PyTorch versions of the port's streaming and training kernels.

Each function computes exactly what its kernel computes, on the same flat
operands, with a Python loop over time: the CPU path of ``kernels.ops`` and
the yardstick the kernels are held against on the card.  (K3's plain
version, the factor fold, is ``core.ridge.cholupdate_window_t``.)

Operand contract (shared with ``kernels.train``, ``kernels.streaming`` and
``kernels.streaming_q8``):

    j_seq    (N, T, Nx) f32   masked inputs, N = S * spp samples
    lengths  (N,) int32       valid lengths (clipped to [0, T])
    p, q     (S,) f32         per-system reservoir gains; sample i belongs
                              to system i // spp
    W, b     (S, Ny, Nr), (S, Ny)   per-system readout (K2, K5)

K5 takes codes and scales in place of p, q and W:

    Lq       (S, Nx, Nx) int8  ring-matrix codes (scale sL)
    qpow     (S, Nx) f32       ring powers q^1..q^Nx (the wrap stays fp32)
    scales   (S, 4) f32        [p, sx, sL, sw], all > 0
    Wq       (S, Ny, Nr) int8  readout codes (scale sw), DPRR layout

A sample's state freezes once k >= length; a dead step adds nothing to the
DPRR accumulator.  The truncation boundary (x(T-1), j(T)) is latched before
the state update at k = length-1, so x(T-1) = 0 when length == 1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import reservoir as core_res
from repro_torch.core.types import Nonlinearity, Tensor


def train_forward_ref(
    j_seq: Tensor,
    lengths: Tensor,
    p: Tensor,
    q: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of K1 (``kernels.train``): ``(r, x_last, x_prev,
    j_last)`` with r (N, Nx*(Nx+1)) in the DPRR layout and the three
    boundary rows (N, Nx).  Same contract as the reference's
    ``ref.train_forward_ref`` on logical (unpadded) shapes."""
    n, t_len, nx = j_seq.shape
    spp = n // p.shape[0]
    ps = p.repeat_interleave(spp)[:, None]
    qs = q.repeat_interleave(spp)
    L = core_res.ring_matrix(qs, nx, j_seq.dtype)       # (N, Nx, Nx)
    qpow = core_res.ring_powers(qs, nx, j_seq.dtype)    # (N, Nx)
    lens = torch.clamp(lengths.to(torch.int64), 0, t_len)[:, None]
    x = torch.zeros((n, nx), dtype=j_seq.dtype, device=j_seq.device)
    acc_outer = torch.zeros((n, nx, nx), dtype=j_seq.dtype,
                            device=j_seq.device)
    acc_sum = torch.zeros_like(x)
    x_bnd = torch.zeros_like(x)
    j_bnd = torch.zeros_like(x)
    for k in range(t_len):
        j_k = j_seq[:, k]
        a = ps * f(j_k + x)
        x_k = (L @ a[..., None])[..., 0] + x[:, -1:] * qpow
        is_bnd = lens == k + 1
        x_bnd = torch.where(is_bnd, x, x_bnd)
        j_bnd = torch.where(is_bnd, j_k, j_bnd)
        live = lens > k
        x_k = torch.where(live, x_k, x)
        x1m = torch.where(live, x_k, 0.0)
        acc_outer = acc_outer + x1m[:, :, None] * x[:, None, :]
        acc_sum = acc_sum + x1m
        x = x_k
    r = torch.cat([acc_outer.reshape(n, nx * nx), acc_sum], dim=-1)
    return r, x, x_bnd, j_bnd


def streaming_logits_ref(
    j_seq: Tensor,
    lengths: Tensor,
    p: Tensor,
    q: Tensor,
    W: Tensor,
    b: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tensor:
    """Plain version of K2 (``kernels.streaming``): readout logits (N, Ny)
    = r . W[system]^T + b[system], bias included.  Same contract as the
    reference's ``ref.streaming_logits_ref``."""
    r = train_forward_ref(j_seq, lengths, p, q, f)[0]
    n_sys = W.shape[0]
    r = r.reshape(n_sys, -1, r.shape[-1])
    logits = r @ W.transpose(-1, -2) + b[:, None, :]
    return logits.reshape(-1, W.shape[1])


def _quantize(v: Tensor, scale: Tensor) -> Tensor:
    """clip(round(v / scale), -127, 127) as int32 codes (half to even)."""
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int32)


def streaming_q8_ref(
    j_seq: Tensor,
    lengths: Tensor,
    Lq: Tensor,
    qpow: Tensor,
    scales: Tensor,
    Wq: Tensor,
    b: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tuple[Tensor, Tensor]:
    """Plain version of K5 (``kernels.streaming_q8``): readout logits
    (N, Ny), bias included, and the int32 DPRR code accumulators
    (N, Nx, Nx+1).

    The math of the reference's ``ref.streaming_q8_sim`` on the true Nx and
    Ny, in its operation order.  Per live step:

        x_prev = xq_prev * sx
        aq     = clip(round(p * f(j + x_prev) / sx))        int8 codes
        y      = Lq @ aq                                    int32
        x      = y * (sx * sL) + x_prev[Nx-1] * qpow
        xq     = clip(round(x / sx))
        acc   += xq (outer) [xq_prev, 1]                    int32

    Dead steps freeze the codes and add nothing.  The readout dequantizes
    the node columns by sx^2 and the ones column by sx, and the codes of W
    by sw.
    """
    n, t_len, nx = j_seq.shape
    n_sys = Lq.shape[0]
    spp = n // n_sys
    sc = scales.repeat_interleave(spp, dim=0)
    p, sx, sL = sc[:, 0:1], sc[:, 1:2], sc[:, 2:3]
    L = Lq.repeat_interleave(spp, dim=0).to(torch.int32)     # (N, Nx, Nx)
    qp = qpow.repeat_interleave(spp, dim=0)                  # (N, Nx)
    mix_scale = sx * sL
    lens = torch.clamp(lengths.to(torch.int64), 0, t_len)[:, None]
    dev = j_seq.device
    xq = torch.zeros((n, nx), dtype=torch.int32, device=dev)
    acc = torch.zeros((n, nx, nx + 1), dtype=torch.int32, device=dev)
    one = torch.ones((n, 1), dtype=torch.int32, device=dev)
    for k in range(t_len):
        x_prev = xq.to(torch.float32) * sx
        aq = _quantize(p * f(j_seq[:, k] + x_prev), sx)
        y = (L * aq[:, None, :]).sum(dim=-1, dtype=torch.int32)
        x = y.to(torch.float32) * mix_scale + x_prev[:, -1:] * qp
        live = lens > k
        xq_k = torch.where(live, _quantize(x, sx), xq)
        x1m = torch.where(live, xq_k, 0)
        acc = acc + x1m[:, :, None] * torch.cat([xq, one], dim=-1)[:, None, :]
        xq = xq_k
    colscale = torch.cat([(sx * sx).expand(n, nx), sx], dim=-1)
    racc = acc.to(torch.float32) * colscale[:, None, :]
    r = torch.cat([racc[..., :nx].reshape(n, nx * nx), racc[..., nx]], dim=-1)
    w = Wq.to(torch.float32) * scales[:, 3, None, None]      # (S, Ny, Nr)
    logits = r.reshape(n_sys, spp, -1) @ w.transpose(-1, -2) + b[:, None, :]
    return logits.reshape(n, -1), acc
