"""Plain PyTorch versions of the port's two CUDA kernels.

Each function computes exactly what its kernel computes, on the same flat
operands, with a Python loop over time: the CPU path of ``kernels.ops`` and
the yardstick the kernels are held against on the card.

Operand contract (shared with ``kernels.train`` and ``kernels.streaming``):

    j_seq    (N, T, Nx) f32   masked inputs, N = S * spp samples
    lengths  (N,) int32       valid lengths (clipped to [0, T])
    p, q     (S,) f32         per-system reservoir gains; sample i belongs
                              to system i // spp
    W, b     (S, Ny, Nr), (S, Ny)   per-system readout (K2 only)

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
