"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its kernel computes, on the same flat
operands, with a Python loop over time (or over columns; K8's is a dense
masked softmax): the CPU path of ``kernels.ops`` and the yardstick the
kernels are held against on the card.
(K3's plain version, the factor fold, is ``core.ridge.cholupdate_window_t``.)
``chol_ref`` and ``ridge_solve_ref`` are no kernel's plain version: they are
the unblocked library solves that ``ops.cholesky`` and ``ops.ridge_solve``
run with ``backend='torch'``, as the reference's XLA branch does.

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

K6 (``reservoir_ref``) writes every state X (N, T, Nx); K7 (``dprr_ref``)
reads a stored X (N, T, Nx) with its lengths (N,).  K8
(``flash_attention_ref``) takes q (B, H, Tq, D) and k, v (B, KV, Tk, D).

A sample's state freezes once k >= length; a dead step adds nothing to the
DPRR accumulator.  The truncation boundary (x(T-1), j(T)) is latched before
the state update at k = length-1, so x(T-1) = 0 when length == 1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import dprr as core_dprr
from repro_torch.core import reservoir as core_res
from repro_torch.core import ridge as core_ridge
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


def reservoir_ref(
    j_seq: Tensor,
    lengths: Tensor,
    p: Tensor,
    q: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tensor:
    """Plain version of K6 (``kernels.reservoir``): every state X (N, T, Nx)
    of ``run_reservoir`` from x(0) = 0.  Rows at k >= length hold the frozen
    last state, as the reference writes them."""
    n = j_seq.shape[0]
    spp = n // p.shape[0]
    return core_res.run_reservoir(p.repeat_interleave(spp),
                                  q.repeat_interleave(spp), j_seq, f=f,
                                  lengths=lengths.to(torch.int64))


def dprr_ref(x: Tensor, lengths: Tensor) -> Tensor:
    """Plain version of K7 (``kernels.dprr``): the DPRR (N, Nx*(Nx+1)) of
    stored states, sum_k x(k) [x(k-1), 1]^T over k < length with x(0) = 0,
    the outer products row-major, then the sums.  The length mask sits on
    the x(k) side only, so frozen rows never count."""
    return core_dprr.compute_dprr(x, lengths=lengths.to(torch.int64))


def chol_tile_ref(a: Tensor) -> Tensor:
    """Plain version of K4a (``kernels.cholesky``): (K, bs, bs) SPD tiles
    -> lower L with a = L L^T, strict upper zero.  The right-looking column
    loop of the reference's ``_chol_tile``: d = sqrt(a[j, j]), the column
    below j divided by d, then the rank-1 update of the trailing square.
    Only the lower triangle is ever read.  A tile that is not positive
    definite gives NaN (sqrt of a negative pivot), with no guard."""
    a = a.clone()
    n = a.shape[-1]
    for j in range(n):
        d = torch.sqrt(a[..., j, j])
        col = a[..., j + 1:, j] / d[..., None]
        a[..., j, j] = d
        a[..., j + 1:, j] = col
        a[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
    return torch.tril(a)


def trsm_lower_t_ref(a: Tensor, L: Tensor) -> Tensor:
    """Plain version of K4b's ``trsm_lower_t``: X L^T = a for a (K, m, bs)
    and lower L (K, bs, bs), forward over columns (the reference's
    ``_trsm_lower_t_tile``): x[:, j] = (a[:, j] - x[:, :j] L[j, :j]) /
    L[j, j]."""
    x = a.clone()
    for j in range(L.shape[-1]):
        dot = (x[..., :, :j] @ L[..., j, :j, None])[..., 0]
        x[..., :, j] = (a[..., :, j] - dot) / L[..., j, j, None]
    return x


def trsm_lower_ref(d: Tensor, L: Tensor) -> Tensor:
    """Plain version of K4b's ``trsm_lower``: X L = d for d (K, m, bs) and
    lower L (K, bs, bs), backward over columns (the reference's
    ``_trsm_lower_tile``): x[:, j] = (d[:, j] - x[:, j+1:] L[j+1:, j]) /
    L[j, j]."""
    x = d.clone()
    for j in range(L.shape[-1] - 1, -1, -1):
        dot = (x[..., :, j + 1:] @ L[..., j + 1:, j, None])[..., 0]
        x[..., :, j] = (d[..., :, j] - dot) / L[..., j, j, None]
    return x


def chol_ref(a: Tensor) -> Tensor:
    """Unblocked lower Cholesky of (..., s, s), NaN where a system is not
    positive definite (``core.ridge.cholesky_or_nan``)."""
    return core_ridge.cholesky_or_nan(a)


def ridge_solve_ref(A: Tensor, B: Tensor) -> Tensor:
    """W~ = A B^-1 for A (..., Ny, s), SPD B (..., s, s): ``chol_ref`` and
    two triangular solves (the reference's ``ref.ridge_solve_ref``)."""
    C = chol_ref(B)
    D = torch.linalg.solve_triangular(C, A.mT, upper=False)
    return torch.linalg.solve_triangular(C.mT, D, upper=True).mT


def flash_attention_ref(
    q: Tensor,   # (B, H, Tq, D)
    k: Tensor,   # (B, KV, Tk, D)
    v: Tensor,   # (B, KV, Tk, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
) -> Tensor:
    """Plain K8: the dense masked softmax of the reference's
    ``ref.flash_attention_ref``, in fp32, returned in q's dtype.  A key is
    live if k_pos <= q_pos (causal) and k_pos > q_pos - window (window >
    0), where row i of q sits at q_pos = q_offset + i.  A row with no live key gives 0, as the kernels do (the reference's
    dense oracle averages such a row's values instead)."""
    b, h, tq, d = q.shape
    _, kv, tk, _ = k.shape
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = q.reshape(b, kv, g, tq, d).to(torch.float32)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.to(torch.float32)) * scale
    q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.to(torch.float32))
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, tq, d).to(q.dtype)
