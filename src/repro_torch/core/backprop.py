"""Truncated backpropagation through the DFR (paper Sec. 3.2-3.5), in PyTorch.

The counterpart of ``repro.core.backprop`` on the serving path:

* ``forward`` - reservoir scan -> DPRR -> readout, plus the truncation
  boundary x(T), x(T-1), j(T).
* ``truncated_loss_from_aux`` / ``grads_truncated_from_aux`` - the
  truncated objective, with ``.detach()`` wherever the reference uses
  ``stop_gradient``: gradients flow only through the re-derived last step
  and the readout (Eq. 33-36).
* ``forward_fused`` - the same ``ForwardAux`` through K1, the fused kernel
  that never stores X, as a ``torch.autograd.Function`` whose backward is the
  closed form of Eq. 33-36 from (r, x(T), x(T-1), j(T)).

Parameters may carry leading system axes *P (the stream server's slots):
``p``/``q`` are (*P), ``W`` (*P, Ny, Nr), ``b`` (*P, Ny), and the data
(*P, B, ...).  Every loss and gradient stays per system, as the reference's
``vmap`` over slots keeps it.

Loss: softmax cross-entropy (Eq. 24), with dL/dlogits = y - e (Eq. 25).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dprr as dprr_mod
from repro_torch.core import reservoir as res_mod
from repro_torch.core.types import DFRParams, Nonlinearity, Tensor


class ForwardAux(NamedTuple):
    logits: Tensor    # (..., Ny)
    probs: Tensor     # (..., Ny)
    r: Tensor         # (..., Nr)
    x_last: Tensor    # (..., Nx)  x(T)
    x_prev: Tensor    # (..., Nx)  x(T-1)
    j_last: Tensor    # (..., Nx)  j(T)


def loss_from_logits(logits: Tensor, onehot: Tensor) -> Tensor:
    """Cross-entropy (Eq. 24) with a numerically safe log-softmax."""
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def _per_sample(v: Tensor) -> Tensor:
    """A per-system value (*P) made to broadcast against samples (*P, B)."""
    return torch.as_tensor(v)[..., None]


def _lead(v, t: Tensor) -> Tensor:
    """A per-system value (*P) made to broadcast against a leaf (*P, ...)."""
    v = torch.as_tensor(v, dtype=t.dtype, device=t.device)
    return v.reshape(v.shape + (1,) * (t.ndim - v.ndim))


def _readout(r: Tensor, W: Tensor, b: Tensor) -> Tensor:
    """logits = r W^T + b per system: r (*P, B, Nr) -> (*P, B, Ny)."""
    return r @ W.transpose(-1, -2) + b[..., None, :]


def _take_step(x: Tensor, idx: Tensor) -> Tensor:
    """x[..., idx, :] per sample: x (..., T, Nx), idx (...) -> (..., Nx)."""
    index = idx.to(torch.int64)[..., None, None].expand(
        *idx.shape, 1, x.shape[-1])
    return torch.gather(x, -2, index)[..., 0, :]


def forward(
    params: DFRParams,
    j_seq: Tensor,
    f: Nonlinearity,
    lengths: Optional[Tensor] = None,
) -> ForwardAux:
    """Full forward pass: reservoir -> DPRR -> output layer.

    j_seq: (*P, B, T, Nx) masked inputs; lengths (*P, B) or None.
    """
    x = res_mod.run_reservoir(_per_sample(params.p), _per_sample(params.q),
                              j_seq, f=f, lengths=lengths)
    r = dprr_mod.compute_dprr(x, lengths=lengths)
    logits = _readout(r, params.W, params.b)
    probs = torch.softmax(logits, dim=-1)
    if lengths is None:
        lengths = torch.full(j_seq.shape[:-2], j_seq.shape[-2],
                             dtype=torch.int32, device=j_seq.device)
    lengths = lengths.to(torch.int64)
    idx_last = torch.clamp(lengths - 1, min=0)
    idx_prev = lengths - 2  # -1 -> x(0) = 0
    x_last = _take_step(x, idx_last)
    x_prev = torch.where((idx_prev >= 0)[..., None],
                         _take_step(x, torch.clamp(idx_prev, min=0)), 0.0)
    j_last = _take_step(j_seq, idx_last)
    return ForwardAux(logits, probs, r, x_last, x_prev, j_last)


def truncated_loss_from_aux(
    params: DFRParams,
    aux: ForwardAux,
    onehot: Tensor,
    f: Nonlinearity,
    loss_fn: Callable[[Tensor, Tensor], Tensor] = loss_from_logits,
) -> Tensor:
    """Truncated objective from a precomputed forward pass, per system (*P).

    Every use of ``aux`` is detached, so gradients flow only through the
    re-derived k = T step and the readout - which is why the forward pass
    can be shared with the serving path's infer-before-update without
    changing the gradients.
    """
    n_nodes = aux.x_last.shape[-1]
    x_prev = aux.x_prev.detach()
    # recompute x(T) with gradient flowing only through (p, q) and the
    # within-step ring chain (Eq. 14 at k = T with x(T-1) detached)
    x_last = res_mod.reservoir_step(
        _per_sample(params.p), _per_sample(params.q), f,
        aux.j_last.detach(), x_prev)
    prev_tilde = torch.cat([x_prev, torch.ones_like(x_prev[..., :1])], -1)
    contrib_T = x_last[..., :, None] * prev_tilde[..., None, :]
    contrib_T_sg = aux.x_last.detach()[..., :, None] * prev_tilde[..., None, :]
    # zero in value, so r keeps the forward's value while autograd sees the
    # k = T contribution
    delta = contrib_T - contrib_T_sg
    delta_outer = delta[..., :, :n_nodes].reshape(*x_last.shape[:-1], -1)
    delta_sum = delta[..., :, n_nodes]
    r = aux.r.detach() + torch.cat([delta_outer, delta_sum], dim=-1)
    logits = _readout(r, params.W, params.b)
    return loss_fn(logits, onehot).sum(dim=-1)


def _require_grad(params: DFRParams) -> DFRParams:
    return DFRParams(*(t.detach().requires_grad_(True)
                       for t in (params.p, params.q, params.W, params.b)))


def _value_and_grad(loss_of: Callable[[DFRParams], Tensor],
                    params: DFRParams) -> Tuple[Tensor, DFRParams]:
    leaves = _require_grad(params)
    with torch.enable_grad():
        loss = loss_of(leaves)
        grads = torch.autograd.grad(
            loss.sum(), [leaves.p, leaves.q, leaves.W, leaves.b])
    return loss.detach(), DFRParams(*grads)


def grads_truncated_from_aux(
    params: DFRParams,
    aux: ForwardAux,
    onehot: Tensor,
    f: Nonlinearity,
    loss_fn: Callable[[Tensor, Tensor], Tensor] = loss_from_logits,
) -> Tuple[Tensor, DFRParams]:
    """Truncated-BP loss (*P) and gradients reusing a precomputed forward
    pass; systems never mix, so each system's gradient is its own."""
    return _value_and_grad(
        lambda prm: truncated_loss_from_aux(prm, aux, onehot, f, loss_fn),
        params)


class _FusedFeatures(torch.autograd.Function):
    """K1's outputs with the closed-form truncated backward.

    Only r's cotangent is honoured: the truncation detaches the boundary
    tensors wherever they are consumed, so their cotangents are zero on
    every training path (the reference's ``_fused_features_bwd``).
    """

    @staticmethod
    def forward(ctx, p, q, j_seq, lengths, f, backend):
        from repro_torch.kernels import ops as kops

        r, x_last, x_prev, j_last = kops.train_forward(
            j_seq, lengths, p, q, f, backend=backend)
        ctx.f = f
        ctx.save_for_backward(q, x_last, x_prev, j_last)
        ctx.mark_non_differentiable(x_last, x_prev, j_last)
        return r, x_last, x_prev, j_last

    @staticmethod
    def backward(ctx, dr, *_unused):
        q, x_last, x_prev, j_last = ctx.saved_tensors
        n_nodes = x_last.shape[-1]
        # Eq. 33: bpv_n = sum_j x(T-1)_j dL/dr_{(n-1)Nx+j} + dL/dr_{Nx^2+n}
        dr_outer = dr[..., : n_nodes * n_nodes].reshape(
            *dr.shape[:-1], n_nodes, n_nodes)
        dr_sum = dr[..., n_nodes * n_nodes:]
        bpv = (dr_outer @ x_prev[..., None])[..., 0] + dr_sum
        # Eq. 34: reversed ring recurrence, dx_m = sum_n q^(n-m) bpv_n
        dx = bpv @ res_mod.ring_matrix(q, n_nodes, bpv.dtype)
        # Eq. 35 / Eq. 36, summed over each system's samples and nodes
        f_T = ctx.f(j_last + x_prev)
        grad_p = (f_T * dx).sum(dim=(-2, -1))
        x_shift = torch.cat([x_prev[..., -1:], x_last[..., :-1]], dim=-1)
        grad_q = (x_shift * dx).sum(dim=(-2, -1))
        return grad_p, grad_q, None, None, None, None


def forward_fused(
    params: DFRParams,
    j_seq: Tensor,
    f: Nonlinearity,
    lengths: Optional[Tensor] = None,
    *,
    backend: Optional[str] = None,
) -> ForwardAux:
    """``forward`` through K1: the same ``ForwardAux`` (equal up to the
    reordered DPRR sums), differentiable with the closed-form truncated
    backward, so autograd of a loss over its logits or r IS the truncated
    gradient."""
    r, x_last, x_prev, j_last = _FusedFeatures.apply(
        params.p, params.q, j_seq, lengths, f, backend)
    logits = _readout(r, params.W, params.b)
    probs = torch.softmax(logits, dim=-1)
    return ForwardAux(logits, probs, r, x_last, x_prev, j_last)


def grads_truncated_fused(
    params: DFRParams,
    j_seq: Tensor,
    onehot: Tensor,
    f: Nonlinearity,
    lengths: Optional[Tensor] = None,
    loss_fn: Callable[[Tensor, Tensor], Tensor] = loss_from_logits,
    *,
    backend: Optional[str] = None,
) -> Tuple[Tensor, DFRParams]:
    """Truncated-BP loss (*P) and gradients through the fused forward."""
    return _value_and_grad(
        lambda prm: loss_fn(forward_fused(prm, j_seq, f, lengths,
                                          backend=backend).logits,
                            onehot).sum(dim=-1),
        params)


# ---------------------------------------------------------------------------
# SGD update.  Two guards on top of the paper's plain SGD, as in the
# reference: gradient clipping by norm, in two groups, and clamping (p, q)
# to the paper's own grid-search ranges.
# ---------------------------------------------------------------------------

P_RANGE = (10.0 ** -3.75, 10.0 ** -0.25)
Q_RANGE = (10.0 ** -2.75, 10.0 ** -0.25)


def _clip_scale(sq_norm: Tensor, max_norm: float, dtype) -> Tensor:
    gnorm = torch.sqrt(sq_norm)
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0).to(dtype)


def clip_by_global_norm(grads: DFRParams, max_norm: float) -> DFRParams:
    """Clip the reservoir grads (p, q) and output grads (W, b) as two
    independent groups, per system: the norm of a slot's gradient never
    involves another slot's."""
    f32 = torch.float32
    s_res = _clip_scale(grads.p.to(f32) ** 2 + grads.q.to(f32) ** 2,
                        max_norm, grads.p.dtype)
    s_out = _clip_scale((grads.W.to(f32) ** 2).sum(dim=(-2, -1))
                        + (grads.b.to(f32) ** 2).sum(dim=-1),
                        max_norm, grads.W.dtype)
    return DFRParams(p=grads.p * s_res, q=grads.q * s_res,
                     W=grads.W * _lead(s_out, grads.W),
                     b=grads.b * _lead(s_out, grads.b))


def apply_sgd(
    params: DFRParams,
    grads: DFRParams,
    lr_res,
    lr_out,
    inv_batch=1.0,
) -> DFRParams:
    """One SGD step with the reference's defaults (clip at norm 1.0, (p, q)
    clamped to their ranges); ``lr_res``, ``lr_out`` and ``inv_batch`` may
    be per system (*P)."""
    g = DFRParams(*(t * _lead(inv_batch, t)
                    for t in (grads.p, grads.q, grads.W, grads.b)))
    g = clip_by_global_norm(g, 1.0)
    return DFRParams(
        p=torch.clamp(params.p - _lead(lr_res, g.p) * g.p, *P_RANGE),
        q=torch.clamp(params.q - _lead(lr_res, g.q) * g.q, *Q_RANGE),
        W=params.W - _lead(lr_out, g.W) * g.W,
        b=params.b - _lead(lr_out, g.b) * g.b,
    )
