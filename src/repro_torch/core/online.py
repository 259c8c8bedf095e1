"""Online training + inference for the serving path (paper Sec. 3.1), in PyTorch.

The counterpart of the parts of ``repro.core.online`` the stream server
runs: the ``OnlineState`` carry, the fused serve step (infer-before-update
plus truncated-BP SGD plus (A, B) accumulation from ONE forward pass) and the
recompute-mode Ridge refresh of selected slot rows.

The reference writes these for one system and ``vmap``s them over the
server's slot axis.  Here every function takes the slot-batched state
directly: each leaf of ``OnlineState`` leads with the slot axes *P (one axis
for the server), and the data leads with the same axes.  Slots never mix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import backprop, dprr, masking, ridge
from repro_torch.core.types import (DFRConfig, DFRParams, QuantParams,
                                    RidgeState, Tensor)


@dataclasses.dataclass
class OnlineState:
    """Carry of the online system; leaves may lead with slot axes.

    ``quant`` (the reference's int8 serving codes) and the drift-detector
    EMAs ``loss_fast``/``loss_slow`` are inert zeros in this port: the serving
    modes that move them are not ported, and they ride along so the state
    keeps the reference's shape.
    """

    params: DFRParams
    ridge: RidgeState
    step: Tensor          # int32 counter
    loss_ema: Tensor      # scalar diagnostics
    quant: QuantParams
    loss_fast: Tensor
    loss_slow: Tensor


def init_state(cfg: DFRConfig, device=None) -> OnlineState:
    """Fresh single-system state: paper init (p, q), zero readout + stats."""
    zero = torch.zeros((), dtype=cfg.dtype, device=device)
    return OnlineState(
        params=DFRParams.init(cfg, device),
        ridge=RidgeState.zeros(cfg.s, cfg.n_classes, cfg.dtype, device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        loss_ema=zero.clone(),
        quant=QuantParams.zeros(cfg.n_classes, cfg.n_rep, device),
        loss_fast=zero.clone(),
        loss_slow=zero.clone(),
    )


def online_serve_step(
    cfg: DFRConfig,
    mask: Tensor,
    state: OnlineState,   # leaves lead with slot axes *P
    u: Tensor,            # (*P, B, T, n_in) window of streamed samples
    length: Tensor,       # (*P, B)
    label: Tensor,        # (*P, B) int
    lr: Tensor,           # (*P) slot learning rate (0 in the frozen phase)
    weight: Tensor,       # (*P, B) 0/1 live-sample mask
    accumulate: Tensor,   # (*P) 0/1: accumulate (A, B) this step?
    *,
    train: bool = True,
    fused: bool = False,
) -> Tuple[OnlineState, Tensor, Dict[str, Tensor]]:
    """Fused infer-before-update + train step for the serving path.

    One forward pass serves three consumers: the returned logits (from the
    old parameters - the honest online metric), the truncated-BP gradients
    (``backprop.grads_truncated_from_aux``) and the (A, B) statistics, which
    accumulate only where ``accumulate`` is set (the frozen-reservoir phase,
    where the forward's parameters are the post-update ones).

    ``train=False`` skips the gradient and SGD: the parameters pass through
    and the loss is the truncated objective's value - the ``lr = 0`` step,
    which the server takes once every live slot is frozen.

    ``fused=True`` runs the shared forward through K1
    (``backprop.forward_fused``), which never stores the state sequence;
    the gradients, statistics and logits read the same ``ForwardAux``
    fields either way.

    This is the reference's step with ``maintain_factor=False`` and
    ``forget=None``: any live incremental factor is dropped once statistics
    move.  Returns (new state, logits (*P, B, Ny), metrics).  The input
    state is not modified.
    """
    f = cfg.f()
    dt = cfg.dtype
    j_seq = masking.apply_mask(mask, u)
    onehot = torch.nn.functional.one_hot(
        label.to(torch.int64), cfg.n_classes).to(dt)
    with torch.no_grad():
        fwd = backprop.forward_fused if fused else backprop.forward
        aux = fwd(state.params, j_seq, f, lengths=length)

    w = weight.to(dt)
    n_w = w.sum(dim=-1)

    def loss_fn(lg, oh):
        return w * backprop.loss_from_logits(lg, oh)

    inv = 1.0 / torch.clamp(n_w, min=1.0)
    if train:
        loss, g = backprop.grads_truncated_from_aux(
            state.params, aux, onehot, f, loss_fn=loss_fn)
        params = backprop.apply_sgd(state.params, g, lr, lr, inv_batch=inv)
    else:
        with torch.no_grad():
            loss = backprop.truncated_loss_from_aux(
                state.params, aux, onehot, f, loss_fn)
        params = state.params

    acc = accumulate.to(dt)
    live = w * acc[..., None]                      # (*P, B) accumulated rows
    rt = dprr.r_tilde(aux.r) * live[..., None]
    A, B = ridge.accumulate_ab(state.ridge.A, state.ridge.B, rt, onehot)
    moved = acc * n_w
    fb = state.ridge.factor_beta
    new = OnlineState(
        params=params,
        ridge=RidgeState(
            A=A,
            B=B,
            count=state.ridge.count + moved.to(state.ridge.count.dtype),
            Lt=state.ridge.Lt,
            # statistics move without rotating a factor: drop any live one
            factor_beta=torch.where(moved > 0, torch.zeros_like(fb), fb),
        ),
        step=state.step + 1,
        loss_ema=0.99 * state.loss_ema + 0.01 * loss * inv,
        quant=state.quant,
        loss_fast=state.loss_fast,
        loss_slow=state.loss_slow,
    )
    hits = (aux.logits.argmax(dim=-1) == label).to(torch.float32) * w
    metrics = {"loss": loss * inv, "acc": hits.sum(dim=-1) * inv}
    return new, aux.logits, metrics


def refresh_output_batched(state: OnlineState, beta) -> OnlineState:
    """Ridge refresh of every slot of a slot-axis state: one batched
    Cholesky over all the (s, s) systems."""
    Wt = ridge.ridge_cholesky_batched(
        state.ridge.A, ridge.regularize(state.ridge.B, beta))
    params = dataclasses.replace(state.params, W=Wt[..., :, :-1],
                                 b=Wt[..., :, -1])
    return dataclasses.replace(state, params=params)


def scatter_readout_rows(
    state: OnlineState, Wt: Tensor, eligible_rows: Tensor, rows: Tensor
) -> OnlineState:
    """Write refreshed readouts ``Wt`` (R, Ny, s) into slot rows ``rows``
    where ``eligible_rows`` (R,) holds; everything else (and every leaf but
    W and b) is untouched.  ``rows`` must be duplicate-free: an ineligible
    row writes its own current value back."""
    rows = rows.to(torch.int64)
    W, b = state.params.W, state.params.b
    W_rows = torch.where(eligible_rows[:, None, None], Wt[..., :, :-1],
                         W[rows])
    b_rows = torch.where(eligible_rows[:, None], Wt[..., :, -1], b[rows])
    params = dataclasses.replace(
        state.params,
        W=W.index_copy(0, rows, W_rows),
        b=b.index_copy(0, rows, b_rows),
    )
    return dataclasses.replace(state, params=params)


def refresh_output_rows(
    state: OnlineState, beta, rows: Tensor, eligible_rows: Tensor
) -> OnlineState:
    """Recompute-mode cohort refresh: gather the due rows, run the batched
    (s, s) Cholesky over just those, scatter the refreshed readouts back.
    With ``rows = arange(S)`` and all rows eligible this is
    ``refresh_output_batched``."""
    idx = rows.to(torch.int64)
    Wt = ridge.ridge_cholesky_batched(
        state.ridge.A[idx], ridge.regularize(state.ridge.B[idx], beta))
    return scatter_readout_rows(state, Wt, eligible_rows, rows)
