"""Online training + inference (paper Sec. 3.1), in PyTorch.

The counterpart of the parts of ``repro.core.online`` the port runs:

* the stream server's path: the ``OnlineState`` carry, the fused serve step
  (infer-before-update plus truncated-BP SGD plus (A, B) accumulation from
  ONE forward pass), the Ridge refresh of selected slot rows in both modes
  (recompute: a batched Cholesky; incremental: two triangular solves
  against the live factor) and the int8 serving scale fold.  The reference
  writes these for one system and ``vmap``s them over the server's slot
  axis; here they take the slot-batched state directly (each leaf leads
  with the slot axes *P, and the data with the same axes).  Slots never
  mix.
* the single-stream edge loop ``OnlineDFR`` and its functions
  (``online_logits``, ``online_infer``, ``online_step``,
  ``refresh_output``, ``reset_statistics``) on one unbatched state, with
  the features from K6 and K7 and the full refresh from the blocked ridge
  solve (K4a, K4b) on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import backprop, dprr, masking, ridge
from repro_torch.core.types import (DFRConfig, DFRParams, QuantParams,
                                    RidgeState, Tensor, map_leaves,
                                    resolve_device, unported)


@dataclasses.dataclass
class OnlineState:
    """Carry of the online system; leaves may lead with slot axes.

    ``quant`` holds the int8 serving codes and scales (``quantize='int8'``
    moves them; otherwise they stay zeros).  The drift-detector EMAs
    ``loss_fast``/``loss_slow`` are inert zeros in this port: the retirement
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


def init_state(cfg: DFRConfig, device=None,
               factor_beta: Optional[float] = None) -> OnlineState:
    """Fresh single-system state: paper init (p, q), zero readout + stats.

    With ``factor_beta`` the state also carries a live incremental factor
    of the empty system (``ridge.seed_factor``: sqrt(beta) I), the
    incremental refresh's starting point."""
    zero = torch.zeros((), dtype=cfg.dtype, device=device)
    rs = RidgeState.zeros(cfg.s, cfg.n_classes, cfg.dtype, device)
    if factor_beta is not None:
        rs = dataclasses.replace(
            rs, Lt=ridge.seed_factor(cfg.s, factor_beta, cfg.dtype, device),
            factor_beta=torch.tensor(factor_beta, dtype=cfg.dtype,
                                     device=device))
    return OnlineState(
        params=DFRParams.init(cfg, device),
        ridge=rs,
        step=torch.zeros((), dtype=torch.int32, device=device),
        loss_ema=zero.clone(),
        quant=QuantParams.zeros(cfg.n_classes, cfg.n_rep, device),
        loss_fast=zero.clone(),
        loss_slow=zero.clone(),
    )


def reset_statistics(state: OnlineState,
                     factor_beta: Optional[float] = None,
                     forget=None) -> OnlineState:
    """Zero the Ridge sufficient statistics, keeping (p, q, W, b) and the
    step counter: the phase switch of the paper's protocol.  The zeroed
    ``factor_beta`` drops any live factor; pass ``factor_beta`` to re-seed
    one for the restarted statistics.  The soft reset (``forget``) is not
    ported yet."""
    if forget is not None:
        raise unported("reset_statistics(forget=...)", "Retirement modes")
    rs = map_leaves(torch.zeros_like, state.ridge)
    if factor_beta is not None:
        s = rs.B.shape[-1]
        rs = dataclasses.replace(
            rs, Lt=ridge.seed_factor(s, factor_beta, rs.B.dtype,
                                     rs.B.device),
            factor_beta=torch.tensor(factor_beta, dtype=rs.B.dtype,
                                     device=rs.B.device))
    return dataclasses.replace(state, ridge=rs)


def _features(cfg: DFRConfig, params: DFRParams, j_seq: Tensor,
              length: Tensor) -> Tensor:
    """DPRR r (B, Nr) of one system through K6 and K7."""
    from repro_torch.kernels import ops as kops  # kernels import core

    nx = cfg.n_nodes
    x = kops.reservoir_states(j_seq, length, params.p, params.q, nx,
                              f=cfg.f())
    return kops.dprr_features(x, length, nx)


@torch.no_grad()
def online_logits(
    cfg: DFRConfig,
    mask: Tensor,
    state: OnlineState,
    u: Tensor,        # (B, T, n_in)
    length: Tensor,   # (B,)
) -> Tensor:
    """Readout logits on a window: (B, Ny)."""
    j_seq = masking.apply_mask(mask, u)
    r = _features(cfg, state.params, j_seq, length)
    return r @ state.params.W.T + state.params.b


def online_infer(cfg: DFRConfig, mask: Tensor, state: OnlineState,
                 u: Tensor, length: Tensor) -> Tensor:
    """Inference on a window: class predictions (B,)."""
    return online_logits(cfg, mask, state, u, length).argmax(dim=-1)


def online_step(
    cfg: DFRConfig,
    mask: Tensor,
    state: OnlineState,
    u: Tensor,        # (B, T, n_in) window of streamed samples
    length: Tensor,   # (B,)
    label: Tensor,    # (B,) int
    lr_res,
    lr_out,
    axis_names: Sequence[str] = (),
    weight: Optional[Tensor] = None,
) -> Tuple[OnlineState, Dict[str, Tensor]]:
    """One online training step of one system: truncated-BP SGD update,
    then (A, B) accumulation with the updated reservoir parameters.

    ``weight`` is an optional (B,) 0/1 live-sample mask: dead samples add
    nothing to the loss, the grads, the statistics or the count.  The
    reduction over device axes (``axis_names``) is not ported yet.
    """
    if tuple(axis_names):
        raise unported("online_step(axis_names=...)", "Multi-device")
    f = cfg.f()
    j_seq = masking.apply_mask(mask, u)
    onehot = torch.nn.functional.one_hot(
        label.to(torch.int64), cfg.n_classes).to(cfg.dtype)
    if weight is None:
        loss_fn = backprop.loss_from_logits
        n_live = torch.tensor(float(u.shape[0]), dtype=cfg.dtype,
                              device=u.device)
    else:
        weight = weight.to(cfg.dtype)

        def loss_fn(lg, oh):
            return weight * backprop.loss_from_logits(lg, oh)

        n_live = weight.sum()
    loss, g = backprop.grads_truncated(state.params, j_seq, onehot, f,
                                       lengths=length, loss_fn=loss_fn)
    inv = 1.0 / torch.clamp(n_live, min=1.0)
    params = backprop.apply_sgd(state.params, g, lr_res, lr_out,
                                inv_batch=inv)
    # streaming sufficient statistics with the *updated* reservoir params
    r = _features(cfg, params, j_seq, length)
    rt = dprr.r_tilde(r)
    # 0/1 weights scale rt once: both the A contraction and the B outer
    # product (w^2 = w) drop dead samples exactly
    rt_acc = rt if weight is None else rt * weight[:, None]
    dA, dB = ridge.accumulate_ab(torch.zeros_like(state.ridge.A),
                                 torch.zeros_like(state.ridge.B), rt_acc,
                                 onehot)
    new = OnlineState(
        params=params,
        ridge=RidgeState(
            A=state.ridge.A + dA,
            B=state.ridge.B + dB,
            count=state.ridge.count + n_live.to(state.ridge.count.dtype),
            # B moved without rotating a factor: any live one is stale
            Lt=state.ridge.Lt,
            factor_beta=torch.zeros_like(state.ridge.factor_beta),
        ),
        step=state.step + 1,
        loss_ema=0.99 * state.loss_ema + 0.01 * loss * inv,
        quant=state.quant,
        loss_fast=state.loss_fast,
        loss_slow=state.loss_slow,
    )
    logits = r @ params.W.T + params.b
    hits = (logits.argmax(dim=-1) == label).to(torch.float32)
    if weight is not None:
        hits = hits * weight
    metrics = {"loss": loss * inv,
               "acc": hits.sum() / torch.clamp(n_live, min=1.0).to(
                   torch.float32)}
    return new, metrics


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
    maintain_factor=False,
    train: bool = True,
    track_state_absmax: bool = False,
    fused: bool = False,
    accumulate_in_place: bool = False,
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

    ``maintain_factor=False`` drops any live incremental factor once
    statistics move.  ``maintain_factor='defer'`` keeps it live without
    rotating it and returns the gated r~ rows (*P, B, s) as
    ``metrics['rt_rows']``; the caller folds them into ``Lt``
    (``kernels.ops.cholupdate_window_t``), as the stream server does after
    its liveness select.  Dead and phase-1 rows are zero, hence no-ops.
    (The reference's inline fold, ``True``, has no caller in the port.)

    ``track_state_absmax`` raises ``quant.x_absmax`` to the largest |x| of
    the window's live boundary states ``x_last``/``x_prev`` (weight-gated):
    the int8 state scale's calibration.

    ``forget=None`` always: the retirement modes are not ported.  Returns
    (new state, logits (*P, B, Ny), metrics).  The input state is not
    modified, except with ``accumulate_in_place``: the window's statistics
    are then added into ``state.ridge.A`` and ``.B`` themselves (same
    rounding), which the new state returns.  The stream server's captured
    round updates its (S, s, s) B so, with no copy of it.
    """
    if maintain_factor not in (False, "defer"):
        raise ValueError(f"maintain_factor must be False or 'defer', got "
                         f"{maintain_factor!r}")
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
    A, B = ridge.accumulate_ab(state.ridge.A, state.ridge.B, rt, onehot,
                               in_place=accumulate_in_place)
    moved = acc * n_w
    fb = state.ridge.factor_beta
    if maintain_factor != "defer":
        # statistics move without rotating a factor: drop any live one
        fb = torch.where(moved > 0, torch.zeros_like(fb), fb)
    quant = state.quant
    if track_state_absmax:
        wb = w[..., None]
        amax = torch.maximum((aux.x_last.abs() * wb).amax(dim=(-2, -1)),
                             (aux.x_prev.abs() * wb).amax(dim=(-2, -1)))
        quant = dataclasses.replace(quant, x_absmax=torch.maximum(
            quant.x_absmax, amax.to(quant.x_absmax.dtype)))
    new = OnlineState(
        params=params,
        ridge=RidgeState(
            A=A,
            B=B,
            count=state.ridge.count + moved.to(state.ridge.count.dtype),
            Lt=state.ridge.Lt,
            factor_beta=fb,
        ),
        step=state.step + 1,
        loss_ema=0.99 * state.loss_ema + 0.01 * loss * inv,
        quant=quant,
        loss_fast=state.loss_fast,
        loss_slow=state.loss_slow,
    )
    hits = (aux.logits.argmax(dim=-1) == label).to(torch.float32) * w
    metrics = {"loss": loss * inv, "acc": hits.sum(dim=-1) * inv}
    if maintain_factor == "defer":
        metrics["rt_rows"] = rt
    return new, aux.logits, metrics


def refresh_output(state: OnlineState, beta,
                   method: str = "cholesky_blocked") -> OnlineState:
    """Ridge re-solve of the output layer of one system from its streamed
    (A, B).  Fast path: with a live factor for exactly this ``beta``
    (``factor_beta``), two triangular solves against it; otherwise the full
    ``ridge.ridge_solve`` (on the card, the blocked solve through K4a and
    K4b), so a beta sweep over frozen statistics stays correct."""
    rs = state.ridge
    beta = torch.as_tensor(beta, dtype=rs.B.dtype, device=rs.B.device)
    if bool((rs.factor_beta > 0) & (rs.factor_beta == beta)):
        Wt = ridge.ridge_solve_from_factor_t(rs.A, rs.Lt)
    else:
        Wt = ridge.ridge_solve(rs.A, ridge.regularize(rs.B, beta), method)
    params = dataclasses.replace(state.params, W=Wt[:, :-1], b=Wt[:, -1])
    return dataclasses.replace(state, params=params)


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


def refresh_output_factor_rows(
    state: OnlineState, rows: Tensor, eligible_rows: Tensor
) -> OnlineState:
    """Incremental-mode cohort refresh: the due rows carry live factors of
    B + beta I (beta baked in at seeding), so the refresh is two triangular
    solves per slot, no factorization."""
    idx = rows.to(torch.int64)
    Wt = ridge.ridge_solve_from_factor_t_batched(
        state.ridge.A[idx], state.ridge.Lt[idx])
    return scatter_readout_rows(state, Wt, eligible_rows, rows)


def fold_quant_rows(
    state: OnlineState, rows: Tensor, eligible_rows: Tensor
) -> OnlineState:
    """Fold fresh int8 serving scales into slot rows ``rows`` where
    ``eligible_rows`` holds (the scatter contract of
    ``scatter_readout_rows``): ``Wq``/``w_scale`` from the freshly refreshed
    readout, ``x_scale`` from the running ``x_absmax``.  Runs at refresh
    boundaries, the only place W moves once a slot is frozen.  A positive
    ``w_scale`` arms the slot's int8 logits."""
    from repro_torch.kernels import ops as kops  # kernels import core

    q = state.quant
    idx = rows.to(torch.int64)
    el = eligible_rows
    W_rows = state.params.W[idx].to(torch.float32)          # (R, Ny, Nr)
    w_scale = kops.symmetric_scale(W_rows.abs().amax(dim=(-2, -1)))
    Wq = kops.quantize_symmetric(W_rows, w_scale[:, None, None])
    x_scale = kops.symmetric_scale(q.x_absmax[idx])
    quant = QuantParams(
        Wq=q.Wq.index_copy(0, idx, torch.where(el[:, None, None], Wq,
                                               q.Wq[idx])),
        w_scale=q.w_scale.index_copy(0, idx, torch.where(el, w_scale,
                                                         q.w_scale[idx])),
        x_scale=q.x_scale.index_copy(0, idx, torch.where(el, x_scale,
                                                         q.x_scale[idx])),
        x_absmax=q.x_absmax,
    )
    return dataclasses.replace(state, quant=quant)


# ---------------------------------------------------------------------------
# Single-stream wrapper (the paper's one-device system)
# ---------------------------------------------------------------------------


class OnlineDFR:
    """Online train/infer stepper for one stream, windows of a fixed length.

    Runs on the CUDA device unless ``device`` names another (the CPU for
    tests); without a CUDA device the default raises.  ``mask`` defaults to
    one drawn from a ``torch.Generator`` seeded by ``cfg.mask_seed``, which
    cannot replay the reference's ``jax.random`` mask: pass that one in to
    reproduce a reference system.
    """

    def __init__(self, cfg: DFRConfig, mask: Optional[Tensor] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device, "OnlineDFR")
        if mask is None:
            mask = masking.make_mask(
                torch.Generator().manual_seed(cfg.mask_seed), cfg.n_nodes,
                cfg.n_in, cfg.dtype)
        self.mask = torch.as_tensor(mask).to(self.device, cfg.dtype)

    def _dev(self, t) -> Tensor:
        return torch.as_tensor(t).to(self.device)

    def init(self) -> OnlineState:
        return init_state(self.cfg, self.device)

    def step(self, state: OnlineState, u, length, label, lr_res, lr_out,
             axis_names: Sequence[str] = ()
             ) -> Tuple[OnlineState, Dict[str, Tensor]]:
        """One online training step: SGD update + (A, B) accumulation."""
        return online_step(self.cfg, self.mask, state,
                           self._dev(u).to(self.cfg.dtype), self._dev(length),
                           self._dev(label), lr_res, lr_out,
                           axis_names=axis_names)

    def infer(self, state: OnlineState, u, length) -> Tensor:
        """Inference on a window: class predictions (B,)."""
        return online_infer(self.cfg, self.mask, state,
                            self._dev(u).to(self.cfg.dtype),
                            self._dev(length))

    def refresh_output(self, state: OnlineState, beta,
                       method: str = "cholesky_blocked") -> OnlineState:
        """Ridge re-solve of the output layer from the streamed (A, B)."""
        return refresh_output(state, beta, method)

    def reset_statistics(self, state: OnlineState) -> OnlineState:
        """Restart the (A, B) accumulation (phase switch)."""
        return reset_statistics(state)
