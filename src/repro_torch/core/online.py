"""Online training + inference (paper Sec. 3.1), in PyTorch.

The counterpart of the parts of ``repro.core.online`` the port runs:

* the stream server's path: the ``OnlineState`` carry, the fused serve step
  (infer-before-update plus truncated-BP SGD plus (A, B) accumulation from
  ONE forward pass), the Ridge refresh of selected slot rows in both modes
  (recompute: a batched Cholesky; incremental: two triangular solves
  against the live factor), the int8 serving scale fold, the forgetting
  factor of ``retirement='forget'`` and the drift detector of
  ``retirement='adaptive'`` (``adaptive_anneal``).  The reference
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
    moves them; otherwise they stay zeros).  ``loss_fast``/``loss_slow`` are
    the drift detector's fast and slow EMAs of the serving error
    (``adaptive_anneal``); they stay zeros outside ``retirement='adaptive'``.
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
    one for the restarted statistics.

    ``forget`` (exclusive with ``factor_beta``) is the soft reset: (A, B)
    and ``factor_beta`` scale by lambda and a live factor by sqrt(lambda),
    so ``Lt^T Lt == B + factor_beta I`` keeps holding, instead of zeroing.
    ``forget=1.0`` changes no bit; ``count`` keeps the number of folded
    samples either way."""
    if forget is not None and factor_beta is not None:
        raise ValueError(
            "reset_statistics: factor_beta (hard reset re-seed) and forget "
            "(soft decaying reset) are exclusive - the soft reset keeps the "
            "existing decayed prior")
    if forget is not None:
        lam_value = float(forget)
        if not 0.0 < lam_value <= 1.0:
            # lambda = 0 would zero the live factor, and the next fold
            # divides by its zero diagonal
            raise ValueError(f"forget must be in (0, 1], got {lam_value!r}")
        rs = state.ridge
        lam = torch.as_tensor(forget, dtype=rs.B.dtype, device=rs.B.device)
        return dataclasses.replace(state, ridge=RidgeState(
            A=rs.A * lam, B=rs.B * lam, count=rs.count,
            Lt=rs.Lt * torch.sqrt(lam), factor_beta=rs.factor_beta * lam))
    rs = map_leaves(torch.zeros_like, state.ridge)
    if factor_beta is not None:
        s = rs.B.shape[-1]
        rs = dataclasses.replace(
            rs, Lt=ridge.seed_factor(s, factor_beta, rs.B.dtype,
                                     rs.B.device),
            factor_beta=torch.tensor(factor_beta, dtype=rs.B.dtype,
                                     device=rs.B.device))
    return dataclasses.replace(state, ridge=rs)


# retirement='adaptive': the drift detector's rates, per serving step (the
# reference's values).  The fast EMA of a slot's serving error tracks the
# current regime; the slow one is the baseline, which follows improvements
# quickly and degradations slowly, so at a drift point it stays near the
# pre-drift error while the fast EMA rises.  A slot trips when fast >
# ratio * slow + ADAPT_MARGIN; the margin keeps a near-perfect slot from
# tripping on one stray miss.  _ADAPT_EPS floors the slow EMA once it is
# seeded, so slow == 0 marks a slot not yet seeded.
ADAPT_FAST_ALPHA = 0.3
ADAPT_SLOW_ALPHA_DOWN = 0.15
ADAPT_SLOW_ALPHA_UP = 0.01
ADAPT_MARGIN = 0.25
_ADAPT_EPS = 1e-6


def adaptive_detect(
    loss_fast: Tensor,   # (S,) fast EMA of the serving error
    loss_slow: Tensor,   # (S,) slow EMA (0: not seeded yet)
    step_err: Tensor,    # (S,) this step's serving error rate (1 - acc)
    update: Tensor,      # (S,) bool: the slot folded live frozen samples
    armed: Tensor,       # (S,) bool: the slot is past its warm-up
    ratio: float,
    forget,              # lambda applied to a tripped slot
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The detector half of ``adaptive_anneal``: the new (fast, slow) EMAs,
    the (S,) trips and the per-slot anneal factor ``lam`` (``forget`` where
    a slot trips, exactly 1.0 elsewhere).  EMAs move only where ``update``
    is set; the first such step seeds both with the observed error; a trip
    snaps the slow EMA to the fast one, re-arming the detector."""
    init = update & (loss_slow <= 0)
    fa = ADAPT_FAST_ALPHA
    sa = torch.where(step_err <= loss_slow,
                     torch.full_like(loss_slow, ADAPT_SLOW_ALPHA_DOWN),
                     torch.full_like(loss_slow, ADAPT_SLOW_ALPHA_UP))
    fast = torch.where(init, step_err, torch.where(
        update, (1.0 - fa) * loss_fast + fa * step_err, loss_fast))
    slow = torch.where(init, step_err, torch.where(
        update, (1.0 - sa) * loss_slow + sa * step_err, loss_slow))
    slow = torch.where(update, torch.clamp(slow, min=_ADAPT_EPS), slow)
    trip = update & armed & ~init & (fast > ratio * slow + ADAPT_MARGIN)
    lam = torch.where(trip, torch.as_tensor(forget, dtype=fast.dtype,
                                            device=fast.device),
                      torch.ones_like(fast))
    slow = torch.where(trip, fast, slow)
    return fast, slow, trip, lam


def anneal_ridge_(rs: RidgeState, lam: Tensor) -> None:
    """Scale slot rows of ``rs`` in place by the (S,) factors ``lam``:
    (A, B) and ``factor_beta`` by lam, the live factor by sqrt(lam), the
    ``reset_statistics(forget=...)`` contract per slot.  A factor of 1.0
    changes no bit."""
    lam3 = lam[:, None, None]
    rs.A.mul_(lam3)
    rs.B.mul_(lam3)
    rs.Lt.mul_(torch.sqrt(lam)[:, None, None])
    rs.factor_beta.mul_(lam)


def adaptive_anneal(
    states: OnlineState,
    step_err: Tensor,    # (S,) this step's serving error rate (1 - acc)
    update: Tensor,      # (S,) bool: slot folded live frozen-phase samples
    armed: Tensor,       # (S,) bool: slot past its detector warm-up
    ratio: float,
    forget,              # lambda in (0, 1] applied to a tripped slot
) -> Tuple[OnlineState, Tensor]:
    """Per-slot drift detection and soft statistics anneal over the slot
    axis: ``adaptive_detect``, then each tripped slot's statistics annealed
    by its ``lam`` (``anneal_ridge_`` on copies).  Returns (new states,
    trips).  The reference gates the anneal on any trip; a slot that does
    not trip scales by exactly 1.0 here, which changes no bit, so a silent
    step moves only the two detector leaves either way."""
    fast, slow, trip, lam = adaptive_detect(
        states.loss_fast, states.loss_slow, step_err, update, armed, ratio,
        forget)
    rs = map_leaves(torch.clone, states.ridge)
    anneal_ridge_(rs, lam)
    return dataclasses.replace(states, ridge=rs, loss_fast=fast,
                               loss_slow=slow), trip


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
    forget: Optional[Tensor] = None,
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

    ``forget`` (None, or a scalar lambda in (0, 1]) is the forgetting
    factor of ``retirement='forget'``: before each accumulated sample's
    fold, (A, B) scale by lambda and the live factor by sqrt(lambda), the
    exponentially weighted recursion B <- lambda B + r~ r~^T.  The window's
    rows carry lambda^(suffix/2) on each factor of their outer product
    (suffix: live rows folded after the row), the carried (A, B) decay by
    lambda^m (m live rows), and ``factor_beta`` decays with the data under
    ``'defer'``, so Lt^T Lt == B + factor_beta I keeps holding.  Under
    ``'defer'`` the per-row factor scales (sqrt(lambda) on live rows,
    exactly 1.0 on gated ones) are ``metrics['fold_scale']``, for the
    caller's fold.  ``forget=1.0`` serves ``forget=None`` bit for bit.
    Returns (new state, logits (*P, B, Ny), metrics).  The input state is not
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
    rt_acc, oh_acc, decay, fold_scale = rt, onehot, None, None
    if forget is not None:
        lam = torch.as_tensor(forget, dtype=dt, device=rt.device)
        # suffix: live rows folded after each row
        suffix = torch.flip(torch.cumsum(torch.flip(live, (-1,)), -1),
                            (-1,)) - live
        half = lam ** (0.5 * suffix)
        rt_acc = rt * half[..., None]
        oh_acc = onehot * half[..., None]
        decay = lam ** live.sum(dim=-1)
        fold_scale = torch.where(live > 0, torch.sqrt(lam),
                                 torch.ones_like(live))
    A, B = ridge.accumulate_ab(state.ridge.A, state.ridge.B, rt_acc, oh_acc,
                               in_place=accumulate_in_place, decay=decay)
    moved = acc * n_w
    fb = state.ridge.factor_beta
    if maintain_factor != "defer":
        # statistics move without rotating a factor: drop any live one
        fb = torch.where(moved > 0, torch.zeros_like(fb), fb)
    elif decay is not None:
        # the prior decays with the data
        fb = fb * decay
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
        if fold_scale is not None:
            metrics["fold_scale"] = fold_scale
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
