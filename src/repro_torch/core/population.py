"""Population-parallel DFR hyperparameter engine, in PyTorch.

The counterpart of ``repro.core.population``.  The paper replaces offline
grid search with truncated-BP gradient descent on (p, q); its companion work
(arXiv:2504.12363) finds the loss landscape multi-modal, so this engine runs
a population of K candidates at once:

  1. ``grid_candidates``     - grid-seeded (p, q) starts (Sec. 4.1's box).
  2. ``evaluate_population`` - every member's DPRR features from ONE launch
                               of K1 per split (``kernels.ops.train_forward``
                               with the member axis leading and per-member
                               (p, q)), then the ridge readout over the beta
                               sweep: per-beta batched (s, s) Cholesky solves
                               ('primal'), or one factorization of the
                               (B, B) kernel matrices over the whole (beta,
                               member) sweep ('dual'), and each member's NRMSE
                               and accuracy on a held-out split.
  3. ``refine_population``   - every member's truncated-BP SGD as one
                               system axis: one K1 launch a minibatch step
                               for the whole population
                               (``backprop.grads_truncated_fused``).
  4. ``cull_population``     - rank selection and CMA-ES-style re-seeding
                               (``core.candidates``).
  5. ``train_population``    - the round driver (evaluate -> cull -> refine
                               -> evaluate), elitist: the best member ever
                               evaluated is returned.

Fitness is the NRMSE of the ridge-refit readout on the evaluation split,
``sqrt(mean((pred - y)^2) / var(y))``; classification targets are one-hot
rows and accuracy is computed too (``select='acc'`` reproduces the serial
grid search's ranking).  ``DFRParams`` is the population container, every
leaf leading with K.  The features take K * B * s floats a split, and K1
reads the masked inputs expanded over the K members, K * B * T * Nx floats:
size the population to the card.

The reference evaluates the features with the plain scan; K1 computes the
same r with its sums in another order.  The reference's random cull draws
from ``jax.random``; here from a ``torch.Generator`` seeded by ``seed``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backprop, dprr, masking, ridge
from repro_torch.core.candidates import (  # noqa: F401  (re-exported)
    P_LOG_RANGE, Q_LOG_RANGE, cull_population, grid_candidates, grid_points,
    init_population)
from repro_torch.core.types import (DFRConfig, DFRParams, Tensor,
                                    TimeSeriesBatch, resolve_device)


# ---------------------------------------------------------------------------
# Evaluation: features -> batched ridge -> NRMSE/accuracy
# ---------------------------------------------------------------------------


class PopulationEval(NamedTuple):
    """Per-member evaluation at each member's best beta."""

    nrmse: Tensor      # (K,) eval-split NRMSE
    acc: Tensor        # (K,) eval-split argmax accuracy (degenerate, Ny=1)
    beta_idx: Tensor   # (K,) int32 index into cfg.betas
    Wt: Tensor         # (K, Ny, s) ridge readout [W | b]
    nrmse_all: Tensor  # (K, n_beta) the full sweep
    acc_all: Tensor    # (K, n_beta)


def population_features(cfg: DFRConfig, mask: Tensor, ps: Tensor,
                        qs: Tensor, u: Tensor, lengths: Tensor) -> Tensor:
    """r~ (K, B, s) of K members on one split: the masked inputs expanded
    over the member axis, one K1 launch (its plain version on the CPU)."""
    from repro_torch.kernels import ops as kops  # kernels import core

    j = masking.apply_mask(mask, u)                       # (B, T, Nx)
    k = ps.shape[0]
    r = kops.train_forward(j.expand(k, *j.shape),
                           lengths.expand(k, *lengths.shape), ps, qs,
                           cfg.n_nodes, f=cfg.f())[0]
    return dprr.r_tilde(r)


@torch.no_grad()
def evaluate_population(
    cfg: DFRConfig,
    mask: Tensor,
    ps: Tensor,
    qs: Tensor,
    train_u: Tensor,
    train_len: Tensor,
    y_train: Tensor,
    eval_u: Tensor,
    eval_len: Tensor,
    y_eval: Tensor,
    select: str = "nrmse",
    ridge_method: str = "cholesky_blocked",
    solver: str = "auto",
) -> PopulationEval:
    """Evaluate K (p, q) candidates.

    y_train (B, Ny) are the targets (one-hot rows for classification),
    y_eval (Be, Ny).  ``select`` picks each member's beta by 'nrmse' (lower
    wins) or 'acc' (higher wins); ties keep the earliest beta of cfg.betas,
    as the serial grid search does.

    ``solver``:
      * 'primal' - per-beta batched Cholesky of B = R~^T R~ + beta I (s, s)
        (``ridge.ridge_solve_batched``): the serial grid search's
        formulation, so rankings agree with it wherever the factorization
        is numerically healthy.
      * 'dual'   - W~ = Y^T (R~ R~^T + beta I)^-1 R~, one batched
        factorization of the (B, B) systems over the whole (beta, member)
        sweep: the same solution when B >= rank, better conditioned and
        cheaper when B < s.
      * 'auto'   - 'dual' when the train split has fewer samples than s.
    Both solve with ``ridge.cholesky_or_nan`` and two triangular solves;
    a system that is not positive definite gives NaN, hence an infinite
    NRMSE.
    """
    rt_train = population_features(cfg, mask, ps, qs, train_u, train_len)
    rt_eval = population_features(cfg, mask, ps, qs, eval_u, eval_len)
    k, n_train, s = rt_train.shape
    n_beta = len(cfg.betas)
    dev, dt = rt_train.device, rt_train.dtype
    betas = torch.tensor(cfg.betas, dtype=dt, device=dev)
    y_train = y_train.to(dt)
    y_eval = y_eval.to(dt)
    use_dual = solver == "dual" or (solver == "auto" and n_train < s)

    if use_dual:
        gram = rt_train @ rt_train.mT                       # (K, B, B)
        eye = torch.eye(n_train, dtype=dt, device=dev)
        G = gram[None] + betas[:, None, None, None] * eye   # (nb, K, B, B)
        C = ridge.cholesky_or_nan(G.reshape(n_beta * k, n_train, n_train))
        Yt = y_train.T.expand(n_beta * k, *y_train.T.shape)
        # X^T = Y^T G^-1, X the dual coefficients (B, Ny)
        Xt = ridge.ridge_solve_from_factor_t_batched(Yt, C.mT)
        Wt_all = Xt.reshape(n_beta, k, -1, n_train) @ rt_train  # (nb,K,Ny,s)
    else:
        A = y_train.T @ rt_train                            # (K, Ny, s)
        Bmat = rt_train.mT @ rt_train                       # (K, s, s)
        Wt_all = torch.stack([
            ridge.ridge_solve_batched(A, ridge.regularize(Bmat, beta),
                                      ridge_method)
            for beta in betas])

    pred = rt_eval @ Wt_all.mT                              # (nb, K, Be, Ny)
    var = torch.mean(torch.square(y_eval - y_eval.mean())) + 1e-12
    err = pred - y_eval
    nrmse = torch.sqrt(torch.mean(err * err, dim=(2, 3)) / var)   # (nb, K)
    nrmse = torch.where(torch.isfinite(nrmse), nrmse,
                        torch.full((), float("inf"), dtype=dt, device=dev))
    hits = pred.argmax(dim=-1) == y_eval.argmax(dim=-1)
    acc = hits.to(torch.float32).mean(dim=2)                # (nb, K)

    # argmax/argmin keep the earliest beta on ties
    beta_idx = (acc.argmax(dim=0) if select == "acc"
                else nrmse.argmin(dim=0)).to(torch.int32)   # (K,)
    rows = beta_idx.to(torch.int64)
    ar = torch.arange(k, device=dev)
    return PopulationEval(
        nrmse=nrmse[rows, ar],
        acc=acc[rows, ar],
        beta_idx=beta_idx,
        Wt=Wt_all[rows, ar],
        nrmse_all=nrmse.T,
        acc_all=acc.T,
    )


# ---------------------------------------------------------------------------
# Truncated-BP refinement, the member axis as one system axis
# ---------------------------------------------------------------------------


def _member(pop: DFRParams, i: int) -> DFRParams:
    return DFRParams(p=pop.p[i], q=pop.q[i], W=pop.W[i], b=pop.b[i])


def refine_population(
    cfg: DFRConfig,
    mask: Tensor,
    pop: DFRParams,
    u: Tensor,
    lengths: Tensor,
    y: Tensor,
    lr_res,
    lr_out,
    steps: int = 1,
    minibatch: int = 4,
    loss: str = "ce",
    fused: bool = True,
) -> Tuple[DFRParams, Tensor]:
    """``steps`` epochs of truncated-BP SGD on every member at once.

    All members see the same minibatch schedule.  Returns (refined
    population, (K,) final-epoch mean loss).

    ``fused=True`` runs each SGD step for the whole population through
    ``backprop.grads_truncated_fused``: one K1 launch over the minibatch
    expanded on the member axis, with the closed-form truncated backward.
    ``fused=False`` keeps the stored-states path (``backprop.
    grads_truncated``, K6 and K7 on the card), a member at a time: the same
    gradients up to the sums' order.  The minibatch loop is a Python loop,
    as ``DFRModel.fit_sgd``'s.
    """
    if steps == 0:
        return pop, torch.zeros(pop.p.shape, dtype=pop.p.dtype,
                                device=pop.p.device)
    f = cfg.f()
    loss_fn = backprop.loss_from_logits if loss == "ce" else backprop.loss_mse
    k = pop.p.shape[0]
    mb = min(minibatch, u.shape[0])
    n = u.shape[0] // mb * mb
    params = pop
    epoch_loss = None
    for _ in range(steps):
        losses = []
        for lo in range(0, n, mb):
            ub, lb, yb = u[lo:lo + mb], lengths[lo:lo + mb], y[lo:lo + mb]
            j_seq = masking.apply_mask(mask, ub)
            if fused:
                l, g = backprop.grads_truncated_fused(
                    params, j_seq.expand(k, *j_seq.shape),
                    yb.expand(k, *yb.shape), f,
                    lengths=lb.expand(k, *lb.shape), loss_fn=loss_fn)
            else:
                per = [backprop.grads_truncated(_member(params, i), j_seq, yb,
                                                f, lengths=lb,
                                                loss_fn=loss_fn)
                       for i in range(k)]
                l = torch.stack([lg[0] for lg in per])
                g = DFRParams(*(torch.stack([getattr(lg[1], name)
                                             for lg in per])
                                for name in ("p", "q", "W", "b")))
            params = backprop.apply_sgd(params, g, lr_res, lr_out,
                                        inv_batch=1.0 / mb)
            losses.append(l / mb)
        epoch_loss = torch.stack(losses).mean(dim=0)
    return params, epoch_loss


# ---------------------------------------------------------------------------
# Round driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PopulationResult:
    """Outcome of a population search (elitist: the best member ever
    evaluated, so never worse than the best grid seed)."""

    best_params: DFRParams  # one member; (W, b) the ridge readout
    best_nrmse: float
    best_acc: float
    best_beta: float
    best_p: float
    best_q: float
    history: List[dict]
    population: DFRParams   # final stacked population
    final_eval: PopulationEval
    time_s: float


def _load_readout(pop: DFRParams, Wt: Tensor) -> DFRParams:
    """Fold each member's ridge solution into its (W, b), so refinement
    starts from the solved readout."""
    return DFRParams(p=pop.p, q=pop.q, W=Wt[..., :-1], b=Wt[..., -1])


def _best_member(pop: DFRParams, ev: PopulationEval, cfg: DFRConfig,
                 select: str) -> dict:
    acc = ev.acc.cpu().numpy()
    nrmse = ev.nrmse.cpu().numpy()
    metric = acc if select == "acc" else -nrmse
    bi = int(np.argmax(metric))
    params = DFRParams(p=pop.p[bi], q=pop.q[bi], W=ev.Wt[bi, :, :-1],
                       b=ev.Wt[bi, :, -1])
    return {
        "metric": float(metric[bi]),
        "params": params,
        "nrmse": float(nrmse[bi]),
        "acc": float(acc[bi]),
        "beta": float(cfg.betas[int(ev.beta_idx[bi])]),
        "p": float(pop.p[bi]),
        "q": float(pop.q[bi]),
    }


def _as_tensor(x, device, dtype=None) -> Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def train_population(
    cfg: DFRConfig,
    train_u,
    train_len,
    y_train,
    eval_u,
    eval_len,
    y_eval,
    *,
    divs: int = 4,
    rounds: int = 1,
    steps_per_round: int = 1,
    minibatch: int = 4,
    survive_frac: float = 0.5,
    jitter: float = 0.15,
    task: str = "classification",
    select: Optional[str] = None,
    lr: Optional[float] = None,
    solver: str = "auto",
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
    mask: Optional[Tensor] = None,
    seed: int = 0,
    device=None,
) -> PopulationResult:
    """Grid-seed K = divs^2 members, then ``rounds`` of (cull -> truncated-BP
    refine -> ridge re-evaluate), returning the best member ever evaluated.

    ``rounds=0`` is a pure grid search.  The round's learning rate anneals
    as lr * 0.1^round; ``lr`` defaults to cfg.lr for classification and to
    0.3 * cfg.lr for regression, whose unnormalized MSE gradient runs much
    hotter than cross-entropy's.  The cull draws from a ``torch.Generator``
    seeded by ``seed``.  The data (numpy arrays or tensors) moves to
    ``device``: the CUDA device unless the caller names another.  ``mask``
    defaults to one drawn from a generator seeded by ``cfg.mask_seed``
    (which cannot replay the reference's ``jax.random`` mask).
    """
    if task not in ("classification", "regression"):
        raise ValueError(f"unknown task: {task}")
    dev = resolve_device(device, "train_population")
    if select is None:
        select = "acc" if task == "classification" else "nrmse"
    loss = "ce" if task == "classification" else "mse"
    if lr is None:
        lr = cfg.lr if task == "classification" else 0.3 * cfg.lr
    if mask is None:
        mask = masking.make_mask(
            torch.Generator().manual_seed(cfg.mask_seed), cfg.n_nodes,
            cfg.n_in, cfg.dtype)
    mask = _as_tensor(mask, dev, cfg.dtype)
    train_u, eval_u = (_as_tensor(x, dev, cfg.dtype) for x in (train_u,
                                                               eval_u))
    y_train, y_eval = (_as_tensor(x, dev, cfg.dtype) for x in (y_train,
                                                               y_eval))
    train_len, eval_len = (_as_tensor(x, dev) for x in (train_len, eval_len))

    t0 = time.perf_counter()
    ps, qs = grid_candidates(divs, p_range, q_range, cfg.dtype, dev)
    pop = init_population(cfg, ps, qs)
    gen = torch.Generator().manual_seed(seed)

    def ev_pop(pop):
        return evaluate_population(
            cfg, mask, pop.p, pop.q, train_u, train_len, y_train,
            eval_u, eval_len, y_eval, select=select, solver=solver)

    ev = ev_pop(pop)
    elite = _best_member(pop, ev, cfg, select)
    history = [{
        "round": 0, "best_nrmse": elite["nrmse"], "best_acc": elite["acc"],
        "mean_nrmse": float(ev.nrmse.mean()), "refine_loss": None,
    }]

    for r in range(rounds):
        fitness = -ev.acc if select == "acc" else ev.nrmse
        pop = cull_population(
            _load_readout(pop, ev.Wt), fitness, gen,
            survive_frac=survive_frac, jitter=jitter,
            p_range=p_range, q_range=q_range)
        lr_r = torch.tensor(lr * (0.1 ** r), dtype=cfg.dtype, device=dev)
        pop, losses = refine_population(
            cfg, mask, pop, train_u, train_len, y_train, lr_r, lr_r,
            steps=steps_per_round, minibatch=minibatch, loss=loss)
        ev = ev_pop(pop)
        cand = _best_member(pop, ev, cfg, select)
        if cand["metric"] > elite["metric"]:
            elite = cand
        history.append({
            "round": r + 1, "best_nrmse": elite["nrmse"],
            "best_acc": elite["acc"],
            "mean_nrmse": float(ev.nrmse.mean()),
            "refine_loss": float(losses.mean()),
        })

    return PopulationResult(
        best_params=elite["params"],
        best_nrmse=elite["nrmse"],
        best_acc=elite["acc"],
        best_beta=elite["beta"],
        best_p=elite["p"],
        best_q=elite["q"],
        history=history,
        population=pop,
        final_eval=ev,
        time_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Batch-type conveniences
# ---------------------------------------------------------------------------


def _one_hot(label, n_classes: int, dtype) -> Tensor:
    label = _as_tensor(label, None).to(torch.int64)
    return torch.nn.functional.one_hot(label, n_classes).to(dtype)


def train_population_classification(
    cfg: DFRConfig,
    train: TimeSeriesBatch,
    evalb: TimeSeriesBatch,
    **kwargs,
) -> PopulationResult:
    """Population search on a labeled batch pair (one-hot targets)."""
    return train_population(
        cfg, train.u, train.length,
        _one_hot(train.label, cfg.n_classes, cfg.dtype),
        evalb.u, evalb.length,
        _one_hot(evalb.label, cfg.n_classes, cfg.dtype),
        task="classification", **kwargs)


def train_population_regression(cfg: DFRConfig, train, evalb,
                                **kwargs) -> PopulationResult:
    """Population search on a regression batch pair (``data.
    RegressionBatch``: u, length, y), NRMSE fitness."""
    return train_population(
        cfg, train.u, train.length, train.y, evalb.u, evalb.length, evalb.y,
        task="regression", **kwargs)
