"""Grid search over (p, q, beta) - the paper's baseline optimizer (Sec. 4.1),
in PyTorch.

The counterpart of ``repro.core.grid_search``.  Ranges (paper): p in
[10^-3.75, 10^-0.25], q in [10^-2.75, 10^-0.25], each divided into ``divs``
equidistant points in log space; beta sweeps ``cfg.betas``.

``grid_search`` evaluates all K = divs^2 candidates at once through the
population engine (``core.population.evaluate_population``: the features
of every member from one K1 launch a split, primal batched solves).
``grid_search_serial`` is the per-candidate loop, the honest serial
baseline: each (p, q) gets its features from K6 and K7
(``kernels.ops.reservoir_states``, ``dprr_features``), as ``DFRModel``
computes them, and its readouts from the blocked ridge solve (K4a, K4b on
the card).  The two searches therefore also hold the two feature routes
against each other.  ``grid_search_until`` is the paper's protocol: grow
``divs`` from 1 until the accuracy reaches a target.

Each result dict also carries ``acc_all``, the (K, n_beta) test-accuracy
table in candidate order, which the reference's dicts do not.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backprop, dprr, masking, population, ridge
from repro_torch.core.candidates import (  # noqa: F401  (re-exported)
    P_LOG_RANGE, Q_LOG_RANGE, grid_points)
from repro_torch.core.types import (DFRConfig, Tensor, TimeSeriesBatch,
                                    resolve_device)


def _one_hot(label: Tensor, cfg: DFRConfig) -> Tensor:
    return torch.nn.functional.one_hot(label.to(torch.int64),
                                       cfg.n_classes).to(cfg.dtype)


@torch.no_grad()
def _eval_pq(
    cfg: DFRConfig,
    mask: Tensor,
    p: Tensor,
    q: Tensor,
    train: TimeSeriesBatch,
    test: TimeSeriesBatch,
    betas: Tuple[float, ...],
) -> Tuple[Tensor, Tensor]:
    """Accuracy (test) and loss (train) for one (p, q) across all betas,
    the features through K6 and K7."""
    from repro_torch.kernels import ops as kops  # kernels import core

    f, nx = cfg.f(), cfg.n_nodes

    def feats(batch: TimeSeriesBatch) -> Tensor:
        j_seq = masking.apply_mask(mask, batch.u)
        x = kops.reservoir_states(j_seq, batch.length, p, q, nx, f=f)
        return kops.dprr_features(x, batch.length, nx)

    r_train = feats(train)
    r_test = feats(test)
    rt = dprr.r_tilde(r_train)
    onehot = _one_hot(train.label, cfg)
    A = onehot.T @ rt
    B = rt.T @ rt

    accs, losses = [], []
    for beta in betas:
        Wt = ridge.ridge_cholesky_blocked(A, ridge.regularize(B, beta))
        W, b = Wt[:, :-1], Wt[:, -1]
        logits_test = r_test @ W.T + b
        accs.append((logits_test.argmax(dim=-1) == test.label).to(
            torch.float32).mean())
        logits_train = r_train @ W.T + b
        losses.append(backprop.loss_from_logits(logits_train, onehot).mean())
    return torch.stack(accs), torch.stack(losses)


def _on_device(batch: TimeSeriesBatch, cfg: DFRConfig,
               device: torch.device) -> TimeSeriesBatch:
    return TimeSeriesBatch(u=batch.u.to(device, cfg.dtype),
                           length=batch.length.to(device),
                           label=batch.label.to(device))


def _setup(cfg: DFRConfig, train, test, mask, device, what: str):
    dev = resolve_device(device, what)
    if mask is None:
        mask = masking.make_mask(
            torch.Generator().manual_seed(cfg.mask_seed), cfg.n_nodes,
            cfg.n_in, cfg.dtype)
    mask = torch.as_tensor(mask).to(dev, cfg.dtype)
    return mask, _on_device(train, cfg, dev), _on_device(test, cfg, dev), dev


def grid_search_serial(
    cfg: DFRConfig,
    train: TimeSeriesBatch,
    test: TimeSeriesBatch,
    divs: int,
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
    mask: Optional[Tensor] = None,
    device=None,
) -> dict:
    """The per-candidate serial sweep (one ``_eval_pq`` a grid point, one
    accuracy read each): the benchmark baseline and ranking oracle.
    Returns the same dict as ``grid_search``."""
    mask, train, test, dev = _setup(cfg, train, test, mask, device,
                                    "grid_search_serial")
    ps = grid_points(divs, *p_range)
    qs = grid_points(divs, *q_range)

    t0 = time.perf_counter()
    best = {"acc": -1.0, "p": None, "q": None, "beta": None}
    table = []
    for p, q in itertools.product(ps, qs):
        accs, _ = _eval_pq(cfg, mask, torch.tensor(p, dtype=cfg.dtype),
                           torch.tensor(q, dtype=cfg.dtype), train, test,
                           cfg.betas)
        accs = accs.cpu().numpy()
        table.append(accs)
        bi = int(np.argmax(accs))
        if accs[bi] > best["acc"]:
            best = {"acc": float(accs[bi]), "p": float(p), "q": float(q),
                    "beta": float(cfg.betas[bi])}
    best["time_s"] = time.perf_counter() - t0
    best["n_points"] = len(ps) * len(qs) * len(cfg.betas)
    best["acc_all"] = np.stack(table)
    return best


def grid_search(
    cfg: DFRConfig,
    train: TimeSeriesBatch,
    test: TimeSeriesBatch,
    divs: int,
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
    mask: Optional[Tensor] = None,
    device=None,
) -> dict:
    """Full (p, q, beta) grid sweep; returns the best accuracy, its
    parameters and the time.

    A shim over ``population.evaluate_population`` with no refinement:
    candidate order, accuracy selection and first-best tie-breaking match
    ``grid_search_serial``.  ``solver='primal'`` factors the (s, s) normal
    matrix per beta as the serial sweep does, so rankings agree wherever
    that factorization is healthy; below fp32's noise floor both give
    garbage, not necessarily the same garbage."""
    mask, train, test, dev = _setup(cfg, train, test, mask, device,
                                    "grid_search")
    t0 = time.perf_counter()
    ps, qs = population.grid_candidates(divs, p_range, q_range, cfg.dtype,
                                        dev)
    ev = population.evaluate_population(
        cfg, mask, ps, qs, train.u, train.length, _one_hot(train.label, cfg),
        test.u, test.length, _one_hot(test.label, cfg), select="acc",
        solver="primal")
    accs = ev.acc.cpu().numpy()
    bi = int(np.argmax(accs))  # product order + first max: serial tie-break
    return {
        "acc": float(accs[bi]),
        "p": float(ps[bi]),
        "q": float(qs[bi]),
        "beta": float(cfg.betas[int(ev.beta_idx[bi])]),
        "time_s": time.perf_counter() - t0,
        "n_points": int(ps.shape[0]) * len(cfg.betas),
        "acc_all": ev.acc_all.cpu().numpy(),
    }


def grid_search_until(
    cfg: DFRConfig,
    train: TimeSeriesBatch,
    test: TimeSeriesBatch,
    target_acc: float,
    max_divs: int = 20,
    mask: Optional[Tensor] = None,
    device=None,
) -> dict:
    """The paper's protocol: increase the divisions from 1 until the test
    accuracy reaches ``target_acc``; ``total_time_s`` sums every sweep's
    time, ``divs`` is the last sweep's."""
    total_t = 0.0
    out = None
    for divs in range(1, max_divs + 1):
        out = grid_search(cfg, train, test, divs, mask=mask, device=device)
        total_t += out["time_s"]
        out["divs"] = divs
        out["total_time_s"] = total_t
        if out["acc"] >= target_acc - 1e-9:
            return out
    return out
