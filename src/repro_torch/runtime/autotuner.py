"""Warm-pool background hyperparameter autotuner for the stream server, in
PyTorch.

The counterpart of ``repro.runtime.autotuner``.  A long-lived server holds
the (p, q) its slots were admitted with; this tuner keeps searching (p, q,
beta) while it serves:

  * Each refresh cohort of the server owns a small persistent candidate
    population over (p, q, beta), a *warm pool*: it survives across tuning
    rounds, so each round continues the search.
  * Every ``interval`` server rounds one live slot per cohort is visited
    round-robin.  The pool, member 0 pinned to that slot's live (p, q,
    beta), is evaluated on the slot's most recent ``history`` samples, taken
    from the request's host arrays (never read back from the device pool):
    ridge-refit readouts on a fit split, NRMSE on the newest validation
    split (``_evaluate_triples``: every member's features from one K1
    launch a split, with per-member (p, q) and beta).
  * The pool is then culled CMA-ES-style (``candidates.survivor_parents``
    and ``candidates.adapted_clones`` in 3 dimensions).
  * When the round's winner beats the incumbent by ``margin`` (relative
    NRMSE), a swap is scheduled and applied just after the slot's next
    cohort refresh boundary (``_swap_slot_row``): the winner's (p, q) and
    its ridge readout on the recent windows, and the Ridge statistics
    re-seeded as ``reset_statistics(factor_beta=beta)`` does, so the
    incremental invariant Lt^T Lt == B + beta I holds across the swap.  An
    int8 slot disarms (``w_scale = 0``) and serves fp32 until its next
    refresh re-folds its scales; the adaptive detector's EMAs re-seed.

The swap writes each row in place into the state tensors of the slot's block, on
the server's stream and outside any graph capture: the server's captured
round replays graphs that hold those tensors' addresses, so a rebuilt state
tree would leave every later replay serving the old tensors.  Stream order
puts the writes after the refresh the dispatch enqueued.

A tuning round reads the device twice: the incumbent's (p, q, beta) as one
small copy, and the candidates' fitness.  Each read waits for the work
queued before it, so under ``pipeline_depth`` > 0 a tuning round drains the
in-flight dispatches.  The random draws come from a ``torch.Generator`` on
the CPU seeded by ``seed``, so a tuned episode makes the same draws on the
card and on the CPU (not the reference's ``jax.random`` draws).

Beta only has a lasting effect under ``refresh_mode='incremental'`` (the
live factor carries the slot's beta; the recompute refresh applies the
server's).  A tuner that never swaps only reads the server's state, and the
episode it serves is the untuned one bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import ridge
from repro_torch.core.candidates import (P_LOG_RANGE, Q_LOG_RANGE,
                                         adapted_clones, seed_candidates,
                                         survivor_parents)
from repro_torch.core.online import OnlineState
from repro_torch.core.population import population_features
from repro_torch.core.types import DFRConfig, Tensor

# beta search box (log10): spans the typical cfg.betas sweep
BETA_LOG_RANGE = (-4.0, 0.0)


# ---------------------------------------------------------------------------
# Candidate evaluation with per-member beta
# ---------------------------------------------------------------------------


@torch.no_grad()
def _evaluate_triples(
    cfg: DFRConfig,
    mask: Tensor,
    ps: Tensor,       # (K,)
    qs: Tensor,       # (K,)
    betas: Tensor,    # (K,) per-member ridge beta
    fit_u: Tensor,    # (B, T, n_in)
    fit_len: Tensor,  # (B,)
    y_fit: Tensor,    # (B, Ny) one-hot
    val_u: Tensor,
    val_len: Tensor,
    y_val: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Evaluate K (p, q, beta) triples.  Returns ``(nrmse, acc, Wt)``, Wt
    (K, Ny, s) the ridge readouts fitted on the fit split.

    The features come from the fused training forward (K1, one launch a
    split for all K members), so the (B, T, Nx) states are never stored.
    Each member's (s, s) system B + beta_k I is factored by
    ``ridge.cholesky_or_nan`` and solved by two triangular solves
    (``torch.cholesky_solve`` would run MAGMA on a CUDA batch); a system
    that is not positive definite gives an infinite NRMSE."""
    rt_fit = population_features(cfg, mask, ps, qs, fit_u, fit_len)
    rt_val = population_features(cfg, mask, ps, qs, val_u, val_len)
    s = rt_fit.shape[-1]
    A = y_fit.T @ rt_fit                                   # (K, Ny, s)
    Bm = rt_fit.mT @ rt_fit                                # (K, s, s)
    eye = torch.eye(s, dtype=Bm.dtype, device=Bm.device)
    C = ridge.cholesky_or_nan(Bm + betas[:, None, None] * eye)
    Wt = ridge.ridge_solve_from_factor_t_batched(A, C.mT)  # (K, Ny, s)

    pred = rt_val @ Wt.mT                                  # (K, Bv, Ny)
    var = torch.mean(torch.square(y_val - y_val.mean())) + 1e-12
    err = pred - y_val
    nrmse = torch.sqrt(torch.mean(err * err, dim=(1, 2)) / var)
    nrmse = torch.where(torch.isfinite(nrmse), nrmse,
                        torch.full((), float("inf"), dtype=nrmse.dtype,
                                   device=nrmse.device))
    hits = pred.argmax(dim=-1) == y_val.argmax(dim=-1)
    return nrmse, hits.to(torch.float32).mean(dim=1), Wt


# ---------------------------------------------------------------------------
# The hot swap: winner rows into the live slot state, in place
# ---------------------------------------------------------------------------


@torch.no_grad()
def _swap_slot_row(
    states: OnlineState,
    row: int,
    p_new: float,
    q_new: float,
    W_new: Tensor,     # (Ny, Nr)
    b_new: Tensor,     # (Ny,)
    beta_new: float,
    maintain_factor: bool,
) -> None:
    """Write one winner into slot ``row`` of the slot-batched state, in
    place: every leaf keeps its tensor and address.

    (p, q) and the warm-start readout replace the row's parameters; the
    Ridge statistics re-seed as ``reset_statistics(factor_beta=beta_new)``:
    A = B = 0, count = 0 and, with ``maintain_factor`` (incremental mode),
    a fresh live factor sqrt(beta) I with ``factor_beta = beta`` (zeros
    otherwise), so Lt^T Lt == B + factor_beta I holds.  The step counter
    survives; the int8 codes and scales (``Wq``, ``w_scale``, ``x_scale``,
    ``x_absmax``) and the detector's ``loss_fast``/``loss_slow`` zero.  The
    scalars are rounded to float32 on the host and written by ``fill_``,
    and sqrt(beta) is the float32 square root, as ``ridge.seed_factor``
    gives it: no write waits for the device."""
    pr, rs, q8 = states.params, states.ridge, states.quant
    pr.p[row].fill_(p_new)
    pr.q[row].fill_(q_new)
    pr.W[row].copy_(W_new)
    pr.b[row].copy_(b_new)
    for leaf in (rs.A, rs.B, rs.count, rs.Lt, rs.factor_beta, q8.Wq,
                 q8.w_scale, q8.x_scale, q8.x_absmax, states.loss_fast,
                 states.loss_slow):
        leaf[row].zero_()
    if maintain_factor:
        beta32 = np.float32(beta_new)
        rs.Lt[row].diagonal().fill_(float(np.sqrt(beta32)))
        rs.factor_beta[row].fill_(float(beta32))


# ---------------------------------------------------------------------------
# Per-cohort warm pool
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CohortPool:
    """Persistent candidate population of one refresh cohort."""

    p: np.ndarray       # (K,)
    q: np.ndarray       # (K,)
    beta: np.ndarray    # (K,)
    visit: int = 0      # round-robin cursor over the cohort's slots
    rounds: int = 0
    swaps: int = 0


@dataclasses.dataclass
class _PendingSwap:
    slot: int
    rid: int            # request id the evaluation belonged to
    p: float
    q: float
    beta: float
    W: Tensor           # (Ny, Nr), on the server's device
    b: Tensor           # (Ny,)


def _to_device(arr: np.ndarray, device: torch.device) -> Tensor:
    """A host array on ``device``; on a CUDA device by a non-blocking copy
    from pinned memory, which does not wait for the queued work."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class WarmPoolAutotuner:
    """Background (p, q, beta) re-optimization for a live ``StreamServer``.

    Attach with ``server.attach_autotuner(tuner)``; the server then calls
    ``on_step()`` after every round (each round of a blocked dispatch, where
    the reference calls it once a dispatch).  See the module docstring for
    the algorithm; knobs:

      * ``population`` - warm-pool size K per cohort (incumbent included).
      * ``history``    - retained samples evaluated per round; a slot is
        visited once it has consumed at least this many samples (and is
        past phase 1).
      * ``interval``   - server rounds between tuning rounds.
      * ``val_frac``   - the newest fraction of the history, the validation
        split (fitness is its NRMSE: the drift-tracking objective).
      * ``margin``     - relative NRMSE improvement the winner must show
        over the incumbent before a swap is scheduled.
      * ``jitter``     - isotropic floor of the survivor covariance used to
        re-seed culled candidates.
      * ``seed``       - seeds the tuner's ``torch.Generator``.
    """

    def __init__(
        self,
        server,
        population: int = 8,
        history: int = 32,
        interval: int = 4,
        val_frac: float = 0.25,
        margin: float = 0.05,
        survive_frac: float = 0.5,
        jitter: float = 0.2,
        seed: int = 0,
    ):
        if population < 2:
            raise ValueError(f"population must be >= 2, got {population!r}")
        if history < 8:
            raise ValueError(f"history must be >= 8, got {history!r}")
        if not 0.0 < val_frac < 1.0:
            raise ValueError(f"val_frac must be in (0, 1), got {val_frac!r}")
        self.server = server
        self.population = int(population)
        self.history = int(history)
        self.interval = max(1, int(interval))
        self.val_frac = float(val_frac)
        self.margin = float(margin)
        self.survive_frac = float(survive_frac)
        self.jitter = float(jitter)
        self._gen = torch.Generator().manual_seed(seed)
        self._pools: Dict[int, _CohortPool] = {}
        self._pending: Dict[int, _PendingSwap] = {}
        self._steps_seen = 0
        self._last_seen_step = int(server.global_step)
        self.swaps_applied = 0
        self.rounds_run = 0

    # -- server hook ---------------------------------------------------------

    def on_step(self) -> None:
        """Called by the server after each round: apply the pending swaps
        whose cohort refresh fired since the last call, then (every
        ``interval`` calls) run one tuning round."""
        # every global step since the last call (the reference calls once a
        # dispatch, which may advance several), tracked with nothing pending
        lo, hi = self._last_seen_step, self.server.global_step
        self._last_seen_step = hi
        fired = set()
        for step in range(lo + 1, hi + 1):
            c = self.server.cohorts.due_cohort(step)
            if c is not None:
                fired.add(c)
        self._apply_due_swaps(fired)
        self._steps_seen += 1
        if self._steps_seen % self.interval == 0:
            self._tune_round()

    # -- swap application ----------------------------------------------------

    def _apply_due_swaps(self, fired) -> None:
        """Apply the pending swaps of the cohorts whose refresh fired: the
        slot then serves the warm-start readout for a whole refresh period
        before its next re-solve folds statistics of the post-swap regime
        only."""
        if not self._pending or not fired:
            return
        srv = self.server
        live = dict(srv.sched.live())
        for slot in list(self._pending):
            pend = self._pending[slot]
            if srv.cohorts.cohort_of_slot[slot] not in fired:
                continue
            del self._pending[slot]
            req = live.get(slot)
            if req is None or req.rid != pend.rid:
                continue  # the stream retired; the evaluation is stale
            blk, row = srv._owner(slot)
            _swap_slot_row(blk.states, row, pend.p, pend.q, pend.W, pend.b,
                           pend.beta,
                           maintain_factor=srv.refresh_mode == "incremental")
            self.swaps_applied += 1

    # -- tuning round --------------------------------------------------------

    def _pool_for(self, cohort: int, p0: float, q0: float, b0: float
                  ) -> _CohortPool:
        pool = self._pools.get(cohort)
        if pool is None:
            k = self.population
            ps, qs = seed_candidates(self._gen, k, p0, q0, jitter=self.jitter)
            lo, hi = BETA_LOG_RANGE
            eps = torch.randn(k, generator=self._gen).numpy()
            betas = b0 * np.exp(eps * self.jitter)
            betas[0] = b0
            betas = np.clip(betas, 10.0 ** lo, 10.0 ** hi)
            pool = self._pools[cohort] = _CohortPool(
                p=ps.numpy().astype(np.float64),
                q=qs.numpy().astype(np.float64),
                beta=betas.astype(np.float64),
            )
        return pool

    def _eligible_slots(self, cohort: int) -> List[Tuple[int, object]]:
        srv = self.server
        out = []
        warm = (srv.phase_steps + 1) * srv.window
        for slot, req in srv.sched.live():
            if srv.cohorts.cohort_of_slot[slot] != cohort:
                continue
            if srv.slot_pos[slot] >= max(self.history, warm):
                out.append((slot, req))
        return out

    def _tune_round(self) -> None:
        srv = self.server
        for cohort in range(srv.cohorts.n_cohorts):
            slots = self._eligible_slots(cohort)
            if not slots:
                continue
            pool = self._pools.get(cohort)
            visit = pool.visit if pool is not None else 0
            slot, req = slots[visit % len(slots)]
            self._tune_slot(cohort, slot, req)

    def _tune_slot(self, cohort: int, slot: int, req) -> None:
        srv = self.server
        cfg, dev = srv.cfg, srv.device
        # the incumbent triple from the live slot row: one small read
        blk, row = srv._owner(slot)
        st = blk.states
        live = torch.stack([st.params.p[row], st.params.q[row],
                            st.ridge.factor_beta[row]]).cpu().numpy()
        p0, q0 = float(live[0]), float(live[1])
        b0 = float(np.float32(srv.beta))   # the server's beta, as float32
        if srv.refresh_mode == "incremental" and float(live[2]) > 0:
            b0 = float(live[2])
        pool = self._pool_for(cohort, p0, q0, b0)
        pool.visit += 1
        pool.rounds += 1
        self.rounds_run += 1
        # pin the incumbent probe: member 0 is always the live triple
        pool.p[0], pool.q[0], pool.beta[0] = p0, q0, b0

        # the slot's most recent `history` consumed samples (host arrays)
        hi = int(srv.slot_pos[slot])
        lo = hi - self.history
        u = np.asarray(req.u[lo:hi], np.float32)
        length = np.asarray(req.length[lo:hi], np.int32)
        label = np.asarray(req.label[lo:hi], np.int32)
        n_val = max(1, int(round(self.history * self.val_frac)))
        n_fit = self.history - n_val
        y = np.eye(cfg.n_classes, dtype=np.float32)[label]

        def up(a):
            return _to_device(a, dev)

        nrmse, _, Wt = _evaluate_triples(
            cfg, srv.mask, up(pool.p.astype(np.float32)),
            up(pool.q.astype(np.float32)), up(pool.beta.astype(np.float32)),
            up(u[:n_fit]), up(length[:n_fit]), up(y[:n_fit]),
            up(u[n_fit:]), up(length[n_fit:]), up(y[n_fit:]))
        fitness = nrmse.cpu().numpy().astype(np.float64)
        win = int(np.argmin(fitness))
        if (np.isfinite(fitness[win]) and win != 0
                and fitness[win] < fitness[0] * (1.0 - self.margin)):
            self._pending[slot] = _PendingSwap(
                slot=slot, rid=req.rid,
                p=float(pool.p[win]), q=float(pool.q[win]),
                beta=float(pool.beta[win]),
                W=Wt[win, :, :-1], b=Wt[win, :, -1])
            pool.swaps += 1

        # evolve the warm pool: CMA-ES-style cull in (p, q, beta) log space;
        # the ranking reads the fitness in float32, as the reference's does
        parent, keep, _ = survivor_parents(
            torch.from_numpy(fitness.astype(np.float32)), self.survive_frac)
        parent = parent.numpy()
        coords = np.stack([pool.p[parent], pool.q[parent], pool.beta[parent]])
        new = adapted_clones(
            self._gen, torch.from_numpy(coords.astype(np.float32)), keep,
            jitter=self.jitter,
            ranges=(P_LOG_RANGE, Q_LOG_RANGE, BETA_LOG_RANGE),
        ).numpy().astype(np.float64)
        pool.p, pool.q, pool.beta = new[0], new[1], new[2]

    # -- diagnostics ---------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "rounds_run": self.rounds_run,
            "swaps_applied": self.swaps_applied,
            "swaps_pending": len(self._pending),
            "cohort_pools": len(self._pools),
        }
