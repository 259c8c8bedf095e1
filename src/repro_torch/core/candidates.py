"""Candidate (p, q) machinery of the offline population engine, the online
ensemble and the stream server's warm-pool autotuner, in PyTorch.

The counterpart of ``repro.core.candidates``: the paper's log-space search
box (Sec. 4.1), grid seeding, jittered seeds around an anchor, rank-order
survivor selection and CMA-ES-style re-seeding of culled candidates from
the survivors' covariance in log space.

The reference splits ``jax.random`` keys; here every random function takes a
``torch.Generator`` and draws its standard normals from it, then hands them
to a private helper that takes the draws (``_seed_from_draws``,
``_adapted_from_draws``).  Those draws cannot replay the reference's, so a
test that holds a function against the reference passes the reference's
own ``jax.random.normal`` draws to the helper.  Draws are taken on the CPU
in float32, whatever the device of the candidates, so a search makes the
same draws on the card and on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ridge
from repro_torch.core.types import DFRConfig, DFRParams, Tensor

P_LOG_RANGE = (-3.75, -0.25)  # paper Sec. 4.1 search box, log10
Q_LOG_RANGE = (-2.75, -0.25)


def _normals(generator: Optional[torch.Generator], shape) -> Tensor:
    """Standard normals (float32, on the CPU) from ``generator``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Grid seeding
# ---------------------------------------------------------------------------


def grid_points(divs: int, lo: float, hi: float) -> np.ndarray:
    """``divs`` equidistant points in log10 space, inclusive of endpoints."""
    if divs == 1:
        return np.array([10.0 ** ((lo + hi) / 2.0)])
    return 10.0 ** np.linspace(lo, hi, divs)


def grid_candidates(
    divs: int,
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
    dtype=torch.float32,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """K = divs^2 grid-seeded (p, q) pairs, in ``itertools.product`` order
    (p-major), the serial grid search's order, so rankings and tie-breaks
    line up exactly."""
    ps = grid_points(divs, *p_range)
    qs = grid_points(divs, *q_range)
    pp, qq = np.meshgrid(ps, qs, indexing="ij")
    return (torch.as_tensor(pp.reshape(-1), dtype=dtype, device=device),
            torch.as_tensor(qq.reshape(-1), dtype=dtype, device=device))


def init_population(cfg: DFRConfig, ps: Tensor, qs: Tensor) -> DFRParams:
    """Stacked population from (K,) candidate vectors: zero readouts."""
    k, dev = ps.shape[0], ps.device
    return DFRParams(
        p=ps.to(cfg.dtype),
        q=qs.to(cfg.dtype),
        W=torch.zeros((k, cfg.n_classes, cfg.n_rep), dtype=cfg.dtype,
                      device=dev),
        b=torch.zeros((k, cfg.n_classes), dtype=cfg.dtype, device=dev),
    )


def seed_candidates(
    generator: Optional[torch.Generator],
    k: int,
    p_init: float,
    q_init: float,
    jitter: float = 0.1,
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
    dtype=torch.float32,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """K jittered (p, q) seeds around an anchor point.

    Member 0 is the *exact* anchor, even outside the search box, so a K=1
    ensemble reproduces the single-system initialization; members 1..K-1
    get multiplicative log-normal jitter, clipped back into the box."""
    eps = _normals(generator, (2, k))
    return _seed_from_draws(eps, p_init, q_init, jitter, p_range, q_range,
                            dtype, device)


def _seed_from_draws(eps, p_init, q_init, jitter, p_range, q_range,
                     dtype=torch.float32, device=None):
    """``seed_candidates`` from its (2, K) standard normals ``eps``."""
    eps = torch.as_tensor(eps, dtype=dtype, device=device)
    k = eps.shape[1]
    anchor = torch.arange(k, device=eps.device) == 0
    scale = torch.where(anchor, 0.0, jitter).to(dtype)
    p0 = torch.tensor(p_init, dtype=dtype, device=eps.device)
    q0 = torch.tensor(q_init, dtype=dtype, device=eps.device)
    p = torch.clamp(p0 * torch.exp(scale * eps[0]), 10.0 ** p_range[0],
                    10.0 ** p_range[1])
    q = torch.clamp(q0 * torch.exp(scale * eps[1]), 10.0 ** q_range[0],
                    10.0 ** q_range[1])
    # the clip must not move an out-of-box anchor (the K=1 parity contract)
    return torch.where(anchor, p0, p), torch.where(anchor, q0, q)


# ---------------------------------------------------------------------------
# Rank-ordered selection / culling
# ---------------------------------------------------------------------------


def survivor_parents(
    fitness: Tensor, survive_frac: float = 0.5
) -> Tuple[Tensor, Tensor, int]:
    """Parent assignment for a cull round.

    ``fitness`` is (K,), lower-is-better.  Returns ``(parent, keep,
    n_keep)``: ``parent`` (K,) indexes the member each slot inherits from
    (the top ``ceil(K * survive_frac)`` slots take the survivors in rank
    order, ties kept in member order as the reference's stable sort keeps
    them; each culled slot cycles through the survivors), and ``keep``
    (K,) marks the first ``n_keep`` slots, the survivors after the
    reorder."""
    fitness = torch.as_tensor(fitness)
    k = fitness.shape[0]
    n_keep = max(1, min(k, int(np.ceil(k * survive_frac))))
    order = torch.argsort(fitness, stable=True)   # ascending: best first
    idx = torch.arange(k - n_keep, device=order.device) % n_keep
    parent = torch.cat([order[:n_keep], order[idx]])
    keep = torch.arange(k, device=order.device) < n_keep
    return parent, keep, n_keep


def sampling_cov_chol(coords_log: Tensor, keep: Tensor,
                      jitter: float) -> Tensor:
    """CMA-ES-style sampling covariance (lower Cholesky) from the survivors.

    ``coords_log`` is (D, K) log-space coordinates; ``keep`` (K,) marks the
    survivors, which occupy the first slots in rank order
    (``survivor_parents``' layout), so a slot's index is its rank.  The
    covariance is the survivors' covariance under CMA-ES log-rank weights
    plus an isotropic ``jitter**2`` floor; with one survivor it is the
    floor alone, the isotropic log-normal jitter."""
    d, k = coords_log.shape
    dt = coords_log.dtype
    kf = keep.to(dt)
    n = torch.clamp(kf.sum(), min=1.0)
    rank = torch.arange(k, dtype=dt, device=coords_log.device)
    w = torch.where(keep, torch.log(n + 0.5) - torch.log1p(rank),
                    torch.zeros((), dtype=dt, device=coords_log.device))
    w = torch.clamp(w, min=0.0)
    w = w / torch.clamp(w.sum(), min=1e-12)
    mean = coords_log @ w                                  # (D,)
    cen = (coords_log - mean[:, None]) * kf
    cov = (cen * w) @ cen.T                                # (D, D)
    eye = torch.eye(d, dtype=dt, device=coords_log.device)
    # NaN where not positive definite (jitter 0), as the reference gives
    return ridge.cholesky_or_nan(cov + (jitter ** 2) * eye)


def adapted_clones(
    generator: Optional[torch.Generator],
    coords: Tensor,
    keep: Tensor,
    jitter: float = 0.15,
    ranges: Optional[Sequence[Tuple[float, float]]] = None,
) -> Tensor:
    """Covariance-adapted log-normal jitter on the non-surviving slots.

    ``coords`` (D, K) are positive candidate coordinates (rows: (p, q) or
    (p, q, beta)); slots with ``keep`` set pass through bit for bit.  A
    culled slot steps from its coordinates by ``L @ eps`` in log space,
    ``L`` the survivors' covariance Cholesky (``sampling_cov_chol``).
    ``ranges`` optionally clips each row back into a log10 box."""
    eps = _normals(generator, tuple(coords.shape))
    return _adapted_from_draws(eps, coords, keep, jitter, ranges)


def _adapted_from_draws(eps, coords: Tensor, keep: Tensor,
                        jitter: float = 0.15,
                        ranges: Optional[Sequence[Tuple[float, float]]] = None
                        ) -> Tensor:
    """``adapted_clones`` from its (D, K) standard normals ``eps``."""
    eps = torch.as_tensor(eps, dtype=coords.dtype, device=coords.device)
    keep = keep.to(coords.device)
    L = sampling_cov_chol(torch.log(coords), keep, jitter)
    step = L @ eps                                         # (D, K)
    gate = torch.where(keep, 0.0, 1.0).to(coords.dtype)
    out = coords * torch.exp(gate * step)
    if ranges is not None:
        lo = torch.tensor([10.0 ** r[0] for r in ranges], dtype=coords.dtype,
                          device=coords.device)
        hi = torch.tensor([10.0 ** r[1] for r in ranges], dtype=coords.dtype,
                          device=coords.device)
        out = torch.clamp(out, lo[:, None], hi[:, None])
    return out


def jitter_clones(
    generator: Optional[torch.Generator],
    p: Tensor,
    q: Tensor,
    keep: Tensor,
    jitter: float = 0.15,
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
) -> Tuple[Tensor, Tensor]:
    """``adapted_clones`` on (p, q), clipped back into the search box;
    surviving slots pass unchanged."""
    new = adapted_clones(generator, torch.stack([p, q]), keep, jitter,
                         ranges=(p_range, q_range))
    return new[0], new[1]


def cull_population(
    pop: DFRParams,
    fitness: Tensor,
    generator: Optional[torch.Generator],
    survive_frac: float = 0.5,
    jitter: float = 0.15,
    p_range: Tuple[float, float] = P_LOG_RANGE,
    q_range: Tuple[float, float] = Q_LOG_RANGE,
) -> DFRParams:
    """Replace the worst members with jittered clones of the best.

    ``fitness`` (K,) is lower-is-better (NRMSE, or -accuracy).  The top
    ``ceil(K * survive_frac)`` members survive verbatim in rank order; each
    culled slot re-seeds from a survivor (cycled) with covariance-adapted
    log-normal jitter on (p, q) (``adapted_clones``), clipped into the box,
    and inherits its parent's readout.  K stays constant."""
    parent, keep, _ = survivor_parents(fitness, survive_frac)
    parent = parent.to(pop.p.device)
    new_p, new_q = jitter_clones(generator, pop.p[parent], pop.q[parent],
                                 keep, jitter, p_range, q_range)
    return DFRParams(p=new_p, q=new_q, W=pop.W[parent], b=pop.b[parent])
