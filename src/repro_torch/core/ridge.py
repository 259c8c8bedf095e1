"""Ridge regression engine, in PyTorch.

The counterpart of the parts of ``repro.core.ridge`` that the port runs:
the streaming sufficient statistics (paper Eq. 21-22, 38); the offline
solves of ``DFRModel`` and ``OnlineDFR`` (``ridge_solve``: Algorithm 1 by
Gauss-Jordan, or Cholesky plus two triangular solves through
``kernels.ops.ridge_solve``, the blocked tile kernels K4a/K4b on the card);
the batched Cholesky solve W~ = A (B + beta I)^-1 of the stream server's
recompute mode; and the incremental mode's live factor - seeded as
sqrt(beta) I, rotated rank-1 per sample (``cholupdate_window_t``, the plain
version of K3) and solved by two triangular substitutions.

The live factor is stored transposed, ``Lt = L^T`` (upper triangular), as
the reference stores it: column k of L is row k of Lt, contiguous.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import Tensor, unported

# Relative radicand floor of the downdate guard (the reference's value): a
# rotation with d_k^2 + sign * x_k^2 <= DOWNDATE_GUARD_REL * d_k^2 is
# treated as indefinite and skipped.  Only reachable for sign = -1.
DOWNDATE_GUARD_REL = 1e-6


def accumulate_ab(A: Tensor, B: Tensor, r_tilde: Tensor, onehot: Tensor,
                  in_place: bool = False) -> Tuple[Tensor, Tensor]:
    """Rank-k update of (A, B) with a batch of samples.

    r_tilde: (..., batch, s), onehot: (..., batch, Ny); A (..., Ny, s) and
    B (..., s, s) carry the same leading dims.  ``in_place`` adds into A and
    B and returns them, rounding exactly as the sum into new tensors.
    """
    dA = onehot.transpose(-1, -2) @ r_tilde
    dB = r_tilde.transpose(-1, -2) @ r_tilde
    if in_place:
        return A.add_(dA), B.add_(dB)
    return A + dA, B + dB


def regularize(B: Tensor, beta) -> Tensor:
    """B + beta I, broadcasting over any leading axes."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return B + beta * eye


def ridge_gaussian(A: Tensor, B: Tensor) -> Tensor:
    """Algorithm 1 with row operations vectorized: Gauss-Jordan inversion
    of B in the reference's pivot order, no pivot search (B is SPD, so the
    diagonal never vanishes), then A B^-1.  Batched over leading axes."""
    s = B.shape[-1]
    B = B.clone()
    Binv = torch.eye(s, dtype=B.dtype, device=B.device).expand_as(B).clone()
    for i in range(s):
        buf = 1.0 / B[..., i, i, None]
        brow = B[..., i, :] * buf
        binvrow = Binv[..., i, :] * buf
        B[..., i, :] = brow
        Binv[..., i, :] = binvrow
        col = B[..., :, i].clone()
        col[..., i] = 0.0  # eliminate everywhere but the pivot row
        B = B - col[..., :, None] * brow[..., None, :]
        Binv = Binv - col[..., :, None] * binvrow[..., None, :]
    return A @ Binv


def ridge_cholesky_blocked(A: Tensor, B: Tensor, block: int = 128) -> Tensor:
    """The production ridge solve W~ = A B^-1: Cholesky plus two triangular
    solves, no inverse.  Through ``kernels.ops.ridge_solve``: on the card
    the blocked solve over the tile kernels K4a and K4b with tiles of
    ``block`` (128, the reference's default here, keeps each tile in one
    block's shared memory); on the CPU the unblocked library solve, as the
    reference computes it off the TPU.  NaN where B is not positive
    definite."""
    from repro_torch.kernels import ops as kops  # kernels import core

    return kops.ridge_solve(A, B, block=block)


def ridge_solve(A: Tensor, B: Tensor,
                method: str = "cholesky_blocked") -> Tensor:
    """Dispatch: 'gaussian' | 'cholesky_blocked' ('cholesky_packed' is
    not ported yet)."""
    if method == "gaussian":
        return ridge_gaussian(A, B)
    if method == "cholesky_packed":
        raise unported("ridge method 'cholesky_packed'",
                       "Packed Cholesky ridge")
    if method == "cholesky_blocked":
        return ridge_cholesky_blocked(A, B)
    raise ValueError(f"unknown ridge method: {method}")


def cholesky_or_nan(B: Tensor) -> Tensor:
    """Lower Cholesky factor of (..., s, s), NaN where a system is not
    positive definite, as ``jnp.linalg.cholesky`` gives it in the reference
    (``torch.linalg.cholesky`` would raise instead, and reading its status
    would stall the device queue)."""
    C, info = torch.linalg.cholesky_ex(B)
    return torch.where((info == 0)[..., None, None], C,
                       torch.full((), float("nan"), dtype=C.dtype,
                                  device=C.device))


def ridge_cholesky_batched(A: Tensor, B: Tensor) -> Tensor:
    """Batched ridge solve:  A (K, Ny, s), B (K, s, s)  ->  W~ (K, Ny, s).

    Cholesky plus two triangular solves per member, no inverse; NaN for a
    system that is not positive definite (``cholesky_or_nan``).  The solves
    are the incremental refresh's (``ridge_solve_from_factor_t_batched``),
    not ``torch.cholesky_solve``: on a CUDA batch that one runs MAGMA, whose
    queue allocates device memory, which a CUDA graph capture forbids (the
    stream server captures this refresh).
    """
    return ridge_solve_from_factor_t_batched(A, cholesky_or_nan(B).mT)


def ridge_solve_batched(A: Tensor, B: Tensor,
                        method: str = "cholesky_blocked") -> Tensor:
    """Population-axis dispatch mirroring ``ridge_solve``: A (K, Ny, s),
    B (K, s, s) -> (K, Ny, s)."""
    if method == "cholesky_blocked":
        return ridge_cholesky_batched(A, B)
    if method == "gaussian":
        return ridge_gaussian(A, B)
    raise ValueError(f"unknown batched ridge method: {method}")


def seed_factor(s: int, beta, dtype=torch.float32, device=None) -> Tensor:
    """Factor of the empty system: chol(0 + beta I) = sqrt(beta) I."""
    root = torch.sqrt(torch.tensor(beta, dtype=dtype, device=device))
    return root * torch.eye(s, dtype=dtype, device=device)


def guarded_rotation(dk: Tensor, xk: Tensor, sign: float):
    """One rotation's (r, c, s, bad) with the downdate guard, in the
    reference's operation order (``repro.core.ridge._guarded_rotation``).

    A bad rotation (radicand <= DOWNDATE_GUARD_REL * d_k^2) degrades to the
    identity: r = d_k, c = 1, s = 0.  A zero x_k gives r = d_k, c = 1, s = 0
    as well, so zero rows are exact no-ops."""
    dd = dk * dk
    rad = dd + sign * xk * xk
    bad = rad <= DOWNDATE_GUARD_REL * dd
    r = torch.where(bad, dk, torch.sqrt(torch.where(bad, torch.ones_like(rad),
                                                    rad)))
    c = r / dk
    sk = torch.where(bad, torch.zeros_like(xk), xk / dk)
    return r, c, sk, bad


def cholupdate_window_t(Lt: Tensor, X: Tensor, sign: float = 1.0) -> Tensor:
    """Rotate the rows of X (..., W, s) one by one, in stream order, into
    the transposed factors Lt (..., s, s): Lt'^T Lt' = Lt^T Lt + sign x x^T
    per row (sign -1: the guarded hyperbolic downdate).

    The plain version of K3 and the reference's sample-by-sample sweep
    (``repro.core.ridge.cholupdate_window_t``), batched over the leading
    axes.  Rotation k touches only row k of Lt (its part right of the
    diagonal) and the tail of x.  Returns a new tensor."""
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    U = Lt.clone()
    s = U.shape[-1]
    for t in range(X.shape[-2]):
        x = X[..., t, :].to(U.dtype).clone()
        for k in range(s):
            r, c, sk, _ = guarded_rotation(U[..., k, k], x[..., k], sign)
            tail = ((U[..., k, k + 1:] + (sign * sk)[..., None] * x[..., k + 1:])
                    / c[..., None])
            x[..., k + 1:] = (c[..., None] * x[..., k + 1:]
                              - sk[..., None] * tail)
            U[..., k, k + 1:] = tail
            U[..., k, k] = r
    return U


def ridge_solve_from_factor_t(A: Tensor, Lt: Tensor) -> Tensor:
    """Refresh from one live transposed factor: W~ = A (Lt^T Lt)^-1 for
    A (Ny, s), Lt (s, s)."""
    return ridge_solve_from_factor_t_batched(A[None], Lt[None])[0]


def ridge_solve_from_factor_t_batched(A: Tensor, Lt: Tensor) -> Tensor:
    """Refresh from live transposed factors: W~ = A (Lt^T Lt)^-1 for
    A (K, Ny, s), Lt (K, s, s) - two triangular substitutions, no
    factorization.  (The reference runs blocked substitutions in XLA; here
    ``solve_triangular`` takes both.)"""
    Y = torch.linalg.solve_triangular(Lt.mT, A.mT, upper=False)  # Lt^T Y = A^T
    return torch.linalg.solve_triangular(Lt, Y, upper=True).mT
