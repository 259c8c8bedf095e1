"""Ridge regression engine of the stream server's refresh, in PyTorch.

The counterpart of the parts of ``repro.core.ridge`` that the stream
server's two refresh modes run: the streaming sufficient statistics (paper
Eq. 21-22, 38), the batched Cholesky solve W~ = A (B + beta I)^-1 of the
recompute mode, and the incremental mode's live factor - seeded as
sqrt(beta) I, rotated rank-1 per sample (``cholupdate_window_t``, the plain
version of K3) and solved by two triangular substitutions.

The live factor is stored transposed, ``Lt = L^T`` (upper triangular), as
the reference stores it: column k of L is row k of Lt, contiguous.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import Tensor

# Relative radicand floor of the downdate guard (the reference's value): a
# rotation with d_k^2 + sign * x_k^2 <= DOWNDATE_GUARD_REL * d_k^2 is
# treated as indefinite and skipped.  Only reachable for sign = -1.
DOWNDATE_GUARD_REL = 1e-6


def accumulate_ab(A: Tensor, B: Tensor, r_tilde: Tensor,
                  onehot: Tensor) -> Tuple[Tensor, Tensor]:
    """Rank-k update of (A, B) with a batch of samples.

    r_tilde: (..., batch, s), onehot: (..., batch, Ny); A (..., Ny, s) and
    B (..., s, s) carry the same leading dims.
    """
    A = A + onehot.transpose(-1, -2) @ r_tilde
    B = B + r_tilde.transpose(-1, -2) @ r_tilde
    return A, B


def regularize(B: Tensor, beta) -> Tensor:
    """B + beta I, broadcasting over any leading axes."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return B + beta * eye


def ridge_cholesky_batched(A: Tensor, B: Tensor) -> Tensor:
    """Batched ridge solve:  A (K, Ny, s), B (K, s, s)  ->  W~ (K, Ny, s).

    Cholesky plus two triangular solves per member, no inverse.  A system
    that is not positive definite yields NaN, as ``jnp.linalg.cholesky``
    does in the reference (``torch.linalg.cholesky`` would raise instead,
    and reading its status would stall the device queue).
    """
    C, info = torch.linalg.cholesky_ex(B)
    C = torch.where((info == 0)[..., None, None], C,
                    torch.full((), float("nan"), dtype=C.dtype,
                               device=C.device))
    X = torch.cholesky_solve(A.transpose(-1, -2), C)
    return X.transpose(-1, -2)


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


def ridge_solve_from_factor_t_batched(A: Tensor, Lt: Tensor) -> Tensor:
    """Refresh from live transposed factors: W~ = A (Lt^T Lt)^-1 for
    A (K, Ny, s), Lt (K, s, s) - two triangular substitutions, no
    factorization.  (The reference runs blocked substitutions in XLA; here
    ``solve_triangular`` takes both.)"""
    Y = torch.linalg.solve_triangular(Lt.mT, A.mT, upper=False)  # Lt^T Y = A^T
    return torch.linalg.solve_triangular(Lt, Y, upper=True).mT
