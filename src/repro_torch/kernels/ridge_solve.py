"""Blocked Cholesky ridge solve composing the tile kernels K4a and K4b.

The port of ``repro.kernels.ridge_solve``: W~ = A B^-1 for SPD B by the
paper's Alg. 2-4 at tile granularity (right-looking blocked factorization):

    for k in diag blocks:   Lkk   = chol_block(Bkk)              (K4a)
                            Lik   = trsm_lower_t(Bik, Lkk)       (K4b)
                            Bij  -= Lik @ Ljk^T                  (SYRK)
    D = A C^-T  by block forward substitution                    (K4b)
    W = D C^-1  by block backward substitution                   (K4b)

The SYRK trailing update and the block-combination products are plain
fp32 ``torch.matmul`` (TF32 is off by default for matmuls; the reference
leaves them to XLA as plain dots); the tiles go through
``kernels.cholesky``, which launches the kernels for CUDA tensors and runs
their plain versions for CPU tensors.  The system pads to a multiple of
``block`` with an identity diagonal (padded rows solve to zero exactly) and
the right-hand side's rows pad to a multiple of 8, as in the reference.

Every function works on a leading K axis (``_batched``: K independent
systems, each tile launch covering all K); the unbatched names are the
K = 1 case.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels.cholesky import (chol_block_batched,
                                          trsm_lower_batched,
                                          trsm_lower_t_batched)


def _pad_spd(B: Tensor, block: int):
    """(K, s, s) -> (K, n, n) with n the next multiple of ``block``, the
    padding zero off the diagonal and one on it."""
    s = B.shape[-1]
    pad = (-s) % block
    if not pad:
        return B, s
    Bp = torch.nn.functional.pad(B, (0, pad, 0, pad))
    idx = torch.arange(s, s + pad, device=B.device)
    Bp[:, idx, idx] = 1.0
    return Bp, s + pad


def _pad_rows(x: Tensor, mult: int):
    """Pad the row axis (-2) of (K, m, n) to a multiple of ``mult``."""
    m = x.shape[-2]
    pad = (-m) % mult
    return (torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x), m


def _padded_factor(C: Tensor, block: int):
    Cp, n = _pad_spd(C, block)
    return (torch.tril(Cp) if n != C.shape[-1] else Cp), n


def _padded_rhs(A: Tensor, n: int):
    """A (K, Ny, s) padded to n columns and to a multiple of 8 rows."""
    pad = n - A.shape[-1]
    Ap = torch.nn.functional.pad(A, (0, pad)) if pad else A
    return _pad_rows(Ap, 8)


def cholesky_blocked_batched(B: Tensor, *, block: int = 256,
                             backend: Optional[str] = None) -> Tensor:
    """Blocked lower Cholesky per member: B (K, s, s) -> C (K, s, s) tril."""
    s = B.shape[-1]
    a, n = _pad_spd(B, block)
    a = a.clone()
    for k0 in range(0, n, block):
        k1 = k0 + block
        Lkk = chol_block_batched(a[:, k0:k1, k0:k1], backend=backend)
        a[:, k0:k1, k0:k1] = Lkk
        if k1 < n:
            Lp = trsm_lower_t_batched(a[:, k1:, k0:k1], Lkk, backend=backend)
            a[:, k1:, k0:k1] = Lp
            a[:, k1:, k1:] -= Lp @ Lp.mT
    return torch.tril(a)[:, :s, :s]


def trsm_blocked_lower_t_batched(A: Tensor, C: Tensor, *, block: int = 256,
                                 backend: Optional[str] = None) -> Tensor:
    """D = A (C^T)^-1 per member by block forward substitution (Alg. 3 at
    tile level): A (K, Ny, s), C (K, s, s) lower."""
    s = C.shape[-1]
    Cp, n = _padded_factor(C, block)
    Ap, m = _padded_rhs(A, n)
    D = torch.zeros_like(Ap)
    for j0 in range(0, n, block):
        j1 = j0 + block
        rhs = Ap[:, :, j0:j1]
        if j0:
            rhs = rhs - D[:, :, :j0] @ Cp[:, j0:j1, :j0].mT
        D[:, :, j0:j1] = trsm_lower_t_batched(rhs, Cp[:, j0:j1, j0:j1],
                                              backend=backend)
    return D[:, :m, :s]


def trsm_blocked_lower_batched(Dm: Tensor, C: Tensor, *, block: int = 256,
                               backend: Optional[str] = None) -> Tensor:
    """W = D C^-1 per member by block backward substitution (Alg. 4 at
    tile level): Dm (K, Ny, s), C (K, s, s) lower."""
    s = C.shape[-1]
    Cp, n = _padded_factor(C, block)
    Dp, m = _padded_rhs(Dm, n)
    W = torch.zeros_like(Dp)
    for j0 in range(n - block, -1, -block):
        j1 = j0 + block
        rhs = Dp[:, :, j0:j1]
        if j1 < n:
            rhs = rhs - W[:, :, j1:] @ Cp[:, j1:, j0:j1]
        W[:, :, j0:j1] = trsm_lower_batched(rhs, Cp[:, j0:j1, j0:j1],
                                            backend=backend)
    return W[:, :m, :s]


def ridge_solve_blocked_batched(A: Tensor, B: Tensor, *, block: int = 256,
                                backend: Optional[str] = None) -> Tensor:
    """W~_k = A_k B_k^-1 for every member: A (K, Ny, s), B (K, s, s)."""
    C = cholesky_blocked_batched(B, block=block, backend=backend)
    D = trsm_blocked_lower_t_batched(A, C, block=block, backend=backend)
    return trsm_blocked_lower_batched(D, C, block=block, backend=backend)


def cholesky_blocked(B: Tensor, *, block: int = 256,
                     backend: Optional[str] = None) -> Tensor:
    """Blocked lower Cholesky C with B = C C^T; returns (s, s) tril."""
    return cholesky_blocked_batched(B[None], block=block, backend=backend)[0]


def trsm_blocked_lower_t(A: Tensor, C: Tensor, *, block: int = 256,
                         backend: Optional[str] = None) -> Tensor:
    """D = A (C^T)^-1 for A (Ny, s), C (s, s) lower."""
    return trsm_blocked_lower_t_batched(A[None], C[None], block=block,
                                        backend=backend)[0]


def trsm_blocked_lower(Dm: Tensor, C: Tensor, *, block: int = 256,
                       backend: Optional[str] = None) -> Tensor:
    """W = D C^-1 for Dm (Ny, s), C (s, s) lower."""
    return trsm_blocked_lower_batched(Dm[None], C[None], block=block,
                                      backend=backend)[0]


def ridge_solve_blocked(A: Tensor, B: Tensor, *, block: int = 256,
                        backend: Optional[str] = None) -> Tensor:
    """The paper's pipeline on tiles: W~ = A B^-1 via Cholesky + 2 TRSMs."""
    return ridge_solve_blocked_batched(A[None], B[None], block=block,
                                       backend=backend)[0]
