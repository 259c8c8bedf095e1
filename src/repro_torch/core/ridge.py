"""Ridge regression engine of the stream server's refresh, in PyTorch.

The counterpart of the parts of ``repro.core.ridge`` that the recompute-mode
refresh runs: the streaming sufficient statistics (paper Eq. 21-22, 38) and
the batched Cholesky solve W~ = A (B + beta I)^-1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import Tensor


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
