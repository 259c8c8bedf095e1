"""Dot-Product Reservoir Representation (DPRR), paper Sec. 2.3, in PyTorch.

    r_{(i-1)Nx+j} = sum_{k=1..T} x(k)_i x(k-1)_j      (Eq. 27)
    r_{Nx^2 + i}  = sum_{k=1..T} x(k)_i               (Eq. 28)
    with x(0) = 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import Tensor


def shifted_states(x: Tensor) -> Tensor:
    """X0 = [0, x(1), ..., x(T-1)]: the x(k-1) stream with x(0) = 0.

    x: (..., T, Nx) -> (..., T, Nx)
    """
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[..., :-1, :]


def compute_dprr(x: Tensor, lengths: Optional[Tensor] = None) -> Tensor:
    """DPRR vector r of a state sequence.

    x: (..., T, Nx) reservoir states; lengths: optional (...) valid lengths,
    padded steps contribute nothing.  Returns (..., Nx*(Nx+1)): the
    flattened (Nx, Nx) dot-product block followed by the Nx sum block.
    """
    n_nodes = x.shape[-1]
    x0 = shifted_states(x)
    if lengths is not None:
        t = torch.arange(x.shape[-2], device=x.device)
        live = (t < lengths[..., None]).to(x.dtype)
        x1m = x * live[..., None]
    else:
        x1m = x
    outer = torch.einsum("...ki,...kj->...ij", x1m, x0)
    sums = x1m.sum(dim=-2)
    flat = outer.reshape(*outer.shape[:-2], n_nodes * n_nodes)
    return torch.cat([flat, sums], dim=-1)


def r_tilde(r: Tensor) -> Tensor:
    """r~ = [r, 1] (paper Eq. 16), batched over leading dims."""
    ones = torch.ones((*r.shape[:-1], 1), dtype=r.dtype, device=r.device)
    return torch.cat([r, ones], dim=-1)
