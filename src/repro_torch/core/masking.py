"""Input masking for the DFR (paper Sec. 2.1-2.2), in PyTorch.

The digital DFR multiplies the held input sample by a per-virtual-node mask:
``j(k) = M @ u(k)`` with ``M`` an (Nx, n_in) random matrix fixed at system
construction.  Each virtual node reads one random input channel with a
random +/-1 sign.

``make_mask`` draws from a ``torch.Generator``, which cannot replay the
reference's ``jax.random`` bits: to reproduce a reference system exactly,
pass its mask in (``StreamServer(mask=...)`` accepts one).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Tensor


def make_mask(
    generator: torch.Generator,
    n_nodes: int,
    n_in: int,
    dtype=torch.float32,
) -> Tensor:
    """Mask matrix M of shape (Nx, n_in), on the CPU: each virtual node
    reads ONE random input channel with a random +/-1 sign (the reference's
    default mode 'select')."""
    bits = torch.rand((n_nodes, n_in), generator=generator) < 0.5
    signs = torch.where(bits, 1.0, -1.0).to(dtype)
    sel = torch.randint(0, n_in, (n_nodes,), generator=generator)
    return signs * torch.nn.functional.one_hot(sel, n_in).to(dtype)


def apply_mask(mask: Tensor, u: Tensor) -> Tensor:
    """j(k) = M u(k), batched over any leading dims of ``u``.

    u: (..., n_in)  ->  j: (..., Nx)
    """
    return torch.einsum("ni,...i->...n", mask, u)
