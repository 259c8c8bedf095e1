"""Feed-forward blocks: SwiGLU / GeLU MLPs.

The port of ``repro.models.ffn``.  The reference's ``fsdp_gather`` and
``shard_act`` are the identity without a device mesh, so they have no
counterpart here.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tensor
from repro_torch.models.layers import dense_init


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16, gated: bool = True) -> Dict[str, Tensor]:
    p = {
        "w_up": dense_init(generator, (d_model, d_ff), dtype),
        "w_down": dense_init(generator, (d_ff, d_model), dtype),
    }
    if gated:
        p["w_gate"] = dense_init(generator, (d_model, d_ff), dtype)
    return p


def _act(x: Tensor, activation: str) -> Tensor:
    """The activation in f32, back in x's dtype (tanh-approximate GeLU, as
    ``jax.nn.gelu``'s default)."""
    xf = x.to(torch.float32)
    y = F.silu(xf) if activation == "silu" else F.gelu(xf, approximate="tanh")
    return y.to(x.dtype)


def mlp_apply(p: Mapping[str, Tensor], x: Tensor,
              activation: str = "silu") -> Tensor:
    """x: (B, T, d_model)."""
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        gate = x @ p["w_gate"].to(x.dtype)
        h = _act(gate, "silu" if activation == "silu" else "gelu") * up
    else:
        h = _act(up, "gelu" if activation == "gelu" else "silu")
    return h @ p["w_down"].to(x.dtype)
