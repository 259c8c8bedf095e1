"""Feed-forward blocks: SwiGLU / GeLU MLPs.

The port of ``repro.models.ffn``: tensor parallel over d_ff, the weights
gathered over the FSDP axes at their use (``distributed.sharding``; both
are the identity without a mesh).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tensor
from repro_torch.distributed.sharding import fsdp_gather, shard_act
from repro_torch.models.layers import dense_init


def mlp_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype=torch.bfloat16, gated: bool = True) -> Dict[str, Tensor]:
    p = {
        "w_up": dense_init(generator, (d_model, d_ff), ("embed", "mlp"),
                           dtype),
        "w_down": dense_init(generator, (d_ff, d_model), ("mlp", "embed"),
                             dtype),
    }
    if gated:
        p["w_gate"] = dense_init(generator, (d_model, d_ff),
                                 ("embed", "mlp"), dtype)
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
    up = x @ fsdp_gather(p["w_up"], ("embed", "mlp")).to(x.dtype)
    if "w_gate" in p:
        w_gate = fsdp_gather(p["w_gate"], ("embed", "mlp"))
        gate = x @ w_gate.to(x.dtype)
        h = _act(gate, "silu" if activation == "silu" else "gelu") * up
    else:
        h = _act(up, "gelu" if activation == "gelu" else "silu")
    h = shard_act(h, ("batch", None, "act_model"))
    return h @ fsdp_gather(p["w_down"], ("mlp", "embed")).to(x.dtype)
