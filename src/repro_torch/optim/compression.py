"""Gradient compression for a slow all-reduce (int8 + error feedback).

The port of ``repro.optim.compression``.  Per-tensor symmetric int8 codes
cut the reduced bytes 4x against f32; the quantization error is fed back
into the next step's gradient (error feedback keeps SGD unbiased to first
order).  The sum runs over a ``torch.distributed`` process group where the
reference takes a mesh axis name; ``group=None`` is one rank, the
reference's axis of size 1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.types import Tensor
from repro_torch.optim.optimizers import tree_map



def compress_int8(g: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-tensor int8 quantization: (codes, f32 scale), the
    codes ``clip(round(g / scale), -127, 127)`` (half to even)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor, dtype=torch.float32) -> Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(g: Tensor, group: Optional[dist.ProcessGroup],
                    residual: Tensor) -> Tuple[Tensor, Tensor]:
    """Error-feedback compressed all-reduce of one tensor over ``group``:
    (the mean gradient in g's dtype, the new residual).  The codes are
    summed as int32, the scales averaged (one shared scale)."""
    g_ef = g.to(torch.float32) + residual
    q, scale = compress_int8(g_ef)
    new_residual = g_ef - decompress_int8(q, scale)
    q_sum = q.to(torch.int32)
    n = 1.0
    if group is not None:
        n = float(dist.get_world_size(group))
        dist.all_reduce(q_sum, group=group)
        scale = scale.clone()
        dist.all_reduce(scale, group=group)
        scale = scale / n
    reduced = q_sum.to(torch.float32) * scale / n
    return reduced.to(g.dtype), new_residual


def tree_compressed_psum(grads, group: Optional[dist.ProcessGroup],
                         residuals):
    """``compressed_psum`` leaf by leaf: (reduced grads, new residuals),
    each in the grads' layout."""
    outs = tree_map(lambda g, r: compressed_psum(g, group, r), grads,
                    residuals)
    return (tree_map(lambda g, o: o[0], grads, outs),
            tree_map(lambda g, o: o[1], grads, outs))
