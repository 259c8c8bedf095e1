"""Shared model layers: inits, norms, RoPE, embeddings.

The port of ``repro.models.layers``.  The inits draw the reference's
distributions from an explicit ``torch.Generator`` (the same laws, not the
same numbers: ``convert.lm_params_from_numpy`` carries the reference's own
values over).  They draw in fp32 on the generator's device and cast: a CPU
generator gives the same parameters on every device, a CUDA generator draws
a model too large for the host straight onto the card.  With no generator
(``None``) they draw nothing and return tensors on the meta device: the
shapes and dtypes alone, as the reference's ``eval_shape`` gives them.

Each init takes the leaf's logical axes (``("embed", "heads")``: the
reference's ``PV`` axes) and sets them on the tensor it returns as
``tensor.axes``; ``models.transformer.ParamTree`` keeps them beside the
parameter, and ``distributed.sharding`` maps them onto a mesh.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import Tensor
from repro_torch.distributed.sharding import reduce_partial

Axes = Tuple[Optional[str], ...]


def with_axes(t: Tensor, axes: Axes) -> Tensor:
    """``t`` with its logical axes set as ``t.axes``."""
    if len(axes) != t.ndim:
        raise ValueError(f"axes {axes} do not match shape {tuple(t.shape)}")
    t.axes = tuple(axes)
    return t


def init_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where an init puts its tensors: the generator's device, or the meta
    device when there is no generator."""
    return torch.device("meta") if generator is None else generator.device


def normal(generator: Optional[torch.Generator], shape) -> Tensor:
    """Standard normal fp32 draws on the generator's device (nothing drawn
    on the meta device without a generator)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=init_device(generator))


def dense_init(
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    axes: Axes,
    dtype=torch.bfloat16,
    scale: Optional[float] = None,
    fan_in: Optional[int] = None,
) -> Tensor:
    """Normal weights with std ``fan_in ** -0.5`` (fan_in = shape[0])."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    return with_axes((normal(generator, shape) * scale).to(dtype), axes)


def zeros_init(shape, axes: Axes, dtype=torch.bfloat16,
               device=None) -> Tensor:
    return with_axes(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones_init(shape, axes: Axes, dtype=torch.bfloat16,
              device=None) -> Tensor:
    return with_axes(torch.ones(shape, dtype=dtype, device=device), axes)


def full_init(shape, value: float, axes: Axes, dtype=torch.bfloat16,
              device=None) -> Tensor:
    return with_axes(torch.full(shape, value, dtype=dtype, device=device),
                     axes)


# ---------------------------------------------------------------------------
# Norms (f32 accumulation)
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(x.dtype)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (classic + M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4) -> Tensor:
    """x: (B, T, H, D); positions: (B, T) int."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_m_rope(x: Tensor, positions: Tensor, theta: float = 1e4,
                 sections=(16, 24, 24)) -> Tensor:
    """Multimodal RoPE (Qwen2-VL): positions (B, T, 3) = (t, h, w) ids.

    The head_dim/2 frequency slots are split into ``sections`` groups, each
    rotated by one positional stream.  For text tokens the three streams
    are equal and M-RoPE degenerates to 1-D RoPE.
    """
    d = x.shape[-1]
    n_half = d // 2
    if sum(sections) != n_half:
        raise ValueError(f"sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {n_half}")
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    bounds = torch.cumsum(torch.tensor(sections, device=x.device), 0)
    slot = torch.arange(n_half, device=x.device)
    sec_id = (slot[:, None] >= bounds[None, :]).sum(-1)  # (D/2,) in 0..2
    angles = positions.to(torch.float32)[..., sec_id] * freqs  # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal(max_len: int, d: int) -> Tensor:
    """The (max_len, d) fp32 table of absolute positions (whisper): sines
    then cosines, ``repro.models.transformer._sinusoidal``."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32)[None]
    inv = torch.exp(-torch.log(torch.tensor(10000.0)) * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_init(generator: Optional[torch.Generator], vocab: int,
               d_model: int, dtype=torch.bfloat16) -> Tensor:
    w = normal(generator, (vocab, d_model))
    return with_axes((w * (d_model ** -0.5)).to(dtype),
                     ("vocab", "embed_no_shard"))


def embed_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """Rows of the table (``F.embedding``).  A sharded table (a DTensor,
    vocab over 'model') has DTensor shard the lookup: each rank reads its
    own rows, and the partial rows are summed at once (the masked partial
    sum lives only until the next operation)."""
    return reduce_partial(torch.nn.functional.embedding(ids, table))


def unembed(x: Tensor, table: Tensor) -> Tensor:
    """Logits in f32 (stable CE)."""
    return torch.einsum("btd,vd->btv", x.to(torch.float32),
                        table.to(torch.float32))
