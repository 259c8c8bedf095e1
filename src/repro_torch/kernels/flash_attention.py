"""K8 on Hopper: flash attention forward (online softmax, causal / sliding
window, GQA).

The port of ``repro.kernels.flash_attention._flash_kernel``.  The kernel
(``csrc/flash_attention.cu``) runs one block per (batch, head, query tile)
with the KV loop inside the block, and key tiles above the causal diagonal
or outside the window skipped by their index.  bf16 inputs take the tensor
cores: a producer warp loads Q once and K/V tiles into a ring of shared
memory by TMA, and two consumer warpgroups run both products as ``wgmma``
(P split into two bf16 halves so that it is not rounded once).  fp32 inputs
take a SIMT kernel with fp32 FMAs on the CUDA cores.  Both read q, k and v
through their strides, so the model's (B, T, H, D) activations enter as
transposed views, and write the output into a (B, T, H, D) buffer returned
as its (B, H, T, D) view: the model's transpose back is then contiguous.
The TMA unit needs each operand's base address 16-byte aligned and its
strides multiples of 16 bytes; a bf16 call that breaks this raises and
never drops to the SIMT kernel.  Its plain version is ``kernels.ref.
flash_attention_ref``; ``kernels.ops.flash_attention`` chooses between them
by the tensors' device.

``flash_attention_k8`` is K8 registered with ``torch.library`` as the op
``repro_torch::flash_attention_k8``: on a CUDA tensor it launches the
kernel (``flash_attention_cuda``); on a fake tensor (the dry run,
``launch.steps.lower_cell``) it gives the output's shape alone, and the
FLOP counter (``torch.utils.flop_counter``) counts it at 4 * D FLOPs a
live (query, key) pair and head: the two products of the pair, as the
kernel skips dead key tiles.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels._build import CudaKernel, stream_handle

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "flash_attention", "dfr_flash_attention",
    [_P] * 4 + [_L] * 12 + [_I] * 10 + [_F, _I, _P],
)
HEAD_DIMS = (32, 64, 128)   # the tiles' widths on both routes
TMA_ALIGN = 16              # bytes: TMA base addresses and strides
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535         # heads and batch are the grid's y and z


def _check(q: Tensor, k: Tensor, v: Tensor) -> tuple:
    """Validate K8's operands; returns (B, H, KV, Tq, Tk, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"K8 takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    b, h, tq, d = q.shape
    kv, tk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, tk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, KV, Tk, D) = ({b}, KV, Tk, "
                         f"{d}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if min(b, h, kv, tq, tk) < 1 or h % kv:
        raise ValueError(f"need B, H, KV, Tq, Tk >= 1 and KV | H, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"K8 takes head_dim in {HEAD_DIMS}, got {d}")
    if max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"K8 takes B, H <= {MAX_GRID_YZ}, got {b}, {h}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    return b, h, kv, tq, tk, d


def _check_tma(name: str, t: Tensor) -> None:
    """Raise unless the TMA unit can read ``t``: a 16-byte aligned base and
    (B, H, T) strides that are multiples of 16 bytes (a dimension of extent
    1 is never stepped, so its stride does not matter)."""
    es = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name}'s base address is not {TMA_ALIGN}-byte "
                         f"aligned (K8's bf16 route loads it by TMA)")
    for n, s in zip(t.shape[:3], t.stride()[:3]):
        if n > 1 and (s * es) % TMA_ALIGN:
            raise ValueError(f"{name}'s strides {tuple(t.stride())} are not "
                             f"multiples of {TMA_ALIGN} bytes (K8's bf16 "
                             f"route loads it by TMA)")


def flash_attention_cuda(
    q: Tensor,   # (B, H, Tq, D)
    k: Tensor,   # (B, KV, Tk, D)
    v: Tensor,   # (B, KV, Tk, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
) -> Tensor:
    """Launch K8 once.  Returns out (B, H, Tq, D) in q's dtype, a view of a
    contiguous (B, Tq, H, D) buffer.  Row i of q is masked as position
    ``q_offset + i``."""
    b, h, kv, tq, tk, d = _check(q, k, v)
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, h, kv, tq, tk, d, DTYPES[q.dtype], int(bool(causal)), int(window),
        int(q_offset), float(scale),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return out


def live_pairs(tq: int, tk: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """The (query, key) pairs K8's mask keeps: key j is live for the query
    at position i when j <= i (causal) and j > i - window (window > 0)."""
    total = 0
    for i in range(q_offset, q_offset + tq):
        hi = min(i + 1, tk) if causal else tk
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


@torch.library.custom_op("repro_torch::flash_attention_k8", mutates_args=())
def flash_attention_k8(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int, q_offset: int) -> Tensor:
    """K8 as a dispatcher op: (B, H, Tq, D) out of q (B, H, Tq, D) and k/v
    (B, KV, Tk, D).  A CUDA tensor launches the kernel; there is no CPU
    kernel (the CPU runs the plain versions)."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)


@flash_attention_k8.register_fake
def _(q, k, v, causal, window, q_offset):
    b, h, tq, d = q.shape
    return q.new_empty((b, tq, h, d)).transpose(1, 2)


def _k8_flops(q_shape, k_shape, v_shape, causal, window, q_offset, *args,
              **kwargs):
    b, h, tq, d = q_shape
    return 4 * d * b * h * live_pairs(tq, k_shape[2], causal, window,
                                      q_offset)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(torch.ops.repro_torch.flash_attention_k8)(
        _k8_flops)


_register_flops()
