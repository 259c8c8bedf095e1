"""K4a and K4b on Hopper: the tile Cholesky and the tile triangular solves.

The port of ``repro.kernels.cholesky``: ``_chol_tile`` (K4a) and
``_trsm_lower_t_tile`` / ``_trsm_lower_tile`` (K4b), the tiles that
``kernels.ridge_solve`` composes into the blocked factorization and the two
block substitutions.  Both kernels live in ``csrc/cholesky.cu``: K4a runs
one thread block per tile, blocked in panels of 32 columns with the same
rounded operations in the same order as its plain version; K4b a grid over
(row blocks, K) with one warp per right-hand-side row.  Their plain
versions are ``kernels.ref.chol_tile_ref``, ``trsm_lower_t_ref`` and
``trsm_lower_ref``.

The public tile functions keep the reference's names and shapes, single
tile and ``_batched`` over a leading K axis, and choose the kernel or the
plain version by the tensors' device (or ``backend``).  The reference's
``block_m`` is a TPU grid knob and has no counterpart: K4b picks its own
row blocks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import (CudaKernel, check_operand,
                                        resolve_backend, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int

MAX_TILE = 1024  # csrc/cholesky.cu: K4b's lane holds at most 32 columns

CHOL_KERNEL = CudaKernel("cholesky", "dfr_chol_tile", [_P, _P, _I, _I, _I, _P])
TRSM_KERNEL = CudaKernel(
    "cholesky", "dfr_trsm_tile", [_P, _P, _P, _I, _I, _I, _I, _I, _P])


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check_tiles(name: str, t: Tensor) -> tuple:
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    check_operand(name, t, torch.float32, dev)
    if t.ndim != 3 or t.shape[1] != t.shape[2]:
        raise ValueError(f"{name} must be (K, bs, bs), got {tuple(t.shape)}")
    k, bs, _ = t.shape
    if k < 1 or not (1 <= bs <= MAX_TILE):
        raise ValueError(f"the tile kernels take K >= 1 tiles of 1 <= bs <= "
                         f"{MAX_TILE}, got {tuple(t.shape)}")
    return k, bs, dev


def chol_tile_cuda(a: Tensor) -> Tensor:
    """Launch K4a once: lower factors L (K, bs, bs) of the SPD tiles a."""
    k, bs, dev = _check_tiles("a", a)
    L = torch.empty_like(a)
    CHOL_KERNEL.launch(a.data_ptr(), L.data_ptr(), k, bs, _device_index(dev),
                       stream_handle(dev))
    return L


def trsm_tile_cuda(rhs: Tensor, L: Tensor, backward: bool) -> Tensor:
    """Launch K4b once: X (K, m, bs) with X L^T = rhs (forward) or, with
    ``backward``, X L = rhs, for lower L (K, bs, bs)."""
    k, bs, dev = _check_tiles("L", L)
    check_operand("rhs", rhs, torch.float32, dev)
    if rhs.ndim != 3 or rhs.shape[0] != k or rhs.shape[2] != bs \
            or rhs.shape[1] < 1:
        raise ValueError(f"rhs must be ({k}, m, {bs}) with m >= 1, got "
                         f"{tuple(rhs.shape)}")
    out = torch.empty_like(rhs)
    TRSM_KERNEL.launch(rhs.data_ptr(), L.data_ptr(), out.data_ptr(), k,
                       rhs.shape[1], bs, int(backward), _device_index(dev),
                       stream_handle(dev))
    return out


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def chol_block_batched(a: Tensor, *,
                       backend: Optional[str] = None) -> Tensor:
    """Tile Cholesky of each member: a (K, bs, bs) SPD -> L (K, bs, bs)
    lower, strict upper zero (one K4a launch)."""
    if resolve_backend(backend, a) == "cuda":
        return chol_tile_cuda(_f32(a))
    return kref.chol_tile_ref(a)


def chol_block(a: Tensor, *, backend: Optional[str] = None) -> Tensor:
    """Cholesky of one (bs, bs) tile."""
    return chol_block_batched(a[None], backend=backend)[0]


def trsm_lower_t_batched(a: Tensor, L: Tensor, *,
                         backend: Optional[str] = None) -> Tensor:
    """X L^T = a per member: a (K, m, bs), L (K, bs, bs) lower (K4b)."""
    if resolve_backend(backend, a) == "cuda":
        return trsm_tile_cuda(_f32(a), _f32(L), backward=False)
    return kref.trsm_lower_t_ref(a, L)


def trsm_lower_batched(d: Tensor, L: Tensor, *,
                       backend: Optional[str] = None) -> Tensor:
    """X L = d per member: d (K, m, bs), L (K, bs, bs) lower (K4b)."""
    if resolve_backend(backend, d) == "cuda":
        return trsm_tile_cuda(_f32(d), _f32(L), backward=True)
    return kref.trsm_lower_ref(d, L)


def trsm_lower_t(a: Tensor, L: Tensor, *,
                 backend: Optional[str] = None) -> Tensor:
    """X L^T = a;  a: (m, bs), L: (bs, bs) lower-triangular."""
    return trsm_lower_t_batched(a[None], L[None], backend=backend)[0]


def trsm_lower(d: Tensor, L: Tensor, *,
               backend: Optional[str] = None) -> Tensor:
    """X L = d;  d: (m, bs), L: (bs, bs) lower-triangular."""
    return trsm_lower_batched(d[None], L[None], backend=backend)[0]
