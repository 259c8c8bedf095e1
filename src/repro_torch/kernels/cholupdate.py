"""K3 on Hopper: the rank-1 window fold into live transposed factors.

The port of ``repro.kernels.cholupdate._cholupd_tile``: W sample rows
rotated, in stream order, into each of K transposed Cholesky factors
(``sign=+1`` update, ``sign=-1`` guarded hyperbolic downdate).  The kernel
(``csrc/cholupdate.cu``) runs one block per factor and folds in place:
one warp runs the chain of rotations down the diagonal, the other seven
apply each step to the rest of its row one step behind.  An optional
per-row scale (the forgetting factor's sqrt(lambda)) multiplies each factor
before each row, and an optional flag output reports, per factor, whether
the downdate guard skipped a rotation.
A bf16 factor folds in one pass (at most ``pass_rows(s, True)`` rows):
the kernel reads its rows as bf16, rotates in fp32 and rounds each element
to bf16 once, where it writes it.
Its plain version is ``core.ridge.cholupdate_window_t``;
``kernels.ops.cholupdate_window_t`` chooses between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels._build import (CudaKernel, c_function, check_operand,
                                        stream_handle)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "cholupdate", "dfr_cholupdate_window_t",
    [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
)


@functools.lru_cache(maxsize=None)
def pass_rows(s: int, bf16: bool) -> int:
    """The sample rows one launch folds in one pass into factors of s: a
    bf16 factor takes at most that many rows (csrc/cholupdate.cu)."""
    fn, _ = c_function("cholupdate", "dfr_cholupdate_pass_rows", [_I, _I])
    return int(fn(int(s), int(bf16)))


@functools.lru_cache(maxsize=None)
def max_factor(bf16: bool = False) -> int:
    """The largest factor s one launch takes: the largest whose pass of one
    sample row fits in shared memory (csrc/cholupdate.cu's smem_bytes);
    about 5,800, so Nx <= 75 at s = Nx^2 + Nx + 1."""
    fn, _ = c_function("cholupdate", "dfr_cholupdate_max_factor", [_I])
    return int(fn(int(bf16)))


def cholupdate_window_t_cuda(Lt: Tensor, X: Tensor, sign: float,
                             scale: Optional[Tensor] = None,
                             flags: Optional[Tensor] = None) -> Tensor:
    """Launch K3 once: fold X (K, W, s) into Lt (K, s, s) in place, and
    return Lt.  Only its upper triangle is read and written.  Lt is
    float32, or bfloat16 with W at most ``pass_rows(s, True)``.  ``scale``
    (K, W) float32 scales each factor before each row; ``flags`` (K,) int32
    receives whether the downdate guard skipped a rotation of each
    factor."""
    dev = Lt.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    if Lt.ndim != 3 or Lt.shape[1] != Lt.shape[2]:
        raise ValueError(f"Lt must be (K, s, s), got {tuple(Lt.shape)}")
    k, s, _ = Lt.shape
    bf16 = Lt.dtype == torch.bfloat16
    cap = max_factor(bf16)
    if not (1 <= s <= cap) or k < 1:
        raise ValueError(
            f"K3 (cholupdate) takes K >= 1 factors of 1 <= s <= {cap} on the "
            f"card (one sample row a pass in shared memory), got "
            f"{tuple(Lt.shape)}; longer factors are ROADMAP Queue 2's item 2")
    if X.ndim != 3 or X.shape[0] != k or X.shape[2] != s:
        raise ValueError(f"X must be ({k}, W, {s}), got {tuple(X.shape)}")
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    check_operand("Lt", Lt, torch.bfloat16 if bf16 else torch.float32, dev)
    check_operand("X", X, torch.float32, dev)
    w = X.shape[1]
    if bf16 and w > pass_rows(s, True):
        raise ValueError(f"a bf16 factor of s={s} takes at most "
                         f"{pass_rows(s, True)} rows a launch, got W={w}")
    if scale is not None:
        check_operand("scale", scale, torch.float32, dev, (k, w))
    if flags is not None:
        check_operand("flags", flags, torch.int32, dev, (k,))
    if w == 0:
        if flags is not None:
            flags.zero_()
        return Lt
    KERNEL.launch(
        Lt.data_ptr(), X.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if flags is None else flags.data_ptr(),
        k, s, w, float(sign), int(bf16),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return Lt
