"""K3 on Hopper: the rank-1 window fold into live transposed factors.

The port of ``repro.kernels.cholupdate._cholupd_tile``: W sample rows
rotated, in stream order, into each of K transposed Cholesky factors
(``sign=+1`` update, ``sign=-1`` guarded hyperbolic downdate).  The kernel
(``csrc/cholupdate.cu``) runs one block per factor and folds in place:
one warp runs the chain of rotations down the diagonal, the other seven
apply each step to the rest of its row one step behind.
Its plain version is ``core.ridge.cholupdate_window_t``;
``kernels.ops.cholupdate_window_t`` chooses between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels._build import (CudaKernel, check_operand,
                                        stream_handle)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

MAX_FACTOR = 4096  # csrc/cholupdate.cu: passes of 5 rows in shared memory

KERNEL = CudaKernel(
    "cholupdate", "dfr_cholupdate_window_t",
    [_P, _P, _I, _I, _I, _F, _I, _P],
)


def cholupdate_window_t_cuda(Lt: Tensor, X: Tensor, sign: float) -> Tensor:
    """Launch K3 once: fold X (K, W, s) into Lt (K, s, s) in place, and
    return Lt.  Only its upper triangle is read and written."""
    dev = Lt.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    if Lt.ndim != 3 or Lt.shape[1] != Lt.shape[2]:
        raise ValueError(f"Lt must be (K, s, s), got {tuple(Lt.shape)}")
    k, s, _ = Lt.shape
    if not (1 <= s <= MAX_FACTOR) or k < 1:
        raise ValueError(f"K3 takes K >= 1 factors of 1 <= s <= {MAX_FACTOR}"
                         f", got {tuple(Lt.shape)}")
    if X.ndim != 3 or X.shape[0] != k or X.shape[2] != s:
        raise ValueError(f"X must be ({k}, W, {s}), got {tuple(X.shape)}")
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    check_operand("Lt", Lt, torch.float32, dev)
    check_operand("X", X, torch.float32, dev)
    if X.shape[1] == 0:
        return Lt
    KERNEL.launch(
        Lt.data_ptr(), X.data_ptr(), k, s, X.shape[1], float(sign),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return Lt
