"""K7 on Hopper: the DPRR of stored reservoir states.

The port of ``repro.kernels.dprr._dprr_kernel``.  The kernel
(``csrc/dprr.cu``) runs one warp per sample over its stored states X
(N, T, Nx) up to Nx = 32, and a block of ceil(Nx / 32)^2 warps above: the
sample's live rows stream through a ring in shared memory, each lane sums
an 8 x 4 tile of the outer products in registers, and r
(N, Nx*(Nx+1)) gets the outer products row-major, then the sums.  The
x(k) side is masked by the sample's length.  Its plain
version is ``kernels.ref.dprr_ref``; ``kernels.ops.dprr_features`` chooses
between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.types import Tensor
from repro_torch.kernels._build import (CudaKernel, check_nodes,
                                        check_operand, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "dprr", "dfr_dprr_features",
    [_P, _P, _I, _I, _I, _P, _I, _P],
)


def dprr_features_cuda(x: Tensor, lengths: Tensor) -> Tensor:
    """Launch K7 once over all N samples of X (N, T, Nx) with lengths (N,)
    int32.  Returns r (N, Nx*(Nx+1))."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {dev}")
    check_operand("x", x, torch.float32, dev)
    if x.ndim != 3:
        raise ValueError(f"x must be (N, T, Nx), got {tuple(x.shape)}")
    n, t_len, nx = x.shape
    check_nodes(KERNEL, "K7 (dprr)", nx)
    if n < 1 or t_len < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")
    check_operand("lengths", lengths, torch.int32, dev, (n,))
    r = torch.empty((n, nx * (nx + 1)), dtype=torch.float32, device=dev)
    KERNEL.launch(
        x.data_ptr(), lengths.data_ptr(), n, t_len, nx, r.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return r
