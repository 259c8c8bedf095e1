"""K1 on Hopper: the fused training forward (reservoir -> DPRR aux).

The port of ``repro.kernels.train._train_forward_kernel``.  The kernel
(``csrc/train.cu``) emits ``(r, x_last, x_prev, j_last)`` per sample with the
state sequence X never stored: r is the DPRR vector and the other three are
the truncation boundary x(T), x(T-1), j(T) that truncated backprop needs.
Its plain version is ``kernels.ref.train_forward_ref``; ``kernels.ops``
chooses between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.types import Nonlinearity, Tensor
from repro_torch.kernels._build import (CudaKernel, check_sample_operands,
                                        stream_handle)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "train", "dfr_train_forward",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _I, _P],
)


def train_forward_cuda(
    j_seq: Tensor,
    lengths: Tensor,
    p: Tensor,
    q: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch K1 once over all N samples (operand contract in
    ``kernels.ref``).  Returns r (N, Nx*(Nx+1)) and x_last, x_prev, j_last
    (N, Nx)."""
    n, t_len, nx, spp, dev = check_sample_operands(j_seq, lengths, p, q)
    r = torch.empty((n, nx * (nx + 1)), dtype=torch.float32, device=dev)
    x_last, x_prev, j_last = (
        torch.empty((n, nx), dtype=torch.float32, device=dev)
        for _ in range(3))
    KERNEL.launch(
        j_seq.data_ptr(), lengths.data_ptr(), p.data_ptr(), q.data_ptr(),
        n, t_len, nx, spp, f.code, float(f.alpha),
        r.data_ptr(), x_last.data_ptr(), x_prev.data_ptr(), j_last.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return r, x_last, x_prev, j_last
