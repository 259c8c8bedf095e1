"""K6 on Hopper: the unfused reservoir, every state x(k) stored.

The port of ``repro.kernels.reservoir._reservoir_kernel``.  The kernel
(``csrc/reservoir.cu``) runs one warp per sample and writes the whole state
sequence X (N, T, Nx), the frozen last state in every row past a sample's
length.  Its plain version is ``kernels.ref.reservoir_ref``;
``kernels.ops.reservoir_states`` chooses between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.types import Nonlinearity, Tensor
from repro_torch.kernels._build import (CudaKernel, check_sample_operands,
                                        stream_handle)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "reservoir", "dfr_reservoir_states",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _P],
)


def reservoir_states_cuda(
    j_seq: Tensor,
    lengths: Tensor,
    p: Tensor,
    q: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tensor:
    """Launch K6 once over all N samples (operand contract in
    ``kernels.ref``).  Returns X (N, T, Nx)."""
    n, t_len, nx, spp, dev = check_sample_operands(j_seq, lengths, p, q,
                                                    KERNEL, "K6 (reservoir)")
    X = torch.empty((n, t_len, nx), dtype=torch.float32, device=dev)
    KERNEL.launch(
        j_seq.data_ptr(), lengths.data_ptr(), p.data_ptr(), q.data_ptr(),
        n, t_len, nx, spp, f.code, float(f.alpha), X.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return X
