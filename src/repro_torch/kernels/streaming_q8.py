"""K5 on Hopper: the int8 fused streaming step (reservoir -> DPRR -> logits
on symmetric int8 codes).

The port of ``repro.kernels.streaming._streaming_kernel_q8``, the serving
logits of armed slots under ``quantize='int8'``.  The kernel
(``csrc/streaming_q8.cu``) keeps the state as int32 codes, runs the ring mix
and the DPRR accumulation in integers and dequantizes only the readout.  Its
plain version is ``kernels.ref.streaming_q8_ref``, which it matches code for
code; ``kernels.ops.streaming_logits_slots_q8`` builds the codes and scales
and chooses between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.types import Nonlinearity, Tensor
from repro_torch.kernels._build import (CudaKernel, check_operand,
                                        check_samples, stream_handle)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "streaming_q8", "dfr_streaming_logits_q8",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P],
)


def streaming_logits_q8_cuda(
    j_seq: Tensor,
    lengths: Tensor,
    Lq: Tensor,
    qpow: Tensor,
    scales: Tensor,
    Wq: Tensor,
    b: Tensor,
    f: Nonlinearity = Nonlinearity(),
    acc: Optional[Tensor] = None,
) -> Tensor:
    """Launch K5 once over all N samples (operand contract in
    ``kernels.ref``): logits (N, Ny), bias included.  With ``acc`` (N, Nx,
    Nx+1) int32 the kernel also writes its DPRR code accumulators there."""
    n_sys = Lq.shape[0]
    n, t_len, nx, spp, dev = check_samples(j_seq, lengths, n_sys, KERNEL,
                                           "K5 (streaming_q8)")
    nr = nx * (nx + 1)
    ny = Wq.shape[1] if Wq.ndim == 3 else -1
    for name, t, dtype, shape in (
            ("Lq", Lq, torch.int8, (n_sys, nx, nx)),
            ("qpow", qpow, torch.float32, (n_sys, nx)),
            ("scales", scales, torch.float32, (n_sys, 4)),
            ("Wq", Wq, torch.int8, (n_sys, ny, nr)),
            ("b", b, torch.float32, (n_sys, ny))):
        check_operand(name, t, dtype, dev, shape)
    if acc is not None:
        check_operand("acc", acc, torch.int32, dev, (n, nx, nx + 1))
    out = torch.empty((n, ny), dtype=torch.float32, device=dev)
    KERNEL.launch(
        j_seq.data_ptr(), lengths.data_ptr(), Lq.data_ptr(), qpow.data_ptr(),
        scales.data_ptr(), Wq.data_ptr(), b.data_ptr(), n, t_len, nx, ny,
        spp, f.code, float(f.alpha), out.data_ptr(),
        acc.data_ptr() if acc is not None else None,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return out
