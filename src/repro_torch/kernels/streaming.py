"""K2 on Hopper: the fused streaming step (reservoir -> DPRR -> logits).

The port of ``repro.kernels.streaming._streaming_kernel``, the serving
path's infer-before-update.  The kernel (``csrc/streaming.cu``) runs the
reservoir and the DPRR accumulation with both held in registers and
contracts the accumulator with each system's readout, bias included; X and
r are never stored.  Its plain version is
``kernels.ref.streaming_logits_ref``; ``kernels.ops`` chooses between them
by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.types import Nonlinearity, Tensor
from repro_torch.kernels._build import (CudaKernel, check_sample_operands,
                                        stream_handle)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "streaming", "dfr_streaming_logits",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _I, _P],
)


def streaming_logits_cuda(
    j_seq: Tensor,
    lengths: Tensor,
    p: Tensor,
    q: Tensor,
    W: Tensor,
    b: Tensor,
    f: Nonlinearity = Nonlinearity(),
) -> Tensor:
    """Launch K2 once over all N samples (operand contract in
    ``kernels.ref``): logits (N, Ny) = r . W[system]^T + b[system]."""
    n, t_len, nx, spp, dev = check_sample_operands(j_seq, lengths, p, q)
    n_sys = p.shape[0]
    if W.ndim != 3 or W.shape[0] != n_sys or W.shape[2] != nx * (nx + 1):
        raise ValueError(f"W must be ({n_sys}, Ny, {nx * (nx + 1)}), got "
                         f"{tuple(W.shape)}")
    ny = W.shape[1]
    if b.shape != (n_sys, ny):
        raise ValueError(f"b must be ({n_sys}, {ny}), got {tuple(b.shape)}")
    for name, t in (("W", W), ("b", b)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    out = torch.empty((n, ny), dtype=torch.float32, device=dev)
    KERNEL.launch(
        j_seq.data_ptr(), lengths.data_ptr(), p.data_ptr(), q.data_ptr(),
        W.data_ptr(), b.data_ptr(), n, t_len, nx, ny, spp, f.code,
        float(f.alpha), out.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream_handle(dev),
    )
    return out
