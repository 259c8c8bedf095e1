"""Public wrappers around the port's kernels, with dispatch.

Backend per call:
  * ``backend='cuda'``  - the hand-written Hopper kernel; raises on tensors
                          that are not on a CUDA device.
  * ``backend='torch'`` - the plain PyTorch version (``kernels.ref``).
  * ``backend=None``    - from the tensors' device: 'cuda' for CUDA tensors,
                          'torch' for CPU tensors.  On a CUDA tensor the
                          kernel launches or raises; nothing falls back.

The wrappers take the reference's logical shapes (``repro.kernels.ops``) and
own the flattening to the kernels' (N, T, Nx) operands.  The reference's
TPU padding (``n_pad``, ``ny_pad``, the mirrored ring lane) has no
counterpart here: the kernels work on the true Nx and Ny.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import Nonlinearity, Tensor
from repro_torch.kernels import ref as kref
from repro_torch.kernels.streaming import streaming_logits_cuda
from repro_torch.kernels.train import train_forward_cuda

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: Optional[str], t: Tensor) -> str:
    if backend is None:
        return "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS} or None")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError(f"backend='cuda' needs CUDA tensors, got a tensor "
                         f"on {t.device}")
    return backend


def _flat(t: Tensor, shape, dtype) -> Tensor:
    return t.reshape(shape).to(dtype).contiguous()


def train_forward(
    j_seq: Tensor,                 # (*P, B, T, Nx) masked inputs
    lengths: Optional[Tensor],     # (*P, B) int, or None = full length
    p: Tensor,                     # (*P) per-system gains
    q: Tensor,                     # (*P)
    f: Nonlinearity = Nonlinearity(),
    *,
    backend: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused training forward: ``(r, x_last, x_prev, j_last)`` shaped
    (*P, B, Nr) and (*P, B, Nx) x3, with X never materialized (K1).
    ``p``/``q`` carry one value per system of the leading dims *P, so one
    call (one launch) covers every slot of a server step."""
    be = resolve_backend(backend, j_seq)
    *lead, b, t_len, nx = j_seq.shape
    n_sys = int(torch.Size(lead).numel())
    if lengths is None:
        lengths = torch.full((*lead, b), t_len, dtype=torch.int32,
                             device=j_seq.device)
    args = (_flat(j_seq, (n_sys * b, t_len, nx), torch.float32),
            _flat(lengths, (n_sys * b,), torch.int32),
            _flat(p, (n_sys,), torch.float32),
            _flat(q, (n_sys,), torch.float32), f)
    fn = train_forward_cuda if be == "cuda" else kref.train_forward_ref
    r, x_last, x_prev, j_last = fn(*args)
    dt = j_seq.dtype
    return (r.reshape(*lead, b, -1).to(dt),
            x_last.reshape(*lead, b, nx).to(dt),
            x_prev.reshape(*lead, b, nx).to(dt),
            j_last.reshape(*lead, b, nx).to(dt))


def streaming_logits_slots(
    j_seq: Tensor,     # (S, B, T, Nx) masked inputs, slot axis leading
    lengths: Tensor,   # (S, B) int
    p: Tensor,         # (S,) per-slot reservoir gains
    q: Tensor,         # (S,)
    W: Tensor,         # (S, Ny, Nr) per-slot readout weights
    b: Tensor,         # (S, Ny)
    f: Nonlinearity = Nonlinearity(),
    *,
    backend: Optional[str] = None,
) -> Tensor:
    """Readout logits (S, B, Ny) of every slot in one kernel launch (K2):
    the stream server's infer-before-update."""
    be = resolve_backend(backend, j_seq)
    n_sys, bsz, t_len, nx = j_seq.shape
    ny = W.shape[-2]
    args = (_flat(j_seq, (n_sys * bsz, t_len, nx), torch.float32),
            _flat(lengths, (n_sys * bsz,), torch.int32),
            _flat(p, (n_sys,), torch.float32),
            _flat(q, (n_sys,), torch.float32),
            _flat(W, (n_sys, ny, nx * (nx + 1)), torch.float32),
            _flat(b, (n_sys, ny), torch.float32), f)
    fn = streaming_logits_cuda if be == "cuda" else kref.streaming_logits_ref
    return fn(*args).reshape(n_sys, bsz, ny).to(j_seq.dtype)


def streaming_logits(
    j_seq: Tensor,     # (B, T, Nx) masked inputs
    lengths: Tensor,   # (B,) int
    p: Tensor,         # scalar
    q: Tensor,         # scalar
    W: Tensor,         # (Ny, Nr)
    b: Tensor,         # (Ny,)
    f: Nonlinearity = Nonlinearity(),
    *,
    backend: Optional[str] = None,
) -> Tensor:
    """Readout logits (B, Ny) of one system in one kernel launch (K2)."""
    return streaming_logits_slots(
        j_seq[None], lengths[None], torch.as_tensor(p)[None],
        torch.as_tensor(q)[None], W[None], b[None], f, backend=backend,
    )[0]
