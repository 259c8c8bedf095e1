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
TPU padding (``n_pad``, ``ny_pad``, the mirrored ring lane) and its tiling
knobs (``block_b``, ``chunk_t``, ``block_t``, and flash attention's
``block_q``, ``block_k``) have no counterpart here: the kernels work on the
true Nx and Ny and choose their own tiles.  The wrappers keep the
reference's order, ``(..., n_nodes, *, f, chunk_t, backend)``, take
``chunk_t`` only so that a reference-style call runs, and check
``n_nodes`` against the node axis.  ``block`` stays on the ridge solve and
the Cholesky: it is the tile size of K4a and K4b.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core import reservoir as core_res
from repro_torch.core import ridge as core_ridge
from repro_torch.core.types import Nonlinearity, Tensor
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ridge_solve as kridge
from repro_torch.kernels._build import resolve_backend
from repro_torch.kernels.cholupdate import cholupdate_window_t_cuda
from repro_torch.kernels.cholupdate import pass_rows as cholupdate_pass_rows
from repro_torch.kernels.dprr import dprr_features_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.reservoir import reservoir_states_cuda
from repro_torch.kernels.streaming import streaming_logits_cuda
from repro_torch.kernels.streaming_q8 import streaming_logits_q8_cuda
from repro_torch.kernels.train import train_forward_cuda

MAX_Q8_STEPS = 2 ** 17  # int32 headroom of K5's accumulator: 127^2 * T


# ---------------------------------------------------------------------------
# Symmetric int8 quantization (the reference's convention: scale =
# absmax / 127 with an epsilon floor, codes clipped to +-127, no zero point;
# rounding is half to even in both frameworks)
# ---------------------------------------------------------------------------


def symmetric_scale(absmax: Tensor, eps: float = 1e-12) -> Tensor:
    """Symmetric int8 scale ``max(absmax, eps) / 127``; the floor keeps an
    all-zero operand coding to zeros instead of NaNs."""
    return torch.clamp(absmax.to(torch.float32), min=eps) / 127.0


def quantize_symmetric(v: Tensor, scale: Tensor) -> Tensor:
    """fp -> int8 codes: ``clip(round(v / scale), -127, 127)``."""
    return torch.clamp(torch.round(v.to(torch.float32) / scale),
                       -127, 127).to(torch.int8)


def dequantize_symmetric(q: Tensor, scale: Tensor,
                         dtype=torch.float32) -> Tensor:
    """int8 codes -> fp: ``q * scale``."""
    return (q.to(torch.float32) * scale).to(dtype)


def _flat(t: Tensor, shape, dtype) -> Tensor:
    return t.reshape(shape).to(dtype).contiguous()


def _gain(v, like: Tensor) -> Tensor:
    """A scalar gain (float or tensor) as the (1,) f32 operand of one
    system."""
    return torch.as_tensor(v, device=like.device).reshape(1).to(
        torch.float32)


def _check_nodes(nx: int, n_nodes: int) -> None:
    if nx != n_nodes:
        raise ValueError(f"n_nodes={n_nodes} does not match the node axis "
                         f"Nx={nx}")


def reservoir_states(
    j_seq: Tensor,      # (B, T, Nx) masked inputs
    lengths: Tensor,    # (B,) int
    p: Tensor,          # scalar
    q: Tensor,          # scalar
    n_nodes: int,
    *,
    f: Nonlinearity = Nonlinearity(),
    backend: Optional[str] = None,
) -> Tensor:
    """Reservoir states X (B, T, Nx) from x(0) = 0, every step stored and
    the frozen last state in each row past a length (K6)."""
    be = resolve_backend(backend, j_seq)
    b, t_len, nx = j_seq.shape
    _check_nodes(nx, n_nodes)
    args = (_flat(j_seq, (b, t_len, nx), torch.float32),
            _flat(lengths, (b,), torch.int32), _gain(p, j_seq),
            _gain(q, j_seq), f)
    fn = reservoir_states_cuda if be == "cuda" else kref.reservoir_ref
    return fn(*args).to(j_seq.dtype)


def dprr_features(
    x: Tensor,          # (B, T, Nx) reservoir states
    lengths: Tensor,    # (B,) int
    n_nodes: int,
    *,
    backend: Optional[str] = None,
) -> Tensor:
    """Batched DPRR r vectors (B, Nx*(Nx+1)) of stored states: the outer
    products row-major, then the sums (K7)."""
    be = resolve_backend(backend, x)
    b, t_len, nx = x.shape
    _check_nodes(nx, n_nodes)
    args = (_flat(x, (b, t_len, nx), torch.float32),
            _flat(lengths, (b,), torch.int32))
    fn = dprr_features_cuda if be == "cuda" else kref.dprr_ref
    return fn(*args).to(x.dtype)


def ridge_solve(
    A: Tensor,          # (Ny, s)
    B: Tensor,          # (s, s), SPD
    *,
    block: int = 256,
    backend: Optional[str] = None,
) -> Tensor:
    """W~ = A B^-1.  'cuda': the blocked solve over the tile kernels K4a
    and K4b with tiles of ``block``; 'torch': the unblocked library solve
    (``kref.ridge_solve_ref``), as the reference's XLA branch.  A system
    that is not positive definite gives NaN either way."""
    if resolve_backend(backend, B) == "torch":
        return kref.ridge_solve_ref(A, B)
    return kridge.ridge_solve_blocked(A, B, block=block, backend="cuda")


def cholesky(
    B: Tensor,          # (s, s), SPD
    *,
    block: int = 256,
    backend: Optional[str] = None,
) -> Tensor:
    """Lower Cholesky factor of B.  'cuda': the blocked solve over K4a and
    K4b; 'torch': ``kref.chol_ref``, as the reference's XLA branch."""
    if resolve_backend(backend, B) == "torch":
        return kref.chol_ref(B)
    return kridge.cholesky_blocked(B, block=block, backend="cuda")


def train_forward(
    j_seq: Tensor,                 # (*P, B, T, Nx) masked inputs
    lengths: Optional[Tensor],     # (*P, B) int, or None = full length
    p: Tensor,                     # (*P) per-system gains
    q: Tensor,                     # (*P)
    n_nodes: int,
    *,
    f: Nonlinearity = Nonlinearity(),
    chunk_t: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused training forward: ``(r, x_last, x_prev, j_last)`` shaped
    (*P, B, Nr) and (*P, B, Nx) x3, with X never materialized (K1).
    ``p``/``q`` carry one value per system of the leading dims *P, so one
    call (one launch) covers every slot of a server step.  ``chunk_t`` is
    the reference's time tiling, taken for its call signature and unused
    (the kernel chooses its own tiles)."""
    be = resolve_backend(backend, j_seq)
    *lead, b, t_len, nx = j_seq.shape
    _check_nodes(nx, n_nodes)
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
    n_nodes: int,
    *,
    f: Nonlinearity = Nonlinearity(),
    chunk_t: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tensor:
    """Readout logits (S, B, Ny) of every slot in one kernel launch (K2):
    the stream server's infer-before-update.  ``chunk_t`` is the
    reference's time tiling, taken for its call signature and unused."""
    be = resolve_backend(backend, j_seq)
    n_sys, bsz, t_len, nx = j_seq.shape
    _check_nodes(nx, n_nodes)
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
    n_nodes: int,
    *,
    f: Nonlinearity = Nonlinearity(),
    chunk_t: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tensor:
    """Readout logits (B, Ny) of one system in one kernel launch (K2)."""
    return streaming_logits_slots(
        j_seq[None], lengths[None], torch.as_tensor(p)[None],
        torch.as_tensor(q)[None], W[None], b[None], n_nodes, f=f,
        backend=backend,
    )[0]


def streaming_logits_slots_q8(
    j_seq: Tensor,     # (S, B, T, Nx) masked inputs, slot axis leading
    lengths: Tensor,   # (S, B) int
    p: Tensor,         # (S,) per-slot reservoir gains
    q: Tensor,         # (S,) (coded into ring-matrix codes here)
    Wq: Tensor,        # (S, Ny, Nr) int8 readout codes
    w_scale: Tensor,   # (S,) f32 readout scale (0 = unarmed)
    x_scale: Tensor,   # (S,) f32 reservoir-state scale (0 = unarmed)
    b: Tensor,         # (S, Ny) fp readout bias (stays fp)
    n_nodes: int,
    *,
    f: Nonlinearity = Nonlinearity(),
    chunk_t: Optional[int] = None,
    backend: Optional[str] = None,
    return_acc: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Int8 readout logits (S, B, Ny) f32 of every slot in one kernel
    launch (K5): the stream server's serving path for armed slots.

    Owns the code and scale prep, once, in PyTorch, so the kernel and its
    plain version see the same bits: the ring matrix L(q) and its powers
    in fp32 (``core.reservoir``), ring codes with sL = max|L| / 127, and the
    unarmed scales (0) replaced by 1.0 so the program stays NaN-free (the
    caller discards unarmed slots' logits).  ``return_acc`` also returns the
    int32 DPRR code accumulators (S, B, Nx, Nx+1).  ``chunk_t`` is the
    reference's time tiling, taken for its call signature and unused.
    """
    be = resolve_backend(backend, j_seq)
    n_sys, bsz, t_len, nx = j_seq.shape
    _check_nodes(nx, n_nodes)
    args = streaming_q8_operands(j_seq, lengths, p, q, Wq, w_scale, x_scale,
                                 b, f)
    if be == "cuda":
        acc = (torch.empty((n_sys * bsz, nx, nx + 1), dtype=torch.int32,
                           device=j_seq.device) if return_acc else None)
        logits = streaming_logits_q8_cuda(*args, acc=acc)
    else:
        logits, acc = kref.streaming_q8_ref(*args)
    logits = logits.reshape(n_sys, bsz, -1)
    if return_acc:
        return logits, acc.reshape(n_sys, bsz, nx, nx + 1)
    return logits


def streaming_q8_operands(j_seq, lengths, p, q, Wq, w_scale, x_scale, b,
                          f: Nonlinearity = Nonlinearity()) -> tuple:
    """The flat operands of K5 and of its plain version (contract in
    ``kernels.ref``) from ``streaming_logits_slots_q8``'s arguments."""
    n_sys, bsz, t_len, nx = j_seq.shape
    if t_len > MAX_Q8_STEPS:
        raise ValueError(f"int8 streaming takes T <= {MAX_Q8_STEPS} (int32 "
                         f"accumulator headroom), got T={t_len}")
    ny = Wq.shape[-2]
    q32 = q.to(torch.float32)
    L = core_res.ring_matrix(q32, nx, torch.float32)           # (S, Nx, Nx)
    sL = symmetric_scale(L.abs().amax(dim=(-2, -1)))
    Lq = quantize_symmetric(L, sL[:, None, None])
    qpow = core_res.ring_powers(q32, nx, torch.float32)        # (S, Nx)
    sx = torch.where(x_scale > 0, x_scale, 1.0).to(torch.float32)
    sw = torch.where(w_scale > 0, w_scale, 1.0).to(torch.float32)
    scales = torch.stack([p.to(torch.float32), sx, sL, sw], dim=-1)
    return (_flat(j_seq, (n_sys * bsz, t_len, nx), torch.float32),
            _flat(lengths, (n_sys * bsz,), torch.int32),
            Lq.contiguous(), qpow.contiguous(), scales.contiguous(),
            _flat(Wq, (n_sys, ny, nx * (nx + 1)), torch.int8),
            _flat(b, (n_sys, ny), torch.float32), f)


def streaming_logits_q8(
    j_seq: Tensor,     # (B, T, Nx) masked inputs
    lengths: Tensor,   # (B,) int
    p: Tensor,         # scalar
    q: Tensor,         # scalar
    Wq: Tensor,        # (Ny, Nr) int8
    w_scale: Tensor,   # scalar
    x_scale: Tensor,   # scalar
    b: Tensor,         # (Ny,)
    n_nodes: int,
    *,
    f: Nonlinearity = Nonlinearity(),
    chunk_t: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tensor:
    """Int8 readout logits (B, Ny) of one system in one kernel launch (K5)."""
    def one(v):
        return torch.as_tensor(v)[None]

    return streaming_logits_slots_q8(
        j_seq[None], lengths[None], one(p), one(q), Wq[None], one(w_scale),
        one(x_scale), b[None], n_nodes, f=f, backend=backend,
    )[0]


def cholupdate_window_t(
    Lt: Tensor,        # (*K, s, s) transposed live factors (upper)
    X: Tensor,         # (*K, W, s) sample rows, stream order
    sign: float = 1.0,
    *,
    scale: Optional[Tensor] = None,   # (*K, W) factor scale before each row
    flags: Optional[Tensor] = None,   # (*K,) int32 out: the guard skipped
    out: Optional[Tensor] = None,
    backend: Optional[str] = None,
) -> Tensor:
    """Rotate the W rows of X into the transposed factors, in stream order:
    Lt'^T Lt' = Lt^T Lt + sign x x^T per row (sign -1: the guarded
    downdate).  One kernel launch for all K factors (K3).  Zero rows are
    exact no-ops.

    ``scale`` multiplies each factor by ``scale[..., t]`` before row t (the
    forgetting factor's fold; 1.0 changes no bit).  ``flags`` (contiguous
    int32) receives, per factor, whether the downdate guard skipped any
    rotation.  ``out`` (contiguous, Lt's shape) receives the result and may
    be ``Lt`` itself: the stream server folds its (S, s, s) factors in
    place.

    A bf16 factor is folded in fp32 and rounded to bf16 once, as K3's
    plain version folds it: K3 reads and writes it as bf16 when the window
    fits one of its passes (``kernels.cholupdate.pass_rows``; 8 rows at
    s = 931); a longer window is folded into an fp32 copy, rounded back
    into ``out`` at the end (the copy a temporary: under a graph capture it
    lives in the graph's pool)."""
    be = resolve_backend(backend, Lt)
    *lead, s, s2 = Lt.shape
    w = X.shape[-2]
    if s != s2 or tuple(X.shape) != (*lead, w, s):
        raise ValueError(f"Lt must be (..., s, s) and X (..., W, s) with the "
                         f"same leading axes, got {tuple(Lt.shape)} and "
                         f"{tuple(X.shape)}")
    if scale is not None and tuple(scale.shape) != (*lead, w):
        raise ValueError(f"scale must be {(*lead, w)}, got "
                         f"{tuple(scale.shape)}")
    if flags is not None and (tuple(flags.shape) != tuple(lead)
                              or flags.dtype != torch.int32
                              or not flags.is_contiguous()):
        raise ValueError(f"flags must be contiguous int32 of shape "
                         f"{tuple(lead)}")
    if out is not None and (out.shape != Lt.shape or not out.is_contiguous()):
        raise ValueError("out must be contiguous with Lt's shape")
    if be == "torch":
        res = core_ridge.cholupdate_window_t(Lt, X, sign, scale=scale,
                                             flags=flags)
        return res if out is None else out.copy_(res)
    k = int(torch.Size(lead).numel())
    if Lt.dtype == torch.bfloat16 and w > cholupdate_pass_rows(s, True):
        U = _flat(Lt, (k, s, s), torch.float32)
    else:
        if out is None:
            out = Lt.clone(memory_format=torch.contiguous_format)
        elif out.data_ptr() != Lt.data_ptr():
            out.copy_(Lt)
        U = out
    cholupdate_window_t_cuda(
        U.view(k, s, s), _flat(X, (k, w, s), torch.float32), sign,
        scale=None if scale is None else _flat(scale, (k, w), torch.float32),
        flags=None if flags is None else flags.view(k))
    if U is not out:
        U = U.view(Lt.shape).to(Lt.dtype)
        out = U if out is None else out.copy_(U)
    return out


def cholupdate_window(
    L: Tensor,         # (*K, s, s) live LOWER factors
    X: Tensor,         # (*K, W, s)
    sign: float = 1.0,
    *,
    backend: Optional[str] = None,
) -> Tensor:
    """``cholupdate_window_t`` on lower factors L = Lt^T, the reference's
    ``ops.cholupdate_window`` layout: the same kernel on ``L.mT``."""
    Lt = L.transpose(-1, -2).contiguous()
    return cholupdate_window_t(Lt, X, sign, backend=backend).transpose(-1, -2)


def flash_attention(
    q: Tensor,   # (B, H, Tq, D)
    k: Tensor,   # (B, KV, Tk, D)
    v: Tensor,   # (B, KV, Tk, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    backend: Optional[str] = None,
) -> Tensor:
    """Causal / sliding-window GQA attention (K8) in the reference's
    (B, H, T, D) layout, scaled by D^-1/2, row i of q at position
    ``q_offset + i``.  'cuda' launches K8, which chooses its own tiles;
    'torch' is the plain version ``ref.flash_attention_ref``."""
    be = resolve_backend(backend, q)
    fn = flash_attention_cuda if be == "cuda" else kref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)
