"""Modular DFR reservoir forward pass (paper Eq. 14), in PyTorch.

Recurrence (with ring wrap x(k)_0 := x(k-1)_{Nx}):

    a(k)_n  = p * f(j(k)_n + x(k-1)_n)          # nonlinear branch
    x(k)_n  = a(k)_n + q * x(k)_{n-1}           # ring accumulation

in the closed form x(k) = L(q) @ a(k) + q^{1..Nx} * x(k-1)_{Nx}, with
L(q)[n, i] = q^(n-i) for i <= n.

Parameters may be batched: ``p`` and ``q`` broadcast against the batch shape
of the inputs (everything but the last axis of ``j_k``, or the last two of
``j_seq``), so one call serves many systems with their own (p, q) - the
stream server's slot axis.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import Nonlinearity, Tensor


def _signed_powers(q: Tensor, expo: Tensor) -> Tensor:
    """q ** expo for integer exponents >= 0, as the reference computes it:
    |q| ** expo with the sign of q applied to odd exponents."""
    q = q[..., None]
    powed = torch.abs(q) ** expo
    odd = (expo % 2) == 1
    sign = torch.where((q < 0) & odd, -1.0, 1.0).to(powed.dtype)
    return powed * sign


def ring_matrix(q: Tensor, n_nodes: int, dtype=torch.float32) -> Tensor:
    """L(q)[n, i] = q^(n-i) for i <= n else 0;  shape (*q.shape, Nx, Nx)."""
    q = torch.as_tensor(q)
    n = torch.arange(n_nodes, device=q.device)
    expo = n[:, None] - n[None, :]
    low = expo >= 0
    powed = _signed_powers(q[..., None], torch.clamp(expo, min=0))
    return torch.where(low, powed, torch.zeros((), dtype=powed.dtype,
                                               device=q.device)).to(dtype)


def ring_powers(q: Tensor, n_nodes: int, dtype=torch.float32) -> Tensor:
    """[q^1, q^2, ..., q^Nx] - carries x(k-1)_{Nx} around the ring."""
    q = torch.as_tensor(q)
    expo = torch.arange(1, n_nodes + 1, device=q.device)
    return _signed_powers(q, expo).to(dtype)


def _node_axis(v: Tensor) -> Tensor:
    """A per-system scalar (batch shape) made to broadcast over nodes."""
    v = torch.as_tensor(v)
    return v[..., None] if v.ndim else v


def reservoir_step(
    p: Tensor,
    q: Tensor,
    f: Nonlinearity,
    j_k: Tensor,
    x_prev: Tensor,
    L: Optional[Tensor] = None,
    qpow: Optional[Tensor] = None,
) -> Tensor:
    """One time step in matrix form.

    j_k, x_prev: (..., Nx) -> x_k: (..., Nx); p, q broadcast against
    j_k.shape[:-1].
    """
    n_nodes = x_prev.shape[-1]
    if L is None:
        L = ring_matrix(q, n_nodes, x_prev.dtype)
    if qpow is None:
        qpow = ring_powers(q, n_nodes, x_prev.dtype)
    a = _node_axis(p) * f(j_k + x_prev)
    ring_in = x_prev[..., -1:]  # x(k-1)_{Nx}
    return (L @ a[..., None])[..., 0] + ring_in * qpow


def run_reservoir(
    p: Tensor,
    q: Tensor,
    j_seq: Tensor,
    *,
    f: Nonlinearity = Nonlinearity(),
    lengths: Optional[Tensor] = None,
) -> Tensor:
    """Run the reservoir over a batched masked input sequence.

    j_seq: (..., T, Nx) -> states X (..., T, Nx).  ``p``/``q`` broadcast
    against j_seq.shape[:-2].  With ``lengths`` (j_seq.shape[:-2]), the state
    is frozen once k >= length, so X[..., length-1, :] is the final state
    x(T) of every sample.  The state starts at zero (paper Sec. 2.2).
    """
    n_nodes = j_seq.shape[-1]
    t_len = j_seq.shape[-2]
    x = torch.zeros_like(j_seq[..., 0, :])
    L = ring_matrix(q, n_nodes, j_seq.dtype)
    qpow = ring_powers(q, n_nodes, j_seq.dtype)
    xs = []
    for k in range(t_len):
        x_k = reservoir_step(p, q, f, j_seq[..., k, :], x, L, qpow)
        if lengths is not None:
            x_k = torch.where((k < lengths)[..., None], x_k, x)
        x = x_k
        xs.append(x)
    return torch.stack(xs, dim=-2)
