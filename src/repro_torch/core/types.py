"""Core dataclasses for the modular Delayed Feedback Reservoir (DFR), in PyTorch.

The PyTorch counterpart of ``repro.core.types``.  The modular DFR model
(paper Eq. 14):

    x(k)_n = p * f(j(k)_n + x(k-1)_n) + q * x(k)_{n-1}

with the loop-wrap convention x(k)_0 := x(k-1)_{Nx}, masking j(k) = M @ u(k),
and the DPRR readout

    r = vec( sum_k x(k) [x(k-1), 1]^T ),   r_tilde = [r, 1].

Every state container is a dataclass of tensors.  Leaves may carry leading
batch axes (the stream server stacks a slot axis S onto every leaf), and
``map_leaves`` walks them in field order so admission, freezing and
snapshots treat the whole tree at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Nonlinearities f.  The paper's evaluation uses f(z) = alpha * z; tanh and
# Mackey-Glass are kept for the analog-DFR reference path and ablations.
# The CUDA kernels take the nonlinearity as an integer code plus alpha.
# ---------------------------------------------------------------------------

NONLINEARITY_CODES = {"linear": 0, "tanh": 1, "mackey_glass": 2}
MG_P = 2.0  # Mackey-Glass exponent (paper Eq. 3); alpha does not apply


def f_linear(z: Tensor, alpha: float = 1.0) -> Tensor:
    return alpha * z


def f_tanh(z: Tensor, alpha: float = 1.0) -> Tensor:
    return torch.tanh(alpha * z)


def f_mackey_glass(z: Tensor, mg_p: float = MG_P) -> Tensor:
    """Mackey-Glass style saturation f(z) = z / (1 + |z|^p) (paper Eq. 3)."""
    return z / (1.0 + torch.abs(z) ** mg_p)


@dataclasses.dataclass(frozen=True)
class Nonlinearity:
    """The bound nonlinearity ``z -> f(z, alpha)``.

    Callable on tensors like the reference's ``cached_nonlinearity``, and
    hashable; ``code`` and ``alpha`` are what the CUDA kernels read.
    ``mackey_glass`` ignores ``alpha``, as the reference does.
    """

    name: str = "linear"
    alpha: float = 1.0

    def __post_init__(self):
        if self.name not in NONLINEARITY_CODES:
            raise ValueError(f"unknown nonlinearity: {self.name!r}")

    @property
    def code(self) -> int:
        return NONLINEARITY_CODES[self.name]

    def __call__(self, z: Tensor) -> Tensor:
        if self.name == "linear":
            return f_linear(z, self.alpha)
        if self.name == "tanh":
            return f_tanh(z, self.alpha)
        return f_mackey_glass(z)


@dataclasses.dataclass(frozen=True)
class DFRConfig:
    """Static configuration of a modular DFR classifier."""

    n_in: int                      # #V  input channels
    n_classes: int                 # #C  output classes
    n_nodes: int = 30              # Nx  virtual nodes (paper uses 30)
    nonlinearity: str = "linear"   # f;  paper evaluation uses linear
    alpha: float = 1.0             # f scale (folded into p for linear f)
    p_init: float = 0.01           # paper Sec. 4.1
    q_init: float = 0.01           # paper Sec. 4.1
    epochs: int = 25               # paper Sec. 4.1
    lr: float = 1.0                # paper Sec. 4.1
    res_lr_drop_epochs: Tuple[int, ...] = (5, 10, 15, 20)
    out_lr_drop_epochs: Tuple[int, ...] = (10, 15, 20)
    betas: Tuple[float, ...] = (1e-6, 1e-4, 1e-2, 1e0)  # ridge reg. sweep
    mask_seed: int = 0
    dtype: Any = torch.float32

    @property
    def n_rep(self) -> int:
        """N_r: DPRR feature count = Nx * (Nx + 1)."""
        return self.n_nodes * (self.n_nodes + 1)

    @property
    def s(self) -> int:
        """s = Nx^2 + Nx + 1 (paper Eq. 20): ridge system size."""
        return self.n_nodes * self.n_nodes + self.n_nodes + 1

    def f(self) -> Nonlinearity:
        return Nonlinearity(self.nonlinearity, float(self.alpha))


def map_leaves(fn: Callable[..., Tensor], tree, *rest):
    """Apply ``fn`` leaf by leaf to one or more dataclass trees of the same
    type, rebuilding the tree (the port's ``jax.tree_util.tree_map``)."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: map_leaves(fn, getattr(tree, f.name),
                               *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def _zeros(shape, dtype, device) -> Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass
class DFRParams:
    """Trainable parameters of the DFR system."""

    p: Tensor      # scalar reservoir gain on the nonlinear branch
    q: Tensor      # scalar reservoir gain on the ring branch
    W: Tensor      # (Ny, Nr) output weights
    b: Tensor      # (Ny,)    output bias

    @classmethod
    def init(cls, cfg: DFRConfig, device=None) -> "DFRParams":
        dt = cfg.dtype
        return cls(
            p=torch.tensor(cfg.p_init, dtype=dt, device=device),
            q=torch.tensor(cfg.q_init, dtype=dt, device=device),
            W=_zeros((cfg.n_classes, cfg.n_rep), dt, device),
            b=_zeros((cfg.n_classes,), dt, device),
        )


@dataclasses.dataclass
class QuantParams:
    """Int8 serving state of the reference (``quantize='int8'``).

    The port does not serve int8 yet; the leaves stay inert zeros so that
    ``OnlineState`` keeps the reference's shape and ``convert`` can carry
    every leaf across.
    """

    Wq: Tensor        # (Ny, Nr) int8
    w_scale: Tensor   # scalar f32
    x_scale: Tensor   # scalar f32
    x_absmax: Tensor  # scalar f32

    @classmethod
    def zeros(cls, n_classes: int, n_rep: int, device=None) -> "QuantParams":
        return cls(
            Wq=_zeros((n_classes, n_rep), torch.int8, device),
            w_scale=_zeros((), torch.float32, device),
            x_scale=_zeros((), torch.float32, device),
            x_absmax=_zeros((), torch.float32, device),
        )


@dataclasses.dataclass
class RidgeState:
    """Streaming sufficient statistics for Ridge regression (paper Eq. 21-22).

    A = E R~^T (Ny, s) and B = R~ R~^T (s, s), both sums over samples
    (beta * I is added at solve time).  ``Lt``/``factor_beta`` carry the
    reference's incremental Cholesky factor; the port's recompute-mode
    refresh never reads them, and ``factor_beta`` drops to 0 as soon as
    statistics move, exactly as the reference does without a live factor.
    """

    A: Tensor
    B: Tensor
    count: Tensor        # int32 number of accumulated samples
    Lt: Tensor           # (s, s) transposed live factor (unused here)
    factor_beta: Tensor  # scalar; > 0 would mark Lt live

    @classmethod
    def zeros(cls, s: int, n_classes: int, dtype=torch.float32,
              device=None) -> "RidgeState":
        return cls(
            A=_zeros((n_classes, s), dtype, device),
            B=_zeros((s, s), dtype, device),
            count=_zeros((), torch.int32, device),
            Lt=_zeros((s, s), dtype, device),
            factor_beta=_zeros((), dtype, device),
        )


@dataclasses.dataclass
class RequestPool:
    """Device-resident staged stream payloads, one row per serving slot.

    A stream's padded samples are uploaded once and written into the slot
    row at admission; the per-step (S, W, T, n_in) window is gathered by a
    per-slot cursor.  Capacity is a multiple of the serving window, and pad
    rows carry the host-staging defaults for dead samples (u=0, length=1,
    label=0).

    u:      (S, C, T, n_in) staged samples
    length: (S, C) int32 valid lengths (1 on pad rows)
    label:  (S, C) int32 labels (0 on pad rows)
    n:      (S,)   int32 true sample count per slot row
    """

    u: Tensor
    length: Tensor
    label: Tensor
    n: Tensor

    @property
    def capacity(self) -> int:
        return self.u.shape[1]

    @classmethod
    def zeros(cls, n_slots: int, capacity: int, t_max: int, n_in: int,
              dtype=torch.float32, device=None) -> "RequestPool":
        return cls(
            u=_zeros((n_slots, capacity, t_max, n_in), dtype, device),
            length=torch.ones((n_slots, capacity), dtype=torch.int32,
                              device=device),
            label=_zeros((n_slots, capacity), torch.int32, device),
            n=_zeros((n_slots,), torch.int32, device),
        )


@dataclasses.dataclass(frozen=True)
class TimeSeriesBatch:
    """A padded batch of variable-length multivariate time series.

    u:       (B, T_max, n_in) float inputs, zero padded past `length`.
    length:  (B,) int32 true lengths  (1 <= length <= T_max).
    label:   (B,) int32 class ids.
    """

    u: Tensor
    length: Tensor
    label: Tensor

    @property
    def batch(self) -> int:
        return self.u.shape[0]

    @property
    def t_max(self) -> int:
        return self.u.shape[1]
