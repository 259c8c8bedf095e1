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


def resolve_device(device=None,
                   what: str = "this entry point") -> torch.device:
    """The device of an entry point: CUDA unless the caller names another.
    Without a CUDA device the default raises: nothing falls back to the
    CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on the CUDA device by default and this host "
                f"has none; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def unported(knob: str, item: str) -> NotImplementedError:
    """The error a knob or method of the reference that is not ported yet
    raises: it names the knob and its ROADMAP.md item."""
    return NotImplementedError(
        f"{knob} is not ported to PyTorch yet: see ROADMAP.md, Queue 1, "
        f"'{item}'")


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
    """Int8 serving state (``quantize='int8'``).

    ``x_absmax`` tracks the running max |x| of the reservoir states served
    (``online_serve_step(track_state_absmax=True)``); at each refresh
    boundary ``online.fold_quant_rows`` folds ``Wq``/``w_scale`` from the
    refreshed readout and ``x_scale`` from ``x_absmax``.  A slot with
    ``w_scale == 0`` is unarmed and serves its fp32 logits.
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
    incremental Cholesky factor, transposed: with ``refresh_mode=
    'incremental'`` a slot is seeded with Lt = sqrt(beta) I and every
    accumulated r~ row is rotated into it, so Lt^T Lt = B + beta I holds and
    the refresh is two triangular solves.  Without a live factor
    (recompute mode) ``factor_beta`` drops to 0 as soon as statistics move,
    and Lt is never read.
    """

    A: Tensor
    B: Tensor
    count: Tensor        # int32 number of accumulated samples
    Lt: Tensor           # (s, s) transposed live factor (upper triangular)
    factor_beta: Tensor  # scalar; > 0 marks Lt live

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
class WindowState:
    """Ring of the last ``capacity`` retained samples of one stream, for
    ``retirement='window'`` (the stream server stacks a slot axis onto every
    leaf).

    ``rows[pos]`` is the next sample to evict: when a new sample is
    retained, the overwritten row is subtracted from (A, B) and downdated
    out of the live factor.  Every r~ row ends in the constant-1 feature,
    so a zero row marks capacity never written, and evicting it is an exact
    no-op: a capacity of at least a stream's length serves as no retirement.

    rows:   (capacity, s)  retained r~ rows, in ring order.
    onehot: (capacity, Ny) their label one-hots.
    pos:    int32 write cursor (the next row to evict and overwrite).
    """

    rows: Tensor
    onehot: Tensor
    pos: Tensor

    @classmethod
    def zeros(cls, capacity: int, s: int, n_classes: int,
              dtype=torch.float32, device=None) -> "WindowState":
        return cls(
            rows=_zeros((capacity, s), dtype, device),
            onehot=_zeros((capacity, n_classes), dtype, device),
            pos=_zeros((), torch.int32, device),
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
