"""Optimizers as functions on trees of tensors, with the reference's
arithmetic (``repro.optim.optimizers``; no ``torch.optim``, whose AdamW
places eps and the weight decay elsewhere and so rounds differently).

* ``sgd``       - plain SGD (+ momentum).
* ``adamw``     - Adam with decoupled weight decay on every leaf, f32
                  moments, ``(m / bc1) / (sqrt(n / bc2) + eps)``.
* ``adafactor`` - the factored second moment (row and column mean squares
                  over the last two axes), no first moment.

``update(grads, state, params, lr) -> (new_params, new_state)``: each new
parameter is computed in f32 and rounded to the parameter's own dtype
once; ``lr`` is an f32 scalar tensor (``optim.schedule``).  A tree is a
nested dict, list, tuple or NamedTuple with tensors at its leaves; an
``nn.Module`` whose children read by name (``models.transformer.ParamTree``)
counts as a dict and an ``nn.ModuleList`` as a list, so ``init(model)``
and ``update(grads, state, model, lr)`` take the model itself, and the
trees they return are plain dicts and lists in its layout.  The same walk
(``tree_map``, ``tree_leaves``; ``is_leaf`` stops it early, at a tuple of
logical axes say) serves every tree of the port's LM: parameters,
optimizer states, logical axes and placements.

Sharded leaves (``DTensor``s over a mesh, ``distributed.sharding``) keep
their placements: a state leaf is made like its parameter (``zeros_like``),
the plain scalars (the rate, the bias corrections) combine with them as
replicated values, and ``clip_by_global_norm`` sums each leaf's squares
over all its shards before the square root.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.types import Tensor


def _children(node, is_leaf: Optional[Callable[[Any], bool]] = None
              ) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of an inner node, None for a leaf (a tensor, or
    a node ``is_leaf`` accepts)."""
    if isinstance(node, Tensor) or (is_leaf is not None and is_leaf(node)):
        return None
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, nn.ModuleList):
        return list(enumerate(node))
    if isinstance(node, nn.Module):
        return [(k, node[k]) for k in node.keys()]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    raise TypeError(f"not a tree of tensors: {type(node).__name__}")


def _rebuild(node, values: List[Any]):
    """A new node of ``node``'s kind (a module as a dict or a list) from
    its children's new values."""
    if isinstance(node, nn.ModuleList) or isinstance(node, list):
        return list(values)
    if isinstance(node, (dict, nn.Module)):
        return dict(zip([k for k, _ in _children(node)], values))
    if hasattr(node, "_fields"):
        return type(node)(*values)
    return tuple(values)


def tree_leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    """The leaves of a tree, in the order of its children."""
    kids = _children(tree, is_leaf)
    if kids is None:
        return [tree]
    return [leaf for _, c in kids for leaf in tree_leaves(c, is_leaf)]


def tree_map(fn: Callable[..., Any], tree, *rest,
             is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` leaf by leaf over trees of one structure (the first tree's:
    the others are indexed by its keys), rebuilt as plain containers."""
    kids = _children(tree, is_leaf)
    if kids is None:
        return fn(tree, *rest)
    return _rebuild(tree, [
        tree_map(fn, c, *(r[k] for r in rest), is_leaf=is_leaf)
        for k, c in kids])


def _device(params):
    """The device of the parameters' plain tensors (a DTensor's mesh
    device type)."""
    p = tree_leaves(params)[0]
    return p.device_mesh.device_type if isinstance(p, DTensor) else p.device


def _count(params) -> Tensor:
    """The int32 step count, a plain scalar on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=_device(params))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Tensor], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def _f32_zeros(p: Tensor) -> Tensor:
    """f32 zeros shaped (and, for a DTensor, placed) like ``p``."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def _square_sum(g: Tensor) -> Tensor:
    """The f32 sum of g's squares over every shard: a plain scalar."""
    s = torch.sum(g.to(torch.float32) ** 2)
    return s.full_tensor() if isinstance(s, DTensor) else s


def _replicated(fn: Callable) -> Callable:
    """``fn`` with plain tensors (scalars such as the rate) treated as
    replicated values wherever they meet a DTensor."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return wrapped


@_replicated
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in their dtypes,
    the f32 global norm: a plain scalar, summed over every shard of a
    sharded gradient)."""
    gn = torch.sqrt(sum(_square_sum(g) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(_f32_zeros, params)

    @_replicated
    def update(grads, state, params, lr):
        if momentum == 0.0:
            new = tree_map(lambda p, g: (p.to(torch.float32) - lr * g.to(
                torch.float32)).to(p.dtype), params, grads)
            return new, state
        vel = tree_map(lambda v, g: momentum * v + g.to(torch.float32),
                       state, grads)
        new = tree_map(lambda p, v: (p.to(torch.float32) - lr * v).to(
            p.dtype), params, vel)
        return new, vel

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: Tensor  # int32 scalar


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return AdamState(mu=tree_map(_f32_zeros, params),
                         nu=tree_map(_f32_zeros, params),
                         count=_count(params))

    @_replicated
    def update(grads, state, params, lr):
        c = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(
            g.to(torch.float32)), state.nu, grads)
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=cf.device), cf)

        def step(p, m, n):
            upd = (m / bc1) / (torch.sqrt(n / bc2) + eps)
            upd = upd + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        new = tree_map(step, params, mu, nu)
        return new, AdamState(mu=mu, nu=nu, count=c)

    return Optimizer(init, update)


class FactorState(NamedTuple):
    row: Any     # per-param row accumulator (or the full nu below 2-D)
    col: Any
    count: Tensor


def _stack_shape(*layers: Tensor) -> Tensor:
    """A layer list's stacked leaf as a meta tensor: its shape alone."""
    return torch.empty((len(layers),) + tuple(layers[0].shape),
                       device="meta")


def adafactor(eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018, the
    reference's simplified form): for >= 2-D parameters, row and column
    mean-square accumulators over the last two axes; below, a full one.
    No first moment; relative update clipping at ``clip_threshold``.

    The reference stacks each list of layers into one leaf, and so does
    this optimizer: its state is in the reference's layout
    (``convert.to_reference_layout``; a layer list is a dict of stacked
    leaves), and each stacked leaf updates as one tensor.  A layer
    vector (d,) stacks to (L, d) and is factored into rows (L,) and
    columns (d,), and the clip's RMS is taken over the whole stack.
    Neither the gradients nor the parameters are stacked: the stack's
    statistics are sums over its layers (``upd_stack``)."""

    def init(params):
        from repro_torch.convert import to_reference_layout

        dev = _device(params)

        def zeros(shape):
            # a factored leaf: plain zeros (a sharded optimizer state
            # places them afterwards, ``launch.steps.place_opt_state``)
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def rows(p):  # p: a leaf, or a meta tensor of a stacked leaf
            if p.ndim < 2:
                return zeros(p.shape) if p.is_meta else _f32_zeros(p)
            return zeros(p.shape[:-1])

        def cols(p):
            return zeros((1,) if p.ndim < 2 else p.shape[:-2] + p.shape[-1:])

        ref = to_reference_layout(params, stack=_stack_shape)
        return FactorState(row=tree_map(rows, ref), col=tree_map(cols, ref),
                           count=_count(params))

    @_replicated
    def update(grads, state, params, lr):
        c = state.count + 1
        beta = 1.0 - c.to(torch.float32) ** -decay

        def factors(r2, c2):
            return (torch.rsqrt(r2 / torch.clamp(r2.mean(-1, keepdim=True),
                                                 min=eps) + eps),
                    torch.rsqrt(c2 + eps))

        def clip(mean_sq):
            # relative update clipping: the divisor of u
            rms_u = torch.sqrt(mean_sq + eps)
            return torch.clamp(rms_u / clip_threshold, min=1.0)

        def step(p, u):
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        def upd_one(p, g, r, cl):
            gf = g.to(torch.float32)
            g2 = torch.square(gf) + eps
            if g.ndim < 2:
                r2 = beta * r + (1 - beta) * g2
                u = gf * torch.rsqrt(r2 + eps)
                new_r, new_c = r2, cl
            else:
                new_r = beta * r + (1 - beta) * g2.mean(-1)
                new_c = beta * cl + (1 - beta) * g2.mean(-2)
                r_factor, c_factor = factors(new_r, new_c)
                u = gf * r_factor[..., None] * c_factor[..., None, :]
            u = u / clip(torch.mean(torch.square(u)))
            return step(p, u), new_r, new_c

        def upd_stack(ps, gs, r, cl):
            # the stacked leaf (L, *q) of layer leaves q (ndim >= 1), from
            # per-layer reductions: rows over the last axis; columns over
            # axis -2, which for a layer vector is the layers' own
            def g2(g):
                return torch.square(g.to(torch.float32)) + eps

            if gs[0].ndim == 1:
                row_mean = torch.stack([g2(g).mean() for g in gs])
                col_mean = sum(g2(g) for g in gs) / len(gs)
            else:
                row_mean = torch.stack([g2(g).mean(-1) for g in gs])
                col_mean = torch.stack([g2(g).mean(-2) for g in gs])
            new_r = beta * r + (1 - beta) * row_mean
            new_c = beta * cl + (1 - beta) * col_mean
            r_factor, c_factor = factors(new_r, new_c)

            def u(i):
                gf = gs[i].to(torch.float32)
                if gf.ndim == 1:
                    return gf * r_factor[i] * c_factor
                return gf * r_factor[i][..., None] * c_factor[i][..., None, :]

            # u twice a layer (once for the clip's sum, once for the step)
            # rather than a stacked u alive at once
            div = clip(sum(torch.sum(torch.square(u(i)))
                           for i in range(len(gs)))
                       / (len(gs) * gs[0].numel()))
            return ([step(p, u(i) / div) for i, p in enumerate(ps)], new_r,
                    new_c)

        def upd(p, g, r, cl):
            if isinstance(g, _Layers):
                return upd_stack(p, g, r, cl)
            return upd_one(p, g, r, cl)

        from repro_torch.convert import (from_reference_layout,
                                         to_reference_layout)

        def ref(tree):
            return to_reference_layout(tree, stack=_Layers.of,
                                       is_leaf=_Layers.is_one)

        ref_p = ref(tree_map(torch.Tensor.detach, params))
        out = tree_map(upd, ref_p, ref(grads), state.row, state.col,
                       is_leaf=_Layers.is_one)

        def part(k):
            return tree_map(lambda p, o: _Layers(o[0]) if k == 0 and
                            isinstance(p, _Layers) else o[k], ref_p, out,
                            is_leaf=_Layers.is_one)

        # each layer's new leaves, in the params' layout
        new = from_reference_layout(tree_map(torch.Tensor.detach, params),
                                    part(0), is_leaf=_Layers.is_one)
        return new, FactorState(row=part(1), col=part(2), count=c)

    return Optimizer(init, update)


class _Layers(tuple):
    """A layer list's leaves at one position, unstacked: what the
    reference's stacked leaf holds, one tensor a layer."""

    @classmethod
    def of(cls, *leaves):
        return cls(leaves)

    @staticmethod
    def is_one(node) -> bool:
        return isinstance(node, _Layers)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(**kw)
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name}")
