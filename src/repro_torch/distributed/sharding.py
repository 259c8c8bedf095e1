"""Logical-axis sharding rules: the slot mesh's blocks and the LM's FSDP +
tensor parallelism as DTensor placements.

The counterpart of ``repro.distributed.sharding``'s rules engine.  Every
leaf of a tree comes with a tuple of *logical* axis names (an LM
parameter's ``tensor.axes``, ``WindowState.slot_axes``,
``core.online.slot_logical_axes``); a rule table maps each logical name to
mesh axes, and ``guarded_spec`` applies a mesh axis to a dimension only
where the dimension divides by its size and no earlier dimension claimed
it.  A spec is a tuple with one entry per dimension: ``None``
(replicated), a mesh-axis name, or a tuple of them.  A mesh is anything
with ``axis_names`` and ``shape`` (axis name -> size): the serving
``launch.mesh.SlotMesh``, or the LM's ``launch.mesh.LMMesh`` over a
``torch.distributed`` ``DeviceMesh``.

The stream server splits each leaf whose spec puts ``"slot"`` on its first
dimension into contiguous blocks, one per mesh entry, and copies every
other leaf whole to each entry (``shard_blocks``).  Nothing reduces over
``slot``.

The LM half maps a spec onto ``DTensor`` placements (``placements_for``):
for each mesh dimension, ``Shard(d)`` where the spec names that mesh axis
for tensor dimension d, ``Replicate()`` otherwise; a tuple entry such as
``("pod", "data")`` shards one dimension over both mesh dimensions, major
to minor, as JAX does.  Under ``use_mesh`` (a ``MeshContext``), the model
code's ``shard_act`` redistributes an activation to its guarded placements
and ``fsdp_gather`` a weight to its placements with the FSDP axes
(``embed``, ``expert``) dropped, whose backward is the FSDP
reduce-scatter.  Without a mesh, or on a tensor that is not a ``DTensor``,
both are the identity.  ``local_region`` runs a function on each rank's
local shards (``torch.distributed.tensor.experimental.local_map``) where
DTensor has no sharding strategy for the ops inside.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)

from repro_torch.core.types import map_leaves
from repro_torch.launch.mesh import SlotMesh
from repro_torch.optim.optimizers import tree_map

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]

# rule: logical name -> mesh axis name (or tuple of mesh axes, or None)
Rules = Dict[Optional[str], Any]

DEFAULT_RULES: Rules = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "expert_mlp": "model",
    "embed": "data",
    "embed_no_shard": None,
    "expert": "data",
    "batch": ("pod", "data"),
    # the online ensemble's member axis: members are independent, so K
    # splits over a dedicated "member" serving axis where one exists
    "member": ("member", "pod", "data"),
    # the stream server's slot axis: slots are independent streams, so S
    # splits over the "slot" serving axis (launch.mesh.make_slot_mesh)
    "slot": ("slot", "pod", "data"),
    "act_model": "model",
    "kv_alt": "model",
    "layers": None,
    "head_dim": None,
    "seq": None,
    "state": None,
    "conv": None,
    None: None,
}


def _resolve(logical: Optional[str], rules: Rules,
             mesh: Optional[SlotMesh]):
    """Logical axis -> mesh axis (filtered to axes that exist in the
    mesh)."""
    target = rules.get(logical, None)
    if target is None or mesh is None:
        return None
    names = mesh.axis_names
    if isinstance(target, (tuple, list)):
        present = tuple(t for t in target if t in names)
        return present if present else None
    return target if target in names else None


def spec_for(axes: LogicalAxes, rules: Optional[Rules] = None,
             mesh: Optional[SlotMesh] = None) -> Spec:
    """The spec of a leaf with the given logical axes, without the
    divisibility guard (the caller pads the dimensions)."""
    rules = rules or DEFAULT_RULES
    return tuple(_resolve(a, rules, mesh) for a in axes)


def tree_specs(axes_tree, mesh: Optional[SlotMesh] = None,
               rules: Optional[Rules] = None):
    """A tree of logical-axes tuples -> the tree of their specs."""
    return map_leaves(lambda axes: spec_for(tuple(axes), rules, mesh),
                      axes_tree)


def guarded_spec(shape: Tuple[int, ...], axes: LogicalAxes,
                 mesh: Optional[SlotMesh] = None,
                 rules: Optional[Rules] = None) -> Spec:
    """The spec with the divisibility and uniqueness guards: a mesh axis
    applies to a dimension only if (a) the dimension divides by the product
    of its mesh axes' sizes (and that product is above 1) and (b) no earlier
    dimension of the leaf claimed that mesh axis."""
    rules = rules or DEFAULT_RULES
    if mesh is None:
        return (None,) * len(shape)
    used: set = set()
    out = []
    for dim, logical in zip(shape, axes):
        resolved = _resolve(logical, rules, mesh)
        names = (resolved if isinstance(resolved, tuple)
                 else (resolved,) if resolved else ())
        names = tuple(n for n in names if n not in used)
        size = 1
        for n in names:
            size *= mesh.shape[n]
        if names and size > 1 and dim % size == 0:
            used.update(names)
            out.append(names if len(names) > 1 else names[0])
        else:
            out.append(None)
    return tuple(out)


def data_axes(mesh: Optional[SlotMesh] = None) -> Tuple[str, ...]:
    """Mesh axes that carry data parallelism (for the gradient and
    statistics reductions)."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _copy_to(leaf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new contiguous tensor on ``device`` holding ``leaf``'s values
    (``leaf`` may be an expanded view)."""
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    return out.copy_(leaf)


def shard_blocks(tree, axes_tree, mesh: SlotMesh,
                 rules: Optional[Rules] = None) -> List[Any]:
    """Place a slot-batched tree on a 1-D slot mesh: one tree per entry d,
    on ``mesh.devices[d]``.  A leaf whose guarded spec splits its first
    dimension over ``"slot"`` gives entry d its rows ``[d * S/n, (d + 1) *
    S/n)``; every other leaf is copied whole to each entry.  Every leaf of
    every entry is a new tensor."""
    if mesh.axis_names != ("slot",):
        raise ValueError(f"shard_blocks places over a ('slot',) mesh, got "
                         f"{mesh.axis_names}")
    n = mesh.size

    def split(leaf, axes):
        spec = guarded_spec(tuple(leaf.shape), tuple(axes), mesh, rules)
        if any(s is not None for s in spec[1:]):
            raise ValueError(f"shard_blocks splits only the first "
                             f"dimension, got spec {spec}")
        if spec and spec[0] is not None:
            rows = leaf.shape[0] // n
            return [_copy_to(leaf[d * rows:(d + 1) * rows], dev)
                    for d, dev in enumerate(mesh.devices)]
        return [_copy_to(leaf, dev) for dev in mesh.devices]

    parts = map_leaves(split, tree, axes_tree)
    return [map_leaves(lambda p, d=d: p[d], parts) for d in range(n)]


# -- the LM's mesh context, constraints and placements -----------------------


@dataclasses.dataclass
class MeshContext:
    mesh: Any            # an LMMesh (or any mesh with axis_names and shape)
    rules: Rules

    def axis_size(self, name: str) -> int:
        if self.mesh is None or name not in self.mesh.axis_names:
            return 1
        return self.mesh.shape[name]


class _Active:
    """The active ``MeshContext``: one for the process, not a thread's, as
    the autograd engine runs a CUDA backward (and with it the remat
    recompute, which reaches ``shard_act``) on a thread of its own."""

    ctx: Optional[MeshContext] = None


_STATE = _Active()


def current() -> MeshContext:
    """The active ``MeshContext`` (no mesh and the default rules outside
    ``use_mesh``)."""
    if _STATE.ctx is None:
        return MeshContext(mesh=None, rules=dict(DEFAULT_RULES))
    return _STATE.ctx


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Rules] = None):
    """Make ``mesh`` (and ``rules``) the context of ``shard_act``,
    ``fsdp_gather`` and ``local_region`` inside the block."""
    prev = _STATE.ctx
    _STATE.ctx = MeshContext(mesh=mesh, rules=dict(rules or DEFAULT_RULES))
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def placements_for(spec: Spec, mesh) -> Tuple[Placement, ...]:
    """The DTensor placements of a spec: for each mesh dimension,
    ``Shard(d)`` where the spec names that axis for tensor dimension d
    (alone or in a tuple, major to minor), ``Replicate()`` otherwise."""
    out: List[Placement] = []
    for name in mesh.axis_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple)
                                     and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def sharding_for(axes: LogicalAxes, mesh=None,
                 rules: Optional[Rules] = None
                 ) -> Optional[Tuple[Placement, ...]]:
    """The placements of a leaf with these logical axes (no divisibility
    guard, as the reference's ``sharding_for``); None without a mesh."""
    ctx = current()
    mesh = mesh or ctx.mesh
    if mesh is None:
        return None
    return placements_for(spec_for(tuple(axes), rules or ctx.rules, mesh),
                          mesh)


def is_axes(x) -> bool:
    """A logical-axes tuple: a leaf of an axes tree."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(axes_tree, mesh=None):
    """A tree of logical-axes tuples -> the tree of their placements (no
    guard); None without a mesh."""
    mesh = mesh or current().mesh
    if mesh is None:
        return None
    return tree_map(lambda axes: sharding_for(axes, mesh), axes_tree,
                    is_leaf=is_axes)


def guarded_shardings(shapes_tree, axes_tree, mesh=None,
                      rules: Optional[Rules] = None):
    """A tree of tensors (meta, fake or real: only the shapes are read) and
    its tree of logical axes -> the tree of guarded placements; None
    without a mesh."""
    ctx = current()
    mesh = mesh or ctx.mesh
    if mesh is None:
        return None
    rules = rules or ctx.rules
    return tree_map(
        lambda sh, axes: placements_for(
            guarded_spec(tuple(sh.shape), tuple(axes), mesh, rules), mesh),
        shapes_tree, axes_tree)


def guarded_placements(shape, axes: LogicalAxes,
                       rules: Optional[Rules] = None
                       ) -> Tuple[Placement, ...]:
    """The active mesh's guarded placements of one leaf."""
    ctx = current()
    spec = guarded_spec(tuple(shape), tuple(axes), ctx.mesh,
                        rules or ctx.rules)
    return placements_for(spec, ctx.mesh)


def _redistribute(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward and the gradient to
    the same placements in the backward: JAX transposes a sharding
    constraint into the same constraint on the cotangent, so a partial
    gradient is reduced where the reference's constraint stands."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return _redistribute(x, placements)

    @staticmethod
    def backward(ctx, grad):
        return _redistribute(grad, ctx.placements), None


def _constrain(x, placements):
    if not x.requires_grad:
        return _redistribute(x, placements)
    return _Constrain.apply(x, placements)


def reduce_partial(x):
    """A DTensor's pending partial sums reduced (each ``Partial`` mesh
    dimension made ``Replicate``), and its gradient's in the backward; a
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _constrain(x, tuple(Replicate() if p.is_partial() else p
                               for p in x.placements))


def shard_act(x, axes: LogicalAxes):
    """Redistribute an activation to its guarded placements when a mesh
    context is active and ``x`` is a DTensor; the identity otherwise.  A
    pending partial sum is reduced on the way (all-reduce, or
    reduce-scatter where the new placement shards), and so is the
    gradient's in the backward."""
    if current().mesh is None or not isinstance(x, DTensor):
        return x
    return _constrain(x, guarded_placements(x.shape, axes))


def relayout(x, axes: LogicalAxes):
    """``x`` redistributed to its guarded placements with DTensor's own
    backward (the gradient goes back to ``x``'s placements): a change of
    layout that constrains nothing, where ``shard_act`` would."""
    if current().mesh is None or not isinstance(x, DTensor):
        return x
    return _redistribute(x, guarded_placements(x.shape, axes))


def fsdp_gather(w, axes: LogicalAxes):
    """A weight at its use site, redistributed to its tensor-parallel
    placements (the FSDP axes ``embed`` and ``expert`` dropped): the
    all-gather over the data axes of FSDP, whose backward reduce-scatters
    the gradient.  The identity without a mesh or on a plain tensor."""
    ctx = current()
    if ctx.mesh is None or not isinstance(w, DTensor):
        return w
    rules = dict(ctx.rules, embed=None, expert=None)
    return _redistribute(w, guarded_placements(w.shape, axes, rules))


def split_last(x, n: int, size: int):
    """``x`` (..., n * size) reshaped to (..., n, size).  A DTensor's
    pending partial sums are reduced first, and a last dimension sharded
    over more ranks than divide n is gathered: the shards would cut
    through the new n dimension."""
    if isinstance(x, DTensor):
        x = reduce_partial(x)
        mesh, last = x.device_mesh, x.ndim - 1
        k = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                k *= mesh.size(i)
        if k > 1 and n % k:
            x = x.redistribute(mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in x.placements])
    return x.reshape(*x.shape[:-1], n, size)


def zeros(shape, axes: LogicalAxes, dtype, device):
    """Zeros of a global shape: a DTensor at its guarded placements (each
    rank allocating its shard only) under a mesh context over a
    ``DeviceMesh``, a plain tensor otherwise."""
    mesh = current().mesh
    if getattr(mesh, "device_mesh", None) is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    placements = guarded_placements(shape, axes)
    return DTensor.from_local(
        torch.zeros(local_shape(shape, placements, mesh), dtype=dtype,
                    device=device),
        mesh.device_mesh, placements, run_check=False,
        shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local_shape(shape, placements: Sequence[Placement], mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's shard (every sharded dimension divides, as
    ``guarded_spec`` ensures)."""
    out = list(shape)
    for name, pl in zip(mesh.axis_names, placements):
        if isinstance(pl, Shard):
            size = mesh.shape[name]
            if out[pl.dim] % size:
                raise ValueError(f"dimension {pl.dim} of {tuple(shape)} "
                                 f"does not divide over {name}={size}")
            out[pl.dim] //= size
    return tuple(out)


def place(tree, placements_tree, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` at its placements
    (``distribute_tensor``: every rank keeps its shard of the same global
    value).  A leaf already a DTensor is redistributed; a meta tensor
    becomes zeros, each rank allocating its shard only."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, placements):
        if isinstance(t, DTensor):
            return _redistribute(t, placements)
        if t.is_meta:
            loc = torch.zeros(local_shape(t.shape, placements, mesh),
                              dtype=t.dtype,
                              device=mesh.device_mesh.device_type)
            return DTensor.from_local(loc, mesh.device_mesh, placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        return distribute_tensor(t.detach(), mesh.device_mesh, placements)

    return tree_map(one, tree, placements_tree)


def local_region(fn: Callable, in_axes: Sequence, out_like,
                 grad_partial: Sequence[int] = (),
                 rules: Optional[Rules] = None):
    """``fn`` run on each rank's local shards
    (``torch.distributed.tensor.experimental.local_map``) when an argument
    is a DTensor under a mesh context, ``fn`` itself otherwise.  The
    arguments are first redistributed to their guarded placements:
    ``in_axes`` gives each argument's logical axes (None: not a tensor).
    ``out_like`` gives, for the output (an int) or each output (a tuple),
    the argument whose placements it takes.  An argument listed in
    ``grad_partial`` gets its gradient as a partial sum over the ranks that
    hold it replicated while another argument is sharded over them: each
    rank reads only a part of it (ranks that hold every argument alike do
    the same work, and its gradient stays replicated there).  ``rules``
    adds to the active rules for these placements."""
    from torch.distributed.tensor.experimental import local_map

    def wrapped(*args):
        ctx = current()
        if ctx.mesh is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        # local_map reads a list as one value's placements, a tuple as one
        # entry a value
        # partial sums reduced here, with a backward DTensor supports on
        # every version (local_map's own redistribution would turn a
        # gradient from Shard back into Partial)
        args = tuple(reduce_partial(a) for a in args)
        in_pl = tuple(
            None if ax is None or not isinstance(a, torch.Tensor)
            else list(guarded_placements(a.shape, ax,
                                         dict(ctx.rules, **(rules or {}))))
            for a, ax in zip(args, in_axes))
        split = {j for p in in_pl if p is not None
                 for j, q in enumerate(p) if isinstance(q, Shard)}
        grad_pl = tuple(
            p if p is None or i not in grad_partial else
            [Partial() if isinstance(q, Replicate) and j in split else q
             for j, q in enumerate(p)]
            for i, p in enumerate(in_pl))
        out_pl = (tuple(in_pl[i] for i in out_like)
                  if isinstance(out_like, tuple) else in_pl[out_like])
        return local_map(
            fn, out_placements=out_pl, in_placements=in_pl,
            in_grad_placements=grad_pl, device_mesh=ctx.mesh.device_mesh,
            redistribute_inputs=True)(*args)

    return wrapped
