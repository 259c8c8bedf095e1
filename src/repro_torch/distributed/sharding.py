"""Logical-axis sharding rules over the port's slot mesh.

The counterpart of ``repro.distributed.sharding``'s rules engine, as plain
Python over a ``launch.mesh.SlotMesh``.  Every stacked leaf of a serving
tree comes with a tuple of *logical* axis names (``WindowState.slot_axes``,
``RequestPool.slot_axes``, ``core.online.slot_logical_axes``); a rule table
maps each logical name to mesh axes, and ``guarded_spec`` applies a mesh
axis to a dimension only where the dimension divides by its size and no
earlier dimension claimed it.  A spec is a tuple with one entry per
dimension: ``None`` (replicated), a mesh-axis name, or a tuple of them.

The stream server splits each leaf whose spec puts ``"slot"`` on its first
dimension into contiguous blocks, one per mesh entry, and copies every
other leaf whole to each entry (``shard_blocks``).  Nothing reduces over
``slot``.

The LM's activation constraints and named shardings (``shard_act``,
``fsdp_gather``, ``MeshContext``/``use_mesh``, ``sharding_for``,
``tree_shardings``, ``guarded_shardings``) come with the LM launch and
raise until then.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.types import map_leaves, unported
from repro_torch.launch.mesh import LM_SHARDING, SlotMesh

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


# -- the LM's constraints and named shardings: not ported --------------------


class MeshContext:
    def __init__(self, *args, **kwargs):
        raise unported("MeshContext", LM_SHARDING)


def use_mesh(mesh=None, rules=None):
    raise unported("use_mesh", LM_SHARDING)


def shard_act(x, axes):
    raise unported("shard_act", LM_SHARDING)


def fsdp_gather(w, axes):
    raise unported("fsdp_gather", LM_SHARDING)


def sharding_for(axes, mesh=None, rules=None):
    raise unported("sharding_for", LM_SHARDING)


def tree_shardings(axes_tree, mesh=None):
    raise unported("tree_shardings", LM_SHARDING)


def guarded_shardings(shapes_tree, axes_tree, mesh=None, rules=None):
    raise unported("guarded_shardings", LM_SHARDING)
