"""Carry DFR weights, masks and online state between the JAX package and
the port.

``params_leaves`` / ``params_from_leaves`` carry a ``DFRParams`` (either
package's) as a dict of numpy arrays ``p``, ``q``, ``W``, ``b``;
``mask_to_numpy`` / ``mask_from_numpy`` carry an input mask, so both
packages can run one system on the same weights.

Both packages' ``OnlineState`` have the same attribute tree, so one walk
reads either: ``state_leaves`` turns a state (the reference's or the port's,
batched or not) into a dict of numpy arrays under flat leaf names, and
``state_from_leaves`` builds the port's ``OnlineState`` from such a dict.
The names are the ones the reference's own golden fixtures use
(``params_p`` ... ``ridge_B``, ``step``, ``loss_ema``).  Every leaf keeps
its dtype, so an armed int8 state (``quant_Wq`` codes and scales) and a live
incremental factor (``ridge_Lt``, ``ridge_factor_beta``) cross unchanged.
``window_leaves`` / ``window_from_leaves`` carry a window ring
(``WindowState``: ``rows``, ``onehot``, ``pos``) the same way.
Nothing here imports the JAX package: a caller on that side builds its own
state from the same dict.

``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry an LM's parameters
as the reference's ``Transformer.init`` values tree of numpy arrays, for
every family: the layer lists (``layers``, ``enc_layers``, ``dec_layers``)
stacked on a leading axis, the hybrid's ``shared_attn`` unstacked, the MoE
router fp32 and whisper's ``pos_embed`` table carried like any leaf. The
reference's bf16 leaves are ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses: they go through float32, exact for bf16,
and are cast to the parameter's dtype. ``lm_params_to_numpy`` returns
float32 arrays.

``to_reference_layout`` / ``from_reference_layout`` carry a training state
(the model, an optimizer state such as ``AdamState``, or a tuple of them)
in the reference's layout as tensors, dtypes kept: each layer list stacked
on a leading axis, as the reference's ``Trainer`` checkpoints ``(params,
opt_state)``.  ``runtime.Trainer`` saves and restores through them, so a
checkpoint that either package's ``Trainer`` writes restores in the
other's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.online import OnlineState
from repro_torch.core.types import (DFRParams, QuantParams, RidgeState,
                                    WindowState)
from repro_torch.models.transformer import STACKED, ParamTree
from repro_torch.optim.optimizers import _children, _rebuild, tree_map

# flat leaf name -> attribute path, in OnlineState field order
LEAF_PATHS = (
    ("params_p", ("params", "p")),
    ("params_q", ("params", "q")),
    ("params_W", ("params", "W")),
    ("params_b", ("params", "b")),
    ("ridge_A", ("ridge", "A")),
    ("ridge_B", ("ridge", "B")),
    ("ridge_count", ("ridge", "count")),
    ("ridge_Lt", ("ridge", "Lt")),
    ("ridge_factor_beta", ("ridge", "factor_beta")),
    ("step", ("step",)),
    ("loss_ema", ("loss_ema",)),
    ("quant_Wq", ("quant", "Wq")),
    ("quant_w_scale", ("quant", "w_scale")),
    ("quant_x_scale", ("quant", "x_scale")),
    ("quant_x_absmax", ("quant", "x_absmax")),
    ("loss_fast", ("loss_fast",)),
    ("loss_slow", ("loss_slow",)),
)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def params_leaves(params) -> Dict[str, np.ndarray]:
    """A ``DFRParams`` (either package's) as numpy ``p``, ``q``, ``W``,
    ``b``."""
    return {k: _to_numpy(getattr(params, k)) for k in ("p", "q", "W", "b")}


def params_from_leaves(leaves: Dict[str, np.ndarray],
                       device=None) -> DFRParams:
    """The port's ``DFRParams`` from ``params_leaves`` output."""
    return DFRParams(**{k: torch.from_numpy(np.array(leaves[k])).to(device)
                        for k in ("p", "q", "W", "b")})


def mask_to_numpy(mask) -> np.ndarray:
    """An input mask (Nx, n_in), either package's, as numpy."""
    return _to_numpy(mask)


def mask_from_numpy(mask: np.ndarray, device=None) -> torch.Tensor:
    """The port's input mask from numpy."""
    return torch.from_numpy(np.array(mask)).to(device)


def state_leaves(state) -> Dict[str, np.ndarray]:
    """Every leaf of an ``OnlineState`` (either package's) as numpy."""
    out = {}
    for name, path in LEAF_PATHS:
        leaf = state
        for attr in path:
            leaf = getattr(leaf, attr)
        out[name] = _to_numpy(leaf)
    return out


def state_from_leaves(leaves: Dict[str, np.ndarray],
                      device=None) -> OnlineState:
    """The port's ``OnlineState`` from ``state_leaves`` output."""
    t = {k: torch.from_numpy(np.array(v)).to(device)
         for k, v in leaves.items()}
    return OnlineState(
        params=DFRParams(p=t["params_p"], q=t["params_q"], W=t["params_W"],
                         b=t["params_b"]),
        ridge=RidgeState(A=t["ridge_A"], B=t["ridge_B"],
                         count=t["ridge_count"], Lt=t["ridge_Lt"],
                         factor_beta=t["ridge_factor_beta"]),
        step=t["step"],
        loss_ema=t["loss_ema"],
        quant=QuantParams(Wq=t["quant_Wq"], w_scale=t["quant_w_scale"],
                          x_scale=t["quant_x_scale"],
                          x_absmax=t["quant_x_absmax"]),
        loss_fast=t["loss_fast"],
        loss_slow=t["loss_slow"],
    )


def window_leaves(win) -> Dict[str, np.ndarray]:
    """A ``WindowState`` (either package's, batched or not) as numpy
    ``rows``, ``onehot``, ``pos``."""
    return {k: _to_numpy(getattr(win, k)) for k in ("rows", "onehot", "pos")}


def window_from_leaves(leaves: Dict[str, np.ndarray],
                       device=None) -> WindowState:
    """The port's ``WindowState`` from ``window_leaves`` output."""
    return WindowState(**{k: torch.from_numpy(np.array(leaves[k])).to(device)
                          for k in ("rows", "onehot", "pos")})


def _load_tree(node: ParamTree, tree: Mapping[str, Any], index=None) -> None:
    """Copy ``tree`` into ``node`` (``index``: the layer of a stacked
    tree); the names must match both ways."""
    if sorted(tree) != sorted(node.keys()):
        raise KeyError(f"parameter names differ: tree {sorted(tree)}, "
                       f"model {sorted(node.keys())}")
    for name, val in tree.items():
        dst = node[name]
        if isinstance(dst, nn.ModuleList):
            for i, layer in enumerate(dst):
                _load_tree(layer, val, i)
        elif isinstance(val, Mapping):
            _load_tree(dst, val, index)
        else:
            arr = np.array(val if index is None else val[index],
                           dtype=np.float32)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {arr.shape}, model "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(arr).to(dst.dtype))


def _depth(tree: Mapping[str, Any]) -> int:
    """The leading (layer) extent of a stacked tree."""
    leaf = tree
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return len(leaf)


def lm_params_from_numpy(model: ParamTree, tree: Mapping[str, Any]
                         ) -> ParamTree:
    """Load the reference's ``Transformer.init`` values tree (numpy arrays,
    or anything ``np.asarray`` reads) into the port's ``Transformer``, in
    place; returns the model.  Every stacked list (``layers``, and
    ``enc_layers``/``dec_layers`` for the encoder-decoder) must have the
    model's depth."""
    for name in STACKED:
        if name in model and name in tree \
                and _depth(tree[name]) != len(model[name]):
            raise ValueError(f"the tree and the model have different "
                             f"depths in {name!r}")
    _load_tree(model, tree)
    return model


def lm_params_to_numpy(model: ParamTree) -> Dict[str, Any]:
    """The port's LM parameters as the reference's values tree: float32
    numpy arrays (copies), each layer list stacked on a leading axis."""

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        # a copy: an fp32 CPU tensor's .numpy() shares its memory
        return tree.to(torch.float32).cpu().numpy().copy()

    return walk(to_reference_layout(model))


def _is_layer_list(node) -> bool:
    return isinstance(node, (list, nn.ModuleList)) and len(node) > 0 and \
        all(isinstance(c, (Mapping, nn.Module)) for c in node)


def _stack(*leaves):
    return torch.stack(leaves)


def to_reference_layout(tree, stack=_stack, is_leaf=None):
    """A tree of tensors in the reference's layout: a ``ParamTree`` as the
    dict of its names, a list of layers (an ``nn.ModuleList``, or a list of
    dicts as an optimizer state mirrors it) as one dict with every leaf
    stacked on a leading axis (``stack(*layer_leaves)``, by default
    ``torch.stack``: dtype and device kept; on meta tensors nothing is
    allocated); dicts, NamedTuples, tuples and other lists as they are.
    ``is_leaf`` marks the leaves of a tree that are not tensors (logical
    axes, say, stacked by their own ``stack``).  The walk is
    ``optim.optimizers``'s (``_children``, ``_rebuild``, ``tree_map``)."""
    if _is_layer_list(tree):
        layers = [to_reference_layout(c, stack, is_leaf) for c in tree]
        return tree_map(stack, *layers, is_leaf=is_leaf)
    kids = _children(tree, is_leaf)
    if kids is None:
        return tree.detach() if isinstance(tree, torch.Tensor) else tree
    return _rebuild(tree, [to_reference_layout(c, stack, is_leaf)
                           for _, c in kids])


def _take(t, i):
    return t[i]


def from_reference_layout(template, tree, take=_take, is_leaf=None):
    """The inverse of ``to_reference_layout``: ``template``'s structure
    filled from ``tree``.  A ``ParamTree``'s parameters are overwritten in
    place (each cast to its dtype) and the module itself returned; a list
    of layers takes layer i's leaves as ``take(stacked_leaf, i)`` (by
    default the slice); any other tensor is replaced by the tree's leaf,
    placed as the template's leaf is where that is a DTensor.
    ``is_leaf`` marks ``tree``'s leaves that are not tensors."""
    if _is_layer_list(template):
        layers = [from_reference_layout(
            c, tree_map(lambda t: take(t, i), tree, is_leaf=is_leaf), take,
            is_leaf) for i, c in enumerate(template)]
        return template if isinstance(template, nn.ModuleList) else layers
    kids = _children(template)
    if kids is None:
        if isinstance(template, DTensor) and not isinstance(tree, DTensor):
            tree = distribute_tensor(tree.to(template.dtype),
                                     template.device_mesh,
                                     template.placements)
        if isinstance(template, nn.Parameter):
            with torch.no_grad():
                template.copy_(tree)
            return template
        return tree
    new = [from_reference_layout(c, tree[k], take, is_leaf)
           for k, c in kids]
    return template if isinstance(template, nn.Module) else \
        _rebuild(template, new)
