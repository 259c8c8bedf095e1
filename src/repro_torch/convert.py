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
as the reference's ``Transformer.init`` values tree of numpy arrays (the
layers stacked on a leading axis).  The reference's bf16 leaves are
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses: they go
through float32, exact for bf16, and are cast to the parameter's dtype.
``lm_params_to_numpy`` returns float32 arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.online import OnlineState
from repro_torch.core.types import (DFRParams, QuantParams, RidgeState,
                                    WindowState)
from repro_torch.models.transformer import ParamTree

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
        if name == "layers":
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


def lm_params_from_numpy(model: ParamTree, tree: Mapping[str, Any]
                         ) -> ParamTree:
    """Load the reference's ``Transformer.init`` values tree (numpy arrays,
    or anything ``np.asarray`` reads) into the port's ``Transformer``, in
    place; returns the model."""
    if len(tree["layers"]["ln_attn_w"]) != len(model["layers"]):
        raise ValueError("the tree and the model have different depths")
    _load_tree(model, tree)
    return model


def lm_params_to_numpy(model: ParamTree) -> Dict[str, Any]:
    """The port's LM parameters as the reference's values tree: float32
    numpy arrays, the layers stacked on a leading axis."""

    def walk(node: ParamTree) -> Dict[str, Any]:
        out = {}
        for name in node.keys():
            val = node[name]
            if name == "layers":
                layers = [walk(layer) for layer in val]
                out[name] = _stack(layers)
            elif isinstance(val, ParamTree):
                out[name] = walk(val)
            else:
                out[name] = val.detach().to(torch.float32).cpu().numpy()
        return out

    return walk(model)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
