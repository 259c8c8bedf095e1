"""Carry DFR weights and online state between the JAX package and the port.

Both packages' ``OnlineState`` have the same attribute tree, so one walk
reads either: ``state_leaves`` turns a state (the reference's or the port's,
batched or not) into a dict of numpy arrays under flat leaf names, and
``state_from_leaves`` builds the port's ``OnlineState`` from such a dict.
The names are the ones the reference's own golden fixtures use
(``params_p`` ... ``ridge_B``, ``step``, ``loss_ema``).  Nothing here
imports the JAX package: a caller on that side builds its own state from
the same dict.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.online import OnlineState
from repro_torch.core.types import DFRParams, QuantParams, RidgeState

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
