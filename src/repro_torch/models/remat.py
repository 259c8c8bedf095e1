"""The reference's remat policies (``repro.models.transformer._remat``) as
``torch.utils.checkpoint``.

The reference wraps each layer body in ``jax.checkpoint`` under
``cfg.remat_policy``; ``remat(policy, fn)`` wraps it in non-reentrant
activation checkpointing while gradients are on (a forward under
``no_grad`` calls ``fn`` as it is):

* ``'none'``: no checkpoint; autograd saves what it saves.
* ``'dots'``: save the outputs of the products with no batch dimension
  (``aten.mm``/``aten.addmm``, the reference's
  ``dots_with_no_batch_dims_saveable``); recompute the rest.
* ``'save_moe'``: save what runs under ``checkpoint_name('moe_xe')`` (the
  MoE's dispatched expert inputs, as the reference's
  ``save_only_these_names('moe_xe')``); recompute the rest.
* anything else (the default ``'nothing'``): save only the body's inputs
  and recompute the whole body in the backward.

Recomputing runs the body's forward again, K8 included: under
``'nothing'`` a train step launches K8 twice a layer.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_names = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str) -> Iterator[None]:
    """Tag the operations run inside the block with ``name`` (the
    reference's ``jax.ad_checkpoint.checkpoint_name``).  The tag lives in
    the running thread, which is the thread that reruns the body in a
    recompute too."""
    prev = getattr(_names, "name", None)
    _names.name = name
    try:
        yield
    finally:
        _names.name = prev


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _save_moe(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE \
        if getattr(_names, "name", None) == "moe_xe" else \
        CheckpointPolicy.PREFER_RECOMPUTE


_SELECTIVE = {"dots": _save_dots, "save_moe": _save_moe}


def remat(policy: str, fn: Callable) -> Callable:
    """``fn`` under the remat ``policy`` (see the module docstring)."""
    if policy == "none":
        return fn
    kw = {}
    if policy in _SELECTIVE:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _SELECTIVE[policy])

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped
