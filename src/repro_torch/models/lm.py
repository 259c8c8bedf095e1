"""LM step functions: the loss, the eval, prefill and decode steps.

The port of ``repro.models.lm``.  The model holds its parameters, so the
steps take no ``params`` argument: ``prefill_step(batch)`` where the
reference has ``prefill_step(params, batch)``.  ``make_train_step`` comes
with the training slice (ROADMAP.md, Queue 1, 'LM training').
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.types import Tensor
from repro_torch.models.transformer import Transformer


def softmax_xent(logits: Tensor, targets: Tensor) -> Tensor:
    """Mean next-token CE; logits f32 (B, T, V), targets int (B, T)."""
    lmax = logits.amax(-1, keepdim=True).detach()
    shifted = logits - lmax
    lse = torch.log(torch.exp(shifted).sum(-1))
    ll = torch.gather(shifted, -1, targets[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - ll)


def loss_fn(model: Transformer, batch: Dict) -> Tuple[Tensor, Dict]:
    """Next-token CE of a {'tokens', 'targets'} batch (B, T), plus the
    family's aux losses (zero for the dense family)."""
    logits, aux = model.train_logits(batch["tokens"])
    targets = model.as_tokens(batch["targets"])
    # next-token objective: shift targets left
    loss = softmax_xent(logits[:, :-1], targets[:, 1:])
    metrics = {"xent": loss}
    if aux:
        lb, zl = aux["lb_loss"], aux["z_loss"]
        loss = loss + 0.01 * lb + 1e-3 * zl
        metrics.update(lb_loss=lb, z_loss=zl)
    metrics["loss"] = loss
    return loss, metrics


def make_eval_step(model: Transformer) -> Callable:
    @torch.no_grad()
    def eval_step(batch):
        _, metrics = loss_fn(model, batch)
        return metrics

    return eval_step


def make_prefill_step(model: Transformer) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch["tokens"])

    return prefill_step


def make_decode_step(model: Transformer) -> Callable:
    def decode_step(token, cache):
        return model.decode_step(token, cache)

    return decode_step
