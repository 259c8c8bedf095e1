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
    """Next-token CE of a batch, plus the family's aux losses
    (``+ 0.01 lb + 1e-3 z``; zero for dense layers, absent for the
    attention-free families).  The batch is {'tokens', 'targets'} (B, T);
    for ``input_mode='embeds'`` {'embeds' (B, T, d_model), 'targets'}; for
    the encoder-decoder {'embeds' (encoder frames), 'targets'}, the
    decoder teacher-forced on the targets.  Only a token batch shifts the
    targets left."""
    cfg = model.cfg
    if cfg.is_encdec:
        kwargs = dict(tokens=batch["targets"], enc_embeds=batch["embeds"])
    elif cfg.input_mode == "embeds":
        kwargs = dict(embeds=batch["embeds"])
    else:
        kwargs = dict(tokens=batch["tokens"])
    logits, aux = model.train_logits(**kwargs)
    targets = model.as_tokens(batch["targets"])
    if not cfg.is_encdec and "tokens" in batch:
        logits, targets = logits[:, :-1], targets[:, 1:]
    loss = softmax_xent(logits, targets)
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
    cfg = model.cfg

    def prefill_step(batch):
        if cfg.is_encdec:
            # prefill = encode the (stub) frames; the decoder starts from BOS
            bos = torch.zeros((len(batch["embeds"]), 1), dtype=torch.int64)
            return model.prefill(tokens=bos, enc_embeds=batch["embeds"])
        if cfg.input_mode == "embeds":
            return model.prefill(embeds=batch["embeds"])
        return model.prefill(batch["tokens"])

    return prefill_step


def make_decode_step(model: Transformer) -> Callable:
    def decode_step(token, cache):
        return model.decode_step(token, cache)

    return decode_step
