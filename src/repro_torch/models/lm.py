"""LM step functions: the loss, the microbatched train step, the eval,
prefill and decode steps.

The port of ``repro.models.lm``.  The model holds its parameters, so the
eval, prefill and decode steps take no ``params`` argument:
``prefill_step(batch)`` where the reference has ``prefill_step(params,
batch)``.  The train step keeps the reference's contract,
``train_step(params, opt_state, step, batch) -> (params, opt_state,
metrics)``, so that ``runtime.Trainer`` and ``launch.train`` read like the
reference's: ``params`` is the model itself (its parameter tree), updated
in place under ``no_grad`` and returned.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.types import Tensor
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map)


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


def make_train_step(
    model: Transformer,
    optimizer: Optimizer,
    lr_fn: Callable[[int], Tensor],
    accum: int = 1,
    grad_clip: float = 1.0,
) -> Callable:
    """Builds ``train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics)`` with ``params`` the model.

    The batch (each leaf's leading axis) is split into ``accum``
    microbatches run one after another; each one's gradients are cast to
    f32 and summed, so the peak activation memory is one microbatch deep.
    The sum over ``accum`` is clipped to ``grad_clip`` by its global norm,
    ``lr_fn(step)`` gives the rate, and ``optimizer.update`` the new
    parameters, copied into the model.  Metrics: ``loss`` (the mean over
    microbatches), ``grad_norm`` (before clipping) and ``lr``, f32
    scalars."""

    def split_mb(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} "
                             f"microbatches")
        return x.reshape(accum, b // accum, *x.shape[1:])

    def train_step(params, opt_state, step, batch):
        micro = {k: split_mb(v) for k, v in batch.items()}
        leaves = tree_leaves(params)
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=model.device)
        for i in range(accum):
            for p in leaves:
                p.grad = None
            loss, _ = loss_fn(model, {k: v[i] for k, v in micro.items()})
            loss.backward()
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)
                if p.grad is None else p.grad.to(torch.float32), params)
            gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                       grads)
            lsum = lsum + loss.detach()
        for p in leaves:
            p.grad = None
        grads = tree_map(lambda g: g / accum, gsum)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(step)
        with torch.no_grad():
            new_params, new_state = optimizer.update(grads, opt_state,
                                                     params, lr)
            for p, new in zip(leaves, tree_leaves(new_params)):
                p.copy_(new)
        metrics = {"loss": lsum / accum, "grad_norm": gnorm, "lr": lr}
        return params, new_state, metrics

    return train_step


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
