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

from typing import Callable, Dict, List, Tuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch.core.types import Tensor
from repro_torch.distributed.sharding import relayout, shard_act, zeros
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map)


def softmax_xent(logits: Tensor, targets: Tensor) -> Tensor:
    """Mean next-token CE; logits f32 (B, T, V), targets int (B, T).  Under
    a mesh the logits are vocab-sharded over 'model' (the reference's
    constraint): the max and the sum reduce over the shards, and each rank
    picks the target logits its shard holds (``_target_logits``)."""
    logits = shard_act(logits, ("batch", None, "vocab"))
    lmax = logits.amax(-1, keepdim=True).detach()
    # pinned as the logits: left free, DTensor may split the rows of a
    # batch too small for the data axes unevenly over them
    shifted = shard_act(logits - lmax, ("batch", None, "vocab"))
    # the vocab sums reduced to the batch placements before they go on
    lse = torch.log(shard_act(torch.exp(shifted).sum(-1), ("batch", None)))
    ll = shard_act(_target_logits(shifted, targets), ("batch", None))
    return torch.mean(lse - ll)


def _target_logits(shifted: Tensor, targets: Tensor) -> Tensor:
    """shifted[b, t, targets[b, t]] (B, T).  On DTensors, the reference's
    masked local reduction: each rank sums its vocab shard's hits (the
    sum over 'model' left pending), so no rank gathers the logits or
    scatters their gradient over the whole vocabulary."""
    targets = targets.to(torch.int64)
    if not isinstance(shifted, DTensor):
        return torch.gather(shifted, -1, targets[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = shifted.device_mesh
    vocab_dims = [i for i, p in enumerate(shifted.placements)
                  if isinstance(p, Shard) and p.dim == 2]

    def pick(s, t):
        offset = 0
        for i in vocab_dims:   # this rank's first vocab id (major to minor)
            offset = offset * mesh.size(i) + mesh.get_local_rank(i)
        ids = offset * s.shape[-1] + torch.arange(s.shape[-1],
                                                  device=s.device)
        return torch.where(ids == t[..., None], s, 0.0).sum(-1)

    t_pl = [p if not isinstance(p, Shard) else Shard(0)
            for p in shifted.placements]
    t_pl = [Replicate() if i in vocab_dims else p
            for i, p in enumerate(t_pl)]
    out_pl = [Partial() if i in vocab_dims else p
              for i, p in enumerate(t_pl)]
    return local_map(pick, out_placements=out_pl,
                     in_placements=(list(shifted.placements), t_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
                         shifted, targets)


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

    return TrainStep(model, optimizer, lr_fn, accum, grad_clip)


class TrainStep:
    """``make_train_step``'s step, callable as ``(params, opt_state, step,
    batch) -> (params, opt_state, metrics)``, and in its parts:
    ``microbatches(batch)``, ``grads(params, microbatch)`` (the f32
    gradients and the loss of one microbatch) and ``apply(params,
    opt_state, step, gsum, lsum)`` (the mean, the clip and the update).
    The dry run traces the parts (``launch.steps.lower_cell``)."""

    def __init__(self, model, optimizer, lr_fn, accum, grad_clip):
        self.model, self.optimizer, self.lr_fn = model, optimizer, lr_fn
        self.accum, self.grad_clip = accum, grad_clip

    def microbatches(self, batch: Dict) -> List[Dict]:
        """The batch split into ``accum`` microbatches on the leading
        axis.  A DTensor batch splits each rank's rows into ``accum``
        blocks: microbatch i is block i of every data shard, so it stays
        sharded like the batch (the same tokens in all, in another
        grouping).  Where a rank holds fewer rows than that takes,
        microbatch i is the batch's block i, as the reference groups them,
        at the batch axes' guarded placements for its own shape
        (replicated where its rows do not divide over the data axes)."""
        accum = self.accum

        def split(x):
            b = x.shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} "
                                 f"microbatches")
            if isinstance(x, DTensor):
                loc = x.to_local()
                if loc.shape[0] % accum:
                    whole = relayout(x, (None,) * x.ndim)
                    mb = b // accum
                    axes = ("batch",) + (None,) * (x.ndim - 1)
                    return [relayout(whole[i * mb:(i + 1) * mb], axes)
                            for i in range(accum)]
                loc = loc.reshape(accum, loc.shape[0] // accum,
                                  *loc.shape[1:])
                return [DTensor.from_local(m, x.device_mesh, x.placements,
                                           run_check=False) for m in loc]
            return x.reshape(accum, b // accum, *x.shape[1:])

        parts = {k: split(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(accum)]

    def grads(self, params, microbatch: Dict):
        """(f32 gradients, each at its parameter's placements, and the
        plain f32 loss) of one microbatch."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, _ = loss_fn(self.model, microbatch)
        loss.backward()
        grads = tree_map(_f32_grad, params)
        for p in leaves:
            p.grad = None
        return grads, _plain(loss.detach())

    def apply(self, params, opt_state, step, gsum, lsum):
        """Average the summed gradients, clip them by their global norm and
        update the parameters (in place) and the optimizer state (each
        leaf keeping its placements)."""
        accum = self.accum
        grads = tree_map(lambda g: g / accum, gsum)
        grads, gnorm = clip_by_global_norm(grads, self.grad_clip)
        lr = self.lr_fn(step)
        with torch.no_grad():
            new_params, new_state = self.optimizer.update(grads, opt_state,
                                                          params, lr)
            for p, new in zip(tree_leaves(params), tree_leaves(new_params)):
                p.copy_(_placed_like(new, p))
            new_state = tree_map(_placed_like, new_state, opt_state)
        metrics = {"loss": lsum / accum, "grad_norm": gnorm, "lr": lr}
        return params, new_state, metrics

    def __call__(self, params, opt_state, step, batch):
        gsum, lsum = None, None
        for mb in self.microbatches(batch):
            grads, loss = self.grads(params, mb)
            gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                       grads)
            lsum = loss if lsum is None else lsum + loss
        return self.apply(params, opt_state, step, gsum, lsum)


def _f32_grad(p: Tensor) -> Tensor:
    g = p.grad
    if g is None:
        return torch.zeros_like(p, dtype=torch.float32)
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g.to(torch.float32)


def _plain(t: Tensor) -> Tensor:
    """A replicated DTensor's full value as a plain tensor."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed_like(new: Tensor, old: Tensor) -> Tensor:
    """``new`` at ``old``'s placements (the step's out_shardings)."""
    if isinstance(old, DTensor) and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


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
            bos = torch.zeros((batch["embeds"].shape[0], 1),
                              dtype=torch.int64)
            if isinstance(batch["embeds"], DTensor):
                bos = zeros((bos.shape[0], 1), ("batch", None), torch.int64,
                            model.device)
            return model.prefill(tokens=bos, enc_embeds=batch["embeds"])
        if cfg.input_mode == "embeds":
            return model.prefill(embeds=batch["embeds"])
        return model.prefill(batch["tokens"])

    return prefill_step


def make_decode_step(model: Transformer) -> Callable:
    def decode_step(token, cache):
        return model.decode_step(token, cache)

    return decode_step
