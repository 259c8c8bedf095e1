"""Step assembly shared by dryrun.py / train.py: the sharded train,
prefill and decode programs of one (arch x shape x mesh) cell.

The port of ``repro.launch.steps``.  ``build_cell`` gives the step, its
arguments as meta tensors (the model on the meta device, the optimizer
state, the batch and the cache) and their placements (the reference's
``in_shardings``); ``lower_cell`` has no XLA to lower to: it runs the step
once on fake tensors over the mesh (``FakeTensorMode``; nothing is
allocated) under ``analysis.CostMode`` and returns what the dry run
records.  ``place_batch`` and ``place_opt_state`` place real tensors the
same way for a live sharded run (``launch.train``, ``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig, ShapeSpec, input_specs
from repro_torch.convert import from_reference_layout, to_reference_layout
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analysis
from repro_torch.models.lm import (make_decode_step, make_prefill_step,
                                   make_train_step)
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import (_children, _rebuild, make_optimizer,
                                          tree_leaves, tree_map)
from repro_torch.optim.schedule import cosine_schedule


def pick_optimizer(cfg: ArchConfig) -> str:
    """Adafactor for 50B+ params (factored state is what fits HBM)."""
    return "adafactor" if cfg.param_count() > 5e10 else "adamw"


def _batch_axes(batch_specs: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {k: ("batch",) + (None,) * (v.ndim - 1)
            for k, v in batch_specs.items()}


def _stack_axes(*layers: tuple) -> tuple:
    return ("layers",) + layers[0]


def _jax_order(tree):
    """The tree with every dict's keys sorted: the order in which JAX
    flattens a dict, which decides the reference's first-wins matches."""
    kids = _children(tree, shd.is_axes)
    if kids is None:
        return tree
    node = _rebuild(tree, [_jax_order(c) for _, c in kids])
    return dict(sorted(node.items())) if isinstance(node, dict) else node


def _opt_axes(opt_state, params_shapes, params_axes):
    """Optimizer-state logical axes: inherit the parameter's axes where the
    shapes match (mu/nu), drop factored dims (adafactor row/col), else
    replicate.  The reference's rule, first match wins in its leaf order,
    applied to the reference's layout (each layer list stacked on a
    leading 'layers' axis), so the port's state shards as the reference's
    does; a layer leaf's axes are the stacked ones less the leading
    entry."""
    ref_shapes = _jax_order(to_reference_layout(params_shapes))
    ref_axes = _jax_order(to_reference_layout(params_axes, stack=_stack_axes,
                                              is_leaf=shd.is_axes))
    pflat = tree_leaves(ref_shapes)
    aflat = tree_leaves(ref_axes, is_leaf=shd.is_axes)
    shape_to_axes: Dict[tuple, tuple] = {}
    by_row: Dict[tuple, tuple] = {}
    by_col: Dict[tuple, tuple] = {}
    for ps, ax in zip(pflat, aflat):
        shape_to_axes.setdefault(tuple(ps.shape), tuple(ax))
    for ps, ax in zip(pflat, aflat):
        s = tuple(ps.shape)
        if len(s) >= 2:
            by_row.setdefault(s[:-1], tuple(ax[:-1]))
            by_col.setdefault(s[:-2] + s[-1:], tuple(ax[:-2] + ax[-1:]))

    def axes_of(leaf):
        s = tuple(leaf.shape)
        for table in (shape_to_axes, by_row, by_col):
            if s in table:
                return table[s]
        return (None,) * len(s)

    ref_state = tree_map(axes_of, to_reference_layout(opt_state))
    return from_reference_layout(opt_state, ref_state,
                                 take=lambda ax, i: ax[1:],
                                 is_leaf=shd.is_axes)


def place_batch(batch: Dict[str, torch.Tensor], mesh, rules=None):
    """A batch of tensors as DTensors sharded over the data axes."""
    axes = _batch_axes(batch)
    return shd.place(batch, shd.guarded_shardings(batch, axes, mesh, rules),
                     mesh)


def opt_placements(opt, model: Transformer, mesh, rules=None):
    """The optimizer state (meta tensors, in the model's own leaf order, as
    ``opt.init(model)`` gives it) and its placements on ``mesh``
    (``_opt_axes``)."""
    shapes = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"), model)
    state = opt.init(shapes)
    axes = _opt_axes(state, shapes, model.axes())
    return state, shd.guarded_shardings(state, axes, mesh, rules)


def place_opt_state(opt, model: Transformer, mesh, rules=None):
    """``opt.init``'s state of a sharded model, each leaf a DTensor at the
    reference's optimizer-state placements (zeros, each rank allocating
    its shard; the step count a replicated scalar)."""
    state, placements = opt_placements(opt, model, mesh, rules)
    return shd.place(state, placements, mesh)


@dataclasses.dataclass
class CellPrograms:
    """Everything needed to run one (arch x shape) cell on a mesh."""

    kind: str
    fn: Any                  # the step callable
    args: Tuple              # meta-tensor trees (the model for params)
    in_shardings: Tuple      # placements trees (None: a plain scalar)
    out_shardings: Any
    donate: Tuple[int, ...]


def build_cell(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    *,
    rules: Optional[dict] = None,
    accum_override: Optional[int] = None,
) -> CellPrograms:
    model = Transformer(cfg, device="meta")
    rules = rules or dict(shd.DEFAULT_RULES)

    with shd.use_mesh(mesh, rules):
        params_shapes = model.param_shapes()
        p_shard = shd.guarded_shardings(params_shapes, model.axes(), mesh,
                                        rules)
        batch_specs = input_specs(cfg, shape)
        b_shard = shd.guarded_shardings(batch_specs, _batch_axes(batch_specs),
                                        mesh, rules)

        if shape.kind == "train":
            opt = make_optimizer(pick_optimizer(cfg))
            accum = accum_override or cfg.grad_accum.get(shape.name, 1)
            lr_fn = cosine_schedule(3e-4, 100, 10000)
            step_fn = make_train_step(model, opt, lr_fn, accum=accum)
            opt_shapes, o_shard = opt_placements(opt, model, mesh, rules)
            args = (model, opt_shapes, 0, batch_specs)
            in_sh = (p_shard, o_shard, None, b_shard)
            return CellPrograms("train", step_fn, args, in_sh,
                                (p_shard, o_shard, None), (0, 1))

        if shape.kind == "prefill":
            prefill = make_prefill_step(model)

            def fn(params, batch):   # params: the model, as the args say
                return prefill(batch)

            return CellPrograms("prefill", fn, (model, batch_specs),
                                (p_shard, b_shard), None, ())

        # decode: one token against a seq_len cache
        decode = make_decode_step(model)

        def fn(params, token, cache):
            return decode(token, cache)

        enc_len = shape.seq_len if cfg.is_encdec else 0
        cache_shapes = model.cache_specs(shape.global_batch, shape.seq_len,
                                         enc_len=enc_len)
        cache_axes = model.cache_axes(shape.global_batch, shape.seq_len,
                                      enc_len=enc_len)
        c_shard = shd.guarded_shardings(cache_shapes, cache_axes, mesh, rules)
        tok = input_specs(cfg, shape)["token"]
        tok_shard = shd.guarded_shardings({"t": tok}, {"t": ("batch", None)},
                                          mesh, rules)["t"]
        return CellPrograms("decode", fn, (model, tok, cache_shapes),
                            (p_shard, tok_shard, c_shard), (None, c_shard),
                            (2,))


def _local_bytes(tree) -> int:
    return sum(analysis.tensor_bytes(t.to_local() if isinstance(t, DTensor)
                                     else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def lower_cell(cell: CellPrograms, mesh, rules: Optional[dict] = None
               ) -> Dict[str, Any]:
    """Run the cell's step once on fake tensors over ``mesh`` (a shape-only
    'fake' process group) and return its per-device costs: ``flops``,
    ``bytes``, ``collective`` (``analysis.CollectiveStats``),
    ``argument_size``, ``output_size`` and ``temp_size`` (the peak of live
    bytes the step allocates), all from each rank's local shards.

    A train step's microbatches are alike in every shape, so its
    microbatch body (``TrainStep.grads``) is traced once and weighted by
    the microbatch count, as the reference's cost walker weights its
    accumulation loop by its trip count; the update (``TrainStep.apply``)
    is traced once.  The peak then adds the f32 gradient sum that the
    accumulation keeps live."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rules = rules or dict(shd.DEFAULT_RULES)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            shd.use_mesh(mesh, rules):
        model = cell.args[0]
        model.distribute(mesh, rules, placements=cell.in_shardings[0])
        args = [model] + [
            a if pl is None else shd.place(a, pl, mesh)
            for a, pl in zip(cell.args[1:], cell.in_shardings[1:])]
        arg_bytes = _local_bytes([a for a in args if not isinstance(a, int)])
        if cell.kind != "train":
            cost = analysis.CostMode()
            with cost:
                out = cell.fn(*args)
            flops, nbytes = cost.flops, cost.bytes
            records, temp = cost.collectives, cost.peak_bytes
        else:
            train, (model, opt_state, step, batch) = cell.fn, args
            accum = train.accum
            micro, update = analysis.CostMode(), analysis.CostMode()
            with micro:
                gsum, lsum = train.grads(model, train.microbatches(batch)[0])
            gsum_bytes = _local_bytes(gsum)
            with update:
                out = train.apply(model, opt_state, step, gsum, lsum)[:2]
            flops = micro.flops * accum + update.flops
            nbytes = micro.bytes * accum + update.bytes
            records = micro.collectives * accum + update.collectives
            temp = max(micro.peak_bytes + (gsum_bytes if accum > 1 else 0),
                       gsum_bytes + update.peak_bytes)
        return {
            "flops": flops,
            "bytes": nbytes,
            "collective": analysis.collective_stats(records),
            "argument_size": arg_bytes,
            "output_size": _local_bytes(out),
            "temp_size": temp,
        }
