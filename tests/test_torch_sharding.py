"""The port's LM sharding rules against the reference's, with no process
group: every parameter, optimizer-state, decode-cache and batch spec of
all 10 architectures on the production meshes (16x16 and 2x16x16) and the
reference test's (4, 2) mesh; the input stand-ins; the model FLOPs and
roofline terms; the collective pricing; and the mapping of a spec onto
DTensor placements.

The reference stacks each layer list on a leading 'layers' axis, which
resolves to no mesh axis; the port keeps the layers as a list, so each of
its layer leaves is held to the reference's stacked spec less its leading
entry (which must be None).  Specs are compared exactly.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.configs.base import input_specs as rinput_specs
from repro.distributed import sharding as rshd
from repro.launch import analysis as ranalysis
from repro.launch import steps as rsteps
from repro.models.transformer import Transformer as RTransformer
from repro.optim.optimizers import make_optimizer as rmake_optimizer
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.configs.base import input_specs
from repro_torch.convert import to_reference_layout
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analysis, steps
from repro_torch.models.transformer import (Transformer, param_axes,
                                            param_shapes)
from repro_torch.optim.optimizers import make_optimizer, tree_map


class _Mesh:
    """A mesh of given axis sizes, for the rules alone (no devices)."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = {
    "pod16x16": dict(data=16, model=16),
    "pod2x16x16": dict(pod=2, data=16, model=16),
    "host4x2": dict(data=4, model=2),
}


def _ref_spec(shape, axes, mesh):
    return tuple(rshd.guarded_spec(tuple(shape), tuple(axes), mesh,
                                   dict(rshd.DEFAULT_RULES)))


def _port_specs(shapes, axes, mesh):
    """The port's (shape, guarded spec) leaves in the reference's layout:
    each layer list's leaves checked alike across layers and stacked as
    ((L,) + shape, (None,) + spec)."""
    specs = tree_map(lambda t, ax: (tuple(t.shape),
                                    shd.guarded_spec(tuple(t.shape), ax,
                                                     mesh)),
                     shapes, axes)

    def stack(*layers):
        assert all(s == layers[0] for s in layers)
        return ((len(layers),) + layers[0][0], (None,) + layers[0][1])

    return to_reference_layout(specs, stack=stack, is_leaf=_is_pair)


def _is_pair(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple) \
        and isinstance(x[1], tuple) and shd.is_axes(x[0][:0])


def _ref_specs(shapes, axes, mesh):
    flat_axes = jax.tree_util.tree_leaves(axes, is_leaf=shd.is_axes)
    flat, tree = jax.tree_util.tree_flatten(shapes)
    assert len(flat) == len(flat_axes)
    return jax.tree_util.tree_unflatten(
        tree, [(tuple(s.shape), _ref_spec(s.shape, a, mesh))
               for s, a in zip(flat, flat_axes)])


def _same(port, ref, reshaped=None):
    """Two (shape, spec) trees equal: dicts key for key, namedtuples
    (optimizer states) field by field, each leaf's spec exactly.  Where
    ``reshaped`` is a list, a leaf whose stacked shape differs from the
    reference's is appended to it instead (the optimizer-state test
    requires the list to stay empty)."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _same(port[k], ref[k], reshaped)
    elif hasattr(ref, "_fields"):
        for a, b in zip(port, ref):
            _same(a, b, reshaped)
    elif reshaped is not None and port[0] != ref[0]:
        reshaped.append((port, ref))
    else:
        assert port == ref, (port, ref)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """Both packages' parameter and optimizer-state trees of an arch, with
    their logical axes (shapes only; built once a test process)."""
    rmodel = RTransformer(rget_config(arch))
    rshapes, raxes = rmodel.param_shapes(), rmodel.axes()
    shapes, axes = param_shapes(get_config(arch)), param_axes(get_config(arch))
    out = {"params": (shapes, axes), "ref_params": (rshapes, raxes)}
    for name in ("adamw", "adafactor"):
        rstate = jax.eval_shape(rmake_optimizer(name).init, rshapes)
        out["ref_" + name] = (rstate, rsteps._opt_axes(rstate, rshapes,
                                                       raxes))
        state = make_optimizer(name).init(shapes)
        out[name] = (state, steps._opt_axes(state, shapes, axes))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_specs_match_reference(arch, mesh_name):
    """Every parameter leaf's spec, and every AdamW and Adafactor state
    leaf's (``_opt_axes``, the reference's first-match rule), equals the
    reference's on its stacked leaf less the leading 'layers' entry."""
    mesh = _Mesh(**MESHES[mesh_name])
    trees = _trees(arch)
    _same(_port_specs(*trees["params"], mesh),
          _ref_specs(*trees["ref_params"], mesh))
    for name in ("adamw", "adafactor"):
        state, state_axes = trees[name]
        rstate, rstate_axes = trees["ref_" + name]
        reshaped = []
        _same(_port_specs(state, state_axes, mesh),
              _ref_specs(rstate, rstate_axes, mesh), reshaped)
        # both optimizers' states are in the reference's stacked shapes
        assert not reshaped


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_batch_and_input_specs_match_reference(arch, mesh_name):
    """The decode cache's specs (at each shape's batch and length), the
    batch specs and ``input_specs`` (shapes and dtypes) equal the
    reference's for every shape."""
    mesh = _Mesh(**MESHES[mesh_name])
    cfg, rcfg = get_config(arch), rget_config(arch)
    model, rmodel = Transformer(cfg, device="meta"), RTransformer(rcfg)
    for name, shape in SHAPES.items():
        rshape = RSHAPES[name]
        got, want = input_specs(cfg, shape), rinput_specs(rcfg, rshape)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).split(".")[-1] == str(
                np.dtype(want[k].dtype)).replace("bfloat16", "bfloat16")
        _same(_port_specs(got, steps._batch_axes(got), mesh),
              _ref_specs(want, rsteps._batch_axes(want), mesh))
        if shape.kind != "decode":
            continue
        enc = shape.seq_len if cfg.is_encdec else 0
        args = (shape.global_batch, shape.seq_len)
        _same(_port_specs(model.cache_specs(*args, enc_len=enc),
                          model.cache_axes(*args, enc_len=enc), mesh),
              _ref_specs(rmodel.cache_specs(*args, enc_len=enc),
                         rmodel.cache_axes(*args, enc_len=enc), mesh))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_and_roofline_match_reference(arch, monkeypatch):
    """``model_flops`` equals the reference's; ``roofline_terms`` equals the
    reference's once its TPU constants are patched to the port's H100
    ones (the reference's file is unchanged)."""
    monkeypatch.setattr(ranalysis, "PEAK_FLOPS_BF16", analysis.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ranalysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ranalysis, "ICI_BW", analysis.LINK_BW)
    for name in SHAPES:
        got = analysis.model_flops(get_config(arch), SHAPES[name])
        assert got == ranalysis.model_flops(rget_config(arch), RSHAPES[name])
        for f, b, w in ((got / 256, 3e11, 2e9), (1e9, 5e12, 1e8),
                        (1e9, 1e6, 3e11)):
            assert analysis.roofline_terms(f, b, w) == \
                ranalysis.roofline_terms(f, b, w)


def test_collective_stats_match_reference_parse():
    """The traced collectives' pricing equals ``parse_collectives`` on HLO
    lines of the same kinds, result shapes and group sizes."""
    rng = np.random.default_rng(0)
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"]
    records, lines = [], []
    for i in range(40):
        kind = kinds[i % len(kinds)]
        dims = [int(d) for d in rng.integers(1, 64, rng.integers(1, 4))]
        dtype, nbytes = [("bf16", 2), ("f32", 4)][i % 2]
        k = int(rng.choice([1, 2, 8, 16, 32]))
        records.append((kind, float(np.prod(dims) * nbytes), k))
        lines.append(f"  %c{i} = {dtype}[{','.join(map(str, dims))}]{{0}} "
                     f"{kind}(%x), replica_groups=[{512 // k},{k}]<=[512]")
    got = analysis.collective_stats(records)
    want = ranalysis.parse_collectives("\n".join(lines))
    assert got.op_counts == want.op_counts
    assert got.op_bytes == pytest.approx(want.op_bytes, rel=1e-12)
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)


@pytest.mark.parametrize("shape,axes,sizes,want", [
    ((8, 128), ("kv", "kv_alt"), dict(data=16, model=16),
     (Replicate(), Shard(1))),
    ((32, 128), ("kv", "kv_alt"), dict(data=16, model=16),
     (Replicate(), Shard(0))),
    ((64, 128), ("batch", None), dict(pod=2, data=16, model=16),
     (Shard(0), Shard(0), Replicate())),
    ((1, 128), ("batch", None), dict(pod=2, data=16, model=16),
     (Replicate(),) * 3),
])
def test_placements_of_reference_spec_cases(shape, axes, sizes, want):
    """The reference test's guard cases (tests/test_distributed.py) as
    placements: a tuple entry shards one dimension over both mesh
    dimensions, major to minor; the local shard shape divides it."""
    mesh = _Mesh(**sizes)
    spec = shd.guarded_spec(shape, axes, mesh)
    assert spec == tuple(rshd.guarded_spec(shape, axes, mesh,
                                           dict(rshd.DEFAULT_RULES)))
    pl = shd.placements_for(spec, mesh)
    assert pl == want
    assert shd.local_shape(shape, pl, mesh) == tuple(
        n // (np.prod([sizes[a] for a in (s if isinstance(s, tuple) else
                                          (s,))]) if s else 1)
        for n, s in zip(shape, spec))


def test_without_a_mesh_everything_is_the_identity():
    """Without a mesh context (or on a plain tensor) ``shard_act`` and
    ``fsdp_gather`` return their argument, ``sharding_for`` and the tree
    shardings give None, ``zeros`` a plain tensor, and ``local_region`` the
    function's own result."""
    x = torch.arange(6.).reshape(2, 3)
    assert shd.shard_act(x, ("batch", None)) is x
    assert shd.fsdp_gather(x, ("embed", "mlp")) is x
    assert shd.current().mesh is None
    assert shd.sharding_for(("batch",)) is None
    assert shd.tree_shardings({"a": ("batch",)}) is None
    assert shd.guarded_shardings({"a": x}, {"a": ("batch", None)}) is None
    z = shd.zeros((2, 3), ("batch", None), torch.float32, "cpu")
    assert type(z) is torch.Tensor and not z.any()
    fn = shd.local_region(lambda a: a * 2, (("batch", None),), 0)
    assert torch.equal(fn(x), x * 2)
    mesh = _Mesh(data=2, model=2)
    with shd.use_mesh(mesh) as ctx:
        assert ctx.axis_size("model") == 2 and ctx.axis_size("pod") == 1
        assert shd.shard_act(x, ("batch", None)) is x
        assert shd.sharding_for(("batch", "mlp")) == (Shard(0), Shard(1))
    assert shd.current().mesh is None
