"""The dry run on the CPU: one cell traced on fake tensors over a 'fake'
process group of 256 ranks, in a subprocess (a process holds one group).

* ``run_cell('smollm-135m', 'train_4k', pod16x16)`` reads ``ok``; its
  argument bytes equal the sum of the local shard bytes of the parameters,
  the AdamW state and the batch from the guarded specs (computed here with
  no process group); its useful-FLOPs ratio (model FLOPs a device over the
  counted FLOPs a device, the reference's field) lies between 0.3 and 1:
  the remat recompute and attention's own FLOPs keep it under 1.
* ``analysis.CostMode`` counts a DTensor product at each rank's local
  size, not the global one, and leaves DTensor's own shape propagation
  out.
* A skipped cell's record equals the reference's skipped record field for
  field (the reference's ``run_cell`` returns before it touches a mesh).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import make_optimizer, tree_leaves

REPO = Path(__file__).resolve().parents[1]

CELL_SCRIPT = r'''
import json, sys
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import analysis, dryrun
out = {"cell": dryrun.run_cell("smollm-135m", "train_4k", False),
       "skipped": dryrun.run_cell("smollm-135m", "long_500k", False)}
# one known sharded product: (256 x 512) @ (512 x 1024) over (16, 16),
# rows over data, columns over model: each rank multiplies 16 x 512 by
# 512 x 64
from repro_torch.launch.mesh import make_production_mesh
from torch._subclasses.fake_tensor import FakeTensorMode
mesh = make_production_mesh()
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(16, 512), mesh.device_mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(512, 64), mesh.device_mesh,
                           [Replicate(), Shard(1)], run_check=False)
    cost = analysis.CostMode()
    with cost:
        y = x @ w
out["product"] = {"flops": cost.flops, "bytes": cost.bytes,
                  "local": list(y.to_local().shape),
                  "collectives": len(cost.collectives)}
import repro.launch.dryrun as rdryrun
out["ref_skipped"] = rdryrun.run_cell("smollm-135m", "long_500k", False)
print(json.dumps(out))
'''


class _Mesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _local_bytes(tree, axes_tree) -> int:
    """The bytes of each leaf's shard on one rank of the 16x16 mesh."""
    mesh = _Mesh()
    total = 0
    for t, ax in zip(tree_leaves(tree), tree_leaves(axes_tree,
                                                    is_leaf=shd.is_axes)):
        spec = shd.guarded_spec(tuple(t.shape), ax, mesh)
        pl = shd.placements_for(spec, mesh)
        n = 1
        for d in shd.local_shape(t.shape, pl, mesh):
            n *= d
        total += n * t.element_size()
    return total


def _expected_argument_bytes() -> int:
    cfg, shape = get_config("smollm-135m"), SHAPES["train_4k"]
    model = Transformer(cfg, device="meta")
    params, axes = model.param_shapes(), model.axes()
    opt = make_optimizer(steps.pick_optimizer(cfg))
    state = opt.init(params)
    state_axes = steps._opt_axes(state, params, axes)
    batch = input_specs(cfg, shape)
    return (_local_bytes(params, axes) + _local_bytes(state, state_axes)
            + _local_bytes(batch, steps._batch_axes(batch)))


def test_dry_run_cell_on_the_fake_group():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", CELL_SCRIPT], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])

    rec = res["cell"]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["chips"] == 256 and rec["optimizer"] == "adamw"
    assert rec["memory"]["argument_size"] == _expected_argument_bytes()
    assert 0.3 <= rec["useful_flops_ratio"] <= 1.0, rec["useful_flops_ratio"]
    assert rec["memory"]["temp_size"] > 0
    assert rec["collective"]["wire_bytes"] > 0
    for k in ("compute_s", "memory_s", "collective_s", "bound_s"):
        assert rec["roofline"][k] > 0

    prod = res["product"]
    assert prod["local"] == [16, 64]
    assert prod["flops"] == 2 * 16 * 512 * 64      # local, not 2*256*512*1024
    assert prod["bytes"] == 4 * (16 * 512 + 512 * 64 + 16 * 64)
    assert prod["collectives"] == 0

    assert res["skipped"] == res["ref_skipped"]
    assert res["skipped"]["status"] == "skipped"
