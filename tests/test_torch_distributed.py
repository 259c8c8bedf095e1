"""The port's distribution layer: the sharding rules over a slot mesh, the
slot mesh itself, and ``online_step`` over a process group.

The twin of tests/test_distributed.py's rule tests and of its
``test_online_step_psum_matches_unsharded``.  The specs are held equal to
the reference's ``guarded_spec`` on the same (fake) meshes.  ``online_step``
runs over two ``gloo`` ranks in two processes on the CPU, each given half
of the window; every rank must end with the same state bit for bit, and
that state must match the one-process step of the port and the reference's
unsharded ``online_step`` to rtol 1e-4 / atol 1e-5: the ranks' partial sums
of (A, B) and of the gradients add in another order than one sum over the
window.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online as ronline
from repro.core.types import DFRConfig as RConfig
from repro.distributed import sharding as rshd
from repro_torch import convert
from repro_torch.core import online
from repro_torch.core.online import OnlineEnsemble
from repro_torch.core.types import DFRConfig, RequestPool, WindowState
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)


class _Mesh:
    """A mesh of given axis sizes, for the rules alone (no devices)."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


@pytest.mark.parametrize("shape,axes,mesh,want", [
    ((8, 128), ("kv", "kv_alt"), dict(data=16, model=16), (None, "model")),
    ((32, 128), ("kv", "kv_alt"), dict(data=16, model=16), ("model", None)),
    ((64, 128), ("batch", None), dict(pod=2, data=16, model=16),
     (("pod", "data"), None)),
    ((1, 128), ("batch", None), dict(pod=2, data=16, model=16),
     (None, None)),
    ((16, 10, 992), ("member", None, None), dict(pod=2, data=4, model=2),
     (("pod", "data"), None, None)),
    ((4,), ("member",), dict(pod=2, data=4, model=2), (None,)),
    ((64, 57, 57), ("slot", None, None), dict(slot=8),
     ("slot", None, None)),
    ((64, 57, 57), ("slot", None, None), dict(pod=2, data=4, model=2),
     (("pod", "data"), None, None)),
    ((6,), ("slot",), dict(slot=8), (None,)),
    ((8, 4, 57, 57), ("slot", "member", None, None), dict(slot=4, member=2),
     ("slot", "member", None, None)),
    ((8, 8, 57, 57), ("slot", "member", None, None),
     dict(pod=2, data=4, model=2), (("pod", "data"), None, None, None)),
])
def test_guarded_spec_matches_reference(shape, axes, mesh, want):
    """The divisibility and uniqueness guards: each spec as the reference's
    ``guarded_spec`` gives it on the same mesh."""
    got = shd.guarded_spec(shape, axes, _Mesh(**mesh), dict(shd.DEFAULT_RULES))
    ref = rshd.guarded_spec(shape, axes, _Mesh(**mesh),
                            dict(rshd.DEFAULT_RULES))
    assert got == want == tuple(ref)


def test_rules_specs_and_data_axes():
    """The rule table is the reference's; ``spec_for``/``tree_specs``
    resolve without the guard; ``data_axes`` lists the mesh's data axes;
    without a mesh everything replicates."""
    assert shd.DEFAULT_RULES == rshd.DEFAULT_RULES
    mesh = _Mesh(pod=2, data=4, model=2)
    assert shd.spec_for(("batch", "mlp", "seq"), mesh=mesh) == (
        ("pod", "data"), "model", None)
    assert shd.guarded_spec((8, 3), ("slot", None)) == (None, None)
    assert shd.data_axes(mesh) == ("pod", "data") and shd.data_axes() == ()
    assert shd.spec_for(("slot", None), mesh=mesh) == tuple(
        rshd.spec_for(("slot", None), mesh=mesh))
    # the rule lists the serving axis first: a tuple of the one present
    slot = tmesh.make_slot_mesh(4, devices=["cpu"] * 4)
    specs = shd.tree_specs(WindowState.slot_axes(), mesh=slot)
    assert specs == WindowState(rows=(("slot",), None, None),
                                onehot=(("slot",), None, None),
                                pos=(("slot",),))


def _leaves_with_axes(tree, axes_tree):
    pairs = []
    from repro_torch.core.types import map_leaves
    map_leaves(lambda leaf, ax: pairs.append((leaf, ax)), tree, axes_tree)
    return pairs


def test_logical_axes_cover_state():
    """The logical-axes trees mirror the state tree leaf for leaf, with the
    stacked slot axis leading: ``slot_logical_axes`` (the server's state),
    and the window rings' and pool's ``slot_axes``."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=6)
    state = online.init_state(cfg)
    pairs = _leaves_with_axes(state, online.slot_logical_axes())
    assert len(pairs) == 17
    for leaf, ax in pairs:
        assert ax[0] == "slot" and len(ax) == leaf.ndim + 1
    for tree, axes in (
            (WindowState.zeros(4, cfg.s, 3), WindowState.slot_axes()),
            (RequestPool.zeros(2, 4, 10, 2), RequestPool.slot_axes())):
        for leaf, ax in _leaves_with_axes(tree, axes):
            assert ax[0] == "slot"
    for leaf, ax in _leaves_with_axes(WindowState.zeros(4, cfg.s, 3),
                                      WindowState.slot_axes()):
        assert len(ax) == leaf.ndim + 1   # the ring's leaves stack S
    for leaf, ax in _leaves_with_axes(RequestPool.zeros(2, 4, 10, 2),
                                      RequestPool.slot_axes()):
        assert len(ax) == leaf.ndim       # the pool's leaves carry S


@pytest.mark.parametrize("name,lead", [
    ("ensemble_logical_axes", ("member",)),
    ("slot_logical_axes", ("slot",)),
    ("ensemble_slot_logical_axes", ("slot", "member"))])
def test_state_logical_axes_match_reference(name, lead):
    """Each logical-axes tree equals the reference's leaf for leaf and
    mirrors the state it names: ``OnlineEnsemble``'s tree (K members
    stacked) for ``ensemble_logical_axes``, the one-stream state with the
    leading dims stacked on for the slot trees."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=6)
    got = getattr(online, name)()
    want = getattr(ronline, name)()
    pairs = _leaves_with_axes(got, want)
    assert len(pairs) == 17 and all(g == w for g, w in pairs)
    if name == "ensemble_logical_axes":
        state, extra = OnlineEnsemble(cfg, 4, device="cpu").init(), 0
    else:
        state, extra = online.init_state(cfg), len(lead)
    for leaf, ax in _leaves_with_axes(state, got):
        assert ax[:len(lead)] == lead and len(ax) == leaf.ndim + extra


def test_make_slot_mesh_and_placement():
    """``make_slot_mesh``: an explicit list may repeat a device; the default
    takes CUDA devices and raises with the counts when there are too few;
    ``shard_blocks`` gives each entry its contiguous rows and copies the
    rest whole."""
    m = tmesh.make_slot_mesh(4, devices=["cpu"] * 4)
    assert m.axis_names == ("slot",) and m.sizes == (4,) and m.size == 4
    assert m.devices == (torch.device("cpu"),) * 4
    m2 = tmesh.make_slot_mesh(2, member=2, devices=["cpu"] * 4)
    assert m2.axis_names == ("slot", "member") and m2.shape == {
        "slot": 2, "member": 2}
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} available"):
        tmesh.make_slot_mesh(n + 1)
    with pytest.raises(ValueError, match="need 4 devices"):
        tmesh.make_slot_mesh(4, devices=["cpu"] * 3)
    # the production mesh needs 256 (512) ranks; no process group is one
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks, the "
                                             f"world size is 1"):
            tmesh.make_production_mesh(multi_pod=multi)
    host = tmesh.make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)
    # a host mesh over several ranks needs their process group: it is built
    # over four gloo ranks in tests/test_torch_sharded_lm.py
    for kw in (dict(data=2), dict(model=2)):
        with pytest.raises(ValueError, match="start a process group"):
            tmesh.make_host_mesh(device="cpu", **kw)

    tree = WindowState(rows=torch.arange(24.).reshape(4, 3, 2),
                       onehot=torch.arange(8.).reshape(4, 2, 1),
                       pos=torch.arange(4, dtype=torch.int32))
    axes = WindowState(rows=("slot", None, None), onehot=(None, None, None),
                       pos=("slot",))
    blocks = shd.shard_blocks(tree, axes, m)
    for d, blk in enumerate(blocks):
        assert torch.equal(blk.rows, tree.rows[d:d + 1])
        assert torch.equal(blk.pos, tree.pos[d:d + 1])
        assert torch.equal(blk.onehot, tree.onehot)   # replicated
        assert blk.rows.data_ptr() != tree.rows.data_ptr()
    with pytest.raises(ValueError, match="'slot'"):
        shd.shard_blocks(tree, axes, m2)
    # without a mesh context the LM's constraint is the identity
    x = torch.zeros(2)
    assert shd.shard_act(x, ("batch",)) is x


# ---------------------------------------------------------------------------
# online_step over a process group
# ---------------------------------------------------------------------------

RANK_MAIN = '''
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + path + "/pg",
                        world_size=world, rank=rank)
try:
    inputs = dict(np.load(path + "/inputs.npz"))
    out = run(rank, world, inputs, dist.group.WORLD)
    np.savez(path + "/rank%d.npz" % rank, **out)
finally:
    dist.destroy_process_group()
'''


def run_ranks(tmp_path, body: str, inputs: dict, world: int = 2):
    """Run ``body`` (which defines ``run(rank, world, inputs, group)``
    returning a dict of arrays) on ``world`` gloo ranks, one process each,
    on the CPU; returns each rank's dict.  A rank that fails fails the
    test."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    script = tmp_path / "rank_main.py"
    script.write_text(body + RANK_MAIN)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


ONLINE_STEP_BODY = '''
from repro_torch import convert
from repro_torch.core import online
from repro_torch.core.online import OnlineEnsemble
from repro_torch.core.types import DFRConfig


def run(rank, world, inputs, group):
    cfg = DFRConfig(n_in=2, n_classes=2, n_nodes=6)
    b = inputs["u"].shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    system = online.OnlineDFR(cfg, mask=torch.tensor(inputs["mask"]),
                              device="cpu")
    new, met = system.step(system.init(), inputs["u"][sl],
                           inputs["length"][sl], inputs["label"][sl],
                           0.2, 0.2, group=group)
    out = convert.state_leaves(new)
    out.update({"metric_" + k: v.numpy() for k, v in met.items()})
    return out
'''


def test_online_step_psum_matches_unsharded(tmp_path):
    """``online_step`` over two gloo ranks, each on half the window, is the
    one-process step of the port and the reference's unsharded step (to
    rtol 1e-4 / atol 1e-5), and both ranks hold the same state bit for
    bit."""
    cfg = DFRConfig(n_in=2, n_classes=2, n_nodes=6)
    rcfg = RConfig(n_in=2, n_classes=2, n_nodes=6)
    rsys = ronline.OnlineDFR(rcfg)
    rng = np.random.default_rng(0)
    inputs = dict(u=rng.normal(size=(4, 10, 2)).astype(np.float32),
                  length=rng.integers(3, 11, 4).astype(np.int32),
                  label=rng.integers(0, 2, 4).astype(np.int32),
                  mask=np.asarray(rsys.mask))
    lr = jnp.float32(0.2)
    rnew, rmet = rsys.step(rsys.init(), jnp.asarray(inputs["u"]),
                           jnp.asarray(inputs["length"]),
                           jnp.asarray(inputs["label"]), lr, lr)
    want = convert.state_leaves(rnew)
    system = online.OnlineDFR(cfg, mask=torch.tensor(inputs["mask"]),
                              device="cpu")
    one, met = system.step(system.init(), inputs["u"], inputs["length"],
                           inputs["label"], 0.2, 0.2)
    one = convert.state_leaves(one)
    ranks = run_ranks(tmp_path, ONLINE_STEP_BODY, inputs)
    for k in want:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], one[k], **TOL, err_msg=k)
        np.testing.assert_allclose(one[k], want[k], **TOL, err_msg=k)
    for k in ("loss", "acc"):
        got = ranks[0]["metric_" + k]
        np.testing.assert_allclose(got, met[k].numpy(), **TOL, err_msg=k)
        np.testing.assert_allclose(got, float(rmet[k]), **TOL, err_msg=k)
