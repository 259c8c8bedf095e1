"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU.

The reference's five tests (tests/test_checkpoint.py) on the port: a
round trip with bf16 and integer leaves, keep-k and the latest step, the
fall-back past a corrupt newest step, a shape mismatch, an atomic
overwrite.  Then the two packages against each other, in the one on-disk
format: a tree that either package saves restores in the other, leaf for
leaf and bit for bit (bf16 too), and ``PopulationTrainer(ckpt_dir=...)``
writes the same manifest keys, shapes, dtypes and metadata keys in both,
its restored winner equal to the one in memory.  Everything is exact:
checkpoints copy bits.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.checkpoint import load_manifest as rload_manifest
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.core.types import DFRConfig as RConfig
from repro.core.types import DFRParams as RParams
from repro.data import make_narma10 as rnarma
from repro.runtime import PopulationTrainer as RTrainer
from repro.runtime import PopulationTrainerConfig as RTrainerConfig
from repro_torch.checkpoint import (CheckpointManager, load_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core.types import DFRConfig, DFRParams
from repro_torch.data import make_narma10
from repro_torch.runtime import PopulationTrainer, PopulationTrainerConfig


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(8, 16, generator=g),
        "emb": torch.randn(10, 4, generator=g).to(torch.bfloat16),
        "nested": {"b": torch.arange(5, dtype=torch.int32)},
        "scalar": torch.tensor(3, dtype=torch.int32),
    }


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _assert_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


# -- the reference's five tests on the port ----------------------------------


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "ck", tree, step=7, metadata={"note": "hi"})
    got, step, meta = restore_checkpoint(tmp_path / "ck", _zeros_like(tree),
                                         device="cpu")
    assert step == 7 and meta["note"] == "hi"
    _assert_equal(got, tree)


def test_manager_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", keep=2)
    tree = _tree()
    for s in (10, 20, 30):
        mgr.save(tree, s)
    assert mgr.steps() == [20, 30]
    assert mgr.latest_step() == 30
    _, step, _ = mgr.restore_latest(_zeros_like(tree), device="cpu")
    assert step == 30


def test_manager_corrupt_fallback(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", keep=3)
    tree = _tree()
    mgr.save(tree, 10)
    mgr.save(tree, 20)
    mani = mgr.path_for(20) / "manifest.json"
    m = json.loads(mani.read_text())
    m["leaves"][0]["shards"][0]["file"] = "missing.npy"
    mani.write_text(json.dumps(m))
    got = mgr.restore_latest(_zeros_like(tree), device="cpu")
    assert got is not None
    _, step, _ = got
    assert step == 10  # fell back past the corrupt one


def test_shape_mismatch_raises(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "ck", tree, step=1)
    bad = dict(tree)
    bad["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path / "ck", bad, device="cpu")


def test_atomic_overwrite(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "ck", tree, step=1)
    tree2 = {k: v for k, v in tree.items()}
    tree2["w"] = tree["w"] + 1
    tree2["nested"] = {"b": tree["nested"]["b"] + 1}
    save_checkpoint(tmp_path / "ck", tree2, step=2)
    got, step, _ = restore_checkpoint(tmp_path / "ck", _zeros_like(tree),
                                      device="cpu")
    assert step == 2
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"] + 1)
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    save_checkpoint(tmp_path / "ck", _tree(), step=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_checkpoint(tmp_path / "ck", _tree())


# -- across the two packages -------------------------------------------------


def _np_tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "w": r.normal(size=(8, 16)).astype(np.float32),
        "emb": r.normal(size=(10, 4)).astype(np.float32),
        "nested": {"b": np.arange(5, dtype=np.int32)},
        "scalar": np.int32(3),
    }


def _jax_tree(t):
    return {"w": jnp.asarray(t["w"]),
            "emb": jnp.asarray(t["emb"], jnp.bfloat16),
            "nested": {"b": jnp.asarray(t["nested"]["b"])},
            "scalar": jnp.asarray(t["scalar"])}


def _torch_tree(t):
    return {"w": torch.from_numpy(t["w"]),
            "emb": torch.from_numpy(t["emb"]).to(torch.bfloat16),
            "nested": {"b": torch.from_numpy(t["nested"]["b"])},
            "scalar": torch.tensor(t["scalar"])}


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _dtype_names(leaves):
    return [str(x.dtype).removeprefix("torch.") for x in leaves]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    t = _np_tree()
    rtree = _jax_tree(t)
    rsave(tmp_path / "ck", rtree, step=5, metadata={"who": "reference"})
    got, step, meta = restore_checkpoint(
        tmp_path / "ck", _torch_tree(_np_tree(1)), device="cpu")
    assert step == 5 and meta == {"who": "reference"}
    rl, pl = jax.tree_util.tree_leaves(rtree), _leaves(got)
    assert _dtype_names(pl) == _dtype_names(rl)
    for a, b in zip(rl, pl):
        np.testing.assert_array_equal(_as_f32(b), _as_f32(a))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = _np_tree()
    ptree = _torch_tree(t)
    save_checkpoint(tmp_path / "ck", ptree, step=6, metadata={"who": "port"})
    got, step, meta = rrestore(tmp_path / "ck", _jax_tree(_np_tree(1)))
    assert step == 6 and meta == {"who": "port"}
    rl, pl = jax.tree_util.tree_leaves(got), _leaves(ptree)
    assert _dtype_names(rl) == _dtype_names(pl)
    for a, b in zip(rl, pl):
        np.testing.assert_array_equal(_as_f32(a), _as_f32(b))
    # the same keys, shapes and dtypes in both manifests
    rsave(tmp_path / "ref", _jax_tree(t), step=6)
    mine, theirs = (load_manifest(tmp_path / "ck"),
                    rload_manifest(tmp_path / "ref"))
    assert [(e["key"], e["shape"], e["dtype"]) for e in mine["leaves"]] == [
        (e["key"], e["shape"], e["dtype"]) for e in theirs["leaves"]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dfr_params_cross_restore_both_ways(tmp_path, dtype):
    """A DFRParams tree, the population's winner, saved by either package
    restores in the other bit for bit, in fp32 and in bf16."""
    r = np.random.default_rng(3)
    p, q = np.float32(0.37), np.float32(-0.21)
    W = r.normal(size=(3, 20)).astype(np.float32)
    b = r.normal(size=(3,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rp = RParams(p=jnp.asarray(p, jdt), q=jnp.asarray(q, jdt),
                 W=jnp.asarray(W, jdt), b=jnp.asarray(b, jdt))
    tp = DFRParams(p=torch.tensor(p).to(tdt), q=torch.tensor(q).to(tdt),
                   W=torch.from_numpy(W).to(tdt),
                   b=torch.from_numpy(b).to(tdt))
    like_t = DFRParams(p=torch.zeros(()), q=torch.zeros(()),
                       W=torch.zeros(3, 20), b=torch.zeros(3))
    rsave(tmp_path / "r", rp, step=1)
    got, _, _ = restore_checkpoint(tmp_path / "r", like_t, device="cpu")
    assert isinstance(got, DFRParams)
    for name in ("p", "q", "W", "b"):
        assert getattr(got, name).dtype == tdt
        assert torch.equal(getattr(got, name), getattr(tp, name))
    save_checkpoint(tmp_path / "t", tp, step=1)
    back, _, _ = rrestore(tmp_path / "t", rp)
    for name in ("p", "q", "W", "b"):
        assert getattr(back, name).dtype == jdt
        np.testing.assert_array_equal(
            _as_f32(getattr(back, name)), _as_f32(getattr(rp, name)))
    assert [e["key"] for e in load_manifest(tmp_path / "t")["leaves"]] == [
        e["key"] for e in rload_manifest(tmp_path / "r")["leaves"]]


def test_population_trainer_manifests_match_the_reference(tmp_path):
    """PopulationTrainer(ckpt_dir=...) in both packages, on the same NARMA10
    data (the grid alone, rounds=0, so neither draws a random number): the
    same manifest keys, shapes, dtypes and metadata keys, the same winning
    (p, q, beta), and the port's restored winner equal to the one in
    memory bit for bit."""
    rtrain, rtest = rnarma(n_train=120, n_test=60, t_len=24, seed=0)
    train, test = make_narma10(n_train=120, n_test=60, t_len=24, seed=0)
    knobs = dict(divs=2, rounds=0, steps_per_round=1, minibatch=16)
    RTrainer(RTrainerConfig(**knobs, ckpt_dir=str(tmp_path / "ref"))).fit(
        RConfig(n_in=1, n_classes=1, n_nodes=6), rtrain, rtest, seed=0)
    pt = PopulationTrainer(PopulationTrainerConfig(
        **knobs, ckpt_dir=str(tmp_path / "port")))
    result = pt.fit(DFRConfig(n_in=1, n_classes=1, n_nodes=6), train, test,
                    seed=0, device="cpu")
    mine = CheckpointManager(tmp_path / "port")
    theirs = RManager(tmp_path / "ref")
    assert mine.steps() == theirs.steps() == [0]
    m = load_manifest(mine.path_for(0))
    r = rload_manifest(theirs.path_for(0))
    assert [(e["key"], e["shape"], e["dtype"]) for e in m["leaves"]] == [
        (e["key"], e["shape"], e["dtype"]) for e in r["leaves"]]
    assert m["metadata"].keys() == r["metadata"].keys()
    for k in ("best_p", "best_q", "best_beta"):
        assert m["metadata"][k] == pytest.approx(r["metadata"][k], rel=1e-6)
    tree, step, meta = mine.restore_latest(
        dataclasses.replace(result.best_params), device="cpu")
    assert step == 0 and meta["best_nrmse"] == result.best_nrmse
    for name in ("p", "q", "W", "b"):
        assert torch.equal(getattr(tree, name),
                           getattr(result.best_params, name).cpu())
