"""The port's optimizers, schedules, gradient compression and straggler
watchdog against the reference's, on the CPU.

* ``sgd`` (momentum 0 and 0.9), ``adamw`` and ``adafactor`` over three
  updates of a seeded tree (a matrix, a stacked 3-D leaf, a vector and a
  bf16 matrix, so the factored and the full second moments and the
  rounding to the parameter's dtype all run), and ``clip_by_global_norm``:
  parameters and state within rtol 1e-6 (the same f32 arithmetic; the
  two frameworks' sqrt, rsqrt and pow may differ in the last bit), a bf16
  parameter within one bf16 step.
* The schedules at every step from 0 to total + 1 within rtol 1e-7.
* int8 compression: codes equal, scales equal; ``tree_compressed_psum``
  on one rank (``group=None``) against the reference's single-shard case
  under ``shard_map`` (reduced gradients within rtol 1e-6, residuals
  within one f32 step of the gradient they are taken from); and one
  two-rank gloo case in two subprocesses, equal to the sum computed here.
* The watchdog's verdicts on one sequence of durations equal the
  reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as rcomp
from repro.optim import optimizers as ropt
from repro.optim import schedule as rsched
from repro.runtime.straggler import StragglerWatchdog as RWatchdog
from repro_torch.optim import compression as pcomp
from repro_torch.optim import optimizers as popt
from repro_torch.optim import schedule as psched
from repro_torch.runtime import StragglerWatchdog

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6
# in sorted key order, the order of JAX's leaves
SHAPES = {"b": (7,), "h": (3, 8), "stack": (2, 4, 3), "w": (6, 5)}
BF16 = ("h",)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax(tree):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16
                                      else torch.float32)
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, name, rtol=RTOL):
    g, w = _np(got), _np(want)
    if got.dtype == torch.bfloat16:
        # one bf16 step of the value: the f32 results may round apart
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=0, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7 * np.abs(
            w).max(), err_msg=name)


OPTIMIZERS = {
    "sgd": dict(),
    "sgd_momentum": dict(momentum=0.9),
    "adamw": dict(),
    "adafactor": dict(),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    kind = name.split("_")[0]
    kw = OPTIMIZERS[name]
    ropt_, popt_ = ropt.make_optimizer(kind, **kw), \
        popt.make_optimizer(kind, **kw)
    rp, pp = _jax(_tree(0)), _torch(_tree(0))
    rs, ps = ropt_.init(rp), popt_.init(pp)
    update = jax.jit(ropt_.update)
    for i in range(3):
        g = _tree(10 + i)
        lr = np.float32(0.01 * (i + 1))
        rp, rs = update(_jax(g), rs, rp, jnp.asarray(lr))
        pp, ps = popt_.update(_torch(g), ps, pp, torch.tensor(lr))
        for k in SHAPES:
            assert pp[k].dtype == (torch.bfloat16 if k in BF16
                                   else torch.float32)
            _close(pp[k], rp[k], f"{name} step {i} {k}")
    for got, want in zip(popt.tree_leaves(ps),
                         jax.tree_util.tree_leaves(rs)):
        _close(got, want, f"{name} state")


def test_clip_by_global_norm_matches_reference():
    tree = _tree(3)
    for max_norm in (1.0, 1e3):
        rg, rn = ropt.clip_by_global_norm(_jax(tree), max_norm)
        pg, pn = popt.clip_by_global_norm(_torch(tree), max_norm)
        _close(pn, rn, "norm")
        for k in SHAPES:
            _close(pg[k], rg[k], k)


def test_tree_map_over_a_module_and_a_namedtuple():
    """A model-like module maps to dicts and lists in its layout."""
    from repro_torch.models.transformer import ParamTree

    mod = ParamTree({"a": torch.ones(2), "layers": [{"w": torch.ones(3)},
                                                    {"w": torch.zeros(3)}]})
    out = popt.tree_map(lambda p: p * 2, mod)
    assert isinstance(out, dict) and isinstance(out["layers"], list)
    assert torch.equal(out["layers"][0]["w"], torch.full((3,), 2.0))
    assert [t.shape for t in popt.tree_leaves(mod)] == [(2,), (3,), (3,)]
    st = popt.AdamState(mu=out, nu=out,
                        count=torch.zeros((), dtype=torch.int32))
    assert len(popt.tree_leaves(st)) == 7


# layer l's gradients scaled by LAYER_SCALE[l][step]: one layer's grow and
# the other's shrink, so that from the second step the clip acts on the
# first layer's update and not on the second's, where a per-layer RMS and
# the stack's RMS differ
LAYER_SCALE = ((1.0, 10.0, 10.0), (1.0, 0.1, 0.1))


def _lm_grads(rparams, step):
    """Seeded gradients shaped like the reference's stacked parameters."""
    rng = np.random.default_rng(100 + step)
    leaves, treedef = jax.tree_util.tree_flatten(rparams)
    grads = []
    for path_leaf in leaves:
        g = rng.normal(size=path_leaf.shape).astype(np.float32)
        grads.append(g)
    tree = jax.tree_util.tree_unflatten(treedef, grads)
    for l, scales in enumerate(LAYER_SCALE):
        tree["layers"] = jax.tree_util.tree_map(
            lambda a, l=l, f=scales[step]: np.concatenate(
                [a[:l], a[l:l + 1] * np.float32(f), a[l + 1:]]),
            tree["layers"])
    return tree


def _same_state(got, want, name):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), name
        for k in want:
            _same_state(got[k], want[k], f"{name}.{k}")
    else:
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_adafactor_lm_steps_match_reference():
    """Three Adafactor steps of the reduced smollm-135m (2 layers, d_model
    64, fp32) at ``clip_threshold=0.5`` against the reference's
    ``make_optimizer('adafactor')`` on the same weights and gradients:
    parameters and state, compared in the reference's layout
    (``convert.to_reference_layout``), within rtol 1e-5 / atol 1e-7.  The
    reference factors each stacked layer vector (L, d) into rows (L,) and
    columns (d,), and takes each stacked leaf's clip RMS over all layers;
    the layers' gradients are scaled apart (``LAYER_SCALE``) so that the
    clip acts on one layer and not on the other."""
    import dataclasses

    import repro.configs as rconfigs
    import repro_torch.configs as pconfigs
    from repro.models.transformer import Transformer as RTransformer
    from repro_torch import convert
    from repro_torch.models.transformer import Transformer

    small = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                 head_dim=32, d_ff=128, vocab=256)
    rcfg = dataclasses.replace(rconfigs.get_reduced("smollm-135m"),
                               dtype=jnp.float32, **small)
    pcfg = dataclasses.replace(pconfigs.get_reduced("smollm-135m"),
                               dtype=torch.float32, **small)
    rparams, _ = RTransformer(rcfg).init(jax.random.PRNGKey(0))
    rparams = jax.tree_util.tree_map(np.asarray, rparams)
    model = convert.lm_params_from_numpy(Transformer(pcfg, device="cpu"),
                                         rparams)
    ropt_ = ropt.make_optimizer("adafactor", clip_threshold=0.5)
    popt_ = popt.make_optimizer("adafactor", clip_threshold=0.5)
    rs, ps = ropt_.init(rparams), popt_.init(model)
    _same_state(convert.to_reference_layout(ps.row), rs.row, "row init")
    update = jax.jit(ropt_.update)
    rp, pp = rparams, model
    for i in range(3):
        g = _lm_grads(rparams, i)
        lr = np.float32(0.01 * (i + 1))
        rp, rs = update(g, rs, rp, jnp.asarray(lr))
        pg = convert.from_reference_layout(
            popt.tree_map(torch.Tensor.detach, model),
            jax.tree_util.tree_map(torch.from_numpy, g))
        pp, ps = popt_.update(pg, ps, pp, torch.tensor(lr))
        _same_state(convert.to_reference_layout(pp), rp, f"step {i} params")
        for field in ("row", "col"):
            _same_state(convert.to_reference_layout(getattr(ps, field)),
                        getattr(rs, field), f"step {i} {field}")
        assert int(ps.count) == int(rs.count) == i + 1


SCHEDULES = {
    "constant": lambda m: m.constant_schedule(3e-4),
    "cosine": lambda m: m.cosine_schedule(1e-3, warmup=5, total=40),
    "cosine_floor0": lambda m: m.cosine_schedule(3e-4, warmup=0, total=17,
                                                 floor=0.0),
    "paper": lambda m: m.paper_step_schedule(0.5, (2, 5), steps_per_epoch=4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    rfn, pfn = SCHEDULES[name](rsched), SCHEDULES[name](psched)
    for step in range(0, 42):
        got = pfn(step)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(got.item(), float(rfn(step)), rtol=1e-7,
                                   atol=0, err_msg=f"{name} step {step}")
    # a tensor step gives the same
    assert pfn(torch.tensor(7)).item() == pfn(7).item()


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_int8_codes_equal_reference(scale):
    g = (np.random.default_rng(4).normal(size=(33, 17)) * scale).astype(
        np.float32)
    rq, rs = rcomp.compress_int8(jnp.asarray(g))
    pq, ps = pcomp.compress_int8(torch.from_numpy(g))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert ps.item() == float(rs)
    np.testing.assert_array_equal(
        pcomp.decompress_int8(pq, ps).numpy(),
        np.asarray(rcomp.decompress_int8(rq, rs)))


def test_tree_compressed_psum_one_rank_matches_reference():
    """group=None is the reference's axis of size 1 (one shard)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    grads, res = _tree(5), {k: v * 1e-3 for k, v in _tree(6).items()}
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pod",))
    fn = shard_map(lambda g, r: rcomp.tree_compressed_psum(g, "pod", r),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                   check_rep=False)
    f32 = {k: jnp.asarray(v) for k, v in grads.items()}
    want_g, want_r = jax.jit(fn)(f32, {k: jnp.asarray(v)
                                       for k, v in res.items()})
    got_g, got_r = pcomp.tree_compressed_psum(
        {k: torch.from_numpy(v) for k, v in grads.items()}, None,
        {k: torch.from_numpy(v) for k, v in res.items()})
    for k in SHAPES:
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=RTOL, atol=0)
        # the residual g_ef - q * scale is a difference of two values of
        # g_ef's size (XLA may fuse it into one FMA): one f32 step of g_ef
        ulp = 2.0 ** -23 * np.abs(grads[k] + res[k]).max()
        np.testing.assert_allclose(got_r[k].numpy(), np.asarray(want_r[k]),
                                   rtol=0, atol=ulp)


RANK_MAIN = '''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.compression import compressed_psum

rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + path + "/rdv",
                        rank=rank, world_size=2)
g = torch.from_numpy(np.random.default_rng(rank).normal(
    size=(9, 4)).astype(np.float32))
out, res = compressed_psum(g, dist.group.WORLD, torch.zeros_like(g))
np.save(f"{path}/out{rank}.npy", out.numpy())
np.save(f"{path}/res{rank}.npy", res.numpy())
dist.destroy_process_group()
'''


def test_compressed_psum_two_gloo_ranks(tmp_path):
    """Two ranks: each gets the mean of the two ranks' codes at the mean
    scale, and keeps its own residual."""
    script = tmp_path / "rank.py"
    script.write_text(RANK_MAIN)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    gs = [np.random.default_rng(r).normal(size=(9, 4)).astype(np.float32)
          for r in range(2)]
    qs = [pcomp.compress_int8(torch.from_numpy(g)) for g in gs]
    scale = (qs[0][1] + qs[1][1]) / 2.0
    want = (qs[0][0].to(torch.int32) + qs[1][0].to(torch.int32)).float() \
        * scale / 2.0
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      want.numpy())
        np.testing.assert_array_equal(
            np.load(tmp_path / f"res{r}.npy"),
            (torch.from_numpy(gs[r]) - pcomp.decompress_int8(*qs[r])).numpy())


def test_watchdog_verdicts_match_reference():
    durations = [("h0", 1.0)] * 6 + [("h1", 5.0), ("h1", 5.0), ("h0", 1.1),
                                     ("h1", 9.0), ("h2", 4.0), ("h2", 1.0),
                                     ("h1", 5.0), ("h1", 0.5), ("h3", 30.0),
                                     ("h3", 30.0), ("h3", 30.0)]
    for kw in (dict(), dict(threshold=2.0, strikes_to_evict=2)):
        ref, got = RWatchdog(**kw), StragglerWatchdog(**kw)
        verdicts = []
        for host, dur in durations:
            verdicts.append(got.observe(host, dur))
            assert verdicts[-1] == ref.observe(host, dur)
            assert got.ewma == ref.ewma and got.deadline() == ref.deadline()
        assert got.strikes == ref.strikes and got.evicted == ref.evicted
        assert {"ok", "suspect", "evict"} <= set(verdicts)
