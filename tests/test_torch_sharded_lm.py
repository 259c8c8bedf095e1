"""The LM sharded over a process group, on the CPU: FSDP + tensor
parallelism over a (data 2, model 2) mesh of four ``gloo`` ranks, held
against the reference's single-device jitted steps and the port's
unsharded ones on the same parameters and batches.

One spawn of four ranks (each a ``python`` process of a script the test
writes under ``tmp_path``; file:// rendezvous there, no port) runs the
reduced smollm-135m (4 layers, d_model 128, 4 heads over 2 KV heads,
vocab 512) in fp32 and in bf16 at tokens (8, 32): the prefill's
last-position logits, four decode steps against a 16-slot cache, then two
AdamW train steps (the cosine schedule past its warmup).  Three fp32
variants take the other routes of ``models.attention.local_heads``: one
KV head under 4 query heads (each rank slices its heads' KV head out of
the whole K/V, the K/V gradients partial sums), and 3 query heads on the
blockwise and on the flash route (the heads do not split over 'model', so
the query rows do, each rank from its rows' offset); the first also
accumulates 8 microbatches, more than a rank's 4 rows split into.  Rank
0 also runs
the unsharded port in fp32.  The limits are those the unsharded port is held to
(``tests/test_torch_lm.py``, ``tests/test_torch_train.py``): fp32 logits
within 1e-4 of the largest |logit|, loss and grad norm within rtol 1e-5,
the moments within 1e-4 of each leaf's largest entry, each parameter
within 1e-3 of its leaf's move plus 1e-7 but for the ill-conditioned
AdamW steps (within two moves there); bf16 at the reference test's own
2e-2.  The reference's own 8-device sharded test fails on this host, so
its single-device step is the yardstick.  The ranks also show that
``clip_by_global_norm`` on sharded gradients is the global norm.

A second spawn runs ``launch.train`` under ``torchrun`` on two CPU ranks
with ``--model-parallel 2``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as rconfigs
from repro.models import lm as rlm
from repro.models.transformer import Transformer as RTransformer
from repro.optim import optimizers as ropt
from repro.optim import schedule as rsched
from test_torch_train import _check_params, _ill, _np_tree

REPO = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m"
B, T, CACHE, DECODE = 8, 32, 16, 4
STEPS = (3, 4)              # past the schedule's warmup of 2
# case: (dtype, overrides of the reduced config, microbatches a step);
# kv_slice's 8 microbatches leave a rank's 4 rows too few to split, so
# each microbatch is one row of the batch, replicated
CASES = {"float32": ("float32", {}, 1), "bfloat16": ("bfloat16", {}, 1),
         "kv_slice": ("float32", {"n_kv_heads": 1}, 8),
         "row_split": ("float32", {"n_heads": 3, "n_kv_heads": 3}, 1),
         "row_split_flash": ("float32", {"n_heads": 3, "n_kv_heads": 1,
                                         "attn_impl": "pallas"}, 1)}

RANK_SCRIPT = '''
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + path + "/pg",
                        world_size=world, rank=rank)
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import place_batch, place_opt_state
from repro_torch.models.lm import (make_decode_step, make_prefill_step,
                                   make_train_step)
from repro_torch.models.transformer import Transformer
from repro_torch.optim import schedule
from repro_torch.optim.optimizers import adamw, clip_by_global_norm

B, CACHE, DECODE = %(B)d, %(CACHE)d, %(DECODE)d
CASES = %(CASES)r
inputs = dict(np.load(path + "/inputs.npz"))


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def flat(tree, prefix, out):
    """A reference-layout dict of tensors as {prefix/path: f32 array}."""
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + "/" + k, out)
        else:
            out[prefix + "/" + k] = full(v).detach().to(torch.float32).numpy()


def run(case, mesh):
    dtype, over, accum = CASES[case]
    cfg = dataclasses.replace(get_reduced("smollm-135m"),
                              dtype=getattr(torch, dtype),
                              **dict(dict(attn_impl="xla"), **over))
    tree = {k[len(case) + 3:]: v for k, v in inputs.items()
            if k.startswith(case + "/p/")}
    nested = {}
    for k, v in tree.items():
        node = nested
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    model = convert.lm_params_from_numpy(Transformer(cfg, device="cpu"),
                                         nested)
    opt = adamw()
    out = {}
    with shd.use_mesh(mesh):
        if mesh is not None:
            model.distribute(mesh)
            state = place_opt_state(opt, model, mesh)
            place = lambda b: place_batch(b, mesh)
        else:
            state = opt.init(model)
            place = lambda b: b
        toks = torch.from_numpy(inputs["tokens"])
        out["prefill"] = full(make_prefill_step(model)(
            place({"tokens": toks}))).numpy()
        cache = model.init_cache(B, CACHE)
        decode = make_decode_step(model)
        for i in range(DECODE):
            logits, cache = decode(place({"t": toks[:, i:i + 1]})["t"],
                                   cache)
            out["decode%%d" %% i] = full(logits).to(torch.float32).numpy()
        step_fn = make_train_step(model, opt, schedule.cosine_schedule(
            1e-3, warmup=2, total=10), accum=accum)
        for s in (3, 4):
            batch = {k: torch.from_numpy(inputs["batch%%d/%%s" %% (s, k)])
                     for k in ("tokens", "targets")}
            model, state, metrics = step_fn(model, state, s, place(batch))
            for k in ("loss", "grad_norm"):
                out["step%%d/%%s" %% (s, k)] = np.float64(metrics[k])
            st = convert.to_reference_layout(state)
            flat(st.mu, "step%%d/mu" %% s, out)
            flat(st.nu, "step%%d/nu" %% s, out)
        flat(convert.to_reference_layout(model), "param", out)
    return {case + "/" + k: v for k, v in out.items()}


mesh = make_host_mesh(data=2, model=2)
result = {}
for case in CASES:
    result.update({"sharded/" + k: v for k, v in run(case, mesh).items()})
    if rank == 0 and case == "float32":
        result.update({"plain/" + k: v for k, v in run(case, None).items()})

# the clip's norm on sharded gradients: every shard's squares summed
g = torch.from_numpy(inputs["clip"])
with shd.use_mesh(mesh):
    pl = shd.guarded_placements(g.shape, ("embed", "mlp"))
    gd = distribute_tensor(g, mesh.device_mesh, pl)
    clipped, gn = clip_by_global_norm({"w": gd, "b": gd[0]}, 0.5)
    _, gn_plain = clip_by_global_norm({"w": g, "b": g[0]}, 0.5)
    result["clip/global"] = np.float64(gn)
    result["clip/plain"] = np.float64(gn_plain)
    result["clip/local"] = np.float64(torch.sqrt(
        (gd.to_local() ** 2).sum() + (gd[0].to_local() ** 2).sum()))
    result["clip/w"] = full(clipped["w"]).numpy()
    result["clip/w_plain"] = clip_by_global_norm(
        {"w": g, "b": g[0]}, 0.5)[0]["w"].numpy()
if rank == 0:
    np.savez(path + "/rank0.npz", **result)
dist.destroy_process_group()
''' % dict(B=B, CACHE=CACHE, DECODE=DECODE, CASES=CASES)


def _batch(cfg, step):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return {"tokens": toks, "targets": toks}


def _flat(tree, prefix):
    """A nested dict of arrays as {prefix/path: array}, and the same
    without the prefix."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}")[0])
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    n = len(prefix) + 1
    return out, {k[n:]: v for k, v in out.items()}


def _reference(case, inputs):
    """The reference's single-device jitted prefill, decode and train steps
    on the parameters and batches the ranks get."""
    dtype, over, accum = CASES[case]
    cfg = dataclasses.replace(rconfigs.get_reduced(ARCH),
                              dtype=getattr(jnp, dtype),
                              **{"attn_impl": "xla", **over})
    model = RTransformer(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    inputs.update(_flat(jax.tree_util.tree_map(np.asarray, params),
                        case + "/p")[0])
    toks = jnp.asarray(inputs["tokens"])
    out = {"prefill": np.asarray(jax.jit(rlm.make_prefill_step(model))(
        params, {"tokens": toks}), np.float32)}
    cache = model.init_cache(B, CACHE)
    decode = jax.jit(rlm.make_decode_step(model))
    for i in range(DECODE):
        logits, cache = decode(params, toks[:, i:i + 1], cache)
        out[f"decode{i}"] = np.asarray(logits, np.float32)
    opt = ropt.adamw()
    step_fn = jax.jit(rlm.make_train_step(model, opt, rsched.cosine_schedule(
        1e-3, warmup=2, total=10), accum=accum))
    init, state, states = _np_tree(params), opt.init(params), []
    for s in STEPS:
        batch = {k: jnp.asarray(inputs[f"batch{s}/{k}"])
                 for k in ("tokens", "targets")}
        params, state, metrics = step_fn(params, state, jnp.asarray(s),
                                         batch)
        for k in ("loss", "grad_norm"):
            out[f"step{s}/{k}"] = float(metrics[k])
        states.append(_flat_state(_np_tree(state)))
    return (_flat(init, "")[1], _flat(_np_tree(params), "")[1], states,
            out)


def _tree(res, prefix):
    """The ranks' {prefix/path: array} entries as a flat dict by path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _states(res, key):
    """The ranks' AdamW moments after each step, flat dicts by path."""
    return [ropt.AdamState(mu=_tree(res, f"{key}/step{s}/mu"),
                           nu=_tree(res, f"{key}/step{s}/nu"),
                           count=np.int32(0)) for s in STEPS]


def _flat_state(state):
    return ropt.AdamState(mu=_flat(state.mu, "")[1], nu=_flat(state.nu, "")[1],
                          count=state.count)


def _run_ranks(tmp_path, inputs, world=4):
    np.savez(tmp_path / "inputs.npz", **inputs)
    script = tmp_path / "rank_main.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    return dict(np.load(tmp_path / "rank0.npz"))


def test_sharded_steps_match_reference_and_unsharded(tmp_path):
    rng = np.random.default_rng(7)
    cfg = rconfigs.get_reduced(ARCH)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
              "clip": rng.normal(size=(128, 256)).astype(np.float32)}
    for s in STEPS:
        for k, v in _batch(cfg, s).items():
            inputs[f"batch{s}/{k}"] = v
    refs = {case: _reference(case, inputs) for case in CASES}
    res = _run_ranks(tmp_path, inputs)

    # the clip sums every shard's squares: the global norm, not a rank's
    np.testing.assert_allclose(res["clip/global"], res["clip/plain"],
                               rtol=1e-6)
    assert abs(res["clip/local"] - res["clip/global"]) > \
        0.1 * res["clip/global"]
    np.testing.assert_allclose(res["clip/w"], res["clip/w_plain"],
                               rtol=1e-6, atol=1e-7)

    for case, (dtype, _, _) in CASES.items():
        init, want_params, want_states, want = refs[case]
        f32 = dtype == "float32"
        plain = case == "float32"       # rank 0 ran the unsharded port too
        logit_rel = 1e-4 if f32 else 2e-2
        whos = ("sharded", "plain") if plain else ("sharded",)
        for key in ("prefill",) + tuple(f"decode{i}" for i in range(DECODE)):
            w = want[key]
            for who in whos:
                got = res[f"{who}/{case}/{key}"]
                np.testing.assert_allclose(
                    got, w, rtol=0, atol=logit_rel * np.abs(w).max(),
                    err_msg=f"{who} {case} {key}")
                assert (got.argmax(-1) == w.argmax(-1)).mean() >= \
                    (1.0 if f32 else 0.9), (who, case, key)
            if plain:
                np.testing.assert_allclose(
                    res[f"sharded/{case}/{key}"],
                    res[f"plain/{case}/{key}"], rtol=0,
                    atol=logit_rel * np.abs(w).max())
        for s in STEPS:
            for k in ("loss", "grad_norm"):
                for who in whos:
                    np.testing.assert_allclose(
                        res[f"{who}/{case}/step{s}/{k}"],
                        want[f"step{s}/{k}"],
                        rtol=1e-5 if f32 else 2e-2,
                        err_msg=f"{who} {case} step {s} {k}")
        got_params = _tree(res, f"sharded/{case}/param")
        assert sorted(got_params) == sorted(want_params)
        got_states = _states(res, f"sharded/{case}")
        if f32:
            for gs, ws in zip(got_states, want_states):
                for name in ("mu", "nu"):
                    for k, w in getattr(ws, name).items():
                        np.testing.assert_allclose(
                            getattr(gs, name)[k], w, rtol=0,
                            atol=1e-4 * np.abs(w).max(),
                            err_msg=f"{case} {k}")
            _check_params(init, got_params, want_params,
                          _ill(got_states, want_states))
        else:
            for k, w in want_params.items():
                moved = 2 * np.abs(w - init[k]).max()
                assert np.abs(got_params[k] - w).max() <= max(
                    2e-2 * np.abs(w).max(), moved), (case, k)
        if plain:
            plain_params = _tree(res, f"plain/{case}/param")
            plain_states = _states(res, f"plain/{case}")
            _check_params(init, got_params, plain_params,
                          _ill(got_states, plain_states))


def test_launch_train_under_torchrun(tmp_path):
    """``launch.train`` on two CPU ranks under ``torchrun`` with
    ``--model-parallel 2``: a (data 1, model 2) mesh, three steps, a
    finite loss, and the final checkpoint written by rank 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--reduced", "--device", "cpu", "--model-parallel", "2",
           "--steps", "3", "--log-every", "1", "--ckpt-dir",
           str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: {'data': 1, 'model': 2}" in out.stdout
    assert "done: 3 steps" in out.stdout
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert (tmp_path / "ckpt" / "step_3").is_dir()
