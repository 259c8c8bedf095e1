"""The port's LM stack against the reference's, on the CPU.

Configs, the token stream, the parameter converter, and the reduced
smollm-135m (4 layers, d_model 128, 4 heads over 2 KV heads, head_dim 32,
vocab 512) with the reference's own parameters carried over by
``convert.lm_params_from_numpy``:

* fp32: logits of ``train_logits`` (both ``attn_impl`` routes, which on the
  CPU are both blockwise, as in the reference), ``prefill`` and 8 steps of
  ``decode_step`` within 1e-4 of the largest logit, the loss within 1e-5
  relative, the KV cache within 1e-5 of its largest entry, the greedy
  ``Server`` tokens equal;
* bf16 (the config's dtype): logits and KV cache within 2e-2 of their
  largest entry - the two frameworks round each bf16 matmul, norm and rope
  output at other places, and the differences grow through the layers to
  about 0.6% of the largest logit on these inputs - with the argmax at
  every position equal, and the loss within 1e-3 relative.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.data.tokens import TokenStream as RTokenStream
from repro.data.tokens import TokenStreamConfig as RTokenStreamConfig
from repro.models import lm as rlm
from repro.models.transformer import Transformer as RTransformer
from repro.runtime.server import Request as RRequest
from repro.runtime.server import Server as RServer
import repro_torch.configs as pconfigs
from repro_torch import convert
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.launch import serve as pserve
from repro_torch.models import lm as plm
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import Request, Server

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               jnp.float32: "float32", jnp.bfloat16: "bfloat16"}
TOL = {"float32": dict(logit_rel=1e-4, loss_rel=1e-5, cache_rel=1e-5),
       "bfloat16": dict(logit_rel=2e-2, loss_rel=1e-3, cache_rel=2e-2)}
ARCH = "smollm-135m"


# ---------------------------------------------------------------------------
# configs, token stream, converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(rconfigs.REGISTRY))
@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_configs_match_reference(arch, which):
    want = getattr(rconfigs, which)(arch)
    got = getattr(pconfigs, which)(arch)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if field.name == "dtype":
            assert DTYPE_NAMES[g] == DTYPE_NAMES[w]
        else:
            assert g == w, field.name
    assert got.padded_vocab == want.padded_vocab
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert [got.window_for_layer(i) for i in range(7)] == \
        [want.window_for_layer(i) for i in range(7)]


def test_registry_and_shapes_match_reference():
    assert pconfigs.ALL_ARCHS == rconfigs.ALL_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in pconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in rconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        pconfigs.get_config("nope")


@pytest.mark.parametrize("seed,step,shard,n_shards", [(0, 0, 0, 1),
                                                      (3, 7, 1, 2)])
def test_token_stream_is_bit_identical(seed, step, shard, n_shards):
    kw = dict(vocab=300, seq_len=33, global_batch=4, seed=seed)
    want = RTokenStream(RTokenStreamConfig(**kw)).batch(step, shard, n_shards)
    got = TokenStream(TokenStreamConfig(**kw)).batch(step, shard, n_shards)
    for key in ("tokens", "targets"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    first = next(TokenStream(TokenStreamConfig(**kw)).batches(step))
    np.testing.assert_array_equal(first["tokens"],
                                  RTokenStream(RTokenStreamConfig(**kw))
                                  .batch(step)["tokens"])


# ---------------------------------------------------------------------------
# the reduced smollm-135m against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(dtype: str, attn_impl: str = "pallas"):
    """(reference model, its params, the port's model with those params)."""
    rcfg = dataclasses.replace(rconfigs.get_reduced(ARCH),
                               dtype=getattr(jnp, dtype), attn_impl=attn_impl)
    pcfg = dataclasses.replace(pconfigs.get_reduced(ARCH),
                               dtype=getattr(torch, dtype),
                               attn_impl=attn_impl)
    rmodel = RTransformer(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(0))
    pmodel = convert.lm_params_from_numpy(
        Transformer(pcfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return rmodel, params, pmodel


def _tokens(b=2, t=40, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


def _assert_logits(got: torch.Tensor, want, dtype: str):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[dtype]["logit_rel"], err
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_converter_round_trip():
    rmodel, params, pmodel = _pair("bfloat16")
    tree = convert.lm_params_to_numpy(pmodel)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    for got, ref in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(got, ref)
    bad = dict(tree, extra=tree["embed"])
    with pytest.raises(KeyError):
        convert.lm_params_from_numpy(pmodel, bad)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_match_reference(attn_impl, dtype):
    rmodel, params, pmodel = _pair(dtype, attn_impl)
    toks = _tokens()
    want, _ = rmodel.train_logits(params, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = pmodel.train_logits(toks)
    assert got.dtype == torch.float32
    assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    _assert_logits(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    rmodel, params, pmodel = _pair(dtype)
    toks = _tokens(t=50, seed=1)
    want = rlm.make_prefill_step(rmodel)(params, {"tokens": jnp.asarray(toks)})
    got = plm.make_prefill_step(pmodel)({"tokens": toks})
    assert tuple(got.shape) == (2, pmodel.cfg.padded_vocab)
    _assert_logits(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_reference(dtype):
    rmodel, params, pmodel = _pair(dtype)
    toks = _tokens(seed=2)
    batch = {"tokens": toks, "targets": toks}
    want, wmet = rlm.loss_fn(rmodel, params,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = plm.make_eval_step(pmodel)(batch)
    assert sorted(got) == sorted(wmet)
    rel = abs(float(got["loss"]) - float(want)) / abs(float(want))
    assert rel <= TOL[dtype]["loss_rel"], rel
    assert float(got["xent"]) == float(got["loss"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype):
    """8 decode steps on a batch of 2 from an empty cache of 16."""
    rmodel, params, pmodel = _pair(dtype)
    toks = _tokens(t=8, seed=3)
    rcache, pcache = rmodel.init_cache(2, 16), pmodel.init_cache(2, 16)
    step = plm.make_decode_step(pmodel)
    for s in range(8):
        want, rcache = rmodel.decode_step(params, jnp.asarray(toks[:, s:s + 1]),
                                          rcache)
        got, pcache = step(toks[:, s:s + 1], pcache)
        _assert_logits(got, want, dtype)
    np.testing.assert_array_equal(pcache["len"].numpy(),
                                  np.asarray(rcache["len"]))
    for key in ("k", "v"):
        got = pcache[key].float().numpy()
        want = np.asarray(rcache[key], np.float32)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL[dtype]["cache_rel"], (key, err)


def test_server_greedy_outputs_match_reference():
    """The reference test's four prompts through max_batch=2 (slot reuse)
    in fp32: the same greedy tokens."""
    rmodel, params, pmodel = _pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 3, 7)]
    rserver = RServer(rmodel, params, max_batch=2, max_len=64)
    pserver = Server(pmodel, max_batch=2, max_len=64)
    for i, p in enumerate(prompts):
        rserver.submit(RRequest(rid=i, prompt=p, max_tokens=4))
        pserver.submit(Request(rid=i, prompt=p, max_tokens=4))
    want = {r.rid: r.out_tokens for r in rserver.run_until_drained()}
    got = {r.rid: r.out_tokens for r in pserver.run_until_drained()}
    assert got == want and set(got) == {0, 1, 2, 3}
    assert all(r.done and r.finish_t >= r.submit_t
               for r in pserver.completed)


def test_serve_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--reduced", "--device", "cpu", "--requests", "3",
        "--prompt-len", "4", "--max-tokens", "2", "--max-batch", "2",
        "--max-len", "16"])
    pserve.main()
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the knobs the families brought (each raised until the families were
# ported; tests/test_torch_families.py holds them in full)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,updates,knob", [
    ("llama4-scout-17b-a16e", {}, "family 'moe'"),
    ("zamba2-1.2b", {}, "family 'hybrid'"),
    ("whisper-small", {}, "family 'encdec'"),
    ("rwkv6-7b", {}, "rwkv=True"),
    ("qwen2-vl-7b", {}, "m_rope=True"),
    ("smollm-135m", {"input_mode": "embeds"}, "input_mode='embeds'"),
    ("gemma3-4b", {}, "window_pattern"),
    ("smollm-135m", {"pos": "absolute"}, "pos='absolute'"),
])
def test_unported_knobs_raise(arch, updates, knob):
    """Each knob that raised before the families were ported now builds
    and gives the reference's fp32 logits (within 1e-4 of the largest,
    every argmax equal) on one sequence of 32 tokens or embeddings."""
    kw = dict(updates, dtype=jnp.float32)
    rcfg = dataclasses.replace(rconfigs.get_reduced(arch), **kw)
    pcfg = dataclasses.replace(pconfigs.get_reduced(arch),
                               **dict(updates, dtype=torch.float32))
    rmodel = RTransformer(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(0))
    pmodel = convert.lm_params_from_numpy(
        Transformer(pcfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(1, 32, pcfg.d_model)).astype(np.float32)
    toks = _tokens(b=1, t=32, seed=5)
    if pcfg.is_encdec:
        inputs = dict(tokens=toks[:, :8], enc_embeds=emb)
    elif pcfg.input_mode == "embeds":
        inputs = dict(embeds=emb)
    else:
        inputs = dict(tokens=toks)
    # jitted: an eager call traces and compiles the reference's scans
    want, _ = jax.jit(rmodel.train_logits)(
        params, **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got, _ = pmodel.train_logits(**inputs)
    _assert_logits(got, want, "float32")
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(pconfigs.get_reduced(ARCH))


def test_flash_route_has_no_gradient_yet():
    """The flash route now has a gradient: the loss's gradients through
    it are finite and equal the plain route's (attn_impl='xla') within
    1e-5 of each leaf's largest entry."""
    grads = []
    for impl in ("pallas", "xla"):
        _, _, pmodel = _pair("float32", impl)
        pmodel.zero_grad(set_to_none=True)
        toks = _tokens(t=8)
        loss, _ = plm.loss_fn(pmodel, {"tokens": toks, "targets": toks})
        loss.backward()
        grads.append([p.grad.clone() for p in pmodel.parameters()])
        pmodel.zero_grad(set_to_none=True)
    for g, w in zip(*grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
