"""The port's LM families against the reference's, on the CPU.

Each of the seven configs the port's ``Transformer`` gained (llama4 scout
and maverick: MoE; rwkv6: RWKV6; zamba2: the Mamba2 hybrid with its shared
attention block; whisper: the encoder-decoder; qwen2-vl: M-RoPE on an
embeddings input; gemma3: a per-layer window schedule) at ``get_reduced``'s
size, with the reference's own parameters carried over by
``convert.lm_params_from_numpy``, on seeded numpy inputs:

* ``train_logits`` and ``loss_fn`` (aux terms included), ``prefill`` and
  three ``decode_step``s from an empty cache, with ``attn_impl='pallas'``
  (on the CPU both packages take the blockwise route, the windowed config
  with its per-layer windows);
* fp32 for every config: logits within 1e-4 of the largest with every
  argmax equal, the loss and the aux losses within 1e-5 relative, the
  decode caches within 1e-5 of each leaf's largest entry;
* bf16 for llama4-scout, rwkv6 and gemma3: logits, loss and caches within
  2e-2 (of the largest logit, relative, of each leaf's largest entry), the
  argmax equal wherever the reference's top two logits lie more than
  twice that limit apart (closer ones are ties at bf16's resolution: the
  two frameworks round each bf16 matmul, norm and rope output at other
  places; the exemption follows from the limit, since two logits each
  within it can swap only when their gap is at most twice it, and it
  covers 62 of llama4-scout's 128 training positions on these inputs).
  The MoE in bf16 has a second kind of tie: a token whose top
  two router probabilities are close may go to another expert in the
  other package, which changes its logits by O(1), and the capacity
  ranks of the tokens after it.  So there every position meets the
  limits unless the port routed it within ``TIE`` of a tie in some layer,
  but for training, where at most one other position may miss (on these
  inputs 32 of the 128 training positions are such ties, and one other
  position is 0.022 of the largest logit from the reference's); the
  routing itself is compared exactly in fp32 (``tests/test_torch_moe.py``)
  and the MoE layer in bf16 on equal inputs;
* the converter's round trip, leaf for leaf;
* the ``Server``'s greedy tokens equal to the reference ``Server``'s in
  fp32 for zamba2 (slot reuse over the SSD states and the shared block's
  KV caches) and whisper (the zero cross caches);
* M-RoPE and the sinusoidal table against the reference's functions.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import transformer as rtransformer
from repro.runtime.server import Request as RRequest
from repro.runtime.server import Server as RServer
import repro_torch.configs as pconfigs
from repro_torch import convert
from repro_torch.models import layers as players
from repro_torch.models import lm as plm
from repro_torch.models import moe as pmoe
from repro_torch.models.transformer import Transformer, check_supported
from repro_torch.runtime import Request, Server

FAMILIES = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "rwkv6-7b",
            "zamba2-1.2b", "whisper-small", "qwen2-vl-7b", "gemma3-4b")
BF16 = ("llama4-scout-17b-a16e", "rwkv6-7b", "gemma3-4b")
CASES = [(a, "float32") for a in FAMILIES] + [(a, "bfloat16") for a in BF16]
TOL = {"float32": dict(logit=1e-4, loss=1e-5, cache=1e-5),
       "bfloat16": dict(logit=2e-2, loss=2e-2, cache=2e-2)}
B, T, T_DEC = 2, 64, 16   # T a multiple of the reduced scan_chunk (32)
TIE = 0.02   # a top-2 router probability gap below this is a near tie
MOE_BF16_SHARE = 1 - 1 / (B * T)   # one training position past the limits


@contextlib.contextmanager
def near_ties(model, shape):
    """Record the port's routing while the block runs; yields a list that
    then holds one bool array of ``shape`` (B, T): the positions whose top
    two router probabilities came within TIE in some layer (all False for
    a family without experts)."""
    out = [np.zeros(shape, bool)]
    if model.cfg.family != "moe":
        yield out
        return
    route = pmoe.route

    def spy(router, xg, capacity):
        r = route(router, xg, capacity)
        top2 = torch.topk(r.probs, 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).reshape(shape)
        out[0] |= gap.numpy() < TIE
        return r

    pmoe.route = spy
    try:
        yield out
    finally:
        pmoe.route = route


def _bf16_ties(ties: list, dtype: str) -> np.ndarray:
    """The near ties recorded by ``near_ties``, exempt in bf16 only."""
    return ties[0] if dtype == "bfloat16" else np.zeros_like(ties[0])


@functools.lru_cache(maxsize=None)
def _jit(fn):
    """The reference function jitted once, as its ``Server`` jits
    ``decode_step`` (an eager call traces and compiles its scans anew)."""
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str):
    """(reference model, its params, the port's model with those params)."""
    rcfg = dataclasses.replace(rconfigs.get_reduced(arch),
                               dtype=getattr(jnp, dtype), attn_impl="pallas")
    pcfg = dataclasses.replace(pconfigs.get_reduced(arch),
                               dtype=getattr(torch, dtype),
                               attn_impl="pallas")
    rmodel = rtransformer.Transformer(rcfg)
    if dtype == "float32":
        params, _ = rmodel.init(jax.random.PRNGKey(0))
    else:   # the same values: the reference's init draws in fp32 and casts
        params = jax.tree_util.tree_map(
            lambda a, s: a.astype(s.dtype), _pair(arch, "float32")[1],
            rmodel.param_shapes())
    pmodel = convert.lm_params_from_numpy(
        Transformer(pcfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return rmodel, params, pmodel


def _batch(cfg, seed: int = 0) -> dict:
    """The family's loss_fn batch: tokens, embeddings, or encoder frames
    and decoder targets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.is_encdec:
        return {"embeds": rng.normal(size=(B, T, cfg.d_model)).astype(
                    np.float32) * 0.5,
                "targets": toks[:, :T_DEC]}
    if cfg.input_mode == "embeds":
        return {"embeds": rng.normal(size=(B, T, cfg.d_model)).astype(
                    np.float32) * 0.5,
                "targets": toks}
    return {"tokens": toks, "targets": toks}


def _ref_batch(batch: dict, dtype: str) -> dict:
    """The batch for the reference: embeddings in the model's dtype, as the
    port casts them."""
    return {k: jnp.asarray(v, getattr(jnp, dtype)) if k == "embeds"
            else jnp.asarray(v) for k, v in batch.items()}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_logits(got: torch.Tensor, want, dtype: str, ties=None,
                   share: float = 1.0) -> None:
    """Logits within the dtype's limit of the largest, argmax equal (in
    bf16 where the reference's top two are more than twice the limit
    apart), at every position but the ``ties`` (bool over the leading
    axes), or at ``share`` of them."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    tol = TOL[dtype]["logit"]
    ok = np.abs(got - want).max(-1) <= tol * scale
    same = got.argmax(-1) == want.argmax(-1)
    if dtype == "bfloat16":
        top2 = np.sort(want, axis=-1)[..., -2:]
        same |= top2[..., 1] - top2[..., 0] <= 2 * tol * scale
    ok &= same
    if ties is not None:
        ok |= ties
    assert ok.mean() >= share, (ok.mean(), np.argwhere(~ok)[:8])


def test_every_registry_config_is_supported():
    for arch in pconfigs.ALL_ARCHS:
        check_supported(pconfigs.get_config(arch))
        check_supported(pconfigs.get_reduced(arch))
    cfg = dataclasses.replace(pconfigs.get_reduced("qwen2-vl-7b"),
                              m_rope_sections=(4, 6, 7))
    check_supported(cfg)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="do not sum"), torch.no_grad():
        model.train_logits(embeds=torch.zeros(1, 4, cfg.d_model))


def _train_kwargs(cfg) -> dict:
    """train_logits' keywords, each naming its entry of the batch."""
    if cfg.is_encdec:
        return {"tokens": "targets", "enc_embeds": "embeds"}
    if cfg.input_mode == "embeds":
        return {"embeds": "embeds"}
    return {"tokens": "tokens"}


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str):
    """The reference's train logits, aux, ``loss_fn`` metrics and prefill
    logits on ``_batch``, in one compile: XLA shares the forward among
    them (the reference's prefill is the last position of train_logits)."""
    rmodel, params, pmodel = _pair(arch, dtype)
    kw = _train_kwargs(pmodel.cfg)
    prefill = rlm.make_prefill_step(rmodel)

    def reference(params, rbatch):
        logits, aux = rmodel.train_logits(
            params, **{k: rbatch[v] for k, v in kw.items()})
        return (logits, aux, rlm.loss_fn(rmodel, params, rbatch)[1],
                prefill(params, rbatch))

    return jax.jit(reference)(params, _ref_batch(_batch(pmodel.cfg), dtype))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_train_logits_and_loss_match_reference(arch, dtype):
    _, _, pmodel = _pair(arch, dtype)
    want, waux, wmet, _ = _reference(arch, dtype)
    batch = _batch(pmodel.cfg)
    kw = _train_kwargs(pmodel.cfg)
    shape = (B, T_DEC) if pmodel.cfg.is_encdec else (B, T)
    with torch.no_grad(), near_ties(pmodel, shape) as ties:
        got, gaux = pmodel.train_logits(**{k: batch[v]
                                           for k, v in kw.items()})
    assert got.dtype == torch.float32
    moe_bf16 = pmodel.cfg.family == "moe" and dtype == "bfloat16"
    _assert_logits(got, want, dtype, _bf16_ties(ties, dtype),
                   share=MOE_BF16_SHARE if moe_bf16 else 1)
    assert sorted(gaux) == sorted(waux)
    gmet = plm.make_eval_step(pmodel)(batch)
    assert sorted(gmet) == sorted(wmet)
    for key, w in wmet.items():
        w, g = float(w), float(gmet[key])
        assert abs(g - w) <= TOL[dtype]["loss"] * max(abs(w), 1e-6), (key, g,
                                                                      w)
    if pmodel.cfg.family == "moe":
        assert float(gmet["lb_loss"]) > 0 and float(gmet["z_loss"]) > 0
        assert float(gmet["loss"]) > float(gmet["xent"])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_matches_reference(arch, dtype):
    _, _, pmodel = _pair(arch, dtype)
    want = _reference(arch, dtype)[3]
    batch = _batch(pmodel.cfg)
    batch.pop("targets")
    with near_ties(pmodel, (B, T)) as ties:
        got = plm.make_prefill_step(pmodel)(batch)
    assert tuple(got.shape) == (B, pmodel.cfg.padded_vocab)
    _assert_logits(got, want, dtype, _bf16_ties(ties, dtype)[:, -1])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_steps_match_reference(arch, dtype):
    """Three decode steps on a batch of 2 from an empty cache of 16, then
    every cache leaf."""
    rmodel, params, pmodel = _pair(arch, dtype)
    toks = np.random.default_rng(3).integers(0, pmodel.cfg.vocab,
                                             (B, 3)).astype(np.int32)
    rcache, pcache = rmodel.init_cache(B, 16), pmodel.init_cache(B, 16)
    assert sorted(pcache) == sorted(rcache)
    for s in range(3):
        tok = toks[:, s:s + 1]
        want, rcache = _jit(rmodel.decode_step)(params, jnp.asarray(tok),
                                                rcache)
        with near_ties(pmodel, (B, 1)) as ties:
            got, pcache = pmodel.decode_step(tok, pcache)
        _assert_logits(got, want, dtype, _bf16_ties(ties, dtype)[:, 0])
    for key, want in rcache.items():
        got = pcache[key]
        assert tuple(got.shape) == tuple(want.shape), key
        if key in ("len", "enc_len"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        elif want.size and np.abs(np.asarray(want, np.float32)).max() > 0:
            assert _rel(got.float().numpy(), want) <= TOL[dtype]["cache"], key
        else:
            assert not got.any(), key   # whisper's never-filled cross caches


@pytest.mark.parametrize("arch", FAMILIES)
def test_converter_round_trip(arch):
    _, params, pmodel = _pair(arch, "float32")
    tree = convert.lm_params_to_numpy(pmodel)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    for got, ref in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small"])
def test_server_greedy_outputs_match_reference(arch):
    """Four prompts through max_batch=2 (slot reuse) in fp32: the same
    greedy tokens."""
    rmodel, params, pmodel = _pair(arch, "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pmodel.cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    rserver = RServer(rmodel, params, max_batch=2, max_len=32)
    pserver = Server(pmodel, max_batch=2, max_len=32)
    for i, p in enumerate(prompts):
        rserver.submit(RRequest(rid=i, prompt=p, max_tokens=4))
        pserver.submit(Request(rid=i, prompt=p, max_tokens=4))
    want = {r.rid: r.out_tokens for r in rserver.run_until_drained()}
    got = {r.rid: r.out_tokens for r in pserver.run_until_drained()}
    assert got == want and set(got) == {0, 1, 2, 3}


@pytest.mark.parametrize("sections,positions", [
    ((4, 6, 6), "text"), ((4, 6, 6), "vision"), ((16, 24, 24), "vision")])
def test_m_rope_matches_reference(sections, positions):
    d = 2 * sum(sections)
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 5, 3, d)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5, 3)).astype(np.int32)
    if positions == "text":
        pos[..., 1:] = pos[..., :1]
    want = rlayers.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                sections)
    got = players.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if positions == "text":   # degenerate streams: 1-D RoPE
        plain = players.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(pos[..., 0]), 1e6)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_sinusoidal_matches_reference():
    want = np.asarray(rtransformer._sinusoidal(512, 128))
    got = players.sinusoidal(512, 128).numpy()
    # sin and cos of fp32 angles up to 511 rad: 1e-5 of their range is
    # below the angles' own rounding (an ulp of 511 is 6.1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=6.1e-5)
