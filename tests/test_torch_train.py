"""The port's LM training path against the reference's, on the CPU.

* ``flash_attention``'s gradients (the recompute backward of
  ``models.attention.flash_attention_backward``) against ``jax.vjp`` of the
  reference's ``make_flash_scoped`` and against autograd through the
  port's ``blockwise_attention``: B=2, T=96, H=4 over KV=2, D=16, causal
  and not, tiles of 32 x 64 and 64 x 32 (T is not a multiple of 64), fp32
  within rtol 1e-5 / atol 1e-6.
* ``make_train_step`` on the reduced smollm-135m (4 layers, d_model 128)
  in fp32 with the reference's parameters (``convert``), at
  ``attn_impl='xla'`` and ``'pallas'`` and ``accum`` 1 and 2, over two
  AdamW steps (cosine schedule past its warmup): loss, grad_norm and lr
  within rtol 1e-5; the moments ``mu`` and ``nu`` (the clipped gradients
  and their squares) within 1e-4 of each leaf's largest entry (the first
  step's gradients agree to about 1e-6 of it; the second step's are taken
  at parameters that already differ where the first was ill-conditioned,
  below); each
  parameter within 1e-3 of its leaf's largest move plus 1e-7, except
  where the step is ill-conditioned: AdamW moves a parameter by
  u = m_hat / (sqrt(n_hat) + 1e-8), and where the measured differences of
  m_hat and sqrt(n_hat) in the entry's row bound u's difference, to first
  order, above 1e-3 (``_ill``: entries whose sqrt(n_hat) is near 1e-8, or
  whose m_hat nearly cancels across steps), f32 sums in another order can
  move the step by more than 1e-3 of itself.  Those entries are held to
  two moves instead: 0.3-1.8% of them on these inputs (1 to 11 of 32,768
  to 131,072 of a layer leaf miss the tighter limit; the rest meet it by
  a factor of 3 or more).  One bf16 step: loss and grad_norm within 2e-2
  relative, the gradients and each parameter within 2e-2 of the leaf's
  largest entry (the LM's bf16 limit), except where the gradient's sign is
  not resolved (``test_train_step_bf16_matches_reference``).  One fp32
  step each of the reduced llama4-scout (the MoE's aux losses in the
  loss) and gemma3 (the window schedule).
* The remat policies: gradients bit for bit equal under 'nothing',
  'none', 'dots' and 'save_moe', for a dense, an MoE, a hybrid, an RWKV
  and the encoder-decoder config (every body the port wraps).
* ``Trainer``, as ``tests/test_runtime.py`` holds the reference's: it runs
  and checkpoints, recovers from an injected fault bit for bit (a quadratic
  and the reduced LM), gives up after its retries, and evicts a straggler;
  ``compress_grads=True`` raises (it waits for the LM's sharding);
  a reference ``Trainer``'s checkpoint at step 2 restores into the port
  bit for bit and the port's next step matches the reference's, and a
  port checkpoint restores in the reference.
* ``launch.train.main --reduced --steps 3 --device cpu``, then resumed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import attention as ratt
from repro.models import lm as rlm
from repro.models.transformer import Transformer as RTransformer
from repro.optim import optimizers as ropt
from repro.optim import schedule as rsched
from repro.runtime.trainer import Trainer as RTrainer
from repro.runtime.trainer import TrainerConfig as RTrainerConfig
import repro_torch.configs as pconfigs
from repro_torch import convert
from repro_torch.launch import train as ptrain
from repro_torch.models import attention as patt
from repro_torch.models import lm as plm
from repro_torch.models.transformer import Transformer
from repro_torch.optim import optimizers as popt
from repro_torch.optim import schedule as psched
from repro_torch.runtime import (ElasticRestart, StragglerWatchdog, Trainer,
                                 TrainerConfig)

ARCH = "smollm-135m"
STEPS = (3, 4)              # past the schedule's warmup of 2
B, T = 4, 32


def _lr(mod):
    return mod.cosine_schedule(1e-3, warmup=2, total=10)


# ---------------------------------------------------------------------------
# flash attention's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(32, 64), (64, 32)])
def test_flash_gradients_match_reference(causal, bq, bk):
    rng = np.random.default_rng(bq + 2 * causal)
    q = rng.normal(size=(2, 96, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    flash = ratt.make_flash_scoped(causal, bq, bk)

    def ref(q_, k_, v_, ct_):
        out, vjp = jax.vjp(lambda a, b, c: flash(a, b, c, jnp.int32(0)),
                           q_, k_, v_)
        return out, vjp(ct_)

    want_out, want = jax.jit(ref)(q, k, v, ct)
    got, plain = [], []
    for fn, grads in ((patt.flash_attention, got),
                      (patt.blockwise_attention, plain)):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*ts, causal=causal, block_q=bq, block_k=bk)
        out.backward(torch.from_numpy(ct))
        grads.extend(t.grad for t in ts)
        if fn is patt.flash_attention:
            np.testing.assert_allclose(out.detach().numpy(),
                                       np.asarray(want_out), rtol=1e-5,
                                       atol=1e-6)
    for name, g, w, p in zip("qkv", got, want, plain):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name} vs jax.vjp")
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name} vs blockwise")


@pytest.mark.parametrize("q_offset", [32, 50])
def test_flash_gradients_with_query_offset(q_offset):
    """A slice of the query rows at ``q_offset`` against all 96 keys (the
    row split over 'model'): the flash route's output and gradient against
    ``jax.vjp`` of the reference's blockwise attention at that offset."""
    rng = np.random.default_rng(q_offset)
    q = rng.normal(size=(2, 46, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)

    def ref(q_, k_, v_, ct_):
        out, vjp = jax.vjp(lambda a, b, c: ratt.blockwise_attention(
            a, b, c, causal=True, q_offset=q_offset, block_q=32,
            block_k=64), q_, k_, v_)
        return out, vjp(ct_)

    want_out, want = jax.jit(ref)(q, k, v, ct)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = patt.flash_attention(*ts, causal=True, q_offset=q_offset,
                               block_q=32, block_k=64)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-6)
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name} vs jax.vjp")


# ---------------------------------------------------------------------------
# make_train_step against the reference's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str, attn_impl: str):
    cfg = dataclasses.replace(rconfigs.get_reduced(arch),
                              dtype=getattr(jnp, dtype), attn_impl=attn_impl)
    model = RTransformer(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    return model, params


def _port(arch: str, dtype: str, attn_impl: str) -> Transformer:
    cfg = dataclasses.replace(pconfigs.get_reduced(arch),
                              dtype=getattr(torch, dtype),
                              attn_impl=attn_impl)
    _, params = _reference(arch, dtype, attn_impl)
    return convert.lm_params_from_numpy(
        Transformer(cfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))


def _batch(cfg, step: int):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.input_mode == "embeds" or cfg.is_encdec:
        emb = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "targets": toks}
    return {"tokens": toks, "targets": toks}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, dtype, attn_impl, accum, steps):
    """The reference's states after each step: [(params, AdamState,
    metrics)], numpy."""
    model, params = _reference(arch, dtype, attn_impl)
    opt = ropt.adamw()
    step_fn = jax.jit(rlm.make_train_step(model, opt, _lr(rsched),
                                          accum=accum))
    state, out = opt.init(params), []
    for s in steps:
        batch = {k: jnp.asarray(v) for k, v in _batch(model.cfg, s).items()}
        params, state, metrics = step_fn(params, state, jnp.asarray(s),
                                         batch)
        out.append((_np_tree(params), _np_tree(state),
                    {k: float(v) for k, v in metrics.items()}))
    return out


def _port_run(arch, dtype, attn_impl, accum, steps):
    model = _port(arch, dtype, attn_impl)
    init = convert.lm_params_to_numpy(model)
    opt = popt.adamw()
    step_fn = plm.make_train_step(model, opt, _lr(psched), accum=accum)
    state, out = opt.init(model), []
    for s in steps:
        batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg,
                                                          s).items()}
        model, state, metrics = step_fn(model, state, s, batch)
        out.append((convert.lm_params_to_numpy(model),
                    _np_tree(jax.tree_util.tree_map(
                        lambda t: t.numpy(), convert.to_reference_layout(
                            state), is_leaf=lambda x: isinstance(
                                x, torch.Tensor))),
                    {k: float(v) for k, v in metrics.items()}))
    return init, out


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _ill(got_states, want_states, rel=1e-3, first=1):
    """Per leaf, where AdamW's step may differ by more than ``rel`` between
    the packages.  The step is u = m_hat / (s + 1e-8), s = sqrt(n_hat), so
    to first order |du| <= dm / (s + 1e-8) + |m_hat| ds / (s + 1e-8)^2,
    with dm and ds the largest differences of m_hat and s measured in the
    entry's row (the last axis: entries that share a scale); where that
    bound exceeds ``rel`` at some step, the step is ill-conditioned.  The
    states are those after steps ``first``, ``first + 1``, ... (their
    count, for the bias corrections)."""
    b1, b2, eps, masks = 0.9, 0.95, 1e-8, None
    leaves = jax.tree_util.tree_leaves
    for t, (gs, ws) in enumerate(zip(got_states, want_states), start=first):
        ill = []
        for gm, gn, wm, wn in zip(leaves(gs.mu), leaves(gs.nu),
                                  leaves(ws.mu), leaves(ws.nu)):
            mg, mw = gm / (1 - b1 ** t), wm / (1 - b1 ** t)
            sg, sw = np.sqrt(gn / (1 - b2 ** t)), np.sqrt(wn / (1 - b2 ** t))
            dm = np.abs(mg - mw).max(axis=-1, keepdims=True)
            ds = np.abs(sg - sw).max(axis=-1, keepdims=True)
            ill.append(dm / (sw + eps) + np.abs(mw) * ds / (sw + eps) ** 2
                       > rel)
        masks = ill if masks is None else [a | b for a, b in zip(masks, ill)]
    return masks


def _check_params(init, got, want, ill, rel=1e-3, atol=1e-7):
    """Each leaf within ``rel`` of its largest move plus ``atol``; where
    ``ill`` (a mask a leaf) marks the step ill-conditioned, within two
    moves."""
    for (path, g), w, p0, bad in zip(_leaves(got),
                                     jax.tree_util.tree_leaves(want),
                                     jax.tree_util.tree_leaves(init), ill):
        move = np.abs(w - p0).max()
        err = np.abs(g - w)
        name = jax.tree_util.keystr(path)
        assert (err[~bad] <= rel * move + atol).all(), \
            (name, err[~bad].max(), move)
        assert (err[bad] <= 2 * move).all(), (name, err[bad].max(), move)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_train_step_matches_reference(attn_impl, accum):
    want = _reference_run(ARCH, "float32", attn_impl, accum, STEPS)
    init, got = _port_run(ARCH, "float32", attn_impl, accum, STEPS)
    for (gp, gs, gm), (wp, ws, wm) in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=k)
        for (path, g), w in zip(_leaves((gs.mu, gs.nu)),
                                jax.tree_util.tree_leaves((ws.mu, ws.nu))):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                err_msg=jax.tree_util.keystr(path))
        assert int(gs.count) == int(ws.count)
    _check_params(init, got[-1][0], want[-1][0],
                  _ill([g[1] for g in got], [w[1] for w in want]))


def test_train_step_bf16_matches_reference():
    """One bf16 step at the LM's bf16 limit: the gradients (mu / 0.1) and
    each parameter within 2e-2 of the leaf's largest entry, but where the
    reference's gradient lies within that limit of 0 its sign is not
    resolved, and AdamW's first step moves it by about lr either way:
    there within two moves."""
    init = convert.lm_params_to_numpy(_port(ARCH, "bfloat16", "pallas"))
    (wp, ws, wm), = _reference_run(ARCH, "bfloat16", "pallas", 1,
                                   STEPS[:1])
    _, ((gp, gs, gm),) = _port_run(ARCH, "bfloat16", "pallas", 1, STEPS[:1])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=2e-2, err_msg=k)
    unresolved = []
    for (path, g), w in zip(_leaves(gs.mu), jax.tree_util.tree_leaves(
            ws.mu)):
        lim = 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=lim,
                                   err_msg=jax.tree_util.keystr(path))
        unresolved.append(np.abs(w) <= lim)
    for (path, g), w, p0, bad in zip(_leaves(gp),
                                     jax.tree_util.tree_leaves(wp),
                                     jax.tree_util.tree_leaves(init),
                                     unresolved):
        err, name = np.abs(g - w), jax.tree_util.keystr(path)
        assert (err[~bad] <= 2e-2 * np.abs(w).max()).all(), name
        assert (err[bad] <= 2 * np.abs(w - p0).max()).all(), name


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "gemma3-4b"])
def test_train_step_families_match_reference(arch):
    want = _reference_run(arch, "float32", "pallas", 1, STEPS[:1])
    init, got = _port_run(arch, "float32", "pallas", 1, STEPS[:1])
    (gp, gs, gm), (wp, ws, wm) = got[0], want[0]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=k)
    _check_params(init, gp, wp, _ill([gs], [ws]))


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------


REMAT_ARCHS = [ARCH, "llama4-scout-17b-a16e", "zamba2-1.2b", "rwkv6-7b",
               "whisper-small"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_equal_gradients(arch, monkeypatch):
    """Equal gradients under every policy; on the dense config the flash
    route's forward runs once a layer under 'none' and twice (forward and
    recompute) under the others, as K8 does on the card."""
    calls = []
    blockwise = patt.blockwise_attention
    monkeypatch.setattr(patt, "blockwise_attention",
                        lambda *a, **k: calls.append(1) or blockwise(*a, **k))
    grads = {}
    for policy in ("none", "nothing", "dots", "save_moe"):
        cfg = dataclasses.replace(pconfigs.get_reduced(arch),
                                  dtype=torch.float32, attn_impl="pallas",
                                  remat_policy=policy)
        model = Transformer(cfg, device="cpu")
        calls.clear()
        loss, _ = plm.loss_fn(model, _batch(cfg, 0))
        loss.backward()
        if arch == ARCH:
            assert len(calls) == cfg.n_layers * (1 if policy == "none"
                                                 else 2), policy
        grads[policy] = [p.grad for p in model.parameters()]
        assert all(g is not None and torch.isfinite(g).all()
                   for g in grads[policy])
    for policy in ("nothing", "dots", "save_moe"):
        for g, w in zip(grads[policy], grads["none"]):
            assert torch.equal(g, w), policy


# ---------------------------------------------------------------------------
# Trainer (tests/test_runtime.py's cases, and the LM)
# ---------------------------------------------------------------------------


def _quad_step(params, opt_state, step, batch):
    lr = 0.1
    grads = {k: 2 * (p - batch["target"]) for k, p in params.items()}
    new = {k: p - lr * grads[k] for k, p in params.items()}
    loss = sum(torch.sum((p - batch["target"]) ** 2)
               for p in params.values())
    return new, opt_state, {"loss": loss}


def _quad_batch(step):
    return {"target": torch.tensor(float(step % 3))}


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=5),
                 _quad_step, _quad_batch)
    p, o, step = tr.run({"w": torch.zeros(4)}, (), num_steps=12)
    assert step == 12
    assert tr.ckpt.steps() == [5, 10, 12]
    assert len(tr.metrics_log) == 12
    restored, _, at = tr.restore({"w": torch.zeros(4)}, ())
    assert at == 12 and torch.equal(restored["w"], p["w"])


def _faulty(fired, at=7):
    def fault(step):
        if step == at and not fired:
            fired.append(step)
            raise RuntimeError("injected device loss")
    return fault


def test_trainer_recovers_from_injected_fault(tmp_path):
    """A fault at step 7 restores the step-5 checkpoint and replays; the
    final params equal an uninterrupted run's bit for bit."""
    params = {"w": torch.zeros(4)}
    clean = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "a"),
                                  ckpt_every=5), _quad_step, _quad_batch)
    p_clean, _, _ = clean.run(params, (), num_steps=12)
    fired = []
    faulty = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "b"),
                                   ckpt_every=5), _quad_step, _quad_batch,
                     fault_hook=_faulty(fired))
    p_fault, _, _ = faulty.run(params, (), num_steps=12)
    assert fired == [7]
    assert torch.equal(p_clean["w"], p_fault["w"])


def test_trainer_gives_up_after_max_retries(tmp_path):
    def always_fail(step):
        raise RuntimeError("persistent failure")

    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "c"), ckpt_every=5,
                               max_retries_per_step=2),
                 _quad_step, _quad_batch, fault_hook=always_fail)
    with pytest.raises(RuntimeError, match="persistent"):
        tr.run({"w": torch.zeros(2)}, (), num_steps=3)


def test_trainer_compress_grads_is_unported(tmp_path):
    """The reference's Trainer never reads compress_grads: the knob raises
    instead of running uncompressed."""
    with pytest.raises(NotImplementedError, match="never reads"):
        Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "z"),
                              compress_grads=True), _quad_step, _quad_batch)


def test_trainer_evicts_a_straggler(tmp_path):
    """Three slow steps evict the host: the state is saved, then
    ElasticRestart."""
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "e"), ckpt_every=50),
                 _quad_step, _quad_batch)
    tr.watchdog = StragglerWatchdog(threshold=2.0, strikes_to_evict=1)
    tr.watchdog.ewma = 1e-9       # every real step is a straggler now
    with pytest.raises(ElasticRestart, match="host0"):
        tr.run({"w": torch.zeros(2)}, (), num_steps=3)
    assert tr.ckpt.steps() == [0]


def _lm_trainer(path, fault_hook=None, ckpt_every=2):
    model = _port(ARCH, "float32", "pallas")
    opt = popt.adamw()
    step_fn = plm.make_train_step(model, opt, _lr(psched))
    batch = functools.partial(_batch, model.cfg)
    tr = Trainer(TrainerConfig(ckpt_dir=str(path), ckpt_every=ckpt_every),
                 step_fn, lambda s: {k: torch.from_numpy(v)
                                     for k, v in batch(s).items()},
                 fault_hook=fault_hook)
    return tr, model, opt.init(model)


def test_trainer_recovers_the_lm_bit_for_bit(tmp_path):
    tr, model, state = _lm_trainer(tmp_path / "a")
    clean, _, _ = tr.run(model, state, num_steps=5)
    fired = []
    tr, model, state = _lm_trainer(tmp_path / "b", _faulty(fired, at=3))
    fault, fstate, _ = tr.run(model, state, num_steps=5)
    assert fired == [3] and int(fstate.count) == 5
    for g, w in zip(fault.parameters(), clean.parameters()):
        assert torch.equal(g, w)


def test_trainer_checkpoints_cross_packages(tmp_path):
    """A reference Trainer's checkpoint at step 2 restores into the port
    bit for bit; the port's next step matches the reference's; the port's
    checkpoint restores in the reference."""
    rmodel, params = _reference(ARCH, "float32", "pallas")
    ropt_ = ropt.adamw()
    rstep = jax.jit(rlm.make_train_step(rmodel, ropt_, _lr(rsched)))

    def rbatch(s):
        return {k: jnp.asarray(v) for k, v in _batch(rmodel.cfg, s).items()}

    rtr = RTrainer(RTrainerConfig(ckpt_dir=str(tmp_path / "ref"),
                                  ckpt_every=2),
                   lambda p, o, s, b: rstep(p, o, jnp.asarray(s), b), rbatch)
    rparams, rstate, _ = rtr.run(params, ropt_.init(params), num_steps=2)

    tr, model, state = _lm_trainer(tmp_path / "ref")
    model, state, step = tr.restore(model, state)
    assert step == 2 and int(state.count) == 2
    for (path, g), w in zip(_leaves(convert.lm_params_to_numpy(model)),
                            jax.tree_util.tree_leaves(_np_tree(rparams))):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    for g, w in zip(jax.tree_util.tree_leaves(
            convert.to_reference_layout(state)),
            jax.tree_util.tree_leaves(rstate)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    init = convert.lm_params_to_numpy(model)
    model, state, _ = tr.run(model, state, num_steps=3, start_step=2)
    rparams, rstate, rmet = rstep(rparams, rstate, jnp.asarray(2), rbatch(2))
    np.testing.assert_allclose(tr.metrics_log[-1]["loss"],
                               float(rmet["loss"]), rtol=1e-5)
    # the third step's moments carry the two restored (equal) steps' too
    gstate = jax.tree_util.tree_map(lambda t: t.numpy(),
                                    convert.to_reference_layout(state))
    ill = _ill([gstate], [_np_tree(rstate)], first=3)
    _check_params(init, convert.lm_params_to_numpy(model),
                  _np_tree(rparams), ill)

    # the port's checkpoint (step 3) restores in the reference
    (rp, rs), step, _ = rtr.ckpt.restore_latest((rparams, rstate))
    assert step == 3
    for (path, g), w in zip(_leaves(_np_tree(rp)),
                            jax.tree_util.tree_leaves(
                                convert.lm_params_to_numpy(model))):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert rp["embed"].dtype == jnp.float32 and int(rs.count) == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    ptrain.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1}" in out
    assert "arch smollm-135m: 0.7M params" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done: 3 steps" in out
    ptrain.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done: 4 steps" in out
    assert [line.split()[1] for line in out.splitlines()
            if line.startswith("step ")] == ["3"]
