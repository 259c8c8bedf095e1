"""The port's core modules against the JAX package, on the same numpy inputs.

Covers the reservoir (ring matrix and powers with q < 0, the length-frozen
scan), the DPRR, the full forward with its truncation boundary, the
truncated gradients (shared-forward and fused), the per-slot SGD update and
the dataset generator.  Each test states its tolerance; the reason is the
same throughout: both sides compute in fp32 and sum in different orders.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import backprop as rbp
from repro.core import dprr as rdprr
from repro.core import reservoir as rres
from repro.core.types import DFRParams as RParams
from repro.core.types import cached_nonlinearity
from repro.data import timeseries as rdata
from repro_torch.core import backprop as bp
from repro_torch.core import dprr, masking, reservoir
from repro_torch.core.types import DFRParams, Nonlinearity
from repro_torch.data import timeseries as data


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(b=4, t=15, nx=6, ny=3, seed=0, lengths=(15, 1, 7, 2)):
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(b, t, nx)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    W = (0.1 * rng.normal(size=(ny, nx * (nx + 1)))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(ny,))).astype(np.float32)
    labels = rng.integers(0, ny, b)
    onehot = np.eye(ny, dtype=np.float32)[labels]
    return j, lens, W, bias, onehot


def _params(p, q, W, bias):
    return (RParams(jnp.float32(p), jnp.float32(q), jnp.asarray(W),
                    jnp.asarray(bias)),
            DFRParams(torch.tensor(p), torch.tensor(q), _t(W), _t(bias)))


@pytest.mark.parametrize("q", [0.35, -0.4, 0.0])
def test_ring_matrix_and_powers_match_reference(q):
    """Exact-integer exponents on the same fp32 base: the two pow
    implementations agree to 1 ulp (rtol 1e-6), including the sign rule for
    q < 0 and 0^0 = 1 on the diagonal for q = 0."""
    nx = 9
    np.testing.assert_allclose(
        reservoir.ring_matrix(torch.tensor(q), nx).numpy(),
        np.asarray(rres.ring_matrix(jnp.float32(q), nx)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        reservoir.ring_powers(torch.tensor(q), nx).numpy(),
        np.asarray(rres.ring_powers(jnp.float32(q), nx)), rtol=1e-6, atol=0)


def test_ring_matrix_batched_over_systems():
    """Per-system q gives one ring matrix per system."""
    qs = np.asarray([0.3, -0.5], np.float32)
    got = reservoir.ring_matrix(_t(qs), 5).numpy()
    for s, q in enumerate(qs):
        np.testing.assert_allclose(
            got[s], np.asarray(rres.ring_matrix(jnp.float32(q), 5)),
            rtol=1e-6, atol=0)


@pytest.mark.parametrize("f_name,q", [("linear", 0.4), ("tanh", -0.5)])
def test_run_reservoir_with_lengths_matches_reference(f_name, q):
    """States frozen past each length; a 15-step fp32 recurrence reordered
    inside each step's matvec agrees to rtol 1e-5 / atol 1e-6."""
    j, lens, *_ = _case()
    want = rres.run_reservoir(jnp.float32(0.3), jnp.float32(q),
                              jnp.asarray(j), f=cached_nonlinearity(f_name, 1.0),
                              lengths=jnp.asarray(lens))
    got = reservoir.run_reservoir(torch.tensor(0.3), torch.tensor(q), _t(j),
                                  f=Nonlinearity(f_name), lengths=_t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # frozen past the length: the last row repeats x(length)
    np.testing.assert_array_equal(got[1, 0].numpy(), got[1, -1].numpy())


def test_compute_dprr_matches_reference():
    """Sums over 15 steps of products of O(1) states: rtol/atol 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 15, 6)).astype(np.float32)
    lens = np.asarray([15, 1, 7, 2], np.int32)
    want = rdprr.compute_dprr(jnp.asarray(x), lengths=jnp.asarray(lens))
    got = dprr.compute_dprr(_t(x), lengths=_t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        dprr.compute_dprr(_t(x)).numpy(),
        np.asarray(rdprr.compute_dprr(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f_name,with_lengths", [("linear", True),
                                                 ("mackey_glass", True),
                                                 ("tanh", False)])
def test_forward_every_field_matches_reference(f_name, with_lengths):
    """Every ForwardAux field, lengths 1 and T included, and the full-length
    default (rtol/atol 1e-5)."""
    j, lens, W, bias, _ = _case(seed=4)
    rp, tp = _params(0.3, -0.45, W, bias)
    want = rbp.forward(rp, jnp.asarray(j), cached_nonlinearity(f_name, 1.0),
                       lengths=jnp.asarray(lens) if with_lengths else None)
    got = bp.forward(tp, _t(j), Nonlinearity(f_name),
                     lengths=_t(lens) if with_lengths else None)
    for name in bp.ForwardAux._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-5, atol=1e-5, err_msg=name)


def _grad_close(got, want, rtol, atol):
    for k in "pqWb":
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_grads_truncated_from_aux_weighted_loss_matches_reference():
    """The serve step's weighted loss (w * CE, dead samples w = 0,
    core/online.py:511): loss and gradients of (p, q, W, b) agree to
    rtol 1e-4 / atol 1e-6 (autograd in two frameworks, fp32)."""
    j, lens, W, bias, onehot = _case(seed=5)
    w = np.asarray([1, 1, 0, 1], np.float32)
    rp, tp = _params(0.25, 0.3, W, bias)
    f_ref = cached_nonlinearity("tanh", 1.0)
    wj = jnp.asarray(w)

    @jax.jit
    def ref_grads(prm, j_seq, lengths, oh):
        aux = rbp.forward(prm, j_seq, f_ref, lengths=lengths)
        return rbp.grads_truncated_from_aux(
            prm, aux, oh, f_ref,
            loss_fn=lambda lg, o: wj * rbp.loss_from_logits(lg, o))

    lw, gw = ref_grads(rp, jnp.asarray(j), jnp.asarray(lens),
                       jnp.asarray(onehot))
    f = Nonlinearity("tanh")
    aux_t = bp.forward(tp, _t(j), f, lengths=_t(lens))
    wt = _t(w)
    lt, gt = bp.grads_truncated_from_aux(
        tp, aux_t, _t(onehot), f,
        loss_fn=lambda lg, oh: wt * bp.loss_from_logits(lg, oh))
    np.testing.assert_allclose(float(lt), float(lw), rtol=1e-5)
    _grad_close(gt, gw, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("q", [0.4, -0.3])
def test_forward_fused_backward_matches_reference(q):
    """The autograd.Function's closed-form backward vs the reference's
    custom VJP (rtol 1e-4 / atol 1e-6), and vs the port's own shared-forward
    autograd path, which it must equal as a truncated gradient."""
    j, lens, W, bias, onehot = _case(seed=6)
    rp, tp = _params(0.2, q, W, bias)
    f_ref = cached_nonlinearity("linear", 1.0)
    lr_, gr = jax.jit(
        lambda prm, j_seq, oh, lengths: rbp.grads_truncated_fused(
            prm, j_seq, oh, f_ref, lengths, backend="xla"))(
        rp, jnp.asarray(j), jnp.asarray(onehot), jnp.asarray(lens))
    f = Nonlinearity()
    lt, gt = bp.grads_truncated_fused(tp, _t(j), _t(onehot), f, _t(lens))
    np.testing.assert_allclose(float(lt), float(lr_), rtol=1e-5)
    _grad_close(gt, gr, rtol=1e-4, atol=1e-6)
    aux = bp.forward(tp, _t(j), f, lengths=_t(lens))
    la, ga = bp.grads_truncated_from_aux(tp, aux, _t(onehot), f)
    _grad_close(gt, DFRParams(*(x.numpy() for x in
                                (ga.p, ga.q, ga.W, ga.b))),
                rtol=1e-4, atol=1e-6)


def test_apply_sgd_clips_per_slot_like_vmapped_reference():
    """Slot 0's gradients are large enough to clip, slot 1's are not: each
    slot clips by its own norm, as the reference's vmap does (a single
    global norm over slots would shrink slot 1's step too).  Elementwise
    fp32 arithmetic: rtol 1e-6."""
    rng = np.random.default_rng(7)
    S, ny, nr = 3, 3, 12
    P = dict(p=np.asarray([0.01, 0.2, 0.4], np.float32),
             q=np.asarray([0.01, 0.3, 0.5], np.float32),
             W=rng.normal(size=(S, ny, nr)).astype(np.float32),
             b=rng.normal(size=(S, ny)).astype(np.float32))
    G = dict(p=np.asarray([5.0, 1e-3, 0.2], np.float32),
             q=np.asarray([-4.0, 2e-3, 0.1], np.float32),
             W=(rng.normal(size=(S, ny, nr)) * [[[30.0]], [[1e-3]], [[0.2]]]
                ).astype(np.float32),
             b=(rng.normal(size=(S, ny)) * [[30.0], [1e-3], [0.2]]
                ).astype(np.float32))
    lr = np.asarray([0.2, 0.2, 0.0], np.float32)
    inv = np.asarray([0.5, 1.0, 0.25], np.float32)
    want = jax.vmap(rbp.apply_sgd)(
        RParams(**{k: jnp.asarray(v) for k, v in P.items()}),
        RParams(**{k: jnp.asarray(v) for k, v in G.items()}),
        jnp.asarray(lr), jnp.asarray(lr), jnp.asarray(inv))
    got = bp.apply_sgd(DFRParams(**{k: _t(v) for k, v in P.items()}),
                       DFRParams(**{k: _t(v) for k, v in G.items()}),
                       _t(lr), _t(lr), _t(inv))
    for k in "pqWb":
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # slot 1 took its full unclipped step
    np.testing.assert_allclose(got.W[1].numpy(),
                               P["W"][1] - 0.2 * G["W"][1], rtol=1e-6)


def test_make_mask_selects_one_signed_channel_per_node():
    """The port draws its own mask (torch.Generator cannot replay
    jax.random): each node reads one input channel with sign +/-1, and a
    seed fixes the draw."""
    m = masking.make_mask(torch.Generator().manual_seed(3), 30, 13)
    assert m.shape == (30, 13) and m.dtype == torch.float32
    assert torch.equal((m != 0).sum(dim=1), torch.ones(30, dtype=torch.int64))
    assert set(m[m != 0].tolist()) <= {-1.0, 1.0}
    assert torch.equal(m, masking.make_mask(torch.Generator().manual_seed(3),
                                            30, 13))


@pytest.mark.parametrize("name,cap", [("ARAB", 40), ("JPVOW", 30)])
def test_load_is_byte_identical_to_reference(name, cap):
    want_tr, want_te = rdata.load(name, seed=1, size_cap=cap)
    got_tr, got_te = data.load(name, seed=1, size_cap=cap)
    for got, want in ((got_tr, want_tr), (got_te, want_te)):
        for field in ("u", "length", "label"):
            g = getattr(got, field).numpy()
            w = np.asarray(getattr(want, field))
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), field


def test_core_exports_every_reference_name_but_the_multi_device_readout():
    """Every public name of ``repro.core`` has its counterpart in
    ``repro_torch.core``: since the multi-device readout is ported
    (tests/test_torch_readout.py), the two export sets are equal."""
    import repro.core as rcore
    import repro_torch.core as core

    def exports(pkg):
        return {n for n in dir(pkg) if not n.startswith("_")
                and not type(getattr(pkg, n)).__name__ == "module"}

    assert exports(core) == exports(rcore)
