"""The LM-feature readout (``repro_torch.core.readout``) against the
reference's ``DistributedDFRReadout(axis_names=())``, and over two gloo
ranks against one.

Both packages run one readout on the same (B, T, D) features and the
reference readout's mask (its 1/sqrt(D) scale included), carried over as
numpy.  On the CPU the port's features run the plain versions of K6 and
K7, its SGD forward K1's plain version and its solve the library solve.

Tolerances (the ones the port's tests use):
  * features, (A, B) and one SGD step: rtol 1e-4 / atol 1e-5 (the same
    fp32 arithmetic, sums in another order);
  * the ridge solve: max |dW| <= 2e-4 max |W|;
  * predictions: at least 0.98 agree.
Two ranks, each on half the batch, sum their (A, B) and their gradients
with one ``all_reduce``: their W and their SGD step are held to the same
tolerances against one rank's, and the ranks to each other bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.readout import DistributedDFRReadout as RReadout
from repro.core.readout import ReadoutConfig as RReadoutConfig
from repro_torch import convert
from repro_torch.core import masking
from repro_torch.core.readout import DistributedDFRReadout, ReadoutConfig
from test_torch_distributed import run_ranks

TOL = dict(rtol=1e-4, atol=1e-5)
W_REL = 2e-4
AGREE = 0.98
B, T, D, NY, NX = 16, 12, 24, 3, 6
BETA = 1e-2


def _inputs():
    rng = np.random.default_rng(7)
    return dict(h=rng.normal(size=(B, T, D)).astype(np.float32),
                label=rng.integers(0, NY, B).astype(np.int32),
                lengths=rng.integers(2, T + 1, B).astype(np.int32))


def _pair():
    ref = RReadout(RReadoutConfig(feature_dim=D, n_classes=NY, n_nodes=NX))
    port = DistributedDFRReadout(
        ReadoutConfig(feature_dim=D, n_classes=NY, n_nodes=NX),
        mask=convert.mask_from_numpy(np.asarray(ref.mask)), device="cpu")
    return ref, port


@pytest.mark.parametrize("ragged", [False, True])
def test_readout_matches_reference(ragged):
    """features, accumulate, solve and predict against the reference's
    single-device readout, with and without per-sample lengths."""
    ref, port = _pair()
    x = _inputs()
    ln = x["lengths"] if ragged else None
    rln = None if ln is None else jnp.asarray(ln)
    rparams, rridge = ref.init()
    params, rs = port.init()
    np.testing.assert_array_equal(params.p.numpy(), np.asarray(rparams.p))
    h, rh = torch.from_numpy(x["h"]), jnp.asarray(x["h"])
    r = port.features(params, h, None if ln is None else torch.tensor(ln))
    np.testing.assert_allclose(r.numpy(),
                               np.asarray(ref.features(rparams, rh, rln)),
                               **TOL)
    rs = port.accumulate(rs, params, h, torch.from_numpy(x["label"]),
                         None if ln is None else torch.tensor(ln))
    rrs = ref.accumulate(rridge, rparams, rh, jnp.asarray(x["label"]), rln)
    for name in ("A", "B", "count", "factor_beta"):
        np.testing.assert_allclose(getattr(rs, name).numpy(),
                                   np.asarray(getattr(rrs, name)), **TOL,
                                   err_msg=name)
    fit = port.solve(rs, params, BETA)
    rfit = ref.solve(rrs, rparams, jnp.float32(BETA))
    rW = np.asarray(rfit.W)
    assert np.abs(fit.W.numpy() - rW).max() <= W_REL * np.abs(rW).max()
    assert np.abs(fit.b.numpy() - np.asarray(rfit.b)).max() <= (
        W_REL * np.abs(rW).max())
    preds = port.predict(fit, h, None if ln is None else torch.tensor(ln))
    rpreds = np.asarray(ref.predict(rfit, rh, rln))
    assert float((preds.numpy() == rpreds).mean()) >= AGREE


def test_readout_sgd_step_matches_reference():
    """One truncated-BP SGD step (K1's forward on the card, its plain
    version here) against the reference's step."""
    ref, port = _pair()
    x = _inputs()
    rparams, _ = ref.init()
    params, _ = port.init()
    # start from a nonzero readout, so the step moves (p, q) too
    W0 = np.random.default_rng(3).normal(
        scale=0.1, size=tuple(params.W.shape)).astype(np.float32)
    params.W = torch.from_numpy(W0.copy())
    rparams = type(rparams)(p=rparams.p, q=rparams.q, W=jnp.asarray(W0),
                            b=rparams.b)
    new, loss = port.sgd_step(params, torch.from_numpy(x["h"]),
                              torch.from_numpy(x["label"]), 0.1, 0.1,
                              torch.from_numpy(x["lengths"]))
    rnew, rloss = ref.sgd_step(rparams, jnp.asarray(x["h"]),
                               jnp.asarray(x["label"]), jnp.float32(0.1),
                               jnp.float32(0.1), jnp.asarray(x["lengths"]))
    for name in ("p", "q", "W", "b"):
        np.testing.assert_allclose(getattr(new, name).numpy(),
                                   np.asarray(getattr(rnew, name)), **TOL,
                                   err_msg=name)
    assert float(new.p) != float(params.p)
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)


def test_readout_default_mask_and_device():
    """The default mask is the port's seeded draw scaled by 1/sqrt(D); the
    default device is the card, and raises on a host without one."""
    cfg = ReadoutConfig(feature_dim=D, n_classes=NY, n_nodes=NX)
    ro = DistributedDFRReadout(cfg, device="cpu")
    want = masking.make_mask(torch.Generator().manual_seed(cfg.mask_seed),
                             NX, D, torch.float32) / math.sqrt(D)
    assert torch.equal(ro.mask, want)
    assert ro.dfr_cfg.s == NX * NX + NX + 1 and ro.group is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DistributedDFRReadout(cfg)


READOUT_BODY = '''
from repro_torch.core.readout import DistributedDFRReadout, ReadoutConfig


def run(rank, world, inputs, group):
    ro = DistributedDFRReadout(
        ReadoutConfig(feature_dim=int(inputs["dims"][0]),
                      n_classes=int(inputs["dims"][1]),
                      n_nodes=int(inputs["dims"][2])),
        group=group, mask=torch.from_numpy(inputs["mask"]), device="cpu")
    b = inputs["h"].shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    h, label, ln = (torch.from_numpy(inputs[k][sl])
                    for k in ("h", "label", "lengths"))
    params, rs = ro.init()
    rs = ro.accumulate(rs, params, h, label, ln)
    fit = ro.solve(rs, params, float(inputs["beta"]))
    params.W = torch.from_numpy(inputs["W0"])
    new, loss = ro.sgd_step(params, h, label, 0.1, 0.1, ln)
    return dict(W=fit.W.numpy(), b=fit.b.numpy(), p=new.p.numpy(),
                q=new.q.numpy(), W1=new.W.numpy(), b1=new.b.numpy(),
                loss=loss.numpy())
'''


def test_readout_two_gloo_ranks_match_one(tmp_path):
    """Two gloo ranks on the CPU, each with half the batch: one
    ``all_reduce`` of (A, B) gives both the one-rank W, and one of the loss,
    the gradients and the batch size the one-rank SGD step; the ranks agree
    bit for bit."""
    ref, port = _pair()
    x = _inputs()
    W0 = np.random.default_rng(3).normal(
        scale=0.1, size=(NY, NX * (NX + 1))).astype(np.float32)
    inputs = dict(x, mask=np.asarray(ref.mask), W0=W0, beta=np.float32(BETA),
                  dims=np.array([D, NY, NX]))
    ranks = run_ranks(tmp_path, READOUT_BODY, inputs)
    params, rs = port.init()
    h, label, ln = (torch.from_numpy(x[k]) for k in ("h", "label", "lengths"))
    fit = port.solve(port.accumulate(rs, params, h, label, ln), params, BETA)
    params.W = torch.from_numpy(W0.copy())
    new, loss = port.sgd_step(params, h, label, 0.1, 0.1, ln)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    W = fit.W.numpy()
    for k, want in (("W", W), ("b", fit.b.numpy())):
        assert np.abs(ranks[0][k] - want).max() <= W_REL * np.abs(W).max()
    for k, want in (("p", new.p), ("q", new.q), ("W1", new.W),
                    ("b1", new.b), ("loss", loss)):
        np.testing.assert_allclose(ranks[0][k], want.numpy(), **TOL,
                                   err_msg=k)
    preds = port.predict(fit, h, ln).numpy()
    fit.W, fit.b = (torch.from_numpy(ranks[0][k]) for k in ("W", "b"))
    assert float((port.predict(fit, h, ln).numpy() == preds).mean()) >= AGREE
