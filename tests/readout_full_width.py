"""The LM readout's train accuracy at full width, the reference's readout
beside the port's on the same hidden states (a check run by hand; pytest
does not collect it):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/readout_full_width.py

``chip_smoke.py`` phase 8b turns its synthetic 4-class token task (1024
sequences of 64 tokens) into smollm-135m's full-width hidden states on
the card (the seed-0 bf16 parameters) and reads them out with the port's
``DistributedDFRReadout`` (Nx = 30, beta 1e-2).  Here the same
parameters run the trunk on the CPU in fp32, in chunks, and the states
go as numpy to the reference's ``DistributedDFRReadout`` and to the
port's, both with the reference's mask, and to the port's with its own
mask (phase 8b's).  Printed: each train accuracy, the masked inputs'
spread and the share of reservoir states in tanh's saturated range
(|x| > 0.99) and their mean |x|, and the same for the features
normalised to zero mean and unit variance per channel; beside them, the
train accuracy of a ridge (beta 1e-2) on each sequence's mean state, to
tell whether the states carry the class.  About 2 minutes on 8 CPU
cores.
"""
import dataclasses
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (LM_ARCH, READOUT_BETA, READOUT_NODES,  # noqa: E402
                        READOUT_TASK, synth_task)
from repro.core.readout import DistributedDFRReadout as RReadout  # noqa: E402
from repro.core.readout import ReadoutConfig as RReadoutConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import masking, reservoir  # noqa: E402
from repro_torch.core.readout import (DistributedDFRReadout,  # noqa: E402
                                      ReadoutConfig)
from repro_torch.models.transformer import Transformer  # noqa: E402

SATURATED = 0.99
CHUNK = 64   # sequences a trunk call


def hidden_states(toks: np.ndarray) -> np.ndarray:
    """smollm-135m's trunk outputs (B, T, 576) in fp32 on the CPU, from
    phase 8b's seed-0 bf16 parameters."""
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.bfloat16)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.to(torch.float32)
    out = []
    with torch.no_grad():
        for i in range(0, len(toks), CHUNK):
            out.append(model._trunk(model._embed(toks[i:i + CHUNK]))[0])
    return torch.cat(out).numpy()


def port_accuracy(h: np.ndarray, labels: np.ndarray, mask) -> tuple:
    """(train accuracy, saturated share, mean |x| of the states, std of
    the masked inputs)."""
    cfg = ReadoutConfig(feature_dim=h.shape[-1], n_classes=int(
        labels.max()) + 1, n_nodes=READOUT_NODES)
    ro = DistributedDFRReadout(cfg, mask=mask, device="cpu")
    params, rs = ro.init()
    ht = torch.from_numpy(h)
    fit = ro.solve(ro.accumulate(rs, params, ht, labels), params,
                   READOUT_BETA)
    acc = float((ro.predict(fit, ht) == torch.from_numpy(labels)).float()
                .mean())
    j = masking.apply_mask(ro.mask, ht)
    x = reservoir.run_reservoir(params.p, params.q, j, f=cfg.dfr().f())
    sat = float((x.abs() > SATURATED).float().mean())
    return acc, sat, float(x.abs().mean()), float(j.std())


def pooled_ridge_accuracy(h: np.ndarray, labels: np.ndarray) -> float:
    """Train accuracy of a float64 ridge on [mean_t h, 1]."""
    x = np.concatenate([h.mean(1), np.ones((len(h), 1))], 1).astype(
        np.float64)
    y = np.eye(int(labels.max()) + 1)[labels]
    w = np.linalg.solve(x.T @ x + READOUT_BETA * np.eye(x.shape[1]), x.T @ y)
    return float(np.mean((x @ w).argmax(1) == labels))


def main() -> None:
    n, t, classes = (READOUT_TASK[k] for k in ("n", "seq", "classes"))
    toks, labels = synth_task(np.random.default_rng(1), n, t,
                              get_config(LM_ARCH).vocab, classes)
    t0 = time.perf_counter()
    h = hidden_states(toks)
    print(f"{LM_ARCH} trunk on {n} x {t} tokens, fp32 on the CPU: "
          f"{h.shape} in {time.perf_counter() - t0:.1f} s; |h| mean "
          f"{np.abs(h).mean():.3f}, max {np.abs(h).max():.3f}")
    ref = RReadout(RReadoutConfig(feature_dim=h.shape[-1], n_classes=classes,
                                  n_nodes=READOUT_NODES))
    for name, feats in (("raw", h), ("normalised", (h - h.mean((0, 1)))
                                     / (h.std((0, 1)) + 1e-6))):
        params, rs = ref.init()
        fit = ref.solve(ref.accumulate(rs, params, jnp.asarray(feats),
                                       jnp.asarray(labels)),
                        params, READOUT_BETA)
        racc = float(np.mean(np.asarray(ref.predict(fit, jnp.asarray(
            feats))) == labels))
        pacc, sat, xabs, jstd = port_accuracy(feats, labels,
                                              np.array(ref.mask))
        oacc, osat, _, _ = port_accuracy(feats, labels, None)
        print(f"{name} states: train accuracy reference {racc:.4f}, port "
              f"{pacc:.4f} (reference mask), port {oacc:.4f} (its own "
              f"mask); masked inputs std {jstd:.3f}; states mean |x| "
              f"{xabs:.4f}, with |x| > {SATURATED}: {sat:.4f} (own mask "
              f"{osat:.4f}); ridge on mean-pooled states "
              f"{pooled_ridge_accuracy(feats, labels):.4f}")


if __name__ == "__main__":
    main()
