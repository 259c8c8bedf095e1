"""Synthetic multivariate time-series classification data (paper Table 4).

A copy of the generator in ``repro.data.timeseries``: class-separable
synthetic series with exactly the Table 4 statistics (#V channels, #C
classes, Train/Test sizes, Tmin/Tmax lengths).  The arrays are numpy, seeded
by ``zlib.crc32`` of the dataset name, so both packages produce the same
bytes for the same seed; ``load`` returns them as CPU tensors.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.types import TimeSeriesBatch


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_in: int       # V
    n_classes: int  # C
    n_train: int
    n_test: int
    t_min: int
    t_max: int


# Paper Table 4, verbatim.
PAPER_DATASETS: Dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        DatasetSpec("ARAB", 13, 10, 6600, 2200, 4, 93),
        DatasetSpec("AUS", 22, 95, 1140, 1425, 45, 136),
        DatasetSpec("CHAR", 3, 20, 300, 2558, 109, 205),
        DatasetSpec("CMU", 62, 2, 29, 29, 127, 580),
        DatasetSpec("ECG", 2, 2, 100, 100, 39, 152),
        DatasetSpec("JPVOW", 12, 9, 270, 370, 7, 29),
        DatasetSpec("KICK", 62, 2, 16, 10, 274, 841),
        DatasetSpec("LIB", 2, 15, 180, 180, 45, 45),
        DatasetSpec("NET", 4, 13, 803, 534, 50, 994),
        DatasetSpec("UWAV", 3, 8, 200, 427, 315, 315),
        DatasetSpec("WAF", 6, 2, 298, 896, 104, 198),
        DatasetSpec("WALK", 62, 2, 28, 16, 128, 1918),
    ]
}


def _gen_class_params(rng: np.random.Generator, n_classes: int, n_in: int):
    """Per-class prototype curves: a small bank of sinusoidal harmonics per
    channel (class-specific amplitudes, cycle counts and phases)."""
    n_h = 4
    amp = rng.uniform(0.3, 1.0, (n_classes, n_in, n_h))
    cycles = rng.uniform(0.5, 4.0, (n_classes, n_in, n_h))
    phase = rng.uniform(0, 2 * np.pi, (n_classes, n_in, n_h))
    return amp, cycles, phase


def _synth_one(
    rng: np.random.Generator,
    t_len: int,
    amp: np.ndarray,     # (n_in, n_h)
    cycles: np.ndarray,  # (n_in, n_h)
    phase: np.ndarray,   # (n_in, n_h)
    noise: float,
) -> np.ndarray:
    """One time-warped, scaled rendering of a class prototype plus AR(1)
    observation noise, z-normalized per channel."""
    n_in = amp.shape[0]
    warp = rng.uniform(0.85, 1.15)
    offs = rng.uniform(-0.05, 0.05)
    scale = rng.uniform(0.8, 1.25)
    frac = (np.arange(t_len) / max(t_len - 1, 1))[:, None, None]  # (T,1,1)
    curves = amp[None] * np.sin(
        2 * np.pi * cycles[None] * (warp * frac + offs) + phase[None]
    )
    x = scale * curves.sum(-1)  # (T, n_in)
    e = rng.normal(0, noise, (t_len, n_in))
    ar = np.zeros_like(e)
    for t in range(t_len):
        ar[t] = (0.6 * ar[t - 1] if t else 0.0) + e[t]
    x = x + ar
    mu, sd = x.mean(0, keepdims=True), x.std(0, keepdims=True) + 1e-6
    return (x - mu) / sd


def make_dataset(
    spec: DatasetSpec,
    seed: int = 0,
    noise: float = 0.3,
    size_cap: int | None = None,
) -> Tuple[TimeSeriesBatch, TimeSeriesBatch]:
    """Generate (train, test) batches with the spec's exact statistics;
    ``size_cap`` bounds Train/Test counts, keeping every class."""
    rng = np.random.default_rng(seed + zlib.crc32(spec.name.encode()) % (2**31))
    amp, cycles, phase = _gen_class_params(rng, spec.n_classes, spec.n_in)

    def gen_split(n: int, split_seed: int) -> TimeSeriesBatch:
        srng = np.random.default_rng(split_seed)
        labels = np.arange(n) % spec.n_classes  # balanced
        srng.shuffle(labels)
        lengths = srng.integers(spec.t_min, spec.t_max + 1, n)
        u = np.zeros((n, spec.t_max, spec.n_in), np.float32)
        for i in range(n):
            c = labels[i]
            u[i, : lengths[i]] = _synth_one(
                srng, int(lengths[i]), amp[c], cycles[c], phase[c], noise,
            )
        return TimeSeriesBatch(
            u=torch.from_numpy(u),
            length=torch.from_numpy(lengths.astype(np.int32)),
            label=torch.from_numpy(labels.astype(np.int32)),
        )

    n_train, n_test = spec.n_train, spec.n_test
    if size_cap is not None:
        n_train = max(min(n_train, size_cap), spec.n_classes)
        n_test = max(min(n_test, size_cap), spec.n_classes)
    return gen_split(n_train, seed * 2 + 1), gen_split(n_test, seed * 2 + 2)


def load(name: str, seed: int = 0, size_cap: int | None = None):
    """Load a paper dataset by Table 4 name (synthetic; see module doc)."""
    return make_dataset(PAPER_DATASETS[name.upper()], seed=seed,
                        size_cap=size_cap)
