"""Synthetic multivariate time-series classification data (paper Table 4),
and the NARMA10 regression and drift fixtures.

A copy of the generators in ``repro.data.timeseries``: class-separable
synthetic series with exactly the Table 4 statistics (#V channels, #C
classes, Train/Test sizes, Tmin/Tmax lengths).  The arrays are numpy, seeded
by ``zlib.crc32`` of the dataset name, so both packages produce the same
bytes for the same seed; ``load`` returns them as CPU tensors.  The NARMA10
series (``make_narma10``) and its piecewise-stationary drift streams
(``make_drift_label_streams``, ``drift_segment_bounds``: the stream
server's retirement benchmark) are numpy throughout, the reference's
arrays exactly.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.types import RegressionBatch, TimeSeriesBatch  # noqa: F401


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


# ---------------------------------------------------------------------------
# NARMA10: the standard reservoir-computing regression benchmark (used by the
# population engine's NRMSE fitness and its tests).
# ---------------------------------------------------------------------------


def narma10_series(n_steps: int, seed: int = 0, order: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """One NARMA-``order`` input/output sequence.

        y(t+1) = 0.3 y(t) + 0.05 y(t) sum_{i=0..9} y(t-i)
                 + 1.5 u(t-9) u(t) + 0.1,    u(t) ~ U[0, 0.5]

    Returns (u, y), both (n_steps,) float32.  The recurrence is run with
    zero history for t < order (the usual washout convention).
    """
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 0.5, n_steps).astype(np.float64)
    y = np.zeros(n_steps, np.float64)
    for t in range(n_steps - 1):
        window = y[max(0, t - order + 1): t + 1].sum()
        y[t + 1] = (0.3 * y[t] + 0.05 * y[t] * window
                    + 1.5 * u[max(0, t - order + 1)] * u[t] + 0.1)
    return u.astype(np.float32), y.astype(np.float32)


NARMA_COEFFS = (0.3, 0.05, 1.5, 0.1)
"""The standard NARMA10 recurrence coefficients (a, b, c, d) in
y(t+1) = a y(t) + b y(t) sum_i y(t-i) + c u(t-9) u(t) + d."""


def narma_series_coeffs(
    n_steps: int,
    seed: int = 0,
    order: int = 10,
    coeffs: np.ndarray | Tuple[float, float, float, float] = NARMA_COEFFS,
) -> Tuple[np.ndarray, np.ndarray]:
    """``narma10_series`` with per-step recurrence coefficients.

    ``coeffs`` is either one (a, b, c, d) tuple (stationary - identical to
    ``narma10_series`` for the default coefficients) or an (n_steps, 4)
    array giving the coefficients used to *produce* each y[t] - the
    piecewise-stationary drift hook.  Raises ``ValueError`` if the chosen
    coefficients drive the recurrence non-finite (unstable regime).
    """
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 0.5, n_steps).astype(np.float64)
    cf = np.broadcast_to(
        np.asarray(coeffs, np.float64), (n_steps, 4)
    )
    y = np.zeros(n_steps, np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(n_steps - 1):
            a, b, c, d = cf[t + 1]
            window = y[max(0, t - order + 1): t + 1].sum()
            y[t + 1] = (a * y[t] + b * y[t] * window
                        + c * u[max(0, t - order + 1)] * u[t] + d)
    if not np.isfinite(y).all():
        raise ValueError("NARMA recurrence diverged for these coefficients")
    return u.astype(np.float32), y.astype(np.float32)


def make_narma10_drift(
    n_samples: int = 400,
    t_len: int = 32,
    seed: int = 0,
    switch_frac: float = 0.5,
    coeffs_a: Tuple[float, float, float, float] = NARMA_COEFFS,
    coeffs_b: Tuple[float, float, float, float] = (0.2, 0.04, 1.0, 0.3),
    order: int = 10,
) -> Tuple[RegressionBatch, Dict]:
    """One piecewise-stationary (drifting) NARMA stream, in serving order.

    The recurrence runs under ``coeffs_a`` up to the drift point and under
    ``coeffs_b`` after it: the exogenous input distribution never changes,
    only the input->output dynamics - the regime a deployed reservoir
    readout faces when the plant behind a sensor drifts.  Windows are cut
    stride-1 in time order (no shuffling: sample i is served before sample
    i+1), and the switch lands exactly at sample ``switch_sample =
    floor(n_samples * switch_frac)``: that window's target is the first
    value produced by the ``coeffs_b`` recurrence.

    Returns ``(batch, info)``: a ``RegressionBatch`` with u (N, t_len, 1) /
    length (N,) / y (N, 1), and an info dict with ``switch_sample``,
    ``switch_step`` (the underlying series index where the coefficients
    change) and both coefficient tuples.  Deterministic per ``seed``.
    """
    if not 0.0 < switch_frac < 1.0:
        raise ValueError(f"switch_frac must be in (0, 1), got {switch_frac!r}")
    n_steps = order + n_samples + t_len
    switch_sample = int(n_samples * switch_frac)
    # y[idx] is window i's target for idx = order + i + t_len - 1: regime B
    # from the switch sample's target onward
    switch_step = order + switch_sample + t_len - 1
    cf = np.empty((n_steps, 4), np.float64)
    cf[:switch_step] = coeffs_a
    cf[switch_step:] = coeffs_b
    u, y = narma_series_coeffs(n_steps, seed=seed, order=order, coeffs=cf)
    starts = order + np.arange(n_samples)
    uw = np.stack([u[s: s + t_len] for s in starts])[..., None]
    yw = y[starts + t_len - 1][:, None]
    batch = RegressionBatch(
        u=uw.astype(np.float32),
        length=np.full(n_samples, t_len, np.int32),
        y=yw.astype(np.float32),
    )
    info = {
        "switch_sample": switch_sample,
        "switch_step": switch_step,
        "coeffs_a": tuple(coeffs_a),
        "coeffs_b": tuple(coeffs_b),
    }
    return batch, info


def quantize_targets(
    y: np.ndarray,
    n_classes: int,
    edges: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bin continuous targets into ``n_classes`` ordinal labels.

    ``edges`` defaults to the equal-mass quantile edges of ``y`` itself;
    pass edges computed on a reference segment (e.g. the pre-drift regime)
    to make a distribution shift visible as label-space movement.  Returns
    (labels int32 (N,), edges (n_classes - 1,)).
    """
    y = np.asarray(y).reshape(-1)
    if edges is None:
        qs = np.linspace(0, 1, n_classes + 1)[1:-1]
        edges = np.quantile(y, qs)
    edges = np.asarray(edges, y.dtype)
    return np.digitize(y, edges).astype(np.int32), edges


def make_drift_label_streams(
    n_streams: int,
    n_samples: int,
    t_len: int,
    n_classes: int,
    seed: int = 0,
    seed_stride: int = 17,
) -> Tuple[list, list]:
    """Drifting NARMA streams as classification-serving arrays.

    One ``make_narma10_drift`` stream per rid (seeds strided so streams are
    independent), targets quantized to ``n_classes`` ordinal labels with
    *full-stream* quantile edges - the edges span both regimes, so the
    drift shows up as the input->label mapping moving, not as unseen
    labels.  Returns (streams, switches): each stream is a dict with
    ``u`` (N, t_len, 1) f32, ``length`` (N,) i32 and ``label`` (N,) i32 -
    ready to wrap in a serving request - and ``switches`` the per-stream
    drift sample.  Shared by the drift benchmark and the drift example so
    both report on identical data.
    """
    streams, switches = [], []
    for rid in range(n_streams):
        batch, info = make_narma10_drift(
            n_samples=n_samples, t_len=t_len, seed=seed + seed_stride * rid
        )
        labels, _ = quantize_targets(np.asarray(batch.y), n_classes)
        streams.append({
            "u": np.asarray(batch.u),
            "length": np.asarray(batch.length),
            "label": labels.astype(np.int32),
        })
        switches.append(info["switch_sample"])
    return streams, switches


def drift_segment_bounds(
    n_samples: int, switch_sample: int, window: int
) -> Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
    """The shared (pre, at, post) index bounds for drift-recovery accuracy.

    ``seg = max(window, n_samples // 5)``: *pre* is the seg samples before
    the switch, *at* the seg/2 right after it (where every policy craters
    - no oracle knows the plant changed), *post* the stream tail (where
    retirement policies have had time to re-track).  One definition so the
    benchmark drift table and the example always report comparable
    segments.  Raises ``ValueError`` when the segments do not fit around
    the switch (e.g. an extreme ``switch_frac``): a silent negative bound
    would slice an empty range and report NaN accuracy downstream.
    """
    seg = max(window, n_samples // 5)
    if switch_sample < seg or switch_sample + seg // 2 > n_samples:
        raise ValueError(
            f"accuracy segments of {seg} samples do not fit around "
            f"switch_sample={switch_sample} in n_samples={n_samples}"
        )
    return (
        (switch_sample - seg, switch_sample),
        (switch_sample, switch_sample + seg // 2),
        (n_samples - seg, n_samples),
    )


def make_narma10(
    n_train: int = 200,
    n_test: int = 100,
    t_len: int = 32,
    seed: int = 0,
    order: int = 10,
) -> Tuple[RegressionBatch, RegressionBatch]:
    """NARMA10 framed as sequence -> scalar regression for the DFR pipeline.

    Overlapping windows of length ``t_len`` are cut from one long series;
    each window's target is the NARMA output aligned with its last input
    step.  Train windows precede test windows in time, with a ``t_len``-step
    gap between the last train window and the first test window so no test
    window shares any input step (or adjacent target) with a train window.
    """
    n_total = n_train + n_test
    u, y = narma10_series(order + n_total + 2 * t_len, seed=seed, order=order)
    starts = order + np.arange(n_total)
    starts[n_train:] += t_len  # leakage gap between the splits
    uw = np.stack([u[s: s + t_len] for s in starts])[..., None]  # (B, T, 1)
    yw = y[starts + t_len - 1][:, None]                          # (B, 1)
    lengths = np.full(n_total, t_len, np.int32)

    def split(lo: int, hi: int) -> RegressionBatch:
        return RegressionBatch(
            u=uw[lo:hi].astype(np.float32),
            length=lengths[lo:hi],
            y=yw[lo:hi].astype(np.float32),
        )

    return split(0, n_train), split(n_train, n_total)
