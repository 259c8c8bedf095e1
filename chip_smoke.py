#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one CUDA device (an H100; the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. TF32 off for matmuls and cuDNN (the s=931 ridge solves need full
     fp32), and bf16 matmuls with fp32 reductions only; print the card's
     name and power limit.
  2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once, printing ptxas's registers and
     spills (none of the kernels may spill); count HGMMA
     (wgmma) and UTMALDG (TMA load) instructions in K8's library and IMMA
     (mma.sync on int8) in K5's with cuobjdump, and fail if any is 0.
     Measure the dependent-chain cycles of one warp on the card
     (launch/chain_latency.py) for phase 3's chain bounds.
  3. Each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, with times: K1 (training forward), K2
     (streaming logits) and K5 (int8 streaming logits, int32 accumulators
     equal bit for bit) at 32 slots x a window of 4 = 128 samples, T=93,
     Nx=30, Ny=10, ragged lengths with 0, 1, 2, 16, 17 and T among them
     (around the kernels' chunks of 16 steps), each beside its chain bound
     (the longest live length times one step's dependent chain at the
     maximum SM clock); K3 (factor fold) at 32
     factors of 931 x 931 and windows of 4 rows, sign +1, and sign -1 with
     one guard-skipped rotation, whether it equals its plain version bit for
     bit, timed beside its byte bound and its chain bound, then with the
     retirement modes' operands: the forget scale sqrt(0.95) on live rows
     and a flagged downdate that the guard skips in 3 of the 32 factors,
     each required equal to its plain version bit for bit (flags too) and
     timed beside the unscaled fold and its bound; K6 (reservoir
     states) and K7 (DPRR) on the ARAB training split, at fit_sgd's
     minibatch of 4 (the shape of nearly all their launches in a fit), a
     fit_ridge chunk of 256 samples and all 6600, each timed beside its byte
     bound, K6 beside its chain bound and with its frozen rows equal to the
     last live state, and K7 beside one torch.bmm; K4a (tile
     Cholesky) on the blocked solve's diagonal tiles (at s=931 with tiles
     of 128), timed on one tile of 128 and one of 256 beside
     torch.linalg.cholesky_ex; K4b (tile triangular solves) on every solve
     of that blocked solve, timed on its 896-row panel and its 16-row
     (Ny padded to 8) right-hand side, each forward and backward, beside
     torch.linalg.solve_triangular; the blocked ridge solve at s=931
     against the unblocked library solve over the beta sweep, with tiles
     of 128 and 256.
  4. The port's main paths at full width: the paper's ARAB configuration
     (Nx=30, linear f, 13 inputs, 10 classes, s=931), its full 6600-sample
     training set split into 64 streams, served by StreamServer with 32
     slots and windows of 4, each round replayed from the server's CUDA
     graphs (the default on the card).  A server serves the 64 streams
     twice: a warm-up wave (the kernels' first loads, the graphs' capture),
     then the measured wave, with every launch count set to 0 before it
     and read after it:
       fp32   - recompute refresh: K1 and K2 once per round;
       int8   - quantize='int8', refresh_mode='incremental': K1, K2, K5 and
                K3 once per round.
     Printed: samples/s, p50/p99 of a dispatch, graph replays and eager
     bodies a round, the server's peak memory (allocated and reserved).
  4b. The measured wave of each path under torch.profiler, through the
     captured round, the eager round and the pipelined, blocked round: the
     device's busy time a round and idle share, the graph launches and the
     kernel launches and copies outside graphs a round, and the kernels and
     host ops that take the time.
  4c. Each path through the captured round, the eager round (the captured
     round's oracle, reached through the server's private attribute) and
     the captured round at pipeline_depth=2, step_block=4, alternated
     (captured, eager, pipelined, pipelined, eager, captured): each run's
     numbers, and every run must serve the first captured run's
     predictions and end with its final states bit for bit.
  4d. The retirement modes at ARAB's full width, each with the incremental
     refresh on the same 64 streams (benchmarks/bench_stream.py's
     settings): forget at lambda 0.95, a window of half a stream (52 rows),
     adaptive on its defaults, and adaptive with quantize='int8'.  For each,
     the captured, eager and pipelined (depth 2, blocks of 4) rounds
     alternate as in phase 4c and must serve the same predictions and end
     with the same states and window rings bit for bit; every kernel of
     the path launches its count a round (K3 twice under window: the fold
     and the flagged downdate) and no other; each live factor still
     factors its statistics.  Printed: each run's samples/s and dispatch
     p50/p99, and from one profiled captured wave the device's busy time
     and K3's time a round.
  4e. The reference's drift cells (S4/N160/W4 at Nx 8 and 16, phase_steps
     3, refresh_every 2, incremental, lambda 0.95, a window of 40) through
     the captured round: the pre/at/post-drift accuracy of baseline,
     forget, window and adaptive (and adaptive's plain, blocked and int8
     rows) beside BENCH_stream_drift.json's columns; each retirement
     policy's post-drift accuracy must beat the baseline's by 0.3.
  5. Agreement: a reduced episode of each kind (8 streams on 4 slots, the
     first 800 ARAB samples, same widths) served on the card and on the CPU;
     each retirement path on the first 400.
  6. The training path at full width: DFRModel.fit(train, minibatch=4) on
     the whole ARAB training split (6600 samples, Nx=30, s=931, FIT_EPOCHS
     epochs, the paper's recipe with select='val'), with every launch count
     set to 0 before it and read after it (K6, K7, K4a and K4b); the wall
     time of the SGD and of the ridge fits, the chosen beta, the train and
     test accuracy.  Then OnlineDFR streamed over the training split in
     windows of 8, refresh_output(1e-2) and its accuracy, each call's
     launches read apart: at ONLINE_LR, and at the reference test's 0.5,
     whose refresh must be finite on the card exactly when it is on the
     CPU.  torch.profiler over one fit_ridge and over one
     SGD epoch of 256 samples: the device's busy share and top kernels.
  7. Card against CPU on a reduced fit (Nx=30, the first 512 ARAB training
     samples, 2 epochs): the same beta, at least 0.98 of the test split's
     predictions equal, and |dW| / max |W|.
  8. The LM main path at full width: smollm-135m (configs/smollm_135m.py, 30
     layers, d_model 576, 9 query heads over 3 KV heads, head_dim 64) with
     attn_impl='pallas', bf16, parameters from the port's seeded init.
     make_prefill_step at each PREFILL_SHAPES (B, T), with K8's launch count
     set to 0 before each and read after (one launch a layer, 30); the wall
     time, prefill tokens/s and peak memory.  One prefill under
     torch.profiler: the device's busy share and K8's share of the device
     time.  The continuous-batching Server with launch/serve.py's defaults
     (16 requests of 32 tokens, max_tokens 16, max_batch 8, max_len 256):
     tokens/s, p50/p99 request latency, steps; K8 launches 0 times there,
     since decode attention is plain in both packages.  One wave of 8 short
     requests under torch.profiler: the device's busy share of the decode
     steps, their launches a step, the top kernels and host ops.
  9. Card against CPU for the LM at full width: a prefill of B=2, T=256
     (|dlogits| <= 1e-3 max |logits| in fp32, 2e-2 in bf16, argmax equal
     in both) and the Server on 4 requests (greedy tokens equal on >= 0.98
     of them in fp32; printed without a check in bf16).
Phase 3 also holds K8 (flash attention) against its plain version at the
prefill's two shapes (B=4, H=9, KV=3, T=4096 and B=1, T=32768, D=64,
causal, bf16) on transposed views of (B, T, H, D) buffers as the model
passes them (and at T=4096 also contiguous), Minitron's head layout (B=1,
H=32, KV=8, T=2048, D=128), a windowed and a ragged non-causal case, all
on K8's bf16 route (wgmma on the tensor cores, K/V tiles by TMA), and two
fp32 cases (causal, and windowed) on its SIMT route, each with its
effective TFLOP/s beside the bound's and the time of
torch.nn.functional.scaled_dot_product_attention on the same inputs (timed
here only; the port never calls it).  K8's JSON record also names both
routes.
The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.  Exits non-zero, printing no result, without a CUDA
device or without the repository's sources.
"""
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.dfr_paper import paper_dfr_config  # noqa: E402
from repro_torch.core import masking, ridge  # noqa: E402
from repro_torch.core.dfr import DFRModel  # noqa: E402
from repro_torch.core.online import OnlineDFR  # noqa: E402
from repro_torch.core.types import (DFRConfig, TimeSeriesBatch,  # noqa: E402
                                    map_leaves)
from repro_torch.data import (drift_segment_bounds, load,  # noqa: E402
                               make_drift_label_streams)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import cholesky as k_cholesky  # noqa: E402
from repro_torch.kernels import cholupdate as k_cholupdate  # noqa: E402
from repro_torch.kernels import dprr as k_dprr  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import reservoir as k_reservoir  # noqa: E402
from repro_torch.kernels import ridge_solve as k_ridge  # noqa: E402
from repro_torch.kernels import streaming as k_streaming  # noqa: E402
from repro_torch.kernels import streaming_q8 as k_streaming_q8  # noqa: E402
from repro_torch.kernels import train as k_train  # noqa: E402
from repro_torch.launch import chain_latency  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402
from repro_torch.models.lm import make_prefill_step  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.runtime import (Request, Server, StreamRequest,  # noqa: E402
                                 StreamServer)

PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_INT8_OP_S = 1979e12   # H100 SXM int8, dense
PEAK_BF16_FLOP_S = 989e12  # H100 SXM bf16 tensor cores, dense
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order
K3_REL = 1e-4   # K3: max |dLt| <= K3_REL * max |Lt| (rotations divide)
# phase 3 at the server's shapes: slots, window, T, Nx, Ny for K1, K2 and
# K5; factors, rows per window, s = Nx^2 + Nx + 1 for K3
STREAM_SHAPE = (32, 4, 93, 30, 10)
# the first lengths of phase 3's samples (the rest random in [1, T]): one
# step, all T, two, none, and a chunk of 16 steps exactly and one past it
STREAM_LENGTHS = (1, 93, 2, 0, 16, 17)
K3_SHAPE = (32, 4, 931)
# K3's chain bound: s x W dependent rotations, each along the diagonal at
# least 6 dependent instructions of its fast path (FMUL d*d, FADD of the
# radicand, MUFU.RSQ, FMUL, FFMA, FFMA of the refined square root) at 4
# cycles, the fp32 pipe's dependent-issue latency (MUFU's is longer), at
# the card's maximum SM clock
K3_ROTATION_CYCLES = 6 * 4
# K5's dependent chain a live step, read from its code (csrc/streaming_q8.cu,
# fast path, linear f): 17 fp32 FMA-class operations (FADD, FMUL, FFMA, and
# the integer add of the ring dot's two halves), 4 fp32 min/max, 4 IDP4A and
# one shared-memory round trip (the activation codes' row).  The step of K1,
# K2 and K6 (scan_step) is measured whole.
K5_CHAIN_OPS = {"fp32 FMA": 17, "fp32 min/max": 4, "IDP4A": 4,
                "shared store, __syncwarp, load": 1}
CHAIN = {}  # chain_latency.measure() and the SM clock, set in phase 2
# the training path: ridge tiles (the DFRModel path's block), the chunk of
# fit_ridge, the sizes of the card-vs-CPU fit, and the epochs of the
# full-width fit (the paper's 25)
TILE = 128
CHUNK = 256
FIT_MINIBATCH = 4   # fit_sgd's minibatch in phase 6
AGREE_SAMPLES, AGREE_EPOCHS = 512, 2
FIT_EPOCHS = 25
ONLINE_LR = 0.01  # OnlineDFR's SGD rate at ARAB's width
K4A_REL = 1e-5   # K4a: the same rounded operations as its plain version
K4B_REL = 1e-4   # K4b: dot products in another order
SOLVE_REL = 1e-3  # blocked vs unblocked ridge solve at a well-posed beta
WELL_POSED_BETAS = (1e-2, 1e0)

# K8 at the LM's shapes: (label, B, H, KV, Tq, Tk, D, causal, window,
# dtype, layout); the first is the prefill's, whose numbers go in the JSON
# record.  Layout "bthd": q, k, v are transposed views of (B, T, H, D)
# buffers, as attn_apply_full passes them; "bhtd": contiguous (B, H, T, D).
# The prefill's two shapes are both held against the plain version in the
# model's layout; at T=32768 the dense plain version's scores would take
# 38 GB, so that case's plain version is blockwise_attention (512 x 1024
# tiles, the same masked softmax in f32) on the (B, T, H, D) buffers.
K8_CASES = (
    ("prefill", 4, 9, 3, 4096, 4096, 64, True, 0, torch.bfloat16, "bthd"),
    ("prefill contiguous", 4, 9, 3, 4096, 4096, 64, True, 0,
     torch.bfloat16, "bhtd"),
    ("prefill_32k", 1, 9, 3, 32768, 32768, 64, True, 0, torch.bfloat16,
     "bthd"),
    ("minitron heads", 1, 32, 8, 2048, 2048, 128, True, 0, torch.bfloat16,
     "bhtd"),
    ("window 512", 2, 9, 3, 2048, 2048, 64, True, 512, torch.bfloat16,
     "bhtd"),
    ("ragged non-causal", 2, 9, 3, 1000, 3001, 64, False, 0, torch.bfloat16,
     "bthd"),
    ("fp32", 2, 9, 3, 1024, 1024, 64, True, 0, torch.float32, "bhtd"),
    ("fp32 window 512", 2, 9, 3, 2048, 2048, 64, True, 512, torch.float32,
     "bthd"),
)
K8_DENSE_MAX_BYTES = 8 << 30   # larger dense f32 scores: blockwise plain
# |got - want| <= atol + rtol |want|, elementwise.  bf16: both sides round
# to bf16 from f32 values that differ in their last bits, so they are one
# bf16 step apart at most, and a step is at most 2^-7 of the value (8 bits
# of significand); atol 1e-4 covers the f32 difference of outputs near 0.
# With randn inputs a causal row at T=4096 averages about T/e keys, so a
# typical |out| is about 0.03: the limit is relative, not absolute.  fp32:
# the same f32 arithmetic in another order, with the fast exponential.
K8_TOL = {torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
# K8's two routes in csrc/flash_attention.cu, chosen by dtype
K8_ROUTES = {torch.bfloat16: "wgmma tensor cores, K/V by TMA",
             torch.float32: "SIMT fp32 FMAs"}
# SASS instructions that phase 2 requires in K8's library: the tensor-core
# products (wgmma) and the TMA tile loads of the bf16 route
K8_SASS = ("HGMMA", "UTMALDG")
# the LM main path: smollm-135m, prefill shapes (B, T) - the second is the
# prefill_32k cell's sequence length - and launch/serve.py's defaults
LM_ARCH = "smollm-135m"
PREFILL_SHAPES = ((4, 4096), (1, 32768))
SERVE = dict(requests=16, prompt_len=32, max_tokens=16, max_batch=8,
             max_len=256)
LM_REL = 1e-3        # card vs CPU prefill logits in fp32, of max |logits|
# card vs CPU prefill logits in bf16, of max |logits|: the limit the CPU
# tests hold the bf16 port to against the reference (tests/test_torch_lm.py)
LM_BF16_REL = 2e-2
LM_AGREE = 0.98      # card vs CPU greedy tokens in fp32

KERNELS = {"K1 train_forward": k_train.KERNEL,
           "K2 streaming_logits": k_streaming.KERNEL,
           "K5 streaming_logits_q8": k_streaming_q8.KERNEL,
           "K3 cholupdate_window_t": k_cholupdate.KERNEL,
           "K6 reservoir_states": k_reservoir.KERNEL,
           "K7 dprr_features": k_dprr.KERNEL,
           "K4a chol_tile": k_cholesky.CHOL_KERNEL,
           "K4b trsm_tile": k_cholesky.TRSM_KERNEL,
           "K8 flash_attention": k_flash.KERNEL}
TRAINING_KERNELS = ("K6 reservoir_states", "K7 dprr_features",
                    "K4a chol_tile", "K4b trsm_tile")
# the main paths: server knobs and the kernels each must launch every round
PATHS = {
    "fp32": (dict(), ("K1 train_forward", "K2 streaming_logits")),
    "int8": (dict(quantize="int8", refresh_mode="incremental"),
             ("K1 train_forward", "K2 streaming_logits",
              "K5 streaming_logits_q8", "K3 cholupdate_window_t")),
}
# how a server of a path runs its rounds: replayed from its CUDA graphs (the
# default on the card), through the eager round (the captured round's
# oracle, reached through the server's private ``_graphs``), and replayed
# at the reference benchmark's pipeline_depth=2 and step_block=4
# (benchmarks/bench_stream.py)
KINDS = {"captured": {}, "eager": {},
         "pipelined": dict(pipeline_depth=2, step_block=4)}
# the retirement modes at ARAB's full width, each on the incremental refresh
# (benchmarks/bench_stream.py:310-335): forget at the reference's lambda, a
# window of half a stream (its capacity set per run, max(4, n // 2)),
# adaptive on its defaults and under int8; the kernels each launches a
# round (K3: the fold, and the window's flagged downdate)
INC = dict(refresh_mode="incremental")
RETIRE_PATHS = {
    "forget": (dict(INC, retirement="forget", forget=0.95),
               {"K1 train_forward": 1, "K2 streaming_logits": 1,
                "K3 cholupdate_window_t": 1}),
    "window": (dict(INC, retirement="window"),
               {"K1 train_forward": 1, "K2 streaming_logits": 1,
                "K3 cholupdate_window_t": 2}),
    "adaptive": (dict(INC, retirement="adaptive"),
                 {"K1 train_forward": 1, "K2 streaming_logits": 1,
                  "K3 cholupdate_window_t": 1}),
    "adaptive_int8": (dict(INC, retirement="adaptive", quantize="int8"),
                      {"K1 train_forward": 1, "K2 streaming_logits": 1,
                       "K5 streaming_logits_q8": 1,
                       "K3 cholupdate_window_t": 1}),
}
# the reference's drift cells (benchmarks/bench_stream.py:405-470,
# BENCH_stream_drift.json): S4/N160/W4 at Nx 8 and 16, phase_steps=3,
# refresh_every=2, incremental, lambda 0.95, a window of 40; each policy's
# post-drift accuracy must beat the baseline's by DRIFT_GAIN
DRIFT_NODES = (8, 16)
DRIFT_STREAMS, DRIFT_SAMPLES, DRIFT_T, DRIFT_CLASSES = 4, 160, 16, 4
DRIFT_POLICIES = {
    "baseline": {},
    "forget": dict(retirement="forget", forget=0.95),
    "window": dict(retirement="window", retire_window=40),
    "adaptive": dict(retirement="adaptive"),
}
DRIFT_ADAPTIVE_MODES = {"plain": {}, "blocked": dict(step_block=4),
                        "int8": dict(quantize="int8")}
DRIFT_GAIN = 0.3
K3_FORGET = 0.95   # phase 3's scale operand: sqrt(lambda) on live rows
# phase 5's subset for the retirement paths: the first 400 ARAB samples in
# 8 streams on 4 slots (the CPU folds K3's plain version at s = 931)
RETIRE_AGREE_SAMPLES = 400


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def device_ms(fn, reps: int = 50, setup=None) -> float:
    """Median device time of one call: a busy-wait kernel keeps the card
    occupied while the host enqueues the start event, the call and the end
    event, so the events bracket the call's device work and not the host's
    launch latency.  ``setup()``, if given, runs before each rep outside the
    timed region, and its result is the call's argument."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(arg) if setup is not None else fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 10) -> float:
    """Mean time per call of back-to-back calls, host launch cost included
    (the plain versions issue hundreds of small launches per call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, flops: int, int_ops: int = 0) -> tuple:
    """Least time for the given work: bytes at the memory rate against fp32
    flops and int8 operations, each at its peak rate; the larger bounds."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FP32_FLOP_S + int_ops / PEAK_INT8_OP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(live_steps: int, n: int, nx: int, extra_bytes: int,
          extra_flops: int) -> tuple:
    """Least time for the work this run's inputs need: each live step of a
    sample reads Nx inputs and does 3 Nx^2 + 7 Nx flops (nonlinearity, ring
    matvec, DPRR update); frozen steps past a length need nothing."""
    return bound_ms(live_steps * nx * 4 + n * 4 + extra_bytes,
                    live_steps * (3 * nx * nx + 7 * nx) + extra_flops)


def chain_bound(steps: int, cycles: float, what: str) -> str:
    """The least time of `steps` dependent steps of `cycles` each, at the
    card's maximum SM clock, as a printable phrase."""
    ms = steps * cycles / CHAIN["clock_hz"] * 1e3
    return (f"chain bound {ms:.5f} ms ({steps} steps x {cycles:.1f} cycles "
            f"of {what} at {CHAIN['clock_hz'] / 1e6:.0f} MHz)")


def compare(name: str, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        ok = torch.allclose(g, w, **KERNEL_TOL)
        e = float((g - w).abs().max())
        rel = e / max(float(w.abs().max()), 1e-30)
        print(f"  {name}: max abs err {e:.3e}, max rel err {rel:.3e} "
              f"(tolerance rtol {KERNEL_TOL['rtol']}, atol "
              f"{KERNEL_TOL['atol']})")
        check(ok, f"{name}: kernel disagrees with its plain version")
        err = max(err, e)
    return err


def kernel_phase(dev) -> dict:
    """K1 and K2 against their plain versions at the server's shapes."""
    S, W, T, nx, ny = STREAM_SHAPE
    n = S * W
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, T + 1, n)
    lengths[:6] = STREAM_LENGTHS
    j = torch.from_numpy(rng.normal(size=(S, W, T, nx)).astype(np.float32))
    lens = torch.from_numpy(lengths.reshape(S, W).astype(np.int32))
    p = torch.from_numpy(rng.uniform(0.01, 0.5, S).astype(np.float32))
    q = torch.from_numpy(rng.uniform(-0.5, 0.5, S).astype(np.float32))
    Wr = torch.from_numpy(
        (0.01 * rng.normal(size=(S, ny, nx * (nx + 1)))).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(S, ny)).astype(np.float32))
    j, lens, p, q, Wr, b = (t.to(dev) for t in (j, lens, p, q, Wr, b))
    f = DFRConfig(n_in=1, n_classes=ny, n_nodes=nx).f()
    live_steps = int(lengths.sum())
    nr = nx * (nx + 1)

    def k2(backend):
        return ops.streaming_logits_slots(j, lens, p, q, Wr, b, nx, f=f,
                                          backend=backend)

    def k1(backend):
        return ops.train_forward(j, lens, p, q, nx, f=f, backend=backend)

    records = []
    for name, fn, src, replaces, extra_bytes, extra_flops in (
        ("K2 streaming_logits", k2, "src/repro_torch/kernels/csrc/streaming.cu",
         "src/repro/kernels/streaming.py:39",
         8 * S + 4 * S * ny * nr + 4 * S * ny + 4 * n * ny,
         n * ny * (2 * nr + 1)),
        ("K1 train_forward", k1, "src/repro_torch/kernels/csrc/train.cu",
         "src/repro/kernels/train.py:69",
         8 * S + 4 * n * (nr + 3 * nx), 0),
    ):
        got, want = fn("cuda"), fn("torch")
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = compare(name, got, want)
        ms = device_ms(lambda: fn("cuda"))
        plain_ms = wall_ms(lambda: fn("torch"))
        bound_ms, bound_by = bound(live_steps, n, nx, extra_bytes,
                                   extra_flops)
        print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50), "
              f"plain {plain_ms:.3f} ms (back to back), bound "
              f"{bound_ms:.5f} ms ({bound_by}) at B={n} T={T} Nx={nx} "
              f"Ny={ny}, {live_steps} live steps; "
              + chain_bound(int(lengths.max()),
                            CHAIN["step_cycles"]["K1/K2/K6 scan_step"],
                            "scan_step"))
        records.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None))
    records.append(k5_record(j, lens, p, q, b, f, lengths))
    records.extend(k3_records(dev))
    return {r["name"]: r for r in records}


def k5_record(j, lens, p, q, b, f, lengths) -> dict:
    """K5 against its plain version on the K2 operands with int8 readout
    codes and per-slot scales (the last slot unarmed): the int32 DPRR
    accumulators must be equal, the logits within KERNEL_TOL."""
    name = "K5 streaming_logits_q8"
    S, W, T, nx = j.shape
    ny = b.shape[-1]
    nr = nx * (nx + 1)
    n = S * W
    rng = np.random.default_rng(1)
    dev = j.device
    Wq = torch.from_numpy(rng.integers(-127, 128, (S, ny, nr)).astype(
        np.int8)).to(dev)
    w_scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, S).astype(
        np.float32)).to(dev)
    x_scale = torch.from_numpy(rng.uniform(0.01, 0.05, S).astype(
        np.float32)).to(dev)
    w_scale[-1] = x_scale[-1] = 0.0

    def k5(backend, acc=False):
        return ops.streaming_logits_slots_q8(
            j, lens, p, q, Wq, w_scale, x_scale, b, nx, f=f,
            backend=backend, return_acc=acc)

    (got, got_acc), (want, want_acc) = k5("cuda", True), k5("torch", True)
    torch.cuda.synchronize()
    differ = int((got_acc != want_acc).sum())
    print(f"  {name}: {differ} of {got_acc.numel()} int32 accumulator "
          f"cells differ from the plain version (0 required)")
    check(differ == 0, f"{name}: accumulators differ from the plain version")
    err = compare(name, (got,), (want,))
    # the kernel alone on the codes and scales the wrapper builds; the
    # wrapper's prep (ring codes, powers, scales: about a dozen small ops)
    # is timed apart
    args = ops.streaming_q8_operands(j, lens, p, q, Wq, w_scale, x_scale, b,
                                     f)
    ms = device_ms(lambda: k_streaming_q8.streaming_logits_q8_cuda(*args))
    prep_ms = device_ms(lambda: ops.streaming_q8_operands(
        j, lens, p, q, Wq, w_scale, x_scale, b, f))
    plain_ms = wall_ms(lambda: k5("torch"))
    live = int(lengths.sum())
    # bytes: live inputs, lengths, the ring codes and powers, the scales,
    # the readout codes and bias, the logits; ops: per live step an int8
    # ring dot (Nx^2 MACs) and DPRR update (Nx(Nx+1) MACs), about 12 fp32
    # ops a node, and the fp32 readout
    nbytes = (live * nx * 4 + n * 4 + S * (nx * nx + 4 * nx + 16 + ny * nr
                                           + 4 * ny) + 4 * n * ny)
    bnd, by = bound_ms(nbytes, live * 12 * nx + n * ny * (4 * nr + 1),
                       live * 2 * (nx * nx + nx * (nx + 1)))
    k5_cycles = sum(CHAIN["op_cycles"][op] * k
                    for op, k in K5_CHAIN_OPS.items())
    print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50; the "
          f"wrapper's code and scale prep {prep_ms:.4f} ms more), plain "
          f"{plain_ms:.3f} ms (back to back), bound {bnd:.5f} ms ({by}) at "
          f"B={n} T={T} Nx={nx} Ny={ny}, {live} live steps; "
          + chain_bound(int(lengths.max()), k5_cycles,
                        "K5's step, summed from its operations"))
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/streaming_q8.cu",
                replaces="src/repro/kernels/streaming.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def k3_records(dev) -> list:
    """K3 against its plain version at the server's fold: 32 factors of
    931 x 931 and windows of 4 rows; sign +1 on random upper-triangular
    factors, then sign -1 on the updated factors with one row that the
    downdate guard must skip."""
    name = "K3 cholupdate_window_t"
    K, W, s = K3_SHAPE
    g = torch.Generator().manual_seed(0)
    Lt = torch.triu(0.05 * torch.randn(K, s, s, generator=g), diagonal=1)
    Lt = (Lt + torch.diag_embed(1.0 + torch.rand(K, s, generator=g))).to(dev)
    X = (0.3 * torch.randn(K, W, s, generator=g)).to(dev)
    X[:, 1] = 0.0   # a dead sample: zero rows are exact no-ops
    err = 0.0
    up = None
    for sign in (1.0, -1.0):
        base, rows = Lt, X
        if sign < 0:
            base, rows = up, X.clone()
            rows[0, -1] = 0.0
            rows[0, -1, s // 2] = 3.0 * base[0, s // 2, s // 2]
        got = ops.cholupdate_window_t(base, rows, sign, backend="cuda")
        want = ops.cholupdate_window_t(base, rows, sign, backend="torch")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        e = float((got - want).abs().max())
        rel = e / float(want.abs().max())
        print(f"  {name} sign {sign:+.0f}: max abs err {e:.3e}, relative to "
              f"max |Lt| {rel:.3e} (tolerance {K3_REL}); equal to its plain "
              f"version bit for bit: {bool(torch.equal(got, want))}")
        check(rel <= K3_REL, f"{name}: kernel disagrees with its plain "
                             f"version (sign {sign:+.0f})")
        err = max(err, e)
        up = got
    # the server's call: an in-place fold, here into a fresh copy of the
    # factors made before each rep, outside the timed region
    ms = device_ms(lambda dst: ops.cholupdate_window_t(dst, X, out=dst,
                                                       backend="cuda"),
                   setup=Lt.clone)
    plain_ms = wall_ms(lambda: ops.cholupdate_window_t(Lt, X,
                                                       backend="torch"),
                       reps=2)
    # the upper triangle of each factor (diagonal included) read once and
    # written once, the rows read once; about 6 flops per factor element
    # right of the diagonal per row
    bnd, by = bound_ms(K * s * (s + 1) * 4 + K * W * s * 4,
                       6 * K * W * s * (s - 1) // 2)
    chain_ms = s * W * K3_ROTATION_CYCLES / max_sm_clock_hz() * 1e3
    print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50), plain "
          f"{plain_ms:.1f} ms (back to back), bound {bnd:.5f} ms ({by}); "
          f"chain bound {chain_ms:.4f} ms ({s * W} dependent rotations x "
          f"{K3_ROTATION_CYCLES} cycles at the maximum SM clock) at K={K} "
          f"W={W} s={s}")
    k3_retirement_operands(Lt, X, up, ms)
    return [dict(name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/cholupdate.cu",
                 replaces="src/repro/kernels/cholupdate.py:53",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                 bound_by=by, library_ms=None)]


def k3_retirement_operands(Lt, X, up, unscaled_ms: float) -> None:
    """K3's operands for the retirement modes at the server's fold: the
    forget scale (sqrt(K3_FORGET) on live rows, exactly 1.0 on the dead
    row) and the window's flagged downdate, which the guard skips in some
    factors; each bit for bit equal to its plain version and timed as the
    server calls it (in place), beside the unscaled fold."""
    name = "K3 cholupdate_window_t"
    K, W, s = K3_SHAPE
    scale = torch.where(X.abs().sum(dim=-1) > 0, K3_FORGET ** 0.5,
                        1.0).to(torch.float32)
    got = ops.cholupdate_window_t(Lt, X, scale=scale, backend="cuda")
    want = ops.cholupdate_window_t(Lt, X, scale=scale, backend="torch")
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    print(f"  {name} with the forget scale sqrt({K3_FORGET}): equal to its "
          f"plain version bit for bit: {equal}")
    check(equal, f"{name}: the scaled fold differs from its plain version")
    trip = (0, 5, 17)   # factors whose downdate the guard skips
    D = 0.05 * X
    for i in trip:
        D[i, -1, s // 2] = 3.0 * up[i, s // 2, s // 2]
    flags = torch.full((K,), 7, dtype=torch.int32, device=X.device)
    plain_flags = flags.clone()
    got = ops.cholupdate_window_t(up, D, -1.0, flags=flags, backend="cuda")
    want = ops.cholupdate_window_t(up, D, -1.0, flags=plain_flags,
                                   backend="torch")
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    flagged = [i for i, f in enumerate(flags.tolist()) if f]
    print(f"  {name} flagged downdate: equal to its plain version bit for "
          f"bit: {equal}; guard flags {flagged} (plain "
          f"{[i for i, f in enumerate(plain_flags.tolist()) if f]}, "
          f"engineered {list(trip)})")
    check(equal and flags.tolist() == plain_flags.tolist()
          and flagged == list(trip),
          f"{name}: the flagged downdate differs from its plain version")
    scaled_ms = device_ms(lambda dst: ops.cholupdate_window_t(
        dst, X, scale=scale, out=dst, backend="cuda"), setup=Lt.clone)
    down_ms = device_ms(lambda dst: ops.cholupdate_window_t(
        dst, D, -1.0, flags=flags, out=dst, backend="cuda"), setup=up.clone)
    # as the unscaled fold's bound, plus the scales read and one multiply an
    # element a row (scaled), or the flags written (flagged)
    bnd_s, by_s = bound_ms(K * s * (s + 1) * 4 + K * W * s * 4 + K * W * 4,
                           7 * K * W * s * (s - 1) // 2)
    bnd_d, by_d = bound_ms(K * s * (s + 1) * 4 + K * W * s * 4 + K * 4,
                           6 * K * W * s * (s - 1) // 2)
    print(f"  {name}: scaled {scaled_ms:.4f} ms ({scaled_ms / unscaled_ms:.3f}"
          f" x the unscaled {unscaled_ms:.4f} ms), bound {bnd_s:.5f} ms "
          f"({by_s}); flagged downdate {down_ms:.4f} ms, bound {bnd_d:.5f} ms "
          f"({by_d}); device time, median of 50, at K={K} W={W} s={s}")


def record(name, source, replaces, err, ms, plain_ms, bnd, library_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=library_ms)


def check_rel(name: str, got, want, tol: float) -> float:
    """max |got - want| <= tol * max |want|, both finite; returns the
    largest absolute error."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e = float((got - want).abs().max())
    rel = e / max(float(want.abs().max()), 1e-30)
    print(f"  {name}: max abs err {e:.3e}, relative to the largest "
          f"{rel:.3e} (tolerance {tol})")
    check(rel <= tol, f"{name}: kernel disagrees with its plain version")
    return e


def training_kernel_records(model: DFRModel, train) -> dict:
    """K6, K7, K4a and K4b against their plain versions on the card at the
    training path's shapes: ARAB's masked training split (a fit_ridge chunk
    and the whole split) at the initial (p, q), and the blocked solve's
    tiles of the ridge system those features give, with tiles of 128."""
    cfg = model.cfg
    nx, nr, dev = cfg.n_nodes, cfg.n_rep, model.device
    params = model.init_params()
    u = train.u.to(dev)
    lens = train.length.to(dev)
    j_all = masking.apply_mask(model.mask, u)
    f = cfg.f()
    records = {}

    def k6(j, ln, backend):
        return ops.reservoir_states(j, ln, params.p, params.q, nx, f=f,
                                    backend=backend)

    def k7(x, ln, backend):
        return ops.dprr_features(x, ln, nx, backend=backend)

    stats = {}
    for n in (FIT_MINIBATCH, CHUNK, train.batch):
        j, ln = j_all[:n], lens[:n]
        t_len = j.shape[1]
        live = int(ln.sum())
        x = k6(j, ln, "cuda")
        x_plain = k6(j, ln, "torch")
        torch.cuda.synchronize()
        e6 = compare(f"K6 at B={n}", (x,), (x_plain,))
        step = torch.arange(t_len, device=dev)
        last = x[torch.arange(n, device=dev), (ln.long() - 1).clamp(min=0)]
        frozen = (step[None, :] >= ln[:, None]) & (ln > 0)[:, None]
        same = bool((x == last[:, None])[frozen].all())
        print(f"  K6 at B={n}: {int(frozen.sum())} frozen rows, each equal "
              f"to the last live state: {same}")
        check(same, f"K6 at B={n}: a frozen row differs from the last live "
                    f"state")
        r = k7(x_plain, ln, "cuda")
        r_plain = k7(x_plain, ln, "torch")
        torch.cuda.synchronize()
        e7 = compare(f"K7 at B={n}", (r,), (r_plain,))
        ms6 = device_ms(lambda: k6(j, ln, "cuda"))
        ms7 = device_ms(lambda: k7(x, ln, "cuda"))
        plain6 = wall_ms(lambda: k6(j, ln, "torch"), reps=3)
        plain7 = wall_ms(lambda: k7(x, ln, "torch"), reps=3)
        # the library's DPRR: one bmm of the masked X^T and the shifted X
        # with its ones column (the operands built once, outside the call)
        step = torch.arange(t_len, device=dev)
        x1m = (x * (step[None, :] < ln[:, None])[..., None]).mT.contiguous()
        x0 = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
        x0a = torch.cat([x0, torch.ones_like(x0[..., :1])], -1).contiguous()
        lib7 = device_ms(lambda: torch.bmm(x1m, x0a))
        # K6: each live step reads Nx inputs and does about Nx^2 + 5 Nx
        # flops (ring matvec, nonlinearity, wrap); every row of X is
        # written, the frozen ones too.  K7: each live row of X read once
        # and 2 Nx (Nx + 1) flops; r written once.
        b6 = bound_ms(live * nx * 4 + n * 4 + 8 + n * t_len * nx * 4,
                      live * (nx * nx + 5 * nx))
        b7 = bound_ms(live * nx * 4 + n * 4 + n * nr * 4,
                      live * 2 * nx * (nx + 1))
        print(f"  K6 at B={n} T={t_len} Nx={nx} ({live} live steps): kernel "
              f"{ms6:.4f} ms, plain {plain6:.3f} ms, bound {b6[0]:.5f} ms "
              f"({b6[1]}); "
              + chain_bound(int(ln.max()),
                            CHAIN["step_cycles"]["K1/K2/K6 scan_step"],
                            "scan_step"))
        print(f"  K7 at B={n}: kernel {ms7:.4f} ms, plain {plain7:.3f} ms, "
              f"one bmm {lib7:.4f} ms, bound {b7[0]:.5f} ms ({b7[1]})")
        stats[n] = (e6, ms6, plain6, b6, e7, ms7, plain7, b7, lib7)
    e6, ms6, plain6, b6, e7, ms7, plain7, b7, lib7 = stats[train.batch]
    records["K6 reservoir_states"] = record(
        "K6 reservoir_states", "src/repro_torch/kernels/csrc/reservoir.cu",
        "src/repro/kernels/reservoir.py:30",
        max(e6, stats[CHUNK][0]), ms6, plain6, b6, None)
    records["K7 dprr_features"] = record(
        "K7 dprr_features", "src/repro_torch/kernels/csrc/dprr.cu",
        "src/repro/kernels/dprr.py:28", max(e7, stats[CHUNK][4]), ms7,
        plain7, b7, lib7)

    # the ridge system of these features, and the blocked solve's tiles
    A, B = model.ridge_statistics(train, params, CHUNK)
    tiles = capture_tiles(A, ridge.regularize(B, 1e-2))
    diag = torch.cat([a for (a,) in tiles["chol_block_batched"]])
    got, want = (k_cholesky.chol_block_batched(diag, backend=be)
                 for be in ("cuda", "torch"))
    torch.cuda.synchronize()
    e4a = check_rel(f"K4a on the blocked solve's {diag.shape[0]} diagonal "
                    f"tiles",
                    got, want, K4A_REL)
    print(f"  K4a equal to its plain version bit for bit: "
          f"{bool(torch.equal(got, want))}")
    # one tile at the blocked solve's 128 and at ops' default of 256: the
    # leading diagonal tile of the regularized system
    Breg = ridge.regularize(B, 1e-2)
    for bs in (TILE, 2 * TILE):
        tile = Breg[None, :bs, :bs].contiguous()
        got = k_cholesky.chol_tile_cuda(tile)
        want = ref.chol_tile_ref(tile)
        torch.cuda.synchronize()
        err = check_rel(f"K4a one {bs}x{bs} tile", got, want, K4A_REL)
        ms = device_ms(lambda: k_cholesky.chol_tile_cuda(tile))
        plain = wall_ms(lambda: ref.chol_tile_ref(tile), reps=3)
        lib = device_ms(lambda: torch.linalg.cholesky_ex(tile))
        bnd = bound_ms(2 * bs * bs * 4, bs ** 3 // 3)
        print(f"  K4a one {bs}x{bs} tile: kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, torch.linalg.cholesky_ex {lib:.4f} ms, "
              f"bound {bnd[0]:.6f} ms ({bnd[1]})")
        if bs == TILE:
            records["K4a chol_tile"] = record(
                "K4a chol_tile", "src/repro_torch/kernels/csrc/cholesky.cu",
                "src/repro/kernels/cholesky.py:37", max(e4a, err), ms, plain,
                bnd, lib)

    e4b = 0.0
    timed = {}
    for key, fn in (("trsm_lower_t_batched", k_cholesky.trsm_lower_t_batched),
                    ("trsm_lower_batched", k_cholesky.trsm_lower_batched)):
        for rhs, L in tiles[key]:
            got, want = fn(rhs, L, backend="cuda"), fn(rhs, L, backend="torch")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            check(bool(torch.isfinite(got).all()) and rel <= K4B_REL,
                  f"K4b {key} at m={rhs.shape[1]}: relative error {rel:.3e}")
            e4b = max(e4b, err)
            timed.setdefault((key, rhs.shape[1]), (rhs, L))
    print(f"  K4b: {sum(len(tiles[k]) for k in tiles if 'trsm' in k)} "
          f"solves of the blocked solve within {K4B_REL} of the plain "
          f"version (max abs err {e4b:.3e})")
    # the factorization's largest panel (m = 896) and the substitutions'
    # right-hand side (Ny padded to 8: m = 16), each in both directions
    # (the panel's operands also solved backward)
    panel = max(m for _, m in timed)
    rows = min(m for _, m in timed)
    for m in (panel, rows):
        key = next(k for k, mm in timed if mm == m)
        rhs, L = (t.contiguous() for t in timed[(key, m)])
        for back in (False, True):
            ms = device_ms(lambda: k_cholesky.trsm_tile_cuda(rhs, L, back))
            plain_fn = ref.trsm_lower_ref if back else ref.trsm_lower_t_ref
            plain = wall_ms(lambda: plain_fn(rhs, L), reps=3)
            # X L = D is solve_triangular(L, left=False); X L^T = A with L^T
            lib = device_ms(lambda: torch.linalg.solve_triangular(
                L if back else L.mT, rhs, upper=not back, left=False))
            bnd = bound_ms((2 * m * TILE + TILE * TILE) * 4, m * TILE * TILE)
            print(f"  K4b {'backward' if back else 'forward'} m={m} "
                  f"bs={TILE}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
                  f"solve_triangular {lib:.4f} ms, bound {bnd[0]:.6f} ms "
                  f"({bnd[1]})")
            if "K4b trsm_tile" not in records:   # the forward panel
                records["K4b trsm_tile"] = record(
                    "K4b trsm_tile",
                    "src/repro_torch/kernels/csrc/cholesky.cu",
                    "src/repro/kernels/cholesky.py:101", e4b, ms, plain,
                    bnd, lib)
    ridge_solve_check(A, B, cfg.betas)
    return records


def capture_tiles(A, B) -> dict:
    """The tile operands the blocked solve gives K4a and K4b for
    W = A B^-1 (with tiles of TILE), from a run of the blocked solve over
    the plain tiles: no kernel launches."""
    names = ("chol_block_batched", "trsm_lower_t_batched",
             "trsm_lower_batched")
    seen = {n: [] for n in names}
    orig = {n: getattr(k_ridge, n) for n in names}

    def recorder(name):
        def fn(*args, **kw):
            seen[name].append(tuple(a.clone() for a in args))
            return orig[name](*args, **kw)
        return fn

    for n in names:
        setattr(k_ridge, n, recorder(n))
    try:
        k_ridge.ridge_solve_blocked(A, B, block=TILE, backend="torch")
    finally:
        for n in names:
            setattr(k_ridge, n, orig[n])
    return seen


def ridge_solve_check(A, B, betas) -> None:
    """ops.ridge_solve at s=931 (the blocked solve over K4a and K4b, tiles
    of 128 and 256) against the unblocked library solve, over the sweep;
    the well-posed betas must agree within SOLVE_REL."""
    for beta in betas:
        Bb = ridge.regularize(B, beta)
        want = ref.ridge_solve_ref(A, Bb)
        line = []
        for block in (TILE, 2 * TILE):
            got = ops.ridge_solve(A, Bb, block=block)
            fin = bool(torch.isfinite(got).all())
            rel = (float((got - want).abs().max() / want.abs().max())
                   if fin and bool(torch.isfinite(want).all()) else None)
            line.append(f"block {block}: finite {fin}, max |dW| / max |W| "
                        f"{rel if rel is None else f'{rel:.3e}'}")
            if beta in WELL_POSED_BETAS:
                check(rel is not None and rel <= SOLVE_REL,
                      f"ridge solve at beta {beta}, block {block}: {rel}")
        print(f"  ridge solve s={B.shape[0]} beta {beta:g} (library finite "
              f"{bool(torch.isfinite(want).all())}): " + "; ".join(line))
    Bb = ridge.regularize(B, 1e-2)
    ms = {block: device_ms(lambda: ops.ridge_solve(A, Bb, block=block),
                           reps=10) for block in (TILE, 2 * TILE)}

    def library():
        C, _ = torch.linalg.cholesky_ex(Bb)
        return torch.cholesky_solve(A.mT, C)

    lib = device_ms(library, reps=10)
    print(f"  ridge solve s={B.shape[0]}: blocked solve {ms[TILE]:.3f} ms "
          f"(tiles of {TILE}), {ms[2 * TILE]:.3f} ms (tiles of {2 * TILE}); "
          f"torch.linalg.cholesky_ex + cholesky_solve {lib:.3f} ms")


def load_arab():
    """The paper's ARAB configuration (configs/dfr_paper.py), its full
    training split as numpy arrays, and both splits as batches."""
    train, test = load("ARAB")
    cfg = paper_dfr_config("ARAB")
    arrays = (train.u.numpy(), train.length.numpy(), train.label.numpy())
    return cfg, arrays, (train, test)


def make_streams(arrays, n_streams: int, n_samples=None):
    """Carve the first ``n_samples`` samples into ``n_streams`` streams
    (examples/online_edge.py)."""
    u, ln, lab = (a[:n_samples] for a in arrays)
    splits = [idx for idx in np.array_split(np.arange(len(u)), n_streams)
              if len(idx)]
    streams = [StreamRequest(rid=i, u=u[idx], length=ln[idx],
                             label=lab[idx])
               for i, idx in enumerate(splits)]
    return streams, len(splits[0])


def phase_steps_for(samples_per_stream: int, window: int) -> int:
    """Phase 1 covers ~40% of each stream's windows and leaves at least one
    phase-2 window (examples/online_edge.py)."""
    windows = max(1, samples_per_stream // window)
    return max(1, min(int(windows * 0.4) or 1, windows - 1))


def serve(cfg, streams, t_max, per_stream, max_streams, device, **kw):
    srv = StreamServer(cfg, t_max=t_max, max_streams=max_streams, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device=device, **kw)
    for s in streams:
        srv.submit(s)
    done = srv.run_until_drained(strict=True)
    return srv, {r.rid: r for r in done}


def serving_run(cfg, arrays, path: str, kind: str, profile=None) -> dict:
    """One full-width ARAB server of ``path`` (see PATHS) and ``kind`` (see
    KINDS) serving two waves of the same 64 streams on its 32 slots.  The
    first is the warm-up: each kernel's first load, the libraries' set-up
    and, on the captured round, the capture of each graph (a server's graphs
    hold its own tensors, so every server captures its own).  The second is
    measured, with every launch count set to 0 just before it and read just
    after, under ``profile`` (a torch.profiler context) where given.  The
    peak memory is the server's over both waves, above what the process
    held before it: allocated, and reserved (the graphs' pool is reserved,
    and a replay allocates nothing)."""
    knobs = {**{**PATHS, **RETIRE_PATHS}[path][0], **KINDS[kind]}
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 64)
    knobs = window_capacity(knobs, per_stream)
    srv = StreamServer(cfg, t_max=t_max, max_streams=32, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device="cuda",
                       pool_capacity=max(s.n_samples for s in streams),
                       **knobs)
    if kind == "eager":
        srv._graphs = None   # the eager round: the captured round's oracle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for s in streams:
        srv.submit(s)
    srv.run_until_drained(strict=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    streams, _ = make_streams(arrays, 64)
    for rec in (srv.step_times_s, srv.dispatch_times_s, srv.drain_times_s):
        rec.clear()
    graphs = srv._graphs
    replays0 = graphs.replays if graphs else 0
    eager0 = graphs.eager_calls if graphs else 0
    step0, int8_0 = srv.global_step, srv.served_int8
    reset_launches()
    with profile if profile is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for s in streams:
            srv.submit(s)
        done = srv.run_until_drained(strict=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rounds = srv.global_step - step0
    return dict(
        srv=srv, done={r.rid: r for r in done[-len(streams):]}, wall=wall,
        warm_s=warm_s, rounds=rounds, dispatches=len(srv.step_times_s),
        launches=read_launches(), lat=srv.latency_percentiles_ms(),
        replays=(graphs.replays - replays0) if graphs else 0,
        eager_calls=(graphs.eager_calls - eager0) if graphs else rounds,
        served=sum(r.n_samples for r in streams),
        served_int8=srv.served_int8 - int8_0,
        peak_alloc=torch.cuda.max_memory_allocated() - base_alloc,
        peak_reserved=torch.cuda.max_memory_reserved() - base_reserved)


def window_capacity(knobs: dict, per_stream: int) -> dict:
    """The window mode's ring of half a stream (bench_stream.py)."""
    if knobs.get("retirement") == "window" and "retire_window" not in knobs:
        knobs = dict(knobs, retire_window=max(4, per_stream // 2))
    return knobs


def run_line(res: dict) -> str:
    """A serving run's numbers as one printable phrase."""
    lat, r = res["lat"], res["rounds"]
    return (f"{res['served'] / res['wall']:.1f} samples/s ({res['served']} "
            f"in {res['wall']:.3f} s, {r} rounds, {res['dispatches']} "
            f"dispatches); dispatch p50 {lat['p50_ms']:.3f} ms, p99 "
            f"{lat['p99_ms']:.3f} ms (enqueue p50 "
            f"{lat['dispatch_p50_ms']:.3f} ms, prediction read p50 "
            f"{lat['drain_p50_ms']:.3f} ms); {res['replays'] / r:.2f} graph "
            f"replays and {res['eager_calls']} eager bodies over {r} rounds; "
            f"peak memory of the server: max_memory_allocated "
            f"{res['peak_alloc'] / 2**20:.1f} MiB, max_memory_reserved "
            f"{res['peak_reserved'] / 2**20:.1f} MiB; warm-up wave "
            f"{res['warm_s']:.3f} s")


def main_path_phase(card: str, cfg, arrays, path: str) -> dict:
    """The main path ``path`` through the captured round (the default on
    the card): one measured wave with every kernel's launch count set to 0
    just before it and read just after."""
    knobs, on_path = PATHS[path]
    res = serving_run(cfg, arrays, path, "captured")
    srv, done, rounds = res["srv"], res["done"], res["rounds"]
    launches, served = res["launches"], res["served"]
    acc = float(np.mean([r.online_accuracy for r in done.values()]))
    tag = f"[{card}] {path}"
    print(f"  {tag}: ARAB Nx={cfg.n_nodes} s={cfg.s} {knobs or 'defaults'}, "
          f"captured round: {len(done)} streams, " + run_line(res))
    print(f"  {tag}: mean rolling online accuracy {acc:.4f}")
    check(res["replays"] > 0, "the captured round replayed no graph")
    if knobs.get("quantize") == "int8":
        print(f"  {tag}: {res['served_int8']} of {served} predictions "
              f"({res['served_int8'] / served:.4f}) served from armed int8 "
              f"slots")
        check(res["served_int8"] > 0, "no prediction came from an armed slot")
    print(f"  {tag}: launches: " + ", ".join(
        f"{name.split()[0]} {count}" for name, count in launches.items())
        + f" over {rounds} rounds")
    check(sum(len(r.preds) for r in done.values()) == served,
          f"served fewer than {served} samples")
    for name, count in launches.items():
        want = rounds if name in on_path else 0
        check(count == want, f"{path}: {name}: {count} launches over "
                             f"{rounds} rounds ({want} expected)")
    for r in done.values():
        st = r.final_state
        check(all(bool(torch.isfinite(t).all()) for t in
                  (st.params.p, st.params.q, st.params.W, st.params.b,
                   st.ridge.Lt)),
              f"stream {r.rid}: non-finite final state")
        check(all(0 <= x < cfg.n_classes for x in r.preds),
              f"stream {r.rid}: prediction out of range")
    if knobs.get("refresh_mode") == "incremental":
        # the live factor still factors the accumulated statistics
        st = max(done.values(), key=lambda r: r.n_samples).final_state
        Lt = st.ridge.Lt.double()
        Bb = st.ridge.B.double() + float(st.ridge.factor_beta) * torch.eye(
            cfg.s, dtype=torch.float64, device=Lt.device)
        rel = float((Lt.T @ Lt - Bb).abs().max() / Bb.abs().max())
        print(f"  {tag}: max |Lt^T Lt - (B + beta I)| / max |B + beta I| "
              f"{rel:.3e} (tolerance 1e-4)")
        check(rel <= 1e-4, "the live factor no longer factors B + beta I")
    return {name: launches[name] for name in on_path}


def profile_phase(card: str, cfg, arrays, path: str, kind: str,
                  top: int = 6) -> dict:
    """Where a round's time goes: the measured wave of ``serving_run``
    under torch.profiler.  Prints the device's busy time a round and its
    idle share of the wall time, the graph launches and the kernel launches
    and copies issued outside graphs a round (runtime API calls the
    profiler saw), and the kernels and host ops that take the most time.
    Profiling slows the host, so the wave's own numbers come from phases 4
    and 4c, not from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    res = serving_run(cfg, arrays, path, kind, profile=prof)
    wall, rounds = res["wall"], res["rounds"]
    events = prof.key_averages()
    # kernel events only: an operator's device time repeats its kernels'
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in dev)
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def api_calls(*prefixes):
        return sum(e.count for e in host if e.key.startswith(prefixes))

    graph_launches = api_calls("cudaGraphLaunch")
    launches = api_calls("cudaLaunchKernel", "cuLaunchKernel")
    copies = api_calls("cudaMemcpy")
    print(f"  [{card}] {path} {kind}: profiled {rounds} rounds "
          f"({res['dispatches']} dispatches) in {wall:.3f} s; device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e3 / rounds:.3f} ms a round, "
          f"{100 * busy_us / 1e6 / wall:.1f}% of wall (idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%); a round: "
          f"{graph_launches / rounds:.2f} graph launches, "
          f"{launches / rounds:.1f} kernel launches and "
          f"{copies / rounds:.2f} copies outside graphs")
    for e in dev[:top]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy_us > 0, "the profiler saw no device time")
    if kind != "eager":
        check(graph_launches > 0, "the profiler saw no graph launch")
    k3_us = sum(e.self_device_time_total for e in dev
                if "cholupdate_kernel" in e.key)
    return dict(busy_ms=busy_us / 1e3 / rounds, k3_ms=k3_us / 1e3 / rounds,
                idle=100 - 100 * busy_us / 1e6 / wall)


def same_serving(a: dict, b: dict) -> tuple:
    """(predictions equal, final states equal bit for bit) of two runs'
    measured waves and servers."""
    preds = all(a["done"][rid].preds == r.preds
                for rid, r in b["done"].items())
    states = [(x.final_state, y.final_state) for x, y in
              ((a["done"][rid], r) for rid, r in b["done"].items())]
    states.append((a["srv"].states, b["srv"].states))
    if a["srv"].win is not None:
        states.append((a["srv"].win, b["srv"].win))
    leaves_a, leaves_b = [], []
    for sa, sb in states:
        map_leaves(leaves_a.append, sa)
        map_leaves(leaves_b.append, sb)
    return preds, all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))


def rounds_phase(card: str, cfg, arrays, path: str) -> list:
    """The captured round, the eager round and the captured round at the
    reference benchmark's pipeline_depth=2, step_block=4, each as
    ``serving_run``'s measured wave, alternated (captured, eager,
    pipelined, pipelined, eager, captured) because host speed varies within
    a call.  Every run must serve the first captured run's predictions and
    end with its final states (and window rings), bit for bit.  Returns the
    runs."""
    order = ("captured", "eager", "pipelined", "pipelined", "eager",
             "captured")
    runs = []
    for kind in order:
        res = serving_run(cfg, arrays, path, kind)
        print(f"  [{card}] {path} {kind}: " + run_line(res))
        runs.append(res)
    first = runs[0]
    for kind, res in zip(order[1:], runs[1:]):
        preds, states = same_serving(res, first)
        print(f"  {path}: {kind} against the first captured run: "
              f"predictions {'equal' if preds else 'DIFFER'}, final states "
              f"{'equal bit for bit' if states else 'DIFFER'}")
        check(preds and states,
              f"{path}: the {kind} round serves another episode")
    for kind in KINDS:
        sps = [r["served"] / r["wall"] for k, r in zip(order, runs)
               if k == kind]
        p50 = [r["lat"]["p50_ms"] for k, r in zip(order, runs) if k == kind]
        print(f"  {path} {kind}: samples/s " + ", ".join(
            f"{x:.1f}" for x in sps) + "; dispatch p50 " + ", ".join(
            f"{x:.3f} ms" for x in p50))
    check(all(r["replays"] == 0 for k, r in zip(order, runs)
              if k == "eager"), "the eager round replayed a graph")
    return runs


def retirement_phase(card: str, cfg, arrays, path: str) -> None:
    """A retirement path at ARAB's full width: its captured, eager and
    pipelined, blocked rounds alternated (``rounds_phase``),
    every kernel of the path launched its count a round in the first
    captured run (counted at replay) and no other, the final states finite
    and each live factor still factoring its statistics; then the captured
    round's measured wave under torch.profiler, for the device's busy time
    and K3's time a round."""
    knobs, per_round = RETIRE_PATHS[path]
    runs = rounds_phase(card, cfg, arrays, path)
    res = runs[0]
    rounds, launches = res["rounds"], res["launches"]
    print(f"  {path}: launches in the first captured run: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in launches.items())
        + f" over {rounds} rounds")
    for name, n in launches.items():
        want = rounds * per_round.get(name, 0)
        check(n == want, f"{path}: {name}: {n} launches over {rounds} "
                         f"rounds ({want} expected)")
    if knobs.get("quantize") == "int8":
        check(res["served_int8"] > 0, "no prediction came from an armed slot")
    worst = 0.0
    for r in res["done"].values():
        st = r.final_state
        check(all(bool(torch.isfinite(t).all()) for t in
                  (st.params.W, st.params.b, st.ridge.Lt, st.ridge.B)),
              f"{path}: stream {r.rid}: non-finite final state")
        Lt = st.ridge.Lt.double()
        M = st.ridge.B.double() + float(st.ridge.factor_beta) * torch.eye(
            cfg.s, dtype=torch.float64, device=Lt.device)
        worst = max(worst, float((Lt.T @ Lt - M).abs().max() / M.abs().max()))
    print(f"  {path}: max |Lt^T Lt - (B + factor_beta I)| / max |B + "
          f"factor_beta I| over the streams {worst:.3e} (tolerance 1e-4)")
    check(worst <= 1e-4, f"{path}: a live factor no longer factors its "
                         f"statistics")
    prof = profile_phase(card, cfg, arrays, path, "captured")
    samples = [r["served"] / r["wall"] for r in runs]
    print(f"  [{card}] {path}: samples/s {min(samples):.1f}-"
          f"{max(samples):.1f} over the {len(runs)} runs; device busy "
          f"{prof['busy_ms']:.3f} ms a round (idle {prof['idle']:.1f}% under "
          f"the profiler), K3 {prof['k3_ms']:.4f} ms a round "
          f"({per_round['K3 cholupdate_window_t']} launch(es) a round)")


def drift_phase(card: str) -> None:
    """The reference's drift cells on the card, through the captured round:
    each policy's pre/at/post-drift accuracy beside BENCH_stream_drift.json's
    columns, and adaptive's plain, blocked and int8 rows; every retirement
    policy's post-drift accuracy must beat the baseline's by DRIFT_GAIN in
    both cells."""
    bench = json.loads((ROOT / "BENCH_stream_drift.json").read_text())
    rows = {(r["table"], r["cell"]): r for r in bench["rows"]}
    for nx in DRIFT_NODES:
        cfg = DFRConfig(n_in=1, n_classes=DRIFT_CLASSES, n_nodes=nx)
        cell = f"S{DRIFT_STREAMS}/N{DRIFT_SAMPLES}/Nx{nx}/W4"
        runs = {("drift", name): dict(INC, **kw)
                for name, kw in DRIFT_POLICIES.items()}
        runs.update({("drift-adaptive-modes", mode): dict(
            INC, retirement="adaptive", **kw)
            for mode, kw in DRIFT_ADAPTIVE_MODES.items()})
        post = {}
        for (table, name), knobs in runs.items():
            arrays, switches = make_drift_label_streams(
                DRIFT_STREAMS, DRIFT_SAMPLES, DRIFT_T, DRIFT_CLASSES)
            streams = [StreamRequest(rid=i, **a) for i, a in enumerate(arrays)]
            srv = StreamServer(cfg, t_max=DRIFT_T, max_streams=DRIFT_STREAMS,
                               window=4, phase_steps=3, refresh_every=2,
                               device="cuda", **knobs)
            t0 = time.perf_counter()
            for r in streams:
                srv.submit(r)
            srv.run_until_drained(strict=True)
            wall = time.perf_counter() - t0
            bounds = drift_segment_bounds(DRIFT_SAMPLES, switches[0], 4)
            acc = [float(np.mean([np.mean(np.asarray(r.preds[lo:hi])
                                          == r.label[lo:hi])
                                  for r in streams])) for lo, hi in bounds]
            ref_row = rows[(table, cell)]
            want = [ref_row[f"{name}_{seg}_acc"] for seg in
                    ("pre", "at", "post")]
            if table == "drift":
                post[name] = acc[2]
            print(f"  [{card}] {cell} {table} {name}: pre/at/post accuracy "
                  + "/".join(f"{a:.3f}" for a in acc) + " (reference "
                  + "/".join(f"{a:.3f}" for a in want) + f"); "
                  f"{DRIFT_STREAMS * DRIFT_SAMPLES / wall:.1f} samples/s "
                  f"(first episode of a fresh server, captures included)")
        for name in ("forget", "window", "adaptive"):
            gain = post[name] - post["baseline"]
            check(gain >= DRIFT_GAIN,
                  f"{cell}: {name} post-drift accuracy {post[name]:.3f} is "
                  f"not {DRIFT_GAIN} above the baseline's "
                  f"{post['baseline']:.3f}")
        print(f"  {cell}: post-drift gain over the baseline: " + ", ".join(
            f"{n} {post[n] - post['baseline']:+.3f}" for n in
            ("forget", "window", "adaptive")) + f" (at least {DRIFT_GAIN})")


def agreement_phase(cfg, arrays, path: str, n_samples: int = 800) -> None:
    knobs = {**PATHS, **RETIRE_PATHS}[path][0]
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 8, n_samples=n_samples)
    knobs = window_capacity(knobs, per_stream)
    _, on_card = serve(cfg, streams, t_max, per_stream, 4, "cuda", **knobs)
    streams, _ = make_streams(arrays, 8, n_samples=n_samples)
    _, on_cpu = serve(cfg, streams, t_max, per_stream, 4, "cpu", **knobs)
    total = agree = 0
    diffs = {"p": 0.0, "q": 0.0, "W": 0.0}
    for rid, r in on_cpu.items():
        g = on_card[rid]
        total += len(r.preds)
        agree += sum(int(a == b) for a, b in zip(g.preds, r.preds))
        for k in diffs:
            d = (getattr(g.final_state.params, k).cpu()
                 - getattr(r.final_state.params, k)).abs().max()
            diffs[k] = max(diffs[k], float(d))
    frac = agree / total
    print(f"  {path}: card vs CPU: {agree}/{total} predictions agree "
          f"({frac:.4f}); "
          f"largest final |dp| {diffs['p']:.3e}, |dq| {diffs['q']:.3e}, "
          f"|dW| {diffs['W']:.3e}")
    check(frac >= 0.98, f"{path}: card and CPU agree on {frac:.4f} < 0.98")


def timed(obj, name: str, log: list) -> None:
    """Wrap the bound method ``name`` of ``obj`` to append each call's wall
    seconds (synchronized) to ``log``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def chosen_beta(model: DFRModel, train, params) -> tuple:
    """The beta of the sweep whose solve gives the fitted W: fit_ridge's
    statistics and solves repeated for ``params``' (p, q), each beta's W
    compared with the fitted one.  Returns (beta, max |dW| / max |W| per
    finite beta)."""
    cfg = model.cfg
    A, B = model.ridge_statistics(train, params, CHUNK)
    dist = {}
    for beta in cfg.betas:
        Wt = ridge.ridge_solve(A, ridge.regularize(B, beta))
        if bool(torch.isfinite(Wt).all()):
            dist[beta] = float((Wt[:, :-1] - params.W).abs().max()
                               / params.W.abs().max())
    return min(dist, key=dist.get), dist


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def check_launches(what: str, launches: dict, on_path) -> None:
    """Every kernel of ``on_path`` launched, no other."""
    print(f"  {what}: launches: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in launches.items()))
    for name, n in launches.items():
        ok = n > 0 if name in on_path else n == 0
        check(ok, f"{what}: {name} launched {n} times")


def training_phase(card: str, cfg, data) -> dict:
    """DFRModel.fit at full width, then OnlineDFR over the training split;
    returns the fit's launches of the training path's kernels."""
    train, test = data
    fit_cfg = dataclasses.replace(cfg, epochs=FIT_EPOCHS)
    model = DFRModel.create(fit_cfg,
                            generator=torch.Generator().manual_seed(0))
    sgd_s, ridge_s = [], []
    timed(model, "fit_sgd", sgd_s)
    timed(model, "fit_ridge", ridge_s)
    cut = "" if FIT_EPOCHS == cfg.epochs else \
        f" (CUT from the paper's {cfg.epochs})"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params = model.fit(train, minibatch=FIT_MINIBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    del model.fit_sgd, model.fit_ridge
    tag = f"[{card}] DFRModel.fit"
    # select='val' trains on all but a quarter, minibatches of 4
    steps = FIT_EPOCHS * ((train.batch - train.batch // 4) // 4)
    print(f"  {tag}: ARAB Nx={cfg.n_nodes} s={cfg.s}, {train.batch} "
          f"samples, {FIT_EPOCHS} epochs{cut}, minibatch 4, select='val': "
          f"{wall:.2f} s; fit_sgd {sum(sgd_s):.2f} s ({steps} steps, "
          f"{1e3 * sum(sgd_s) / steps:.3f} ms a step), fit_ridge "
          f"{sum(ridge_s):.2f} s ({len(ridge_s)} calls, "
          f"{1e3 * np.median(ridge_s):.1f} ms median)")
    check_launches(tag, launches, TRAINING_KERNELS)
    check(all(bool(torch.isfinite(t).all()) for t in
              (params.p, params.q, params.W, params.b)),
          "DFRModel.fit: non-finite parameters")
    beta, dist = chosen_beta(model, train, params)
    acc_tr = float(model.accuracy(train, params))
    acc_te = float(model.accuracy(test, params))
    print(f"  {tag}: p {float(params.p):.6g}, q {float(params.q):.6g}, "
          f"beta {beta:g} (max |dW| / max |W| against each finite beta's "
          f"solve: {', '.join(f'{b:g}: {d:.2e}' for b, d in dist.items())}); "
          f"train accuracy {acc_tr:.4f}, test accuracy {acc_te:.4f} on "
          f"{test.batch}")
    check(dist[beta] <= 1e-3, "no beta of the sweep gives the fitted W")
    check(acc_te > 3.0 / cfg.n_classes, f"test accuracy {acc_te}")

    # the single-stream edge loop on the same mask: at ONLINE_LR, and at
    # the rate of the reference's own edge-loop test (JPVOW, Nx=16), which
    # at ARAB's width leaves B + 1e-2 I too ill-conditioned for fp32; that
    # episode's finiteness must match the CPU's
    for lr in (ONLINE_LR, 0.5):
        state, acc = online_episode(cfg, model.mask, train, test, lr, "cuda")
        if lr == ONLINE_LR:
            check(acc is not None and acc > 3.0 / cfg.n_classes,
                  f"OnlineDFR at lr {lr}: test accuracy {acc}")
        else:
            _, acc_cpu = online_episode(cfg, model.mask, train, test, lr,
                                        "cpu")
            print(f"  [OnlineDFR] lr {lr}: refresh finite on the card "
                  f"{acc is not None}, on the CPU {acc_cpu is not None}")
            check((acc is None) == (acc_cpu is None),
                  "OnlineDFR: card and CPU disagree on a finite refresh")

    profile_training(card, model, train, params)
    return {name: launches[name] for name in TRAINING_KERNELS}


def online_episode(cfg, mask, train, test, lr: float, device: str):
    """OnlineDFR over the training split in windows of 8 at learning rate
    ``lr``, then refresh_output(1e-2); on the card every call's launches
    are read apart.  Returns the state and the test accuracy (None when
    the refreshed readout is not finite)."""
    card = device == "cuda"
    online = OnlineDFR(cfg, mask=mask, device=device)
    state = online.init()
    reset_launches()
    t0 = time.perf_counter()
    for lo in range(0, train.batch - 7, 8):
        state, _ = online.step(state, train.u[lo:lo + 8],
                               train.length[lo:lo + 8],
                               train.label[lo:lo + 8], lr, lr)
    if card:
        torch.cuda.synchronize()
        check_launches(f"[OnlineDFR] lr {lr}: step", read_launches(),
                       TRAINING_KERNELS[:2])
        reset_launches()
    steps_s = time.perf_counter() - t0
    state = online.refresh_output(state, 1e-2)
    if card:
        check_launches(f"[OnlineDFR] lr {lr}: refresh_output",
                       read_launches(), TRAINING_KERNELS[2:])
        reset_launches()
    preds = online.infer(state, test.u, test.length).cpu()
    if card:
        check_launches(f"[OnlineDFR] lr {lr}: infer", read_launches(),
                       TRAINING_KERNELS[:2])
    finite = bool(torch.isfinite(state.params.W).all())
    acc = float((preds == test.label).float().mean()) if finite else None
    print(f"  [OnlineDFR] {device}, lr {lr}: {train.batch // 8} windows of "
          f"8 in {steps_s:.2f} s; p {float(state.params.p):.6g}, q "
          f"{float(state.params.q):.6g}; refresh_output(1e-2) "
          + (f"test accuracy {acc:.4f} on {test.batch}" if finite else
             "NOT FINITE (B + 1e-2 I is not positive definite in fp32)"))
    return state, acc


def profile_training(card: str, model: DFRModel, train, params,
                     top: int = 6) -> None:
    """torch.profiler over one fit_ridge at full width and over one SGD
    epoch of 256 samples: the device's busy share and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sub = TimeSeriesBatch(u=train.u[:CHUNK], length=train.length[:CHUNK],
                          label=train.label[:CHUNK])
    one_epoch = DFRModel(dataclasses.replace(model.cfg, epochs=1),
                         model.mask)
    for what, fn in (
            (f"fit_ridge, {train.batch} samples",
             lambda: model.fit_ridge(train, params)),
            ("fit_sgd, one epoch of 256 samples",
             lambda: one_epoch.fit_sgd(sub, minibatch=4))):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"  [{card}] {what}: launches " + ", ".join(
            f"{name.split()[0]} {n}" for name, n in read_launches().items()
            if n))
        events = prof.key_averages()
        dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        print(f"  [{card}] {what}: profiled {wall:.3f} s, device busy "
              f"{1e3 * busy:.3f} ms = {100 * busy / wall:.1f}% (idle "
              f"{100 - 100 * busy / wall:.1f}%)")
        for e in dev[:top]:
            print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")
        check(busy > 0, "the profiler saw no device time")


def training_agreement_phase(cfg, data) -> None:
    """The same reduced fit on the card and on the CPU."""
    train, test = data
    sub = TimeSeriesBatch(u=train.u[:AGREE_SAMPLES],
                          length=train.length[:AGREE_SAMPLES],
                          label=train.label[:AGREE_SAMPLES])
    small = dataclasses.replace(cfg, epochs=AGREE_EPOCHS)
    mask = DFRModel.create(small, device="cpu").mask
    out = {}
    for device in ("cuda", "cpu"):
        model = DFRModel(small, mask, device=device)
        t0 = time.perf_counter()
        params = model.fit(sub, minibatch=4)
        beta, _ = chosen_beta(model, sub, params)
        out[device] = (params, beta, model.predict(test, params).cpu(),
                       time.perf_counter() - t0)
    (pg, bg, yg, tg), (pc, bc, yc, tc) = out["cuda"], out["cpu"]
    agree = float((yg == yc).float().mean())
    dW = float((pg.W.cpu() - pc.W).abs().max() / pc.W.abs().max())
    print(f"  DFRModel.fit, {AGREE_SAMPLES} samples, {AGREE_EPOCHS} epochs: "
          f"card {tg:.1f} s, CPU {tc:.1f} s; beta card {bg:g}, CPU {bc:g}; "
          f"{agree:.4f} of {test.batch} test predictions agree; |dp| "
          f"{abs(float(pg.p) - float(pc.p)):.3e}, |dq| "
          f"{abs(float(pg.q) - float(pc.q)):.3e}, max |dW| / max |W| "
          f"{dW:.3e}")
    check(bg == bc, f"card and CPU chose beta {bg:g} and {bc:g}")
    check(agree >= 0.98, f"card and CPU agree on {agree:.4f} < 0.98")


def k8_records(dev) -> dict:
    """K8 against its plain version on the card over K8_CASES, each beside
    the library's scaled_dot_product_attention; the JSON record holds the
    prefill case's numbers and the largest error over the bf16 cases."""
    import torch.nn.functional as F

    rec = None
    err_bf16 = 0.0
    for label, b, h, kv, tq, tk, d, causal, window, dtype, layout in \
            K8_CASES:
        g = torch.Generator(device=dev).manual_seed(tq + d)
        shapes = ((b, tq, h, d), (b, tk, kv, d), (b, tk, kv, d))
        bufs = [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in shapes]
        q, k, v = (t.transpose(1, 2) for t in bufs)
        if layout == "bhtd":
            q, k, v = (t.contiguous() for t in (q, k, v))
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, backend="cuda", **kw)
        dense = 4 * b * h * tq * tk <= K8_DENSE_MAX_BYTES
        if dense:
            plain_fn = lambda: ops.flash_attention(  # noqa: E731
                q, k, v, backend="torch", **kw)
        else:
            plain_fn = lambda: blockwise_attention(  # noqa: E731
                *bufs, **kw).transpose(1, 2)
        want = plain_fn()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K8 {label}: non-finite")
        e = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **K8_TOL[dtype])
        print(f"  K8 {label} ({layout}, plain "
              f"{'dense' if dense else 'blockwise'}): max abs err {e:.3e}, "
              f"max |want| {float(want.float().abs().max()):.3e} (tolerance "
              f"{K8_TOL[dtype]}, {dtype})")
        check(ok, f"K8 {label}: kernel disagrees with its plain version")
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, e)
        del got, want
        ms = device_ms(lambda: ops.flash_attention(q, k, v, backend="cuda",
                                                   **kw), reps=20)
        plain = wall_ms(plain_fn, reps=3 if dense else 1)
        if window:
            # the library takes a window only as a mask, on expanded heads
            q_pos = torch.arange(tq, device=dev)[:, None]
            k_pos = torch.arange(tk, device=dev)[None, :]
            mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
            ke, ve = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, ke, ve, attn_mask=mask)
        else:
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        lib = device_ms(lib_fn, reps=20)
        # the live (q, k) pairs of this mask, 4 D flops each (two products)
        rows = np.arange(tq)
        hi = np.minimum(rows, tk - 1) if causal else np.full(tq, tk - 1)
        lo = np.maximum(rows - window + 1, 0) if window else np.zeros(tq)
        pairs = int(np.clip(hi - lo + 1, 0, None).sum())
        es = torch.finfo(dtype).bits // 8
        peak = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else \
            PEAK_FP32_FLOP_S
        t_bytes = es * d * (2 * b * h * tq + 2 * b * kv * tk) / PEAK_BYTES_S
        t_ops = 4 * b * h * d * pairs / peak
        bnd = (max(t_bytes, t_ops) * 1e3,
               "bytes" if t_bytes >= t_ops else "operations")
        flop = 4 * b * h * d * pairs
        print(f"  K8 {label} B={b} H={h} KV={kv} Tq={tq} Tk={tk} D={d} "
              f"causal={causal} window={window}, {K8_ROUTES[dtype]}: kernel "
              f"{ms:.4f} ms = {flop / ms / 1e9:.1f} TFLOP/s, plain "
              f"{plain:.3f} ms, scaled_dot_product_attention {lib:.4f} ms = "
              f"{flop / lib / 1e9:.1f} TFLOP/s, bound {bnd[0]:.5f} ms "
              f"({bnd[1]}; {flop:.3e} flop, {flop / bnd[0] / 1e9:.1f} "
              f"TFLOP/s)")
        if rec is None:
            rec = record("K8 flash_attention",
                         "src/repro_torch/kernels/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:27", 0.0, ms,
                         plain, bnd, lib)
            rec["routes"] = "; ".join(f"{str(t).split('.')[-1]}: {r}"
                                      for t, r in K8_ROUTES.items())
        del q, k, v, bufs
    rec["max_abs_err"] = err_bf16
    return {rec["name"]: rec}


def lm_model(dtype, device: str) -> Transformer:
    """smollm-135m at full width on the flash route, from the seed-0
    init (drawn on the CPU, so every device gets the same parameters)."""
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas",
                              dtype=dtype)
    return Transformer(cfg, device=device,
                       generator=torch.Generator().manual_seed(0))


def lm_tokens(b: int, t: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def serve_lm(model: Transformer, n: int, prompt_len: int, max_tokens: int,
             max_batch: int, max_len: int) -> tuple:
    """launch/serve.py's loop: n random prompts through the Server; returns
    (server, requests by id, wall seconds)."""
    server = Server(model, max_batch=max_batch, max_len=max_len)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(n):
        prompt = rng.integers(0, model.cfg.vocab, prompt_len).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_tokens=max_tokens))
    done = server.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return server, {r.rid: r for r in done}, time.perf_counter() - t0


def lm_phase(card: str) -> dict:
    """The LM main path at full width: prefills through K8, one under the
    profiler, then the Server; returns K8's launches of the first prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = lm_model(torch.bfloat16, "cuda")
    cfg = model.cfg
    prefill = make_prefill_step(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), "
          f"{n_params} parameters in {cfg.dtype}")
    k8_launches = None
    for b, t in PREFILL_SHAPES:
        batch = {"tokens": lm_tokens(b, t, cfg.vocab, seed=t)}
        prefill(batch)             # first use: allocations, library set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        print(f"  [{card}] prefill B={b} T={t}: {wall:.4f} s, "
              f"{b * t / wall:.1f} prefill tokens/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
              f"launches: " + ", ".join(f"{n.split()[0]} {c}"
                                        for n, c in launches.items() if c))
        check(tuple(logits.shape) == (b, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"prefill B={b} T={t}: logits {tuple(logits.shape)}, or not "
              f"finite")
        for name, count in launches.items():
            want = cfg.n_layers if name == "K8 flash_attention" else 0
            check(count == want, f"prefill B={b} T={t}: {name} launched "
                                 f"{count} times ({want} expected)")
        if k8_launches is None:
            k8_launches = launches["K8 flash_attention"]
        del logits

    b, t = PREFILL_SHAPES[0]
    batch = {"tokens": lm_tokens(b, t, cfg.vocab, seed=t)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev)
    flash = sum(e.self_device_time_total for e in dev if "flash" in e.key)
    print(f"  [{card}] prefill B={b} T={t} profiled: {wall:.4f} s, device "
          f"busy {busy / 1e3:.3f} ms = {100 * busy / 1e6 / wall:.1f}% of wall "
          f"(idle {100 - 100 * busy / 1e6 / wall:.1f}%); K8 "
          f"{flash / 1e3:.3f} ms = {100 * flash / max(busy, 1e-9):.1f}% of "
          f"the device time")
    for e in dev[:8]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy > 0 and flash > 0, "the profiler saw no device time in K8")

    serve_lm(model, 2, 8, 2, 2, 32)          # first use of the decode path
    reset_launches()
    server, done, wall = serve_lm(
        model, SERVE["requests"], SERVE["prompt_len"], SERVE["max_tokens"],
        SERVE["max_batch"], SERVE["max_len"])
    launches = read_launches()
    n_tok = sum(len(r.out_tokens) for r in done.values())
    lat = np.asarray([r.finish_t - r.submit_t for r in done.values()])
    print(f"  [{card}] Server {SERVE}: {len(done)} requests, {n_tok} tokens "
          f"in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), {server.steps} "
          f"steps ({1e3 * wall / server.steps:.2f} ms a step); request "
          f"latency p50 {np.median(lat):.3f} s, p99 "
          f"{np.percentile(lat, 99):.3f} s; K8 launches "
          f"{launches['K8 flash_attention']} (decode attention is the plain "
          f"einsum in both packages, so 0)")
    check(len(done) == SERVE["requests"]
          and n_tok == SERVE["requests"] * SERVE["max_tokens"],
          f"the Server answered {len(done)} requests with {n_tok} tokens")
    check(all(0 <= x < cfg.padded_vocab for r in done.values()
              for x in r.out_tokens), "a token out of range")
    check(all(n == 0 for n in launches.values()),
          f"the Server launched {launches}: decode runs no kernel")

    # where a decode step's time goes: one wave of 8 short requests
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        server, _, wall = serve_lm(model, SERVE["max_batch"], 4, 4,
                                   SERVE["max_batch"], SERVE["max_len"])
    events = prof.key_averages()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev)
    n_launch = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"  [{card}] Server decode profiled: {server.steps} steps in "
          f"{wall:.3f} s, device busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / 1e6 / wall:.1f}% of wall (idle "
          f"{100 - 100 * busy / 1e6 / wall:.1f}%); cudaLaunchKernel "
          f"{n_launch / server.steps:.0f} a step")
    for e in dev[:5]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:5]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy > 0, "the profiler saw no device time in the decode steps")
    return {"K8 flash_attention": k8_launches}


def lm_agreement_phase() -> None:
    """The LM at full width on the card and on the CPU, same parameters: a
    prefill of B=2, T=256, checked in fp32 and bf16, and the Server on 4
    requests, checked in fp32 and printed in bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        models = {d: lm_model(dtype, d) for d in ("cuda", "cpu")}
        toks = {"tokens": lm_tokens(2, 256, models["cpu"].cfg.vocab, seed=1)}
        logits = {d: make_prefill_step(m)(toks).float().cpu()
                  for d, m in models.items()}
        rel = float((logits["cuda"] - logits["cpu"]).abs().max()
                    / logits["cpu"].abs().max())
        same = bool((logits["cuda"].argmax(-1)
                     == logits["cpu"].argmax(-1)).all())
        tokens = {d: serve_lm(m, 4, 32, 16, 4, 256)[1]
                  for d, m in models.items()}
        pairs = [(a, b) for rid in tokens["cpu"]
                 for a, b in zip(tokens["cuda"][rid].out_tokens,
                                 tokens["cpu"][rid].out_tokens)]
        agree = sum(a == b for a, b in pairs) / len(pairs)
        fp32 = dtype == torch.float32
        limit = LM_REL if fp32 else LM_BF16_REL
        print(f"  {dtype}: prefill B=2 T=256 max |dlogits| / max |logits| "
              f"{rel:.3e} (limit {limit}), argmax equal {same}; Server 4 "
              f"requests: {agree:.4f} of {len(pairs)} greedy tokens equal"
              + ("" if fp32 else " (tokens printed, not checked)"))
        check(rel <= limit and same, f"card vs CPU prefill in {dtype}: "
                                     f"{rel}, argmax equal {same}")
        if fp32:
            check(agree >= LM_AGREE, f"card vs CPU tokens agree on {agree}")
        del models


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")),
                        verbose=True)
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(parallel nvcc, {', '.join(sorted(logs)) or 'already built'})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for lib, log in sorted(logs.items()):
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in line]
        check(not spills, f"{lib}.cu spills registers: {spills}")
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: sass.count(op) for op in K8_SASS}
    print("  flash_attention SASS: " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    check(all(counts.values()), f"K8's library lacks {counts}: the bf16 "
                                f"route must run wgmma on TMA-loaded tiles")
    imma = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("streaming_q8"))],
        capture_output=True, text=True, check=True,
        timeout=300).stdout.count("IMMA")
    print(f"  streaming_q8 SASS: IMMA {imma}")
    check(imma > 0, "K5's library has no IMMA: its DPRR product must run "
                    "mma.sync on int8")
    CHAIN.update(chain_latency.measure(), clock_hz=max_sm_clock_hz())
    print("  dependent-chain cycles of one warp (launch/chain_latency.py): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      {**CHAIN["op_cycles"], **CHAIN["step_cycles"]}.items()))

    t0 = time.perf_counter()
    cfg, arrays, data = load_arab()
    print(f"[3] kernels vs plain versions on the card (ARAB data made in "
          f"{time.perf_counter() - t0:.1f} s)")
    records = kernel_phase(dev)
    records.update(training_kernel_records(
        DFRModel.create(cfg, generator=torch.Generator().manual_seed(0)),
        data[0]))
    records.update(k8_records(dev))
    print("[4] main paths: StreamServer on ARAB at full width")
    launches = {}
    for path in PATHS:
        # each kernel reports the launches of the first path it is on
        for name, count in main_path_phase(card, cfg, arrays, path).items():
            launches.setdefault(name, count)
    print("[4b] where the server's time goes (torch.profiler)")
    for path in PATHS:
        for kind in KINDS:
            profile_phase(card, cfg, arrays, path, kind)
    print("[4c] captured, eager, and pipelined and blocked rounds, "
          "alternated")
    for path in PATHS:
        rounds_phase(card, cfg, arrays, path)
    print("[4d] the retirement modes at full width: captured, eager, and "
          "pipelined and blocked rounds, alternated")
    for path in RETIRE_PATHS:
        retirement_phase(card, cfg, arrays, path)
    print("[4e] the reference's drift cells on the card")
    drift_phase(card)
    print("[5] agreement, card vs CPU")
    for path in PATHS:
        agreement_phase(cfg, arrays, path)
    for path in RETIRE_PATHS:
        agreement_phase(cfg, arrays, path, n_samples=RETIRE_AGREE_SAMPLES)
    print("[6] the training path at full width: DFRModel.fit, OnlineDFR")
    launches.update(training_phase(card, cfg, data))
    print("[7] training path agreement, card vs CPU")
    training_agreement_phase(cfg, data)
    print(f"[8] the LM main path at full width: {LM_ARCH}, "
          f"attn_impl='pallas', bf16")
    launches.update(lm_phase(card))
    print("[9] the LM at full width, card vs CPU")
    lm_agreement_phase()

    for name, count in launches.items():
        records[name]["launches"] = count
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(card_line())
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + (("routes",) if "routes" in r else ())}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
