#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one CUDA device (an H100; the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. TF32 off for matmuls and cuDNN (the s=931 ridge solves need full
     fp32); print the card's name and power limit.
  2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once.
  3. Each kernel against its plain PyTorch version on the card, at the
     server's shapes, with times: K1 (training forward), K2 (streaming
     logits) and K5 (int8 streaming logits, int32 accumulators equal bit
     for bit) at 32 slots x a window of 4 = 128 samples, T=93, Nx=30,
     Ny=10, ragged lengths down to 1; K3 (factor fold) at 32 factors of
     931 x 931 and windows of 4 rows, sign +1, and sign -1 with one
     guard-skipped rotation.
  4. The port's main paths at full width: the paper's ARAB configuration
     (Nx=30, linear f, 13 inputs, 10 classes, s=931), its full 6600-sample
     training set split into 64 streams, served by StreamServer with 32
     slots and windows of 4.  Two episodes, each with every launch count
     set to 0 before it and read after it:
       fp32   - recompute refresh: K1 and K2 once per round;
       int8   - quantize='int8', refresh_mode='incremental': K1, K2, K5 and
                K3 once per round.
  4b. One wave of each episode under torch.profiler: the device's busy
     share and the kernels and host ops that take the time.
  5. Agreement: a reduced episode of each kind (8 streams on 4 slots, the
     first 800 ARAB samples, same widths) served on the card and on the CPU.
The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.  Exits non-zero, printing no result, without a CUDA
device or without the repository's sources.
"""
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

from repro_torch.core.types import DFRConfig  # noqa: E402
from repro_torch.data import PAPER_DATASETS, load  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import cholupdate as k_cholupdate  # noqa: E402
from repro_torch.kernels import streaming as k_streaming  # noqa: E402
from repro_torch.kernels import streaming_q8 as k_streaming_q8  # noqa: E402
from repro_torch.kernels import train as k_train  # noqa: E402
from repro_torch.runtime import StreamRequest, StreamServer  # noqa: E402

PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_INT8_OP_S = 1979e12   # H100 SXM int8, dense
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order
K3_REL = 1e-4   # K3: max |dLt| <= K3_REL * max |Lt| (rotations divide)
# phase 3 at the server's shapes: slots, window, T, Nx, Ny for K1, K2 and
# K5; factors, rows per window, s = Nx^2 + Nx + 1 for K3
STREAM_SHAPE = (32, 4, 93, 30, 10)
K3_SHAPE = (32, 4, 931)

KERNELS = {"K1 train_forward": k_train.KERNEL,
           "K2 streaming_logits": k_streaming.KERNEL,
           "K5 streaming_logits_q8": k_streaming_q8.KERNEL,
           "K3 cholupdate_window_t": k_cholupdate.KERNEL}
# the main paths: server knobs and the kernels each must launch every round
PATHS = {
    "fp32": (dict(), ("K1 train_forward", "K2 streaming_logits")),
    "int8": (dict(quantize="int8", refresh_mode="incremental"),
             tuple(KERNELS)),
}


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
    lengths[:3] = (1, T, 2)
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
        return ops.streaming_logits_slots(j, lens, p, q, Wr, b, f,
                                          backend=backend)

    def k1(backend):
        return ops.train_forward(j, lens, p, q, f, backend=backend)

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
              f"Ny={ny}, {live_steps} live steps")
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
            j, lens, p, q, Wq, w_scale, x_scale, b, f, backend=backend,
            return_acc=acc)

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
    print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50; the "
          f"wrapper's code and scale prep {prep_ms:.4f} ms more), plain "
          f"{plain_ms:.3f} ms (back to back), bound {bnd:.5f} ms ({by}) at "
          f"B={n} T={T} Nx={nx} Ny={ny}, {live} live steps")
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
              f"max |Lt| {rel:.3e} (tolerance {K3_REL})")
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
    print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50), plain "
          f"{plain_ms:.1f} ms (back to back), bound {bnd:.5f} ms ({by}) at "
          f"K={K} W={W} s={s}")
    return [dict(name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/cholupdate.cu",
                 replaces="src/repro/kernels/cholupdate.py:53",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                 bound_by=by, library_ms=None)]


def load_arab():
    """The paper's ARAB configuration (configs/dfr_paper.py) and its full
    training split as numpy arrays."""
    spec = PAPER_DATASETS["ARAB"]
    train, _ = load("ARAB")
    cfg = DFRConfig(n_in=spec.n_in, n_classes=spec.n_classes, n_nodes=30,
                    nonlinearity="linear")
    return cfg, (train.u.numpy(), train.length.numpy(), train.label.numpy())


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


def main_path_phase(card: str, cfg, arrays, path: str) -> dict:
    """One full-width ARAB episode of ``path`` (see PATHS), with every
    kernel's launch count set to 0 just before it and read just after."""
    knobs, on_path = PATHS[path]
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 64)
    n_total = sum(s.n_samples for s in streams)
    # warm-up on all 32 slots through a refresh round: one-time CUDA library
    # set-up and the first load of each kernel at the episode's batch
    # shapes stay out of the measured episode
    wstreams, wper = make_streams(arrays, 32, n_samples=32 * 24)
    serve(cfg, wstreams, t_max, wper, 32, "cuda", **knobs)
    del wstreams   # their final-state snapshots would count in the peak
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    srv, done = serve(cfg, streams, t_max, per_stream, 32, "cuda", **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernel.launches for name, kernel in KERNELS.items()}
    rounds = srv.global_step
    served = sum(len(r.preds) for r in done.values())
    lat = srv.latency_percentiles_ms()
    acc = float(np.mean([r.online_accuracy for r in done.values()]))
    tag = f"[{card}] {path}"
    print(f"  {tag}: ARAB Nx={cfg.n_nodes} s={cfg.s} {knobs or 'defaults'}: "
          f"{len(done)} streams, {rounds} rounds, {served} samples served "
          f"in {wall:.3f} s ({served / wall:.1f} samples/s)")
    print(f"  {tag}: step p50 {lat['p50_ms']:.3f} ms, p99 "
          f"{lat['p99_ms']:.3f} ms (prediction read p50 "
          f"{lat['drain_p50_ms']:.3f} ms); mean rolling online accuracy "
          f"{acc:.4f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if knobs.get("quantize") == "int8":
        print(f"  {tag}: {srv.served_int8} of {served} predictions "
              f"({srv.served_int8 / served:.4f}) served from armed int8 "
              f"slots")
        check(srv.served_int8 > 0, "no prediction came from an armed slot")
    print(f"  {tag}: launches: " + ", ".join(
        f"{name.split()[0]} {count}" for name, count in launches.items())
        + f" over {rounds} rounds")
    check(served == n_total, f"served {served} of {n_total} samples")
    check(len(done) == len(streams), "not every stream completed")
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


def profile_phase(card: str, cfg, arrays, path: str, top: int = 8) -> None:
    """Where a server step's time goes: one wave of the main path ``path``
    (32 ARAB streams on the 32 slots) under torch.profiler.  Prints the
    device's busy share of the wall time and the kernels and host ops that
    take the most time.  Profiling slows the host, so the main path's own
    numbers come from phase 4, not from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 32, n_samples=3300)
    srv = StreamServer(cfg, t_max=t_max, max_streams=32, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device="cuda", **PATHS[path][0])
    for s in streams:
        srv.submit(s)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        srv.run_until_drained(strict=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel events only: an operator's device time repeats its kernels'
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in dev)
    print(f"  [{card}] {path}: profiled {srv.global_step} rounds in "
          f"{wall:.3f} s; "
          f"device busy {busy_us / 1e3:.3f} ms = "
          f"{100 * busy_us / 1e6 / wall:.1f}% of wall (idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%)")
    for e in dev[:top]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:top]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy_us > 0, "the profiler saw no device time")


def agreement_phase(cfg, arrays, path: str) -> None:
    knobs = PATHS[path][0]
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 8, n_samples=800)
    _, on_card = serve(cfg, streams, t_max, per_stream, 4, "cuda", **knobs)
    streams, _ = make_streams(arrays, 8, n_samples=800)
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
    check(frac >= 0.98, f"card and CPU agree on {frac:.4f} < 0.98")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build(["train", "streaming", "streaming_q8", "cholupdate"],
                        verbose=True)
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(parallel nvcc, {', '.join(sorted(logs)) or 'already built'})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3] kernels vs plain versions on the card")
    records = kernel_phase(dev)
    t0 = time.perf_counter()
    cfg, arrays = load_arab()
    print(f"[4] main paths: StreamServer on ARAB at full width "
          f"(data made in {time.perf_counter() - t0:.1f} s)")
    launches = {}
    for path in PATHS:
        # each kernel reports the launches of the first path it is on
        for name, count in main_path_phase(card, cfg, arrays, path).items():
            launches.setdefault(name, count)
    print("[4b] where the server's time goes (torch.profiler)")
    for path in PATHS:
        profile_phase(card, cfg, arrays, path)
    print("[5] agreement, card vs CPU")
    for path in PATHS:
        agreement_phase(cfg, arrays, path)

    for name, count in launches.items():
        records[name]["launches"] = count
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(card_line())
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
