#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one CUDA device (an H100; the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. TF32 off for matmuls and cuDNN (the s=931 ridge solves need full
     fp32); print the card's name and power limit.
  2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
  3. K1 (training forward) and K2 (streaming logits) against their plain
     PyTorch versions on the card, at the server's shapes (32 slots x a
     window of 4 = 128 samples, T=93, Nx=30, Ny=10, ragged lengths down to
     1), with times.
  4. The port's main path at full width: the paper's ARAB configuration
     (Nx=30, linear f, 13 inputs, 10 classes, s=931), its full 6600-sample
     training set split into 64 streams, served by StreamServer with 32
     slots and windows of 4.  Both kernels' launch counts must equal the
     number of server rounds.
  4b. One wave of the same path under torch.profiler: the device's busy
     share and the kernels and host ops that take the time.
  5. Agreement: a reduced episode (8 streams on 4 slots, the first 800 ARAB
     samples, same widths) served on the card and on the CPU.
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
from repro_torch.kernels import streaming as k_streaming  # noqa: E402
from repro_torch.kernels import train as k_train  # noqa: E402
from repro_torch.runtime import StreamRequest, StreamServer  # noqa: E402

PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12   # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order


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


def device_ms(fn, reps: int = 50) -> float:
    """Median device time of one call: a busy-wait kernel keeps the card
    occupied while the host enqueues the start event, the call and the end
    event, so the events bracket the call's device work and not the host's
    launch latency."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
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


def bound(live_steps: int, n: int, nx: int, extra_bytes: int,
          extra_flops: int) -> tuple:
    """Least time for the work this run's inputs need: each live step of a
    sample reads Nx inputs and does 3 Nx^2 + 7 Nx flops (nonlinearity, ring
    matvec, DPRR update); frozen steps past a length need nothing."""
    nbytes = live_steps * nx * 4 + n * 4 + extra_bytes
    flops = live_steps * (3 * nx * nx + 7 * nx) + extra_flops
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    S, W, T, nx, ny = 32, 4, 93, 30, 10
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
    return {r["name"]: r for r in records}


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


def serve(cfg, streams, t_max, per_stream, max_streams, device):
    srv = StreamServer(cfg, t_max=t_max, max_streams=max_streams, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device=device)
    for s in streams:
        srv.submit(s)
    done = srv.run_until_drained(strict=True)
    return srv, {r.rid: r for r in done}


def main_path_phase(card: str, cfg, arrays) -> dict:
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 64)
    n_total = sum(s.n_samples for s in streams)
    # warm-up: one-time CUDA library set-up (cuBLAS, cuSOLVER) stays out of
    # the measured episode
    wstreams, wper = make_streams(arrays, 2, n_samples=16)
    serve(cfg, wstreams, t_max, wper, 2, "cuda")
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    k_train.KERNEL.launches = 0
    k_streaming.KERNEL.launches = 0
    t0 = time.perf_counter()
    srv, done = serve(cfg, streams, t_max, per_stream, 32, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1 train_forward": k_train.KERNEL.launches,
                "K2 streaming_logits": k_streaming.KERNEL.launches}
    rounds = srv.global_step
    served = sum(len(r.preds) for r in done.values())
    lat = srv.latency_percentiles_ms()
    acc = float(np.mean([r.online_accuracy for r in done.values()]))
    print(f"  [{card}] ARAB Nx=30 s={cfg.s}: {len(done)} streams, "
          f"{rounds} rounds, {served} samples served in {wall:.3f} s "
          f"({served / wall:.1f} samples/s)")
    print(f"  [{card}] step p50 {lat['p50_ms']:.3f} ms, p99 "
          f"{lat['p99_ms']:.3f} ms (prediction read p50 "
          f"{lat['drain_p50_ms']:.3f} ms); mean rolling online accuracy "
          f"{acc:.4f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"  [{card}] launches: K1 {launches['K1 train_forward']}, "
          f"K2 {launches['K2 streaming_logits']} over {rounds} rounds")
    check(served == n_total, f"served {served} of {n_total} samples")
    check(len(done) == len(streams), "not every stream completed")
    for name, count in launches.items():
        check(count == rounds, f"{name}: {count} launches over {rounds} "
                               f"rounds (one per round expected)")
    for r in done.values():
        st = r.final_state
        check(all(bool(torch.isfinite(t).all()) for t in
                  (st.params.p, st.params.q, st.params.W, st.params.b)),
              f"stream {r.rid}: non-finite final parameters")
        check(all(0 <= x < cfg.n_classes for x in r.preds),
              f"stream {r.rid}: prediction out of range")
    return launches


def profile_phase(card: str, cfg, arrays, top: int = 8) -> None:
    """Where a server step's time goes: one wave of the main path (32 ARAB
    streams on the 32 slots) under torch.profiler.  Prints the device's
    busy share of the wall time and the kernels and host ops that take the
    most time.  Profiling slows the host, so the main path's own numbers
    come from phase 4, not from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 32, n_samples=3300)
    srv = StreamServer(cfg, t_max=t_max, max_streams=32, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device="cuda")
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
    print(f"  [{card}] profiled {srv.global_step} rounds in {wall:.3f} s; "
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


def agreement_phase(cfg, arrays) -> None:
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 8, n_samples=800)
    _, on_card = serve(cfg, streams, t_max, per_stream, 4, "cuda")
    streams, _ = make_streams(arrays, 8, n_samples=800)
    _, on_cpu = serve(cfg, streams, t_max, per_stream, 4, "cpu")
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
    print(f"  card vs CPU: {agree}/{total} predictions agree ({frac:.4f}); "
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
    logs = _build.build(["train", "streaming"], verbose=True)
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
    print(f"[4] main path: StreamServer on ARAB at full width "
          f"(data made in {time.perf_counter() - t0:.1f} s)")
    launches = main_path_phase(card, cfg, arrays)
    print("[4b] where the server's time goes (torch.profiler)")
    profile_phase(card, cfg, arrays)
    print("[5] agreement, card vs CPU")
    agreement_phase(cfg, arrays)

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
