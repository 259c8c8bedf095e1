"""Time the DFR kernels and fit_ridge in several source trees, alternating
between them in one run, on one CUDA device.

    python src/repro_torch/launch/ab_time.py TREE [TREE ...] [--rounds 4]

Each TREE is the root of a checkout of this repository.  The script runs
itself once per (round, tree), each time in a fresh process whose
``repro_torch`` is the one in ``TREE/src``: the trees in the given order in
even rounds and in the reverse order in odd ones (A B C, C B A, ...), so
that a drift of the host's speed over the run falls on every tree alike.
Each tree's kernels build at its first use, into ``TREE/build/kernels``.
A process prints one JSON line, in the run's order:

- ``fit_ridge_ms``: the wall time of each of ``--calls`` calls of
  ``DFRModel.fit_ridge`` on ARAB's 6600 training samples at full width
  (Nx = 30, s = 931, chunks of 256, the blocked solve over the beta
  sweep), synchronized, after one warm-up call; ``fit_ridge_device_ms``:
  the device's busy time in one more call, from torch.profiler;
- ``k6_ms``: K6's device time (the median of 50) at fit_sgd's minibatch of
  4, a chunk of 256 and all 6600 samples;
- ``k7_ms``: K7's device time (the median of 50) at fit_sgd's minibatch of
  4, a chunk of 256 and all 6600 samples, ``bmm_ms`` one ``torch.bmm`` of
  the same DPRR beside each;
- ``k3_ms``: K3's device time (the median of 50) on chip_smoke.py's fold
  at (32, 4, 931), and ``k3_equal``, whether it equals its plain version
  bit for bit there;
- ``k1_ms`` and ``k2_ms``: K1's and K2's device times (the median of 50)
  on chip_smoke.py's phase-3 operands (32 slots x a window of 4, T = 93,
  Nx = 30, Ny = 10, the paper's ARAB configuration), each kernel called
  through its wrapper on the flat operands;
- ``k5_ms``: K5's device time (the median of 50) on the same operands (the
  kernel alone on the codes and scales its wrapper builds), and
  ``k5_equal``, whether its int32 accumulators equal its plain version's
  there.

It calls only APIs that the package has had since DFRModel was ported, so
it also runs on older trees.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def device_ms(fn, reps: int = 50, setup=None) -> float:
    """Median device time of one call, the card kept busy while the host
    enqueues it (as chip_smoke.py times its kernels)."""
    import torch
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


def measure(label: str, calls: int) -> dict:
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import masking
    from repro_torch.core.dfr import DFRModel
    from repro_torch.core.types import DFRConfig
    from repro_torch.data import PAPER_DATASETS, load
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = PAPER_DATASETS["ARAB"]
    train, _ = load("ARAB")
    cfg = DFRConfig(n_in=spec.n_in, n_classes=spec.n_classes, n_nodes=30,
                    nonlinearity="linear")
    model = DFRModel.create(cfg, generator=torch.Generator().manual_seed(0))
    params = model.init_params()
    out = {"label": label}

    def fit_ridge():
        model.fit_ridge(train, params)
        torch.cuda.synchronize()

    fit_ridge()  # builds the kernels
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fit_ridge()
        walls.append(1e3 * (time.perf_counter() - t0))
    out["fit_ridge_ms"] = walls
    out["fit_ridge_median_ms"] = statistics.median(walls) if walls else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fit_ridge()
    out["fit_ridge_device_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA) / 1e3

    dev, nx = model.device, cfg.n_nodes
    j_all = masking.apply_mask(model.mask, train.u.to(dev))
    lens = train.length.to(dev)
    out["k6_ms"], out["k7_ms"], out["bmm_ms"] = {}, {}, {}
    for n in (4, 256, train.batch):
        j, ln = j_all[:n], lens[:n]

        def k6():
            return ops.reservoir_states(j, ln, params.p, params.q, nx,
                                        f=cfg.f(), backend="cuda")

        x = k6()
        out["k6_ms"][n] = device_ms(k6)
        out["k7_ms"][n] = device_ms(
            lambda: ops.dprr_features(x, ln, nx, backend="cuda"))
        step = torch.arange(x.shape[1], device=dev)
        x1m = (x * (step[None, :] < ln[:, None])[..., None]).mT.contiguous()
        x0 = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
        x0a = torch.cat([x0, torch.ones_like(x0[..., :1])], -1).contiguous()
        out["bmm_ms"][n] = device_ms(lambda: torch.bmm(x1m, x0a))

    # chip_smoke.py's K3 operands at the server's fold
    K, W, s = 32, 4, 931
    g = torch.Generator().manual_seed(0)
    Lt = torch.triu(0.05 * torch.randn(K, s, s, generator=g), diagonal=1)
    Lt = (Lt + torch.diag_embed(1.0 + torch.rand(K, s, generator=g))).to(dev)
    X = (0.3 * torch.randn(K, W, s, generator=g)).to(dev)
    X[:, 1] = 0.0
    got = ops.cholupdate_window_t(Lt, X, 1.0, backend="cuda")
    want = ops.cholupdate_window_t(Lt, X, 1.0, backend="torch")
    out["k3_equal"] = bool(torch.equal(got, want))
    out["k3_ms"] = device_ms(
        lambda dst: ops.cholupdate_window_t(dst, X, out=dst, backend="cuda"),
        setup=Lt.clone)
    out.update(stream_timing(dev))
    return out


def stream_timing(dev) -> dict:
    """K1, K2 and K5 on chip_smoke.py's phase-3 operands: their device
    times, and whether K5's accumulators equal the plain version's."""
    import numpy as np
    import torch

    from repro_torch.core.types import DFRConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import streaming as k_streaming
    from repro_torch.kernels import streaming_q8 as k_q8
    from repro_torch.kernels import train as k_train

    S, W, T, nx, ny = 32, 4, 93, 30, 10
    n = S * W
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, T + 1, n)
    lengths[:6] = (1, T, 2, 0, 16, 17)  # chip_smoke.py's STREAM_LENGTHS
    j = torch.from_numpy(rng.normal(size=(S, W, T, nx)).astype(np.float32))
    lens = torch.from_numpy(lengths.reshape(S, W).astype(np.int32))
    p = torch.from_numpy(rng.uniform(0.01, 0.5, S).astype(np.float32))
    q = torch.from_numpy(rng.uniform(-0.5, 0.5, S).astype(np.float32))
    Wr = torch.from_numpy(
        (0.01 * rng.normal(size=(S, ny, nx * (nx + 1)))).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(S, ny)).astype(np.float32))
    f = DFRConfig(n_in=1, n_classes=ny, n_nodes=nx).f()
    jf, lf, pd, qd, Wd, bd = (t.to(dev) for t in (
        j.reshape(n, T, nx), lens.reshape(n), p, q, Wr, b))
    out = {"k1_ms": device_ms(
               lambda: k_train.train_forward_cuda(jf, lf, pd, qd, f)),
           "k2_ms": device_ms(lambda: k_streaming.streaming_logits_cuda(
               jf, lf, pd, qd, Wd, bd, f))}
    rng = np.random.default_rng(1)
    Wq = torch.from_numpy(rng.integers(-127, 128, (S, ny, nx * (nx + 1)))
                          .astype(np.int8))
    w_scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, S).astype(np.float32))
    x_scale = torch.from_numpy(rng.uniform(0.01, 0.05, S).astype(np.float32))
    w_scale[-1] = x_scale[-1] = 0.0
    args = [t.to(dev) for t in (j, lens, p, q, Wq, w_scale, x_scale, b)]
    accs = [ops.streaming_logits_slots_q8(*args, nx, f=f, backend=be,
                                          return_acc=True)[1]
            for be in ("cuda", "torch")]
    flat = ops.streaming_q8_operands(*args, f)
    out["k5_equal"] = bool(torch.equal(*accs))
    out["k5_ms"] = device_ms(lambda: k_q8.streaming_logits_q8_cuda(*flat))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=20,
                    help="timed fit_ridge calls a process")
    ap.add_argument("--child", metavar="LABEL",
                    help="measure the repro_torch on the path (internal)")
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(measure(args.child, args.calls)), flush=True)
        return 0
    for i in range(args.rounds):
        for tree in (args.trees if i % 2 == 0 else args.trees[::-1]):
            env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            str(tree), "--calls", str(args.calls),
                            "--child", str(tree)], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
