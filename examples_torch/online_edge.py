"""Online edge training + inference (the paper's deployment scenario),
served through the PyTorch/CUDA port's continuous-batching stream server.

    python examples_torch/online_edge.py [--size-cap 100] [--nodes 30]
        [--streams 4] [--window 4] [--max-streams 2] [--devices N]
        [--device cuda|cpu]

The twin of ``examples/online_edge.py``.  Several sensor streams submit
labeled sample windows; the server packs them into fixed slots and
advances every live stream one window a round: infer-before-update,
truncated-BP SGD while a slot is young, then (A, B) accumulation with a
ridge refresh every few rounds.  Finished streams retire and their slots
refill; the best stream's retired model is refreshed and scored on the
held-out split.

``--drift`` serves label-drifting streams instead and reports the online
accuracy before, at and after each stream's drift point, where the
retirement policies (``--forget``, ``--retire-window``, ``--retirement
adaptive``) keep tracking.  ``--autotune`` attaches the warm-pool
autotuner; ``--quantize int8``, ``--step-block``, ``--pipeline-depth``
and ``--config auto`` set the server's knobs of the same names.

``--devices N`` splits the slots into N blocks (``--max-streams`` rounds up
to a multiple of N): without ``--device`` over the first N CUDA devices
(it raises when fewer exist), with ``--device`` N blocks on that one device
(``--device cpu``, or ``--device cuda:0`` on a one-card host).  The episode
is the one-block episode bit for bit; only the placement changes.  Runs on
the CUDA device unless ``--device cpu``.

    python examples_torch/online_edge.py --size-cap 32 --nodes 8 \\
        --streams 3 --window 4 --devices 2 --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import OnlineDFR  # noqa: E402
from repro_torch.core.types import DFRConfig  # noqa: E402
from repro_torch.data import (PAPER_DATASETS,  # noqa: E402
                              drift_segment_bounds, load,
                              make_drift_label_streams)
from repro_torch.runtime import (StreamRequest, StreamServer,  # noqa: E402
                                 WarmPoolAutotuner)


def _server_retirement_kw(args) -> dict:
    """--forget / --retire-window / --retirement as server knobs; each
    retirement pins the incremental refresh, and ``refresh_mode`` stays
    None when unset so ``--config auto`` can plan it."""
    picked = [f for f, v in (("--forget", args.forget),
                             ("--retire-window", args.retire_window),
                             ("--retirement", args.retirement))
              if v is not None]
    if len(picked) > 1:
        raise SystemExit(f"pick one of {' / '.join(picked)}")
    inc = args.refresh_mode or "incremental"
    if args.retirement == "adaptive":
        return {"retirement": "adaptive", "refresh_mode": inc}
    if args.forget is not None:
        return {"retirement": "forget", "forget": args.forget,
                "refresh_mode": inc}
    if args.retire_window is not None:
        return {"retirement": "window", "retire_window": args.retire_window,
                "refresh_mode": inc}
    return {"refresh_mode": args.refresh_mode}


def _server_kw(args) -> dict:
    """The serving-pipeline flags as server knobs (unset ones stay None,
    for the server's defaults or the planner's picks)."""
    return {
        "pipeline_depth": args.pipeline_depth,
        "staging": "host" if args.host_staging else "device",
        "devices": args.devices,
        "quantize": args.quantize,
        "step_block": args.step_block,
        "config": args.config,
        "refresh_cohorts": args.refresh_cohorts,
        "device": args.device,
    }


def _effective_max_streams(args) -> int:
    """--max-streams rounded up to a multiple of --devices."""
    ms = args.max_streams
    if args.devices > 1 and ms % args.devices:
        ms = -(-ms // args.devices) * args.devices
        print(f"note: rounding --max-streams up to {ms} "
              f"(multiple of --devices {args.devices})")
    return ms


def _fmt_ms(v) -> str:
    return "n/a" if np.isnan(v) else f"{v:.1f} ms"


def _print_server(server) -> None:
    if server.mesh is not None:
        devs = ", ".join(str(blk.device) for blk in server.blocks)
        print(f"  slot mesh: {server.devices} blocks x "
              f"{server.max_streams // server.devices} slots on {devs}")
    if server.plan is not None:
        print(f"  auto config (calibrated planner): "
              f"refresh_mode={server.refresh_mode}, "
              f"refresh_cohorts={server.cohorts.n_cohorts}, "
              f"step_block={server.step_block} (predicted "
              f"{server.plan.predicted_samples_per_s:.0f} samples/s)")
    if server.quantize != "none" or server.step_block > 1:
        print(f"  serving fast path: quantize={server.quantize}, "
              f"step_block={server.step_block}")


def _serve(server, streams, args) -> list:
    tuner = None
    if args.autotune:
        tuner = WarmPoolAutotuner(server)
        server.attach_autotuner(tuner)
    for s in streams:
        server.submit(s)
    done = server.run_until_drained()
    if tuner is not None:
        st = tuner.stats()
        print(f"  autotuner: {st['rounds_run']} tune round(s), "
              f"{st['swaps_applied']} hot-swap(s) applied "
              f"({st['swaps_pending']} still pending at drain)")
    return done


def _print_latency(server) -> None:
    lat = server.latency_percentiles_ms()
    print(f"  window-round latency p50 {_fmt_ms(lat['p50_ms'])} / "
          f"p99 {_fmt_ms(lat['p99_ms'])} over {server.global_step} rounds")
    if server.pipeline_depth > 0:
        print(f"  pipeline depth {server.pipeline_depth}: dispatch p50 "
              f"{_fmt_ms(lat['dispatch_p50_ms'])}, prediction read p50 "
              f"{_fmt_ms(lat['drain_p50_ms'])} / "
              f"p99 {_fmt_ms(lat['drain_p99_ms'])}")


def run_drift(args) -> None:
    """Serve label-drifting streams and report the drift recovery."""
    n = 64 if args.smoke else 160
    t_len, n_classes = 16, 4
    nodes = min(args.nodes, 8) if args.smoke else args.nodes
    cfg = DFRConfig(n_in=1, n_classes=n_classes, n_nodes=nodes)
    arrays, switches = make_drift_label_streams(args.streams, n, t_len,
                                                n_classes)
    streams = [StreamRequest(rid=rid, **arr)
               for rid, arr in enumerate(arrays)]
    kw = _server_retirement_kw(args)
    server = StreamServer(cfg, t_max=t_len,
                          max_streams=_effective_max_streams(args),
                          window=args.window, phase_steps=3, refresh_every=2,
                          **_server_kw(args), **kw)
    print(f"serving {len(streams)} drifting streams x {n} samples (switch "
          f"at sample {switches[0]}; retirement={server.retirement}) on "
          f"{server.device}")
    _print_server(server)
    done = _serve(server, streams, args)
    for r in sorted(done, key=lambda r: r.rid):
        bounds = drift_segment_bounds(n, switches[r.rid], args.window)
        p = np.asarray(r.preds)
        pre, at, post = (float((p[lo:hi] == r.label[lo:hi]).mean())
                         for lo, hi in bounds)
        print(f"  stream {r.rid}: online acc pre-drift {pre:.3f} / at "
              f"{at:.3f} / post {post:.3f} "
              f"({int(r.final_state.ridge.count)} samples in (A,B))")
    _print_latency(server)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ECG")
    ap.add_argument("--size-cap", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=30)
    ap.add_argument("--streams", type=int, default=4,
                    help="how many sensor streams to carve the data into")
    ap.add_argument("--max-streams", type=int, default=2,
                    help="server slots (< streams exercises refill)")
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--refresh-mode", choices=("recompute", "incremental"),
                    default=None)
    ap.add_argument("--refresh-cohorts", type=int, default=None)
    ap.add_argument("--forget", type=float, default=None, metavar="LAMBDA")
    ap.add_argument("--retire-window", type=int, default=None, metavar="W")
    ap.add_argument("--retirement", choices=("adaptive",), default=None)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=0, metavar="D")
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="split the slots into N blocks (see the module "
                         "docstring for where they go)")
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--step-block", type=int, default=None, metavar="T")
    ap.add_argument("--config", choices=("auto",), default=None)
    ap.add_argument("--host-staging", action="store_true")
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:K (default: the CUDA device, or "
                         "with --devices N the first N CUDA devices)")
    args = ap.parse_args()

    if args.drift:
        run_drift(args)
        return

    spec = PAPER_DATASETS[args.dataset]
    train, test = load(args.dataset, size_cap=args.size_cap)
    cfg = DFRConfig(n_in=spec.n_in, n_classes=spec.n_classes,
                    n_nodes=args.nodes)
    u, ln, lab = (train.u.numpy(), train.length.numpy(),
                  train.label.numpy())
    splits = [idx for idx in np.array_split(np.arange(train.batch),
                                            args.streams) if len(idx)]
    streams = [StreamRequest(rid=i, u=u[idx], length=ln[idx],
                             label=lab[idx])
               for i, idx in enumerate(splits)]
    # phase 1 covers ~40% of each stream's windows, and leaves at least
    # one phase-2 window so (A, B) accumulate and the refresh runs
    windows = max(1, len(splits[0]) // args.window)
    phase_steps = max(1, min(int(windows * 0.4) or 1, windows - 1))
    server = StreamServer(cfg, t_max=train.t_max,
                          max_streams=_effective_max_streams(args),
                          window=args.window, phase_steps=phase_steps,
                          refresh_every=5, **_server_kw(args),
                          **_server_retirement_kw(args))
    print(f"serving {len(streams)} streams x ~{len(splits[0])} samples "
          f"({server.max_streams} slots, windows of {args.window}) on "
          f"{server.device}; phase 1 for {phase_steps} windows a stream, "
          f"then (A,B) accumulation with the {server.refresh_mode} ridge "
          f"refresh every 5 rounds over {server.cohorts.n_cohorts} "
          f"cohort(s), retirement={server.retirement}")
    _print_server(server)
    done = _serve(server, streams, args)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  stream {r.rid}: {r.n_samples} samples, rolling online acc "
              f"{r.online_accuracy:.3f} "
              f"({int(r.final_state.ridge.count)} samples in (A,B))")
    _print_latency(server)

    # the best stream's retired model: refresh the readout from its
    # streamed statistics, then classify the held-out split
    best = max(done, key=lambda r: (r.online_accuracy, -r.rid))
    state = best.final_state
    system = OnlineDFR(cfg, mask=server.mask,
                       device=state.params.W.device)
    if int(state.ridge.count) > 0:
        state = system.refresh_output(state, 1e-2)
    else:
        print("  note: no phase-2 samples accumulated (stream too short "
              "for the phase split): the SGD readout, unrefreshed")
    preds = system.infer(state, test.u, test.length).cpu()
    acc = float((preds == test.label).to(torch.float32).mean())
    print(f"final held-out accuracy (best stream {best.rid}'s model, "
          f"p={float(state.params.p):.4f} q={float(state.params.q):.4f}): "
          f"{acc:.3f}")


if __name__ == "__main__":
    main()
