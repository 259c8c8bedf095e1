"""Multi-pod dry run: trace every (arch x input-shape x mesh) cell.

The port of ``repro.launch.dryrun``.  For each cell this module

    1. builds the sharded step program (``launch.steps.build_cell``),
    2. runs it once on fake tensors over the production mesh
       (``launch.steps.lower_cell``): a 'fake' process group of the
       mesh's size (256 or 512 ranks, this process the last) and
       ``FakeTensorMode``, so nothing is allocated and no collective moves
       a byte,
    3. records each rank's local argument, output and peak live bytes,
       FLOPs, HBM bytes and collective wire bytes
       (``launch.analysis.CostMode``) and the roofline terms on an H100,
    4. writes one JSON artifact under ``artifacts/dryrun_torch/``.

Each cell runs in a process of its own (``--jobs`` at once): a process
holds one fake group, of its cell's mesh.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single           # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import pathlib
import time
import traceback

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.launch import analysis
from repro_torch.launch.steps import build_cell, lower_cell, pick_optimizer

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"


def _fake_group(world: int) -> None:
    """This process as the last rank of a shape-only 'fake' group of
    ``world`` ranks (torch's testing store: collectives return at once).
    Every rank holds shards of one shape; where the work differs between
    ranks, the last rank's is the most (the query-row split's rows sit
    last on the causal diagonal), so the cell is priced at its busiest
    device."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules: dict | None = None, tag: str = "baseline",
             overrides: dict | None = None,
             accum_override: int | None = None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "tag": tag,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "optimizer": pick_optimizer(cfg) if shape.kind == "train" else None,
    }
    if shape_name in cfg.skip_shapes:
        record["status"] = "skipped"
        record["reason"] = (
            "full-attention architecture at 524k context (sub-quadratic "
            "required); see DESIGN.md Arch-applicability"
        )
        return record

    t0 = time.time()
    try:
        _fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size
        cell = build_cell(cfg, shape, mesh, rules=rules,
                          accum_override=accum_override)
        t_build = time.time() - t0
        t0 = time.time()
        cost = lower_cell(cell, mesh, rules=rules)
        t_trace = time.time() - t0
        flops, bytes_acc = cost["flops"], cost["bytes"]
        coll = cost["collective"]
        terms = analysis.roofline_terms(flops, bytes_acc, coll.wire_bytes)
        mflops = analysis.model_flops(cfg, shape)
        record.update(
            status="ok",
            lower_s=round(t_build, 2),
            compile_s=round(t_trace, 2),
            chips=n_chips,
            flops_per_device=flops,
            bytes_per_device=bytes_acc,
            collective=coll.to_json(),
            memory={
                "argument_size": cost["argument_size"],
                "output_size": cost["output_size"],
                "temp_size": cost["temp_size"],
                "generated_code_size": None,
            },
            roofline=terms,
            model_flops_total=mflops,
            model_flops_per_device=mflops / n_chips,
            useful_flops_ratio=(mflops / n_chips) / flops if flops else None,
        )
    except Exception as ex:  # noqa: BLE001 - record the failure, keep sweeping
        record.update(
            status="error",
            error=f"{type(ex).__name__}: {ex}",
            trace=traceback.format_exc()[-4000:],
        )
    return record


def artifact_path(arch: str, shape_name: str, mesh_name: str,
                  tag: str) -> pathlib.Path:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    return ART_DIR / f"{arch}__{shape_name}__{mesh_name}__{tag}.json"


def _run_one(job) -> dict:
    arch, shape_name, multi, tag, overrides, accum = job
    rec = run_cell(arch, shape_name, multi, tag=tag,
                   overrides=overrides or None, accum_override=accum)
    rec["overrides"] = dict(overrides, accum=accum)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. attn_impl=pallas)")
    ap.add_argument("--accum", type=int, default=None,
                    help="grad-accumulation override for train cells")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    archs = ALL_ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    jobs = []
    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        for arch in archs:
            for shape_name in shapes:
                path = artifact_path(arch, shape_name, mesh_name, args.tag)
                if args.skip_existing and path.exists():
                    print(f"[skip-existing] {path.name}")
                    continue
                jobs.append((arch, shape_name, multi, args.tag, overrides,
                             args.accum))

    failures = 0
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, args.jobs), maxtasksperchild=1) as pool:
        for rec in pool.imap(_run_one, jobs):
            path = artifact_path(rec["arch"], rec["shape"], rec["mesh"],
                                 args.tag)
            path.write_text(json.dumps(rec, indent=1))
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" trace={rec['compile_s']}s dom={r['dominant']}"
                         f" frac={r['roofline_fraction']:.3f}")
                print(compiled_summary(rec))
            elif status == "error":
                failures += 1
                extra = " " + rec["error"][:160]
            print(f"[{status}] {rec['arch']} x {rec['shape']} x "
                  f"{rec['mesh']}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


def compiled_summary(rec: dict) -> str:
    mem = rec.get("memory", {})
    return (
        f"    mem/device: args={_gb(mem.get('argument_size'))} "
        f"temp={_gb(mem.get('temp_size'))} "
        f"out={_gb(mem.get('output_size'))} | "
        f"flops/dev={rec['flops_per_device']:.3e} "
        f"bytes/dev={rec['bytes_per_device']:.3e} "
        f"wire/dev={rec['collective']['wire_bytes']:.3e}"
    )


def _gb(v):
    return f"{v/2**30:.2f}GiB" if v else "?"


if __name__ == "__main__":
    main()
