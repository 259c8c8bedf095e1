"""Ridge-regression benchmarks of the port: paper Tables 2, 3, 8 and Fig. 9.

The twin of ``benchmarks/bench_ridge.py``, with the same rows and keys.
Every timed row also names its ``device`` and, on a card, the ``card``
line (``nvidia-smi``'s name and power limit); times are host wall times of
synchronized calls on that device.  Fig. 9 adds the packed in-place solve
(Algorithms 2-4) as a third column beside Gauss-Jordan and the blocked
Cholesky solve.

    PYTHONPATH=src python -m benchmarks_torch.bench_ridge [--device cpu] [--full]

prints one JSON object a row; without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import ridge
from repro_torch.core.types import DFRConfig, DFRParams, resolve_device
from repro_torch.data import PAPER_DATASETS, load


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _where(device: torch.device) -> Dict:
    """The keys that say where a row was timed."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "card": card_line()}
    return {"device": str(device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, device: torch.device, reps: int = 3) -> float:
    """Mean seconds a call, after one call to warm up, each call
    synchronized."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        _sync(device)
    return (time.perf_counter() - t0) / reps


def table2_memory_words(n_nodes: int = 30) -> List[Dict]:
    """Memory footprint formulas (Table 2) for every paper dataset's Ny."""
    rows = []
    s = n_nodes * n_nodes + n_nodes + 1
    for name, spec in PAPER_DATASETS.items():
        naive = ridge.memory_words_naive(s, spec.n_classes)
        prop = ridge.memory_words_proposed(s, spec.n_classes)
        rows.append({
            "table": "T2/T8-memory", "dataset": name, "s": s,
            "n_y": spec.n_classes, "naive_words": naive,
            "proposed_words": prop, "ratio": round(naive / prop, 2),
        })
    return rows


def table3_op_counts(n_nodes: int = 30, n_y: int = 9) -> List[Dict]:
    s = n_nodes * n_nodes + n_nodes + 1
    naive = ridge.op_counts_naive(s, n_y)
    prop = ridge.op_counts_proposed(s, n_y)
    counted = ridge.count_ops_packed(s, n_y)
    return [{
        "table": "T3-ops", "s": s, "n_y": n_y,
        "naive_addmul": naive["add"] + naive["mul"],
        "proposed_addmul": prop["add"] + prop["mul"],
        "enumerated_addmul": counted["add"] + counted["mul"],
        "addmul_ratio": round((naive["add"] + naive["mul"]) /
                              (prop["add"] + prop["mul"]), 1),
        "proposed_sqrt": prop["sqrt"], "proposed_div": prop["div"],
    }]


def fig9_runtime_ratio(sizes=(10, 20, 30), n_ys=(2, 9, 20),
                       device=None, reps: int = 3) -> List[Dict]:
    """Gauss-Jordan vs Cholesky ridge wall time on ``device``: the blocked
    solve (``cholesky_us``, the reference's column) and the packed in-place
    solve (``packed_us``)."""
    device = resolve_device(device, "fig9_runtime_ratio")
    where = _where(device)
    rows = []
    rng = np.random.default_rng(0)
    for nx in sizes:
        s = nx * nx + nx + 1
        R = rng.normal(size=(s, s + 16)).astype(np.float32)
        B = torch.from_numpy(R @ R.T + 0.1 * np.eye(s, dtype=np.float32)).to(
            device)
        for ny in n_ys:
            A = torch.from_numpy(
                rng.normal(size=(ny, s)).astype(np.float32)).to(device)
            t = {m: _time(ridge.ridge_solve, A, B, m, device=device,
                          reps=reps)
                 for m in ("gaussian", "cholesky_blocked", "cholesky_packed")}
            rows.append({
                "table": "Fig9-runtime", "n_x": nx, "s": s, "n_y": ny,
                "gaussian_us": round(t["gaussian"] * 1e6, 1),
                "cholesky_us": round(t["cholesky_blocked"] * 1e6, 1),
                "ratio": round(t["gaussian"] / t["cholesky_blocked"], 2),
                "packed_us": round(t["cholesky_packed"] * 1e6, 1),
                **where,
            })
    return rows


def table8_accuracy_parity(datasets=("JPVOW", "ECG"), size_cap=80,
                           n_nodes: int = 20, device=None) -> List[Dict]:
    """Cholesky (blocked and packed) vs Gaussian ridge: the same accuracy
    (Table 8)."""
    from repro_torch.core.dfr import DFRModel

    device = resolve_device(device, "table8_accuracy_parity")
    where = _where(device)
    rows = []
    for name in datasets:
        train, test = load(name, size_cap=size_cap)
        spec = PAPER_DATASETS[name]
        cfg = DFRConfig(n_in=spec.n_in, n_classes=spec.n_classes,
                        n_nodes=n_nodes)
        m = DFRModel.create(cfg, device=device)
        p0 = DFRParams.init(cfg, device)
        accs = {}
        for method in ("gaussian", "cholesky_blocked", "cholesky_packed"):
            fitted = m.fit_ridge(train, p0, method=method)
            accs[method] = round(float(m.accuracy(test, fitted)), 4)
        s = cfg.s
        rows.append({
            "table": "T8-parity", "dataset": name, **accs,
            "mem_naive": ridge.memory_words_naive(s, cfg.n_classes),
            "mem_prop": ridge.memory_words_proposed(s, cfg.n_classes),
            **where,
        })
    return rows


def run(full: bool = False, device=None) -> List[Dict]:
    rows = []
    rows += table2_memory_words()
    rows += table3_op_counts()
    rows += fig9_runtime_ratio(sizes=(10, 20, 30) if full else (10, 20),
                               device=device)
    rows += table8_accuracy_parity(
        datasets=tuple(PAPER_DATASETS) if full else ("JPVOW", "ECG"),
        device=device)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--full", action="store_true",
                    help="Fig. 9 up to Nx = 30 and Table 8 on every dataset")
    args = ap.parse_args(argv)
    for row in run(full=args.full, device=args.device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
