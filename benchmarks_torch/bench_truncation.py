"""Truncated-backprop storage of the port: paper Table 7.

The twin of ``benchmarks/bench_truncation.py``, with the same rows and
keys: the words full BPTT and the truncated backward keep a sample, from
``repro_torch.core.backprop.storage_words_*``.

    PYTHONPATH=src python -m benchmarks_torch.bench_truncation
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.core import backprop
from repro_torch.core.types import DFRConfig
from repro_torch.data import PAPER_DATASETS


def table7_storage(n_nodes: int = 30) -> List[Dict]:
    rows = []
    for name, spec in PAPER_DATASETS.items():
        cfg = DFRConfig(n_in=spec.n_in, n_classes=spec.n_classes,
                        n_nodes=n_nodes)
        t = spec.t_max
        naive = backprop.storage_words_naive(cfg, t)
        simp = backprop.storage_words_truncated(cfg, t)
        rows.append({
            "table": "T7-truncation", "dataset": name, "t_max": t,
            "naive_words": naive, "simplified_words": simp,
            "reduction_pct": round(100.0 * (naive - simp) / naive, 1),
            "bp_compute_factor": round(1.0 / t, 5),  # ~1/T compute cut
        })
    return rows


def run(full: bool = False) -> List[Dict]:
    del full
    return table7_storage()


if __name__ == "__main__":
    for row in run():
        print(json.dumps(row))
