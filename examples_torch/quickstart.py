"""Quickstart: train a modular DFR classifier end to end (the paper's
pipeline), with the PyTorch/CUDA port.

    python examples_torch/quickstart.py [--dataset JPVOW] [--full]
                                        [--nodes 30] [--population]
                                        [--device cuda|cpu]

The twin of ``examples/quickstart.py``.  Runs the paper's recipe -
truncated-backprop SGD on the reservoir parameters (p, q) and the output
layer, then a ridge refit - on a synthetic stand-in of the chosen Table-4
dataset, and compares it with the grid-search baseline (all candidates'
features from one K1 launch a split).  ``--population`` also runs the
population engine: grid-seeded candidates refined by truncated backprop
and culled by fitness, the whole population at once
(``repro_torch.core.population``).  Runs on the CUDA device unless
``--device cpu``.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import (DFRModel,  # noqa: E402
                              train_population_classification)
from repro_torch.core.grid_search import grid_search  # noqa: E402
from repro_torch.core.types import DFRConfig  # noqa: E402
from repro_torch.data import PAPER_DATASETS, load  # noqa: E402


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="JPVOW",
                    choices=sorted(PAPER_DATASETS))
    ap.add_argument("--full", action="store_true", help="full Table-4 sizes")
    ap.add_argument("--nodes", type=int, default=30)
    ap.add_argument("--population", action="store_true",
                    help="also run the population-parallel search engine")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    spec = PAPER_DATASETS[args.dataset]
    train, test = load(args.dataset, size_cap=None if args.full else 120)
    print(f"{args.dataset}: {train.batch} train / {test.batch} test, "
          f"{spec.n_in} channels, {spec.n_classes} classes, "
          f"T in [{spec.t_min}, {spec.t_max}] (synthetic stand-in), on "
          f"{args.device}")

    cfg = DFRConfig(n_in=spec.n_in, n_classes=spec.n_classes,
                    n_nodes=args.nodes)
    model = DFRModel.create(cfg, device=args.device)

    t0 = time.perf_counter()
    params = model.fit(train, minibatch=4)
    _sync(args.device)
    bp_t = time.perf_counter() - t0
    acc = float(model.accuracy(test, params))
    print(f"[backprop]    test acc {acc:.3f}  ({bp_t:.1f}s)  "
          f"p={float(params.p):.4f} q={float(params.q):.4f}")

    t0 = time.perf_counter()
    gs = grid_search(cfg, train, test, divs=4, device=args.device)
    gs_t = time.perf_counter() - t0
    print(f"[grid search] test acc {gs['acc']:.3f}  ({gs_t:.1f}s over "
          f"{gs['n_points']} points)  p={gs['p']:.4f} q={gs['q']:.4f}")
    print(f"speed ratio (gs/bp at 4 divisions): {gs_t / bp_t:.2f}x "
          f"(the paper's protocol grows the divisions until the accuracy "
          f"matches: core.grid_search.grid_search_until)")

    if args.population:
        t0 = time.perf_counter()
        divs = 4
        res = train_population_classification(
            cfg, train, test, divs=divs, rounds=2, steps_per_round=2,
            minibatch=4, device=args.device)
        _sync(args.device)
        print(f"[population]  test acc {res.best_acc:.3f}  "
              f"({time.perf_counter() - t0:.1f}s, {divs * divs} members x "
              f"{len(res.history) - 1} rounds)  "
              f"p={res.best_p:.4f} q={res.best_q:.4f} "
              f"beta={res.best_beta:g}")


if __name__ == "__main__":
    main()
