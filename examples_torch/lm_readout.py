"""DFR readout at scale: the paper's online trainer as an LM adaptation head,
with the PyTorch/CUDA port.

    python examples_torch/lm_readout.py [--arch smollm-135m] [--full]
        [--n 64] [--seq 32] [--classes 4] [--ranks 2] [--device cuda|cpu]

The twin of ``examples/lm_readout.py``.  A frozen LM backbone (the reduced
smollm-135m here, ``--full`` for its published width; its attention through
K8 on the card) turns a synthetic sequence-classification task into hidden
states; the modular DFR, DPRR and streaming ridge solve
(``repro_torch.core.readout``) fit a classification head on them.  With
``--ranks R`` the batch is split over R processes of one gloo group, and one
``all_reduce`` of (A, B) gives every rank the global statistics (exact:
paper Eq. 38 is a sum), so each rank solves the same system.  Runs on the
CUDA device unless ``--device cpu``.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.readout import (DistributedDFRReadout,  # noqa: E402
                                      ReadoutConfig)
from repro_torch.models.transformer import Transformer  # noqa: E402


def synth_task(rng: np.random.Generator, n: int, t: int, vocab: int,
               n_classes: int):
    """Class c = sequences biased toward token block c (separable in
    occupancy, but only through temporal features here): the reference
    example's recipe, drawn with numpy."""
    labels = rng.integers(0, n_classes, n)
    block = vocab // n_classes
    base = rng.integers(0, vocab, (n, t))
    biased = block * labels[:, None] + rng.integers(0, block, (n, t))
    pick = rng.random((n, t)) < 0.6
    toks = np.where(pick, biased, base)
    return toks.astype(np.int32), labels.astype(np.int32)


@torch.no_grad()
def hidden_states(model: Transformer, toks: np.ndarray) -> torch.Tensor:
    """Frozen-backbone features: the trunk's output before the final norm
    and the unembedding, (B, T, d_model) in float32."""
    h, _ = model._trunk(model._embed(toks))
    return h.float()


def fit(rank: int, ranks: int, h: torch.Tensor, labels: np.ndarray,
        n_nodes: int, n_classes: int, device: str, group=None):
    """This rank's share of the batch through one distributed ridge solve;
    returns the fitted readout's predictions on the rank's share."""
    b = h.shape[0] // ranks
    sl = slice(rank * b, (rank + 1) * b)
    ro = DistributedDFRReadout(
        ReadoutConfig(feature_dim=h.shape[-1], n_classes=n_classes,
                      n_nodes=n_nodes), group=group, device=device)
    params, rs = ro.init()
    rs = ro.accumulate(rs, params, h[sl], torch.from_numpy(labels[sl]))
    fitted = ro.solve(rs, params, 1e-2)
    return ro.predict(fitted, h[sl]).cpu().numpy(), labels[sl]


def _rank_main(rank: int, ranks: int, path: str, args) -> None:
    dist.init_process_group("gloo", init_method=f"file://{path}/pg",
                            world_size=ranks, rank=rank)
    try:
        data = torch.load(f"{path}/features.pt")
        preds, labels = fit(rank, ranks, data["h"], data["labels"].numpy(),
                            args.nodes, args.classes, args.device,
                            group=dist.group.WORLD)
        hits = torch.tensor([float((preds == labels).sum()),
                             float(len(labels))])
        dist.all_reduce(hits)
        if rank == 0:
            print(f"DFR readout over {ranks} gloo ranks (one all_reduce of "
                  f"(A, B)): train acc {float(hits[0] / hits[1]):.3f} over "
                  f"{args.classes} classes")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="the published width, not the reduced config")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=30)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    model = Transformer(cfg, device=args.device,
                        generator=torch.Generator().manual_seed(0))
    print(f"frozen backbone: {cfg.name} "
          f"({'full' if args.full else 'reduced'}, d_model={cfg.d_model}) "
          f"on {model.device}")
    toks, labels = synth_task(np.random.default_rng(1), args.n, args.seq,
                              cfg.vocab, args.classes)
    h = hidden_states(model, toks)
    if args.ranks == 1:
        preds, _ = fit(0, 1, h, labels, args.nodes, args.classes,
                       args.device)
        print(f"DFR readout (one ridge solve, {args.n} sequences): train acc "
              f"{float((preds == labels).mean()):.3f} over {args.classes} "
              f"classes")
    else:
        with tempfile.TemporaryDirectory() as path:
            torch.save({"h": h.cpu(), "labels": torch.from_numpy(labels)},
                       os.path.join(path, "features.pt"))
            mp.spawn(_rank_main, args=(args.ranks, path, args),
                     nprocs=args.ranks)
    s = args.nodes ** 2 + args.nodes + 1
    print(f"the same code path scales: (A, B) are summed over the ranks; the "
          f"Cholesky system is s x s = {s}^2 whatever the stream length")


if __name__ == "__main__":
    main()
