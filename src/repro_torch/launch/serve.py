"""Serving CLI: batched requests through the continuous-batching server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --requests 16 --prompt-len 32 --max-tokens 16 --device cpu

The port of ``repro.launch.serve``; the model runs on ``--device`` (CUDA by
default) with parameters drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config, get_reduced
from repro_torch.models.transformer import Transformer
from repro_torch.runtime.server import Request, Server


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Transformer(cfg, device=args.device)
    server = Server(model, max_batch=args.max_batch, max_len=args.max_len)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_tokens=args.max_tokens))
    done = server.run_until_drained()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    lat = [r.finish_t - r.submit_t for r in done]
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s); p50 latency {np.median(lat):.2f}s "
          f"p99 {np.percentile(lat, 99):.2f}s on {model.device}")


if __name__ == "__main__":
    main()
