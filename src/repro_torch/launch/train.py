"""End-to-end LM training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 300 --batch 8 --seq 512 --ckpt-dir ckpt

The port of ``repro.launch.train``: the synthetic token stream
(``data.tokens.TokenStream``, batches a pure function of the step), the
optimizer and a cosine schedule with the reference's warmup,
``models.lm.make_train_step``, and ``runtime.Trainer`` with its
checkpoints, resume and straggler watchdog.  The model runs on
``--device``: the CUDA device by default (this raises on a host without
one), ``--device cpu`` for the CPU.  The parameters come from the seed-0
init.

Under ``torchrun`` (its environment names the rank and world size) each
rank joins the default process group (NCCL on CUDA, one card a rank;
gloo on the CPU) and the model trains sharded over the host mesh,
``data`` = world // ``--model-parallel`` by ``model`` =
``--model-parallel`` (``launch.mesh.make_host_mesh``): FSDP over data,
tensor parallel over model, the batch split over data.  Rank 0 prints.
``--mesh production`` builds the 16x16 production mesh, which raises
unless the job has 256 ranks.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \
        --device cpu --model-parallel 2 --steps 3
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.mesh import (LMMesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import place_batch, place_opt_state
from repro_torch.models.lm import make_train_step
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(None if args.device == "cuda" else args.device,
                            "launch.train")
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    mesh = (make_production_mesh() if args.mesh == "production"
            else make_host_mesh(model=args.model_parallel, device=device))
    sharded = isinstance(mesh, LMMesh)
    say(f"mesh: {mesh.shape}")
    model = Transformer(cfg, device=device)

    stream = TokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    opt = make_optimizer(args.optimizer)
    lr_fn = cosine_schedule(args.lr, warmup=min(100, args.steps // 10 + 1),
                            total=args.steps)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"arch {cfg.name}: {n_params/1e6:.1f}M params")
    if sharded:
        model.distribute(mesh)
        opt_state = place_opt_state(opt, model, mesh)
    else:
        opt_state = opt.init(model)
    step_fn = make_train_step(model, opt, lr_fn, accum=args.accum)

    def batch_fn(step):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.batch(step).items()}
        return place_batch(batch, mesh) if sharded else batch

    trainer = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        step_fn, batch_fn)
    with use_mesh(mesh if sharded else None):
        model, opt_state, start = trainer.restore(model, opt_state)
        if start:
            say(f"resumed from step {start}")
        _run(args, trainer, model, opt_state, start, say)
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(args, trainer, model, opt_state, start, say) -> None:
    t0 = time.time()

    class LogList(list):
        def append(self, rec):  # live progress printing
            super().append(rec)
            if rec["step"] % args.log_every == 0:
                say(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                    f"({rec['sec']:.2f}s/step)", flush=True)

    trainer.metrics_log = LogList(trainer.metrics_log)
    model, opt_state, step = trainer.run(model, opt_state, args.steps,
                                         start_step=start)
    dt = time.time() - t0
    toks = (args.steps - start) * args.batch * args.seq
    final = trainer.metrics_log[-1]["loss"] if trainer.metrics_log else \
        float("nan")
    say(f"done: {step} steps, {toks/dt/1e3:.1f}k tok/s, "
        f"final loss {final:.4f}")


if __name__ == "__main__":
    main()
