#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one CUDA device (an H100; the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each fatal on failure, in the order 1-4h, 6-6d, 8-8c, 10, 11,
then 11b's dry run with 5, 7, 9, 9b and 10b beside it, then 12 (every
timed phase runs alone on the host):
  1. TF32 off for matmuls and cuDNN (the s=931 ridge solves need full
     fp32), and bf16 matmuls with fp32 reductions only; print the card's
     name and power limit.
  2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once, printing ptxas's registers and
     spills (none of the kernels may spill); count HGMMA
     (wgmma) and UTMALDG (TMA load) instructions in K8's library and IMMA
     (mma.sync on int8) in K5's with cuobjdump, and fail if any is 0.
     Measure the dependent-chain cycles of one warp on the card
     (launch/chain_latency.py) for phase 3's chain bounds.
  3. Each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, with times: K1 (training forward), K2
     (streaming logits) and K5 (int8 streaming logits, int32 accumulators
     equal bit for bit) at 32 slots x a window of 4 = 128 samples, T=93,
     Nx=30, Ny=10, ragged lengths with 0, 1, 2, 16, 17 and T among them
     (around the kernels' chunks of 16 steps), each beside its chain bound
     (the longest live length times one step's dependent chain at the
     maximum SM clock); K3 (factor fold) at 32
     factors of 931 x 931 and windows of 4 rows, sign +1, and sign -1 with
     one guard-skipped rotation, whether it equals its plain version bit for
     bit, timed beside its byte bound and its chain bound, then with the
     retirement modes' operands: the forget scale sqrt(0.95) on live rows
     and a flagged downdate that the guard skips in 3 of the 32 factors,
     each required equal to its plain version bit for bit (flags too) and
     timed beside the unscaled fold and its bound; K6 (reservoir
     states) and K7 (DPRR) on the ARAB training split, at fit_sgd's
     minibatch of 4 (the shape of nearly all their launches in a fit), a
     fit_ridge chunk of 256 samples and all 6600, each timed beside its byte
     bound, K6 beside its chain bound and with its frozen rows equal to the
     last live state, and K7 beside one torch.bmm; K4a (tile
     Cholesky) on the blocked solve's diagonal tiles (at s=931 with tiles
     of 128), timed on one tile of 128 and one of 256 beside
     torch.linalg.cholesky_ex; K4b (tile triangular solves) on every solve
     of that blocked solve, timed on its 896-row panel and its 16-row
     (Ny padded to 8) right-hand side, each forward and backward, beside
     torch.linalg.solve_triangular; the blocked ridge solve at s=931
     against the unblocked library solve over the beta sweep, with tiles
     of 128 and 256.  Last, K1 at the population's shape: one launch over
     16 members x all 6600 ARAB training samples, held against its plain
     version on each member's first 256 samples, entrywise at 16 stable
     (p, q) and to each sample's scale at the 4 x 4 grid's (whose corner
     diverges), and timed beside its byte bound and its chain bound.
     The bf16 routes at the same shapes, each timed beside the fp32 call:
     K1 and K2 on bf16 operands (the wrapper casts them to fp32 for the
     same kernel and rounds its outputs to bf16 once), their fp32 results
     within KERNEL_TOL and their bf16 outputs within one bf16 step of the
     plain version's; K5 on the bf16 server's operands, accumulators equal
     and fp32 logits within KERNEL_TOL; K3 on bf16 factors (read and
     written as bf16 by the kernel, folded in fp32, each element rounded
     once) with sign +1, the forget scale and a flagged downdate, and on a
     window of 12 rows (two passes: folded into an fp32 copy), each bit
     for bit equal to its plain version, flags too, and timed beside the
     fp32 fold and beside the fp32-copy route at the server's window.
     Past one warp (Nx > 32): K1 and K2 at the server round's 128 samples
     and K6 and K7 at the minibatch of 4, the chunk of 256 and all 6600
     ARAB samples (masked at that width), at Nx = 64 and 128, each against
     its plain version and beside its byte bound and its chain bound (the
     step at ceil(Nx / 32) nodes a lane, scan_step_n, measured in phase
     2), K7 also beside one bmm; K3 at 32 factors of s = 4161 (Nx = 64,
     passes of 4 rows) and at two factors of its limit (max_factor: one
     row a pass), windows of 4, against its plain version (printed: bit
     for bit), timed at 4161.
  4. The port's main paths at full width: the paper's ARAB configuration
     (Nx=30, linear f, 13 inputs, 10 classes, s=931), its full 6600-sample
     training set split into 64 streams, served by StreamServer with 32
     slots and windows of 4, each round replayed from the server's CUDA
     graphs (the default on the card).  A server serves the 64 streams
     twice: a warm-up wave (the kernels' first loads, the graphs' capture),
     then the measured wave, with every launch count set to 0 before it
     and read after it:
       fp32   - recompute refresh: K1 and K2 once per round;
       int8   - quantize='int8', refresh_mode='incremental': K1, K2, K5 and
                K3 once per round;
       bf16   - cfg.dtype bfloat16, refresh_mode='incremental' (no bf16
                Cholesky in either package): K1, K2 and K3 once per round,
                its live factor within BF16_FACTOR_REL of its statistics.
     Printed: samples/s, p50/p99 of a dispatch, graph replays and eager
     bodies a round, the server's peak memory (allocated and reserved).
     After 4b, one profiled captured wave of the bf16 path, and its
     samples/s, p50/p99, busy a round, peak memory and mean online
     accuracy beside fp32's (no limit on the accuracy).
  4b. The measured wave of each path under torch.profiler, through the
     captured round, the eager round and the pipelined, blocked round: the
     device's busy time a round and idle share, the graph launches and the
     kernel launches and copies outside graphs a round, and the kernels and
     host ops that take the time.
  4c. Each path through the captured round, the eager round (the captured
     round's oracle, reached through the server's private attribute) and
     the captured round at pipeline_depth=2, step_block=4, alternated
     (captured, eager, pipelined, pipelined, eager, captured): each run's
     numbers, and every run must serve the first captured run's
     predictions and end with its final states bit for bit; the bf16 path
     too.
  4d. The retirement modes at ARAB's full width, each with the incremental
     refresh on the same 64 streams (benchmarks/bench_stream.py's
     settings): forget at lambda 0.95, a window of half a stream (52 rows),
     adaptive on its defaults, and adaptive with quantize='int8'.  For each,
     the captured, eager and pipelined (depth 2, blocks of 4) rounds
     alternate as in phase 4c and must serve the same predictions and end
     with the same states and window rings bit for bit; every kernel of
     the path launches its count a round (K3 twice under window: the fold
     and the flagged downdate) and no other; each live factor still
     factors its statistics.  Printed: each run's samples/s and dispatch
     p50/p99, and from one profiled captured wave the device's busy time
     and K3's time a round.
  4e. The reference's drift cells (S4/N160/W4 at Nx 8 and 16, phase_steps
     3, refresh_every 2, incremental, lambda 0.95, a window of 40) through
     the captured round: the pre/at/post-drift accuracy of baseline,
     forget, window and adaptive (and adaptive's plain, blocked and int8
     rows) beside BENCH_stream_drift.json's columns; each retirement
     policy's post-drift accuracy must beat the baseline's by 0.3.
  4f. The warm-pool autotuner (runtime/autotuner.py, WarmPoolAutotuner on
     its defaults, seed 0) on phase 4's fp32 and int8 servers: an untuned
     run and a margin=10 tuner (which never swaps) must serve the same
     episode bit for bit; then the tuned server's captured, eager and
     pipelined rounds alternated as in phase 4c must make the same tuner
     stats and serve the same predictions and final states bit for bit,
     with K1 launched once a round plus twice a tuning round, and every
     live factor still factoring its statistics (allclose at 2e-3).  Then
     the reference's tuner episode (tests/test_adaptive.py: Nx=16 with a
     bad (p, q), the NARMA drift streams, 2 refresh cohorts) through the
     captured round: swaps, and at least 0.03 accuracy over the untuned
     episode.
  4g. The calibrated planner (runtime/planner.py) at full width:
     get_calibration(force=True) on the card into a temporary file (its
     seconds and coefficients printed); Planner.search() for phase 4's fp32
     and int8 servers (int8 incremental, as phase 4's); the captured
     samples/s of every lattice point with cohorts = 1 (fp32: recompute and
     incremental; int8: incremental; step_block 1, 2, 4, 8), the points
     alternated over five measured waves each, their median; the gate,
     fatal: the best point's rate at most GATE_RATIO (1.3) times the
     plan's; the same rates through replay_bench_tables from a temporary
     directory (printed); and a config='auto' server of each path serving
     what an explicit server with its plan's knobs serves, bit for bit.
  4h. Multi-device serving on one card: phase 4's fp32, int8 and window
     servers (each captured) split into 2 and 4 slot blocks on a mesh that
     repeats cuda:0, each block replaying its own graphs, every kernel of
     the path launched its count a round in each block; each run held
     against the one-block captured run bit for bit, or, for a path that
     runs a batched library call found to round differently for a batch
     of S/N than within one of S (a probe of the round's calls at phase
     4's shapes prints which), to the server parity limits (SERVE_TOL,
     SERVE_AGREE; int8 codes within one); fp32 pipelined and blocked on 2
     blocks likewise; samples/s for 1, 2 and 4 blocks (on one card,
     overhead, not scaling).  With two cards, 2 blocks on the default mesh
     with each block's tensors on its own card; with one, a line says real
     placement was not exercised.
  5. Agreement: a reduced episode of each kind (8 streams on 4 slots, the
     first 200 ARAB samples, same widths) served on the card and on the CPU;
     each retirement path on the first 200, and the bf16 path on the first
     200 (at least BF16_AGREE of the predictions); the population search (the
     first 512 training samples, divs=3, one round; the cull's draws from
     the same CPU generator on both): the same best (p, q, beta), accuracy
     within one test sample.
  6. The training path at full width: DFRModel.fit(train, minibatch=4) on
     the whole ARAB training split (6600 samples, Nx=30, s=931, FIT_EPOCHS
     = 3 epochs, cut from the paper's 25, the paper's recipe with
     select='val'), with every launch count
     set to 0 before it and read after it (K6, K7, K4a and K4b); the wall
     time of the SGD and of the ridge fits, the chosen beta, the train and
     test accuracy.  Then OnlineDFR streamed over the training split in
     windows of 8, refresh_output(1e-2) and its accuracy, each call's
     launches read apart: at ONLINE_LR, and at the reference test's 0.5,
     whose refresh must be finite on the card exactly when it is on the
     CPU.  torch.profiler over one fit_ridge and over one
     SGD epoch of 256 samples: the device's busy share and top kernels.
  6b. The hyperparameter search at full width, each run with every launch
     count set to 0 before it and read after: grid_search_serial (K6, K7,
     K4a, K4b a candidate) and grid_search (K1 once a split) at divs=4,
     whose (16, 4) accuracy tables must agree within 2 test samples at
     beta >= 1e-4 wherever fp32 resolves the readout (the cells whose
     float64 accuracy moves by at most 2 predictions when every feature is
     perturbed by 1e-6, relative; the others are printed with their
     float64 accuracy); K1's share of grid_search's device time;
     train_population_classification (divs=4, one round of one epoch in
     minibatches of 4: K1 once a minibatch step), whose round 0 must be
     grid_search's accuracy and whose best must not be below it; a
     profiled refinement of 32 steps (ms, launches and busy share a step);
     the features' peak memory; then the paper's Table 5 protocol,
     grid_search_until(target = phase 6's test accuracy, max_divs=8), its
     total time beside the fit's wall time and their ratio.  Last,
     PopulationTrainer(ckpt_dir=...) at the same population saves its
     winner (checkpoint/), restored onto the card: its leaves and test
     predictions equal the in-memory winner's bit for bit; the bytes on
     disk and the save and restore times.
  6c. The paper's memory algorithms at full width, from phase 6's model
     and parameters.  Table 8: fit_ridge by Gauss-Jordan, the blocked
     solve (K4a, K4b) and the packed in-place Cholesky (Algorithms 2-4)
     must choose the same beta with test accuracies within 2 of 2200, and
     at beta >= 1e-4 the packed W must lie within max(1e-3, the float64
     W's move under a 1e-6 relative perturbation of B, solved on the CPU)
     of the blocked W; each method's wall time, launches, device time and
     peak memory a solve, beside Table 2's words.  Fig. 9's rows
     (benchmarks_torch/bench_ridge.py) at Nx 10, 20, 30.  Four feature
     rows rotated into the packed factor (cholupdate_packed) against K3's
     fold of them, within 1e-5 of max |Lt|.  On 256 training samples the
     manual truncated gradients against K1's, K6 + K7's (rtol 1e-4 / atol
     1e-5) and full BPTT's W and b (rtol 1e-4 / atol 1e-6), each path's
     launches read apart.  Table 7: the peak memory of full BPTT and of
     K1's truncated gradients over all 6600 samples (full BPTT on the
     largest batch that fits), beside the storage words and one (B, T,
     Nx) state tensor.
  6d. The slice's path past one warp: the paper's ARAB at Nx = 64 (s =
     4161, nothing else cut).  DFRModel.fit(train, minibatch=4) cut to 2
     epochs (K6, K7, K4a, K4b launched, no other kernel), its wall time,
     beta and test accuracy (> 3/C); the fp32 StreamServer with the
     recompute refresh (K1 and K2 once a round, cholesky_ex) and with the
     incremental refresh (K1, K2 and K3 once a round; the live factor
     still factors its statistics) as phase 4 serves ARAB, each captured
     and eager (equal bit for bit), its samples/s, peak memory and, from
     one profiled captured wave, the device's busy time a round and idle
     share.  Int8 and bf16 at Nx = 64 are not served: K5 takes Nx <= 32
     (ROADMAP Queue 2).
  7. Card against CPU on a reduced fit (Nx=30, the first 512 ARAB training
     samples, 2 epochs), and at Nx = 64 on the first 256 (1 epoch): the
     same beta, at least 0.98 of the test split's predictions equal, and
     |dW| / max |W|.
  8. The LM main path at full width: smollm-135m (configs/smollm_135m.py, 30
     layers, d_model 576, 9 query heads over 3 KV heads, head_dim 64) with
     attn_impl='pallas', bf16, parameters from the port's seeded init.
     make_prefill_step at each PREFILL_SHAPES (B, T), with K8's launch count
     set to 0 before each and read after (one launch a layer, 30); the wall
     time, prefill tokens/s and peak memory.  One prefill under
     torch.profiler: the device's busy share and K8's share of the device
     time.  The continuous-batching Server with launch/serve.py's defaults
     (16 requests of 32 tokens, max_tokens 16, max_batch 8, max_len 256):
     tokens/s, p50/p99 request latency, steps; K8 launches 0 times there,
     since decode attention is plain in both packages.  One wave of 8 short
     requests under torch.profiler: the device's busy share of the decode
     steps, their launches a step, the top kernels and host ops.
  8b. The LM-feature readout at full width: smollm-135m's trunk (K8 once
     a layer) turns a synthetic token task (examples_torch/lm_readout.py's
     recipe, 1024 sequences of 64 tokens) into (B, T, 576) hidden states;
     DistributedDFRReadout (Nx = 30, s = 931) accumulates (K6, K7), solves
     at beta 1e-2 (the blocked solve, K4a, K4b), predicts and takes an SGD
     step (K1) on the card, launch counts set to 0 before and read after;
     against the same readout on the CPU (W within the larger of 2e-4 and
     the float64 W's move under a 1e-6 relative perturbation of B,
     predictions equal on 0.98); then two gloo ranks on the card, one
     process each, each with half the batch and one all_reduce of (A, B):
     both ranks' W equal, within the same limit of one rank's.
  8c. The other LM families at their published widths, bf16,
     attn_impl='pallas', parameters drawn on the card from a seeded CUDA
     generator, one model at a time: llama4-scout (8 of its 48 layers, the
     one depth cut), rwkv6-7b, zamba2-1.2b, whisper-small, qwen2-vl-7b and
     gemma3-4b (llama4-maverick runs only reduced, in the CPU tests: one
     full-width layer of its 128 experts is 32 GB).  Each: one prefill at
     (1, 4096) (embeddings for qwen2-vl; whisper 1500 encoder frames and
     BOS, as make_prefill_step gives it) with every launch count set to 0
     before and read after: K8 once a self attention on the flash route,
     so 8, 28, 6 (38 // 6 shared-block sites), 36 (12 encoder, 12 decoder,
     12 cross), 0 for gemma3 (the windowed route, blockwise as in the
     reference) and 0 for rwkv6; wall time, tokens/s, peak memory; then
     the Server with launch/serve.py's defaults: tokens/s, p50/p99, steps.
  9. Card against CPU for the LM at full width: a prefill of B=2, T=256
     (|dlogits| <= 1e-3 max |logits| in fp32, 2e-2 in bf16, argmax equal
     in both) and the Server on 4 requests (greedy tokens equal on >= 0.98
     of them in fp32; printed without a check in bf16).
  9b. Each family of 8c at its published widths and one layer (whisper one
     encoder and one decoder layer, zamba2 one run of attn_every SSM layers
     and the shared block), fp32, B=1, T=256: the prefill on the card, then
     on the CPU with the same parameters, within phase 9's fp32 limits; and
     whisper so in bf16 at 8c's 1500 frames and BOS (K8's bf16 route at the
     decoder's 1 x 1 and 1 x 1500), within phase 9's bf16 limits.
 10. LM training at smollm-135m's full width: (a) ``python -m
     repro_torch.launch.train --steps 10 --batch 8 --seq 512`` at its
     defaults (attn_impl='xla', AdamW, the cosine schedule) as a
     subprocess, 10 finite losses and 'done:', then again to step 13 from
     its checkpoint ('resumed from step 10'); (b) the Trainer in process
     on the flash route, bf16, AdamW and a cosine schedule at peak 1e-3,
     (B, T) = (8, 2048), 20 steps: K8's launches over one step set to 0
     before and read after (60: forward and remat recompute, a layer),
     the median step time (host clock, the loss waited on), tokens/s,
     peak allocated memory, one step under torch.profiler (the device's
     busy share, K8's share, the recompute backward's span), the last
     loss below the first; (c) the same loop with a fault injected at
     step 7 and checkpoints every 5 steps: the Trainer restores step 5
     and replays, each final parameter within 1e-3 of its leaf's largest
     move since the seeded init in (b)'s run at step 10 (bit for bit in
     bf16, at these moves).
 10b. One AdamW step of smollm-135m at full width and 2 layers, fp32,
     B=2, T=256, on the card and on the CPU with the same parameters: the
     loss within rtol 1e-5, grad_norm 1e-4, the moments mu and nu within
     1e-4 of each leaf's largest entry, each parameter within 1e-3 of
     its leaf's largest move plus 1e-7 where the CPU's step is well
     conditioned (ADAM_REL), within two moves elsewhere, and at most 1%
     of the entries ill-conditioned.
 11. The sharded LM on the card: a one-rank NCCL process group and
     make_host_mesh(data=1, model=1), a DeviceMesh; smollm-135m at full
     width, bf16, flash route, from phase 10's seed-0 init and its first
     5 batches: 5 AdamW steps at (8, 2048) and a (4, 4096) prefill
     unsharded, then the same with the parameters through
     guarded_shardings and distribute_tensor, the optimizer state and
     the batches placed (launch/steps.py).  K8's launches over a sharded
     step (60) and a sharded prefill (30), the losses within rtol 1e-3,
     the parameters within phase 10b's rule (1e-3 of each leaf's move
     since init plus 1e-7, at most 1% of the entries exempt as
     ill-conditioned, those within two moves), whether the two runs are
     bit for bit equal, the prefill logits within LM_BF16_REL of max
     |logits| with argmax equal, and the ms a step beside the unsharded
     run's (DTensor's host cost: a finding, not a gate).
 11b. The dry run (python -m repro_torch.launch.dryrun, CPU processes
     with no CUDA device visible, started after phase 11, so that no
     timed phase shares the host's CPUs with it; the untimed card-vs-CPU
     phases 5, 7, 9, 9b and 10b run beside it, its processes at the lowest
     CPU priority, nice 19): every arch at train_4k on pod16x16 (the
     deep archs at DRYRUN_DEPTH's layers, smollm and whisper at full
     depth),
     smollm-135m and llama4-maverick at train_4k on pod2x16x16,
     smollm-135m at train_4k with attn_impl=pallas.  Every
     cell 'ok' (none of these is in a skip_shapes); each cell's
     per-device argument bytes, peak bytes, FLOPs, HBM bytes, wire bytes
     and dominant roofline term.  The other shapes are cut (PERF.md
     section 4).
 12. The processes still running: the script is the subreaper of every
     process it starts (prctl PR_SET_CHILD_SUBREAPER), so a descendant
     whose parent has exited (a dry-run cell's pool worker,
     multiprocessing's resource tracker) is re-parented to it.  It closes
     its resource tracker, ends every child still there (SIGTERM, then
     SIGKILL), reaps it and prints what it found; it does the same when a
     phase fails, and fails if a process outlives SIGKILL.
Phase 3 also holds K8's gradient (flash_attention's autograd: K8 forward,
the recompute backward) against autograd through K8's plain version at
(B=4, H=9, KV=3, T=2048, D=64), causal, on transposed views, in bf16
(within 2e-2 of each gradient's largest entry) and fp32 (1e-4), and
prints the backward's time beside scaled_dot_product_attention's.
Phase 3 also holds K8 (flash attention) against its plain version at the
prefill's two shapes (B=4, H=9, KV=3, T=4096 and B=1, T=32768, D=64,
causal, bf16) on transposed views of (B, T, H, D) buffers as the model
passes them (and at T=4096 also contiguous), Minitron's head layout (B=1,
H=32, KV=8, T=2048, D=128), a windowed and a ragged non-causal case, the
families' head layouts of phase 8c (llama4's 40 over 8 and qwen2-vl's 28
over 4 heads at D=128, zamba2's 32 over 32 at D=64, at T=4096, causal;
whisper's 12 heads non-causal at 1500 x 1500, its decoder's BOS token
causal at 1 x 1 and non-causal at 1 x 1500, and an extra 256 x 1500), all
on K8's bf16 route (wgmma on the tensor cores, K/V tiles by TMA), and two
fp32 cases (causal, and windowed) on its SIMT route, each with its
effective TFLOP/s beside the bound's and the time of
torch.nn.functional.scaled_dot_product_attention on the same inputs (timed
here only; the port never calls it).  K8's JSON record also names both
routes.
The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record, each kernel with its range on the card ("nodes")
and, for K1, K2, K3, K6 and K7, phase 3's numbers past one warp ("wide").
Exits non-zero, printing no result, without a CUDA
device or without the repository's sources.
"""
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.dfr_paper import paper_dfr_config  # noqa: E402
from repro_torch.core import backprop, dprr, masking, ridge  # noqa: E402
from repro_torch.core.dfr import DFRModel  # noqa: E402
from repro_torch.core.online import OnlineDFR  # noqa: E402
from repro_torch.core.readout import (DistributedDFRReadout,  # noqa: E402
                                      ReadoutConfig)
from repro_torch.core.types import (DFRConfig, TimeSeriesBatch,  # noqa: E402
                                    map_leaves)
from repro_torch.data import (drift_segment_bounds, load,  # noqa: E402
                               make_drift_label_streams)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import cholesky as k_cholesky  # noqa: E402
from repro_torch.kernels import cholupdate as k_cholupdate  # noqa: E402
from repro_torch.kernels import dprr as k_dprr  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import reservoir as k_reservoir  # noqa: E402
from repro_torch.kernels import ridge_solve as k_ridge  # noqa: E402
from repro_torch.kernels import streaming as k_streaming  # noqa: E402
from repro_torch.kernels import streaming_q8 as k_streaming_q8  # noqa: E402
from repro_torch.kernels import train as k_train  # noqa: E402
from repro_torch.launch import chain_latency, kernel_cost  # noqa: E402
from repro_torch.data.tokens import (TokenStream,  # noqa: E402
                                     TokenStreamConfig)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402
from repro_torch.models.lm import (make_prefill_step,  # noqa: E402
                                   make_train_step)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import (adamw, constant_schedule,  # noqa: E402
                               cosine_schedule)
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime import (PopulationTrainer,  # noqa: E402
                                 PopulationTrainerConfig, Request, Server,
                                 StreamRequest, StreamServer, Trainer,
                                 TrainerConfig, WarmPoolAutotuner, planner)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import candidates  # noqa: E402
from benchmarks_torch.bench_ridge import (card_line,  # noqa: E402
                                         fig9_runtime_ratio)
from repro_torch.core import population as core_population  # noqa: E402
from repro_torch.core.grid_search import (grid_search,  # noqa: E402
                                          grid_search_serial,
                                          grid_search_until)

# the H100's peak rates and the kernels' work counts: launch/kernel_cost.py,
# which the planner (runtime/planner.py) prices a serving round from too
PEAK_BYTES_S = kernel_cost.PEAK_BYTES_S
PEAK_FP32_FLOP_S = kernel_cost.PEAK_FP32_FLOP_S
PEAK_BF16_FLOP_S = kernel_cost.PEAK_BF16_FLOP_S
bound_ms = kernel_cost.bound_ms
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order
K3_REL = 1e-4   # K3: max |dLt| <= K3_REL * max |Lt| (rotations divide)
# bf16 outputs of K1 and K2 against their plain versions: both round fp32
# results that differ in their last bits to bf16 once, so they are one bf16
# step apart at most, and a step is at most 2^-7 of the value (8 bits of
# significand); atol 1e-4 covers the outputs near 0
BF16_STEP_TOL = dict(rtol=2 ** -7, atol=1e-4)
# each DFR kernel's fp32 route, for the JSON record's route phrase
KERNEL_ROUTES = {"K1 train_forward": "the fp32 kernel",
                 "K2 streaming_logits": "the fp32 kernel",
                 "K5 streaming_logits_q8": "the int8 kernel on fp32 codes "
                                           "and scales",
                 "K3 cholupdate_window_t": "the fp32 kernel on the factor"}
# phase 3 at the server's shapes: slots, window, T, Nx, Ny for K1, K2 and
# K5; factors, rows per window, s = Nx^2 + Nx + 1 for K3
STREAM_SHAPE = (32, 4, 93, 30, 10)
# the first lengths of phase 3's samples (the rest random in [1, T]): one
# step, all T, two, none, and a chunk of 16 steps exactly and one past it
STREAM_LENGTHS = (1, 93, 2, 0, 16, 17)
K3_SHAPE = (32, 4, 931)
# K3's chain bound: s x W dependent rotations, each along the diagonal at
# least 6 dependent instructions of its fast path (FMUL d*d, FADD of the
# radicand, MUFU.RSQ, FMUL, FFMA, FFMA of the refined square root) at 4
# cycles, the fp32 pipe's dependent-issue latency (MUFU's is longer), at
# the card's maximum SM clock
K3_ROTATION_CYCLES = 6 * 4
# K5's dependent chain a live step, read from its code (csrc/streaming_q8.cu,
# fast path, linear f): 17 fp32 FMA-class operations (FADD, FMUL, FFMA, and
# the integer add of the ring dot's two halves), 4 fp32 min/max, 4 IDP4A and
# one shared-memory round trip (the activation codes' row).  The step of K1,
# K2 and K6 (scan_step) is measured whole.
K5_CHAIN_OPS = {"fp32 FMA": 17, "fp32 min/max": 4, "IDP4A": 4,
                "shared store, __syncwarp, load": 1}
CHAIN = {}  # chain_latency.measure() and the SM clock, set in phase 2
# the training path: ridge tiles (the DFRModel path's block), the chunk of
# fit_ridge, the sizes of the card-vs-CPU fit, and the epochs of the
# full-width fit, cut from the paper's 25 to keep the script inside its
# 1,200 s on a slow host (the SGD reaches the clamp p = 10^-3.75 within two
# epochs on ARAB, and each epoch costs 5-12 s of host-bound steps; 3 and 10
# epochs gave test accuracies 0.9264 and 0.9255 on the card, PERF.md)
TILE = 128
CHUNK = 256
FIT_MINIBATCH = 4   # fit_sgd's minibatch in phase 6
AGREE_SAMPLES, AGREE_EPOCHS = 512, 2
FIT_EPOCHS = 3
ONLINE_LR = 0.01  # OnlineDFR's SGD rate at ARAB's width
K4A_REL = 1e-5   # K4a: the same rounded operations as its plain version
K4B_REL = 1e-4   # K4b: dot products in another order
SOLVE_REL = 1e-3  # blocked vs unblocked ridge solve at a well-posed beta
WELL_POSED_BETAS = (1e-2, 1e0)

# K8 at the LM's shapes: (label, B, H, KV, Tq, Tk, D, causal, window,
# dtype, layout); the first is the prefill's, whose numbers go in the JSON
# record.  Layout "bthd": q, k, v are transposed views of (B, T, H, D)
# buffers, as attn_apply_full passes them; "bhtd": contiguous (B, H, T, D).
# The prefill's two shapes are both held against the plain version in the
# model's layout; at T=32768 the dense plain version's scores would take
# 38 GB, so that case's plain version is blockwise_attention (512 x 1024
# tiles, the same masked softmax in f32) on the (B, T, H, D) buffers.
K8_CASES = (
    ("prefill", 4, 9, 3, 4096, 4096, 64, True, 0, torch.bfloat16, "bthd"),
    ("prefill contiguous", 4, 9, 3, 4096, 4096, 64, True, 0,
     torch.bfloat16, "bhtd"),
    ("prefill_32k", 1, 9, 3, 32768, 32768, 64, True, 0, torch.bfloat16,
     "bthd"),
    ("minitron heads", 1, 32, 8, 2048, 2048, 128, True, 0, torch.bfloat16,
     "bhtd"),
    ("window 512", 2, 9, 3, 2048, 2048, 64, True, 512, torch.bfloat16,
     "bhtd"),
    ("ragged non-causal", 2, 9, 3, 1000, 3001, 64, False, 0, torch.bfloat16,
     "bthd"),
    ("fp32", 2, 9, 3, 1024, 1024, 64, True, 0, torch.float32, "bhtd"),
    ("fp32 window 512", 2, 9, 3, 2048, 2048, 64, True, 512, torch.float32,
     "bthd"),
    # the LM families' head layouts at their prefills (phase 8c): groups of
    # 5 and 7 query heads a KV head, a group of 1 at D=64, whisper's
    # non-causal encoder, its decoder's self attention on the BOS token and
    # that token's cross attention to the 1500 frames; whisper's cross
    # attention at 256 decoder rows is an extra case that no path runs
    ("llama4 heads", 1, 40, 8, 4096, 4096, 128, True, 0, torch.bfloat16,
     "bthd"),
    ("qwen2-vl heads", 1, 28, 4, 4096, 4096, 128, True, 0, torch.bfloat16,
     "bthd"),
    ("zamba2 heads", 1, 32, 32, 4096, 4096, 64, True, 0, torch.bfloat16,
     "bthd"),
    ("whisper encoder", 1, 12, 12, 1500, 1500, 64, False, 0, torch.bfloat16,
     "bthd"),
    ("whisper decoder self", 1, 12, 12, 1, 1, 64, True, 0, torch.bfloat16,
     "bthd"),
    ("whisper prefill cross", 1, 12, 12, 1, 1500, 64, False, 0,
     torch.bfloat16, "bthd"),
    ("whisper cross", 1, 12, 12, 256, 1500, 64, False, 0, torch.bfloat16,
     "bthd"),
)
# the query-row split over 'model' (models.attention.local_heads): a rank's
# rows of smollm's 9 heads at train_4k on 16 model ranks (256 of 4096),
# the first rank's, a middle one's and the last one's, and an offset inside
# a key tile (B, H, KV, Tq, Tk, D, q_offset, dtype)
K8_OFFSET_CASES = tuple(
    (4, 9, 3, 256, 4096, 64, off, dt) for off in (0, 1920, 3840, 1000)
    for dt in (torch.bfloat16, torch.float32))
K8_DENSE_MAX_BYTES = 8 << 30   # larger dense f32 scores: blockwise plain
# |got - want| <= atol + rtol |want|, elementwise.  bf16: both sides round
# to bf16 from f32 values that differ in their last bits, so they are one
# bf16 step apart at most, and a step is at most 2^-7 of the value (8 bits
# of significand); atol 1e-4 covers the f32 difference of outputs near 0.
# With randn inputs a causal row at T=4096 averages about T/e keys, so a
# typical |out| is about 0.03: the limit is relative, not absolute.  fp32:
# the same f32 arithmetic in another order, with the fast exponential.
K8_TOL = {torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
# K8's two routes in csrc/flash_attention.cu, chosen by dtype
K8_ROUTES = {torch.bfloat16: "wgmma tensor cores, K/V by TMA",
             torch.float32: "SIMT fp32 FMAs"}
# SASS instructions that phase 2 requires in K8's library: the tensor-core
# products (wgmma) and the TMA tile loads of the bf16 route
K8_SASS = ("HGMMA", "UTMALDG")
# the LM main path: smollm-135m, prefill shapes (B, T) - the second is the
# prefill_32k cell's sequence length - and launch/serve.py's defaults
LM_ARCH = "smollm-135m"
PREFILL_SHAPES = ((4, 4096), (1, 32768))
SERVE = dict(requests=16, prompt_len=32, max_tokens=16, max_batch=8,
             max_len=256)
LM_REL = 1e-3        # card vs CPU prefill logits in fp32, of max |logits|
# card vs CPU prefill logits in bf16, of max |logits|: the limit the CPU
# tests hold the bf16 port to against the reference (tests/test_torch_lm.py)
LM_BF16_REL = 2e-2
LM_AGREE = 0.98      # card vs CPU greedy tokens in fp32
# phase 3: K8's gradient at the train step's attention (smollm-135m's heads
# at phase 10's T, causal, (B, H, KV, T, D)): flash_attention's autograd
# (K8 forward, the recompute backward at the model's 512 x 1024 tiles)
# against autograd through K8's plain version, each of dq, dk, dv within
# its limit of its largest entry: bf16 inputs give bf16 gradients from f32
# sums in another order (and K8's bf16 output in D = rowsum(dO O)); fp32
# the same f32 arithmetic in another order
K8_GRAD_CASE = (4, 9, 3, 2048, 64)
K8_GRAD_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# phase 10: LM training at smollm-135m's full width.  (a) the CLI at its
# defaults (attn_impl='xla', AdamW at 3e-4) with a resume; (b) the Trainer
# in process on the flash route, bf16, AdamW and the CLI's cosine schedule
# at peak TRAIN_LR, K8's launches counted over step TRAIN_COUNT_STEP (two a
# layer: forward and the remat recompute); (c) a fault at REPLAY's step
# restores its last checkpoint and replays, each final parameter within
# REPLAY_REL of its leaf's largest move since the init in (b)'s run at the
# same step: ten steps at a peak of 1e-3 move an entry by under 1e-2, so a
# limit on the parameters' scale would pass a replay without its optimizer
# state; this one is bit for bit in bf16 at these moves (the replay was
# bit for bit in every run so far, though the card's embedding backward
# need not sum in one order); 10b: one step card vs CPU at full width and
# TRAIN_AGREE's depth and shape, fp32.  The CLI's and the Trainer's steps
# are cut to keep the script inside its time
TRAIN_CLI = dict(steps=10, resume=13, batch=8, seq=512, ckpt_every=10)
TRAIN_SHAPE = (8, 2048)
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
TRAIN_COUNT_STEP = 5
REPLAY = dict(steps=10, fault_at=7, ckpt_every=5)
REPLAY_REL = 1e-3
TRAIN_AGREE = dict(n_layers=2, b=2, t=256)
# AdamW moves a parameter by u = m_hat / (s + 1e-8), s = sqrt(n_hat): to
# first order |du| <= dm / (s + eps) + |m_hat| ds / (s + eps)^2, with dm
# and ds the largest card-vs-CPU differences of m_hat and s in the entry's
# row; where that bound exceeds ADAM_REL the step is ill-conditioned
# (tests/test_torch_train.py:_ill), and the limit there is two moves.
# The mask is built from the card's moments, so they are held first, each
# within MOMENT_REL of its leaf's largest entry, and the mask may cover at
# most ADAM_ILL_SHARE of the entries
ADAM_REL = 1e-3
MOMENT_REL = 1e-4
ADAM_ILL_SHARE = 1e-2
# phase 8c: every other LM family at its published widths and full depth,
# but llama4-scout's (8 of its 48 layers, about 2.08B parameters a layer:
# 37 GB in bf16 with its untied embeddings).  llama4-maverick runs only
# reduced, in the CPU tests: one full-width layer of its 128 experts is
# 32 GB in bf16.
SHARDED_STEPS = 5          # phase 11: phase 10's first batches, a run each
SHARDED_PREFILL = (4, 4096)
SHARDED_REL = 1e-3         # sharded vs unsharded loss, rtol
# phase 11b: the dry run's cells, (arch, shape, mesh, --set overrides,
# artifact tag): the train_4k column on pod16x16, two cells on pod2x16x16
# and the flash route's cell.  The whole sweep (80 cells) took 925.7 s on
# eight processes of the card's host, over this script's budget (PERF.md
# section 4).  A process a cell, at most DRYRUN_PROCS at once, the longest
# traces first, so that the processes end together.  A cell's trace grows
# with its layers, so the deep archs run at DRYRUN_DEPTH's layers, at full
# width, to keep the script inside its time: each cut keeps its arch's
# layer pattern (zamba2's shared block every 6 layers, gemma3's 5:1
# windows) and, above 5e10 parameters, Adafactor (launch/steps.py:
# pick_optimizer); smollm and whisper run at full depth
DRYRUN_DEPTH = {"zamba2-1.2b": 12, "rwkv6-7b": 8, "qwen1.5-110b": 40,
                "llama4-scout-17b-a16e": 24,
                "llama4-maverick-400b-a17b": 12, "gemma3-4b": 12,
                "qwen2-vl-7b": 8, "minitron-8b": 8}


def dryrun_sets(arch: str, *extra: str) -> tuple:
    """A dry-run cell's ``--set`` overrides: its DRYRUN_DEPTH, then
    ``extra``."""
    return ((f"n_layers={DRYRUN_DEPTH[arch]}",) if arch in DRYRUN_DEPTH
            else ()) + extra


DRYRUN_CELLS = tuple(
    (arch, "train_4k", mesh, dryrun_sets(arch, *extra), tag)
    for arch, mesh, extra, tag in (
        ("zamba2-1.2b", "single", (), "smoke"),
        ("rwkv6-7b", "single", (), "smoke"),
        ("qwen1.5-110b", "single", (), "smoke"),
        ("whisper-small", "single", (), "smoke"),
        ("smollm-135m", "multi", (), "smoke"),
        ("smollm-135m", "single", (), "smoke"),
        ("smollm-135m", "single", ("attn_impl=pallas",), "smoke_pallas"),
        ("llama4-scout-17b-a16e", "single", (), "smoke"),
        ("llama4-maverick-400b-a17b", "multi", (), "smoke"),
        ("llama4-maverick-400b-a17b", "single", (), "smoke"),
        ("gemma3-4b", "single", (), "smoke"),
        ("qwen2-vl-7b", "single", (), "smoke"),
        ("minitron-8b", "single", (), "smoke")))
DRYRUN_PROCS = 8      # the card's host has 8 CPUs
DRYRUN_TIMEOUT = 300  # s: the phase's limit (PERF.md section 4)

FAMILY_ARCHS = ("llama4-scout-17b-a16e", "rwkv6-7b", "zamba2-1.2b",
                "whisper-small", "qwen2-vl-7b", "gemma3-4b")
FAMILY_DEPTH = {"llama4-scout-17b-a16e": dict(n_layers=8)}
FAMILY_PREFILL = (1, 4096)   # whisper: 1500 encoder frames and BOS
WHISPER_FRAMES = 1500
# phase 9b: card vs CPU per family at full width and one layer (whisper
# one encoder and one decoder layer, zamba2 one run of attn_every SSM
# layers and the shared block), B=1, T=256, fp32, phase 9's limits; then
# whisper in bf16 at 8c's prefill (1500 frames and BOS), so that K8's bf16
# route runs at the decoder's shapes of 8c
FAMILY_AGREE = ([(arch, torch.float32, 256) for arch in FAMILY_ARCHS]
                + [("whisper-small", torch.bfloat16, WHISPER_FRAMES)])

# Nx > 32: phase 3 holds K1, K2, K6 and K7 at WIDE_NODES beside their plain
# versions (K1 and K2 at the server round's 128 samples, K6 and K7 at
# phase 3's three sample counts), K3 at the factor of Nx = WIDE_NX and at
# its limit; phase 6d runs the slice's path, the paper's ARAB at Nx =
# WIDE_NX (s = 4161): the fit cut to WIDE_FIT_EPOCHS, both fp32 refresh
# modes served captured and eager, and a fit on WIDE_AGREE's subset on
# the card and on the CPU
WIDE_NODES = (64, 128)
WIDE_NX = 64
WIDE_FIT_EPOCHS = 2
WIDE_AGREE = dict(samples=256, epochs=1)
# K3's (factors, rows, s): the factor of Nx = WIDE_NX, and K3's limit
# (s None: k_cholupdate.max_factor())
WIDE_K3 = ((32, 4, WIDE_NX * WIDE_NX + WIDE_NX + 1), (2, 4, None))
# each kernel's range on the card, in the JSON line (the node caps of K1,
# K2, K5, K6 and K7 and K3's factor s, max_factor, read from their
# libraries at the end)
KERNEL_NODES = {"K4a chol_tile": "any s, tiles of bs <= 1024",
                "K4b trsm_tile": "any s, tiles", "K8 flash_attention":
                "no node axis"}
WIDE_PATHS = {
    "fp32 Nx=64": (dict(), ("K1 train_forward", "K2 streaming_logits")),
    "incremental Nx=64": (dict(refresh_mode="incremental"),
                          ("K1 train_forward", "K2 streaming_logits",
                           "K3 cholupdate_window_t")),
}

KERNELS = {"K1 train_forward": k_train.KERNEL,
           "K2 streaming_logits": k_streaming.KERNEL,
           "K5 streaming_logits_q8": k_streaming_q8.KERNEL,
           "K3 cholupdate_window_t": k_cholupdate.KERNEL,
           "K6 reservoir_states": k_reservoir.KERNEL,
           "K7 dprr_features": k_dprr.KERNEL,
           "K4a chol_tile": k_cholesky.CHOL_KERNEL,
           "K4b trsm_tile": k_cholesky.TRSM_KERNEL,
           "K8 flash_attention": k_flash.KERNEL}
TRAINING_KERNELS = ("K6 reservoir_states", "K7 dprr_features",
                    "K4a chol_tile", "K4b trsm_tile")
# the main paths: server knobs and the kernels each must launch every round
PATHS = {
    "fp32": (dict(), ("K1 train_forward", "K2 streaming_logits")),
    "int8": (dict(quantize="int8", refresh_mode="incremental"),
             ("K1 train_forward", "K2 streaming_logits",
              "K5 streaming_logits_q8", "K3 cholupdate_window_t")),
}
# the bf16 path (phases 4, 4c, 5): ARAB at full width with cfg.dtype
# bfloat16 and the incremental refresh, the only one either package serves
# in bf16 (no bf16 Cholesky); its state, pool and windows are bf16, and K3
# folds its bf16 factors in fp32.  ``dtype`` is taken out of the knobs and
# set on the config (``path_config``)
BF16_PATHS = {
    "bf16": (dict(refresh_mode="incremental", dtype=torch.bfloat16),
             ("K1 train_forward", "K2 streaming_logits",
              "K3 cholupdate_window_t")),
}
# a bf16 factor against its statistics: each of a stream's ~26 folding
# rounds rounds Lt and B to bf16 once (2^-9 of an entry each), so the
# invariant drifts to a few 1e-2 of max |B + beta I| at most
BF16_FACTOR_REL = 0.1
# card vs CPU on the bf16 path (phase 5): K1's and K2's fp32 sums in
# another order round to neighbouring bf16 values now and then, and a bf16
# episode carries each such step on; tests/test_torch_bf16.py measures the
# reference's bf16 episode against its fp32 one at 0.9143 agreement and
# holds the port's bf16 to the reference's at least that often
BF16_AGREE = 0.95
# how a server of a path runs its rounds: replayed from its CUDA graphs (the
# default on the card), through the eager round (the captured round's
# oracle, reached through the server's private ``_graphs``), and replayed
# at the reference benchmark's pipeline_depth=2 and step_block=4
# (benchmarks/bench_stream.py)
KINDS = {"captured": {}, "eager": {},
         "pipelined": dict(pipeline_depth=2, step_block=4)}
# the retirement modes at ARAB's full width, each on the incremental refresh
# (benchmarks/bench_stream.py:310-335): forget at the reference's lambda, a
# window of half a stream (its capacity set per run, max(4, n // 2)),
# adaptive on its defaults and under int8; the kernels each launches a
# round (K3: the fold, and the window's flagged downdate)
INC = dict(refresh_mode="incremental")
RETIRE_PATHS = {
    "forget": (dict(INC, retirement="forget", forget=0.95),
               {"K1 train_forward": 1, "K2 streaming_logits": 1,
                "K3 cholupdate_window_t": 1}),
    "window": (dict(INC, retirement="window"),
               {"K1 train_forward": 1, "K2 streaming_logits": 1,
                "K3 cholupdate_window_t": 2}),
    "adaptive": (dict(INC, retirement="adaptive"),
                 {"K1 train_forward": 1, "K2 streaming_logits": 1,
                  "K3 cholupdate_window_t": 1}),
    "adaptive_int8": (dict(INC, retirement="adaptive", quantize="int8"),
                      {"K1 train_forward": 1, "K2 streaming_logits": 1,
                       "K5 streaming_logits_q8": 1,
                       "K3 cholupdate_window_t": 1}),
}
# the reference's drift cells (benchmarks/bench_stream.py:405-470,
# BENCH_stream_drift.json): S4/N160/W4 at Nx 8 and 16, phase_steps=3,
# refresh_every=2, incremental, lambda 0.95, a window of 40; each policy's
# post-drift accuracy must beat the baseline's by DRIFT_GAIN
# the planner at full width (phase 4g): the refresh modes measured for each
# of phase 4's servers (the int8 server is incremental), each at
# planner.DEFAULT_STEP_BLOCKS with cohorts = 1, over PLANNER_WAVES measured
# waves alternated between the points, each after a garbage collection.
# Five, not three: a host stall slows a wave by up to 5x (one dispatch of
# 249 ms), and with three waves two slow ones made a point's median 0.53x
# its rate on an H100 (fp32 recompute at step_block 2: 34,564.1, 21,609.6,
# 21,356.0 samples/s)
PLANNER_MODES = {"fp32": ("recompute", "incremental"),
                 "int8": ("incremental",)}
PLANNER_WAVES = 5
DRIFT_NODES = (8, 16)
DRIFT_STREAMS, DRIFT_SAMPLES, DRIFT_T, DRIFT_CLASSES = 4, 160, 16, 4
DRIFT_POLICIES = {
    "baseline": {},
    "forget": dict(retirement="forget", forget=0.95),
    "window": dict(retirement="window", retire_window=40),
    "adaptive": dict(retirement="adaptive"),
}
DRIFT_ADAPTIVE_MODES = {"plain": {}, "blocked": dict(step_block=4),
                        "int8": dict(quantize="int8")}
DRIFT_GAIN = 0.3
K3_FORGET = 0.95   # phase 3's scale operand: sqrt(lambda) on live rows
# phase 5's subsets: the first AGREE_SERVE_SAMPLES ARAB samples (fp32,
# int8) and RETIRE_AGREE_SAMPLES (bf16, the retirement paths: the CPU folds
# K3's plain version at s = 931) in 8 streams on 4 slots, cut to keep the
# script inside its time (these CPU runs set the length of the last group,
# phase 11b's dry run beside them).  The retirement paths keep 200: at 100,
# forget, window and adaptive gave one card-vs-CPU |dW| (4.788e-09), so the
# retirement barely acted there
AGREE_SERVE_SAMPLES = 200
RETIRE_AGREE_SAMPLES = 200
# the hyperparameter search at ARAB's full width: the population's grid
# (K = divs^2 members), its refinement (tests/test_population.py's
# classification case), K1's plain version on K x POP_PLAIN_SAMPLES of the
# phase-3 launch, the two grid searches' accuracy tables within
# POP_TABLE_SAMPLES test samples at beta >= POP_HEALTHY_BETA (at 1e-6 both
# solves are degenerate in fp32, tests/test_population.py:47), the paper's
# Table 5 protocol up to TABLE5_MAX_DIVS, and the card-vs-CPU run (phase 5)
POP_DIVS = 4
POP_REFINE = dict(rounds=1, steps_per_round=1, minibatch=4)
POP_PLAIN_SAMPLES = 256
POP_TABLE_SAMPLES = 2
POP_HEALTHY_BETA = 1e-4
# a cell is ill-posed in fp32 where perturbing every feature by this much
# (relative; about the rounding of an fp32 sum over 6600 samples, sqrt(6600)
# x 2^-24 = 5e-6, taken lower) moves its float64 accuracy by more than
# POP_TABLE_SAMPLES test samples
POP_FP32_NOISE = 1e-6
POP_PROFILE_STEPS = 32
TABLE5_MAX_DIVS = 8
# divs=3: a 2 x 2 grid holds only the box's corners, where on these 512
# samples p = 10^-3.75 leaves the readout at the class prior and p = 10^-0.25
# diverges, so every member scores 0.1 on both devices
POP_AGREE = dict(samples=512, divs=3, rounds=1)
# the autotuner on phase 4's servers (WarmPoolAutotuner's defaults, seed 0),
# and the reference's tuner episode (tests/test_adaptive.py:254-283)
TUNER_CFG = DFRConfig(n_in=1, n_classes=4, n_nodes=16, p_init=0.5,
                      q_init=0.5)
TUNER_SERVER = dict(t_max=16, max_streams=4, window=4,
                    refresh_mode="incremental", refresh_every=5,
                    refresh_cohorts=2)
TUNER_EPISODE = dict(population=8, history=32, interval=2, margin=0.02,
                     seed=1)
TUNER_GAIN = 0.03
TUNER_TOL = 2e-3   # Lt^T Lt against B + beta I after swaps (rtol and atol)
# the paper's memory algorithms at ARAB's full width (phase 6c): the three
# ridge methods on phase 6's statistics (their chosen beta, their test
# accuracies within MEM_ACC_SAMPLES of 2200, the packed W against the
# blocked W at beta >= MEM_HELD_BETA within the float64 run's sensitivity
# to a MEM_FP32_NOISE relative perturbation of B, floored at SOLVE_REL);
# Fig. 9 at Nx 10, 20, 30; the packed update of MEM_UPDATE_ROWS rows
# against K3 within K3's CPU limit; the four gradient paths on
# MEM_GRAD_SAMPLES samples within the CPU tests' limits; and Table 7's
# peak memories on the whole training split
MEM_METHODS = ("gaussian", "cholesky_blocked", "cholesky_packed")
MEM_ACC_SAMPLES = 2
MEM_HELD_BETA = 1e-4
MEM_FP32_NOISE = 1e-6
MEM_UPDATE_ROWS = 4
MEM_UPDATE_REL = 1e-5
MEM_GRAD_SAMPLES = 256
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)     # the truncated paths
FULL_WB_TOL = dict(rtol=1e-4, atol=1e-6)  # full BPTT's W and b
# phase 4h: phase 4's servers split into blocks of a slot mesh that repeats
# cuda:0, each held against its one-block run; on one card more blocks add
# dispatch work and overlap nothing, so their samples/s measure overhead
SHARD_BLOCKS = (2, 4)
SHARD_PATHS = ("fp32", "int8", "window")
# a path that runs a batched library call which rounds differently for a
# batch of S/N than for one of S is held to the server's parity limits
# (tests/test_torch_stream_server.py) instead of bit for bit
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
SERVE_AGREE = 0.98
# the batched library calls of a round, at phase 4's shapes, and the paths
# that run each: the (A, B) products, the recompute refresh's factorization,
# the refreshes' triangular solves, and one per-slot reduction
BATCH_CALLS = {"bmm dA": ("fp32", "int8", "window"),
               "bmm dB": ("fp32", "int8", "window"),
               "cholesky_ex": ("fp32",),
               "solve_triangular": ("fp32", "int8", "window"),
               "sum over a slot's window": ("fp32", "int8", "window")}
# phase 8b: smollm-135m's hidden states of a synthetic token task
# (examples_torch/lm_readout.py:synth_task) through DistributedDFRReadout
# at the paper's Nx; more sequences than s = 931 keep B + beta I
# well-posed.  W is held to READOUT_REL of max |W|, or to the spread two
# fp32 solves of the system may show (fp64_sensitivity) where larger
READOUT_TASK = dict(n=1024, seq=64, classes=4)
READOUT_NODES = 30
READOUT_BETA = 1e-2
READOUT_REL = 2e-4
READOUT_AGREE = 0.98
READOUT_ON_PATH = ("K1 train_forward", "K6 reservoir_states",
                   "K7 dprr_features", "K4a chol_tile", "K4b trsm_tile")


class SmokeFailure(RuntimeError):
    pass


T_START = time.perf_counter()


def header(line: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    print(f"{line} [at {time.perf_counter() - T_START:.1f} s]")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def device_ms(fn, reps: int = 50, setup=None) -> float:
    """Median device time of one call: a busy-wait kernel keeps the card
    occupied while the host enqueues the start event, the call and the end
    event, so the events bracket the call's device work and not the host's
    launch latency.  ``setup()``, if given, runs before each rep outside the
    timed region, and its result is the call's argument."""
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


def chain_bound(steps: int, cycles: float, what: str) -> str:
    """The least time of `steps` dependent steps of `cycles` each, at the
    card's maximum SM clock, as a printable phrase."""
    ms = steps * cycles / CHAIN["clock_hz"] * 1e3
    return (f"chain bound {ms:.5f} ms ({steps} steps x {cycles:.1f} cycles "
            f"of {what} at {CHAIN['clock_hz'] / 1e6:.0f} MHz)")


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


def operands_as(variant: str, *ts):
    """Phase 3's floating operands as ``variant``: 'fp32' as made, 'bf16'
    rounded to bf16 (the bf16 server's dtype), 'up' rounded to bf16 and
    upcast again (the fp32 values the bf16 route's kernel computes on)."""
    if variant == "fp32":
        return ts
    out = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in ts]
    if variant == "up":
        out = [t.to(torch.float32) if t.is_floating_point() else t
               for t in out]
    return out


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def bf16_route(name: str, fn, fp32_ms: float, work) -> str:
    """The bf16 operand route of K1 or K2, ``fn(backend, variant)``: the
    wrapper casts the bf16 operands to fp32, the fp32 kernel runs, and its
    outputs are rounded to bf16 once, as the plain version's.  Held against
    the plain version on the same bf16 operands twice: the fp32 results on
    their values at phase 3's limits (KERNEL_TOL), and the bf16 outputs at
    one bf16 step (BF16_STEP_TOL: two fp32 results that differ in their
    last bits may round to neighbouring bf16 values).  Timed beside the
    fp32 call; returns the JSON record's route phrase."""
    compare(f"{name} on bf16 operands, fp32 before rounding",
            as_tuple(fn("cuda", "up")), as_tuple(fn("torch", "up")))
    got, want = as_tuple(fn("cuda", "bf16")), as_tuple(fn("torch", "bf16"))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check(g.dtype == torch.bfloat16, f"{name}: bf16 route gave {g.dtype}")
        e = float((g.float() - w.float()).abs().max())
        print(f"  {name} bf16 outputs: max abs err {e:.3e} (tolerance one "
              f"bf16 step: rtol {BF16_STEP_TOL['rtol']}, atol "
              f"{BF16_STEP_TOL['atol']})")
        check(torch.allclose(g.float(), w.float(), **BF16_STEP_TOL),
              f"{name}: the bf16 route disagrees with its plain version")
    ms = device_ms(lambda: fn("cuda", "bf16"))
    bnd, by = work.bound()
    print(f"  {name} bf16 operands: {ms:.4f} ms (device time, median of 50, "
          f"the wrapper's casts included) beside fp32 {fp32_ms:.4f} ms; "
          f"bound {bnd:.5f} ms ({by}) with 2-byte operands")
    return (f"float32: {KERNEL_ROUTES[name]}, {fp32_ms:.4f} ms; bfloat16: "
            f"the wrapper casts the operands to fp32 for the same kernel "
            f"and rounds its outputs to bf16 once, {ms:.4f} ms")


def kernel_phase(dev) -> dict:
    """K1 and K2 against their plain versions at the server's shapes, on
    fp32 and on bf16 operands."""
    S, W, T, nx, ny = STREAM_SHAPE
    n = S * W
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, T + 1, n)
    lengths[:6] = STREAM_LENGTHS
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

    def k2(backend, variant="fp32"):
        jj, pp, qq, WW, bb = operands_as(variant, j, p, q, Wr, b)
        return ops.streaming_logits_slots(jj, lens, pp, qq, WW, bb, nx, f=f,
                                          backend=backend)

    def k1(backend, variant="fp32"):
        jj, pp, qq = operands_as(variant, j, p, q)
        return ops.train_forward(jj, lens, pp, qq, nx, f=f, backend=backend)

    records = []
    for name, fn, src, replaces, work, work16 in (
        ("K2 streaming_logits", k2, "src/repro_torch/kernels/csrc/streaming.cu",
         "src/repro/kernels/streaming.py:39",
         kernel_cost.streaming_logits(live_steps, S, n, nx, ny),
         kernel_cost.streaming_logits(live_steps, S, n, nx, ny, in_bytes=2)),
        ("K1 train_forward", k1, "src/repro_torch/kernels/csrc/train.cu",
         "src/repro/kernels/train.py:69",
         kernel_cost.train_forward(live_steps, S, n, nx),
         kernel_cost.train_forward(live_steps, S, n, nx, in_bytes=2)),
    ):
        got, want = as_tuple(fn("cuda")), as_tuple(fn("torch"))
        torch.cuda.synchronize()
        err = compare(name, got, want)
        ms = device_ms(lambda: fn("cuda"))
        plain_ms = wall_ms(lambda: fn("torch"))
        bnd, by = work.bound()
        print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50), "
              f"plain {plain_ms:.3f} ms (back to back), bound "
              f"{bnd:.5f} ms ({by}) at B={n} T={T} Nx={nx} "
              f"Ny={ny}, {live_steps} live steps; "
              + chain_bound(int(lengths.max()),
                            CHAIN["step_cycles"]["K1/K2/K6 scan_step"],
                            "scan_step"))
        records.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bnd,
                            bound_by=by, library_ms=None,
                            routes=bf16_route(name, fn, ms, work16)))
    records.append(k5_record(j, lens, p, q, b, f, lengths))
    records.extend(k3_records(dev))
    return {r["name"]: r for r in records}


def k5_record(j, lens, p, q, b, f, lengths) -> dict:
    """K5 against its plain version on the K2 operands with int8 readout
    codes and per-slot scales (the last slot unarmed): the int32 DPRR
    accumulators must be equal, the logits within KERNEL_TOL; then on the
    bf16 server's operands (the window, p, q and b in bf16; the scales
    fp32), accumulators equal and logits fp32 within KERNEL_TOL."""
    name = "K5 streaming_logits_q8"
    S, W, T, nx = j.shape
    ny = b.shape[-1]
    nr = nx * (nx + 1)
    n = S * W
    rng = np.random.default_rng(1)
    dev = j.device
    Wq = torch.from_numpy(rng.integers(-127, 128, (S, ny, nr)).astype(
        np.int8)).to(dev)
    w_scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, S).astype(
        np.float32)).to(dev)
    x_scale = torch.from_numpy(rng.uniform(0.01, 0.05, S).astype(
        np.float32)).to(dev)
    w_scale[-1] = x_scale[-1] = 0.0

    def k5(backend, acc=False, variant="fp32"):
        jj, pp, qq, bb = operands_as(variant, j, p, q, b)
        return ops.streaming_logits_slots_q8(
            jj, lens, pp, qq, Wq, w_scale, x_scale, bb, nx, f=f,
            backend=backend, return_acc=acc)

    (got, got_acc), (want, want_acc) = k5("cuda", True), k5("torch", True)
    torch.cuda.synchronize()
    differ = int((got_acc != want_acc).sum())
    print(f"  {name}: {differ} of {got_acc.numel()} int32 accumulator "
          f"cells differ from the plain version (0 required)")
    check(differ == 0, f"{name}: accumulators differ from the plain version")
    err = compare(name, (got,), (want,))
    # the kernel alone on the codes and scales the wrapper builds; the
    # wrapper's prep (ring codes, powers, scales: about a dozen small ops)
    # is timed apart
    args = ops.streaming_q8_operands(j, lens, p, q, Wq, w_scale, x_scale, b,
                                     f)
    ms = device_ms(lambda: k_streaming_q8.streaming_logits_q8_cuda(*args))
    prep_ms = device_ms(lambda: ops.streaming_q8_operands(
        j, lens, p, q, Wq, w_scale, x_scale, b, f))
    plain_ms = wall_ms(lambda: k5("torch"))
    live = int(lengths.sum())
    bnd, by = kernel_cost.streaming_logits_q8(live, S, n, nx, ny).bound()
    k5_cycles = sum(CHAIN["op_cycles"][op] * k
                    for op, k in K5_CHAIN_OPS.items())
    print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50; the "
          f"wrapper's code and scale prep {prep_ms:.4f} ms more), plain "
          f"{plain_ms:.3f} ms (back to back), bound {bnd:.5f} ms ({by}) at "
          f"B={n} T={T} Nx={nx} Ny={ny}, {live} live steps; "
          + chain_bound(int(lengths.max()), k5_cycles,
                        "K5's step, summed from its operations"))
    (got, got_acc), (want, want_acc) = (k5("cuda", True, "bf16"),
                                        k5("torch", True, "bf16"))
    torch.cuda.synchronize()
    differ = int((got_acc != want_acc).sum())
    print(f"  {name} on bf16 operands: logits {got.dtype}; {differ} int32 "
          f"accumulator cells differ from the plain version (0 required)")
    check(differ == 0 and got.dtype == torch.float32,
          f"{name}: the bf16 route differs from its plain version")
    compare(f"{name} on bf16 operands", (got,), (want,))
    wrap_ms = device_ms(lambda: k5("cuda"))
    wrap16_ms = device_ms(lambda: k5("cuda", variant="bf16"))
    bnd16, by16 = kernel_cost.streaming_logits_q8(live, S, n, nx, ny,
                                                  in_bytes=2).bound()
    print(f"  {name} bf16 operands: the wrapper (prep and kernel) "
          f"{wrap16_ms:.4f} ms beside fp32's {wrap_ms:.4f} ms (device time, "
          f"median of 50); bound {bnd16:.5f} ms ({by16}) with a 2-byte "
          f"window")
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/streaming_q8.cu",
                replaces="src/repro/kernels/streaming.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None,
                routes=f"float32: {KERNEL_ROUTES[name]}, {wrap_ms:.4f} ms "
                       f"with the prep; bfloat16: the prep casts the window, "
                       f"p, q and b to fp32 for the same kernel, fp32 "
                       f"logits, {wrap16_ms:.4f} ms with the prep")


def k3_operands():
    """K3's operands at the server's fold: random upper-triangular factors
    with a positive diagonal, and rows with a dead (zero) sample."""
    K, W, s = K3_SHAPE
    g = torch.Generator().manual_seed(0)
    Lt = torch.triu(0.05 * torch.randn(K, s, s, generator=g), diagonal=1)
    Lt = Lt + torch.diag_embed(1.0 + torch.rand(K, s, generator=g))
    X = 0.3 * torch.randn(K, W, s, generator=g)
    X[:, 1] = 0.0   # a dead sample: zero rows are exact no-ops
    return Lt, X


def k3_records(dev) -> list:
    """K3 against its plain version at the server's fold: 32 factors of
    931 x 931 and windows of 4 rows; sign +1 on random upper-triangular
    factors, then sign -1 on the updated factors with one row that the
    downdate guard must skip; then on bf16 factors."""
    name = "K3 cholupdate_window_t"
    K, W, s = K3_SHAPE
    Lt, X = (t.to(dev) for t in k3_operands())
    err = 0.0
    up = None
    for sign in (1.0, -1.0):
        base, rows = Lt, X
        if sign < 0:
            base, rows = up, X.clone()
            rows[0, -1] = 0.0
            rows[0, -1, s // 2] = 3.0 * base[0, s // 2, s // 2]
        got = ops.cholupdate_window_t(base, rows, sign, backend="cuda")
        want = ops.cholupdate_window_t(base, rows, sign, backend="torch")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        e = float((got - want).abs().max())
        rel = e / float(want.abs().max())
        print(f"  {name} sign {sign:+.0f}: max abs err {e:.3e}, relative to "
              f"max |Lt| {rel:.3e} (tolerance {K3_REL}); equal to its plain "
              f"version bit for bit: {bool(torch.equal(got, want))}")
        check(rel <= K3_REL, f"{name}: kernel disagrees with its plain "
                             f"version (sign {sign:+.0f})")
        err = max(err, e)
        up = got
    # the server's call: an in-place fold, here into a fresh copy of the
    # factors made before each rep, outside the timed region
    ms = device_ms(lambda dst: ops.cholupdate_window_t(dst, X, out=dst,
                                                       backend="cuda"),
                   setup=Lt.clone)
    plain_ms = wall_ms(lambda: ops.cholupdate_window_t(Lt, X,
                                                       backend="torch"),
                       reps=2)
    bnd, by = kernel_cost.cholupdate(K, W, s).bound()
    chain_ms = s * W * K3_ROTATION_CYCLES / max_sm_clock_hz() * 1e3
    print(f"  {name}: kernel {ms:.4f} ms (device time, median of 50), plain "
          f"{plain_ms:.1f} ms (back to back), bound {bnd:.5f} ms ({by}); "
          f"chain bound {chain_ms:.4f} ms ({s * W} dependent rotations x "
          f"{K3_ROTATION_CYCLES} cycles at the maximum SM clock) at K={K} "
          f"W={W} s={s}")
    k3_retirement_operands(Lt, X, up, ms)
    ms16 = k3_bf16_factor(Lt, X, up, ms)
    return [dict(name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/cholupdate.cu",
                 replaces="src/repro/kernels/cholupdate.py:53",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                 bound_by=by, library_ms=None,
                 routes=f"float32: {KERNEL_ROUTES[name]}, {ms:.4f} ms in "
                        f"place; bfloat16: the kernel reads and writes the "
                        f"bf16 factor in one pass (W <= 8 at s = 931), "
                        f"folding in fp32, {ms16:.4f} ms in place; a longer "
                        f"window folds into an fp32 copy")]


def k3_bf16_factor(Lt, X, up, fp32_ms: float) -> float:
    """K3 on the bf16 server's operands: bf16 factors and rows, sign +1,
    with the forget scale, and as a flagged downdate that the guard skips
    in factors 0, 5 and 17 (K3 reads and writes the bf16 factor itself, in
    one pass), then a window of 12 rows on 4 factors (two passes: folded
    into an fp32 copy); each bit for bit equal to its plain version (which
    folds a bf16 factor in fp32 too), flags too.  The in-place fold is
    timed beside the fp32 one and beside the fp32-copy route on the same
    operands.  Returns its time."""
    name = "K3 cholupdate_window_t"
    K, W, s = K3_SHAPE
    L16, X16, up16 = (t.to(torch.bfloat16) for t in (Lt, X, up))
    scale = torch.where(X.abs().sum(dim=-1) > 0, K3_FORGET ** 0.5,
                        1.0).to(torch.float32)
    D = (0.05 * X).to(torch.bfloat16)
    trip = (0, 5, 17)
    for i in trip:
        D[i, -1, s // 2] = 3.0 * up16[i, s // 2, s // 2].float()
    for what, base, rows, sign, sc, flagged in (
            ("sign +1", L16, X16, 1.0, None, False),
            (f"the forget scale sqrt({K3_FORGET})", L16, X16, 1.0, scale,
             False),
            ("a flagged downdate", up16, D, -1.0, None, True),
            ("a window of 12 rows on 4 factors", L16[:4],
             torch.cat([X16[:4]] * 3, dim=1), 1.0, None, False)):
        flags = (torch.full((base.shape[0],), 7, dtype=torch.int32,
                            device=X.device) if flagged else None)
        plain_flags = flags.clone() if flagged else None
        got = base.clone()
        ops.cholupdate_window_t(got, rows, sign, scale=sc, flags=flags,
                                out=got, backend="cuda")
        want = ops.cholupdate_window_t(base, rows, sign, scale=sc,
                                       flags=plain_flags, backend="torch")
        torch.cuda.synchronize()
        equal = (got.dtype == torch.bfloat16 and torch.equal(got, want)
                 and (not flagged or (
                     flags.tolist() == plain_flags.tolist()
                     and [i for i, f in enumerate(flags.tolist()) if f]
                     == list(trip))))
        print(f"  {name} bf16 factor, {what}: equal to its plain version "
              f"bit for bit{' (flags too)' if flagged else ''}: {equal}")
        check(equal, f"{name}: the bf16 route differs from its plain "
                     f"version ({what})")
    ms16 = device_ms(lambda dst: ops.cholupdate_window_t(
        dst, X16, out=dst, backend="cuda"), setup=L16.clone)

    def copy_route(dst):
        U = dst.to(torch.float32)
        ops.cholupdate_window_t(U, X16, out=U, backend="cuda")
        dst.copy_(U)

    copy_ms = device_ms(copy_route, setup=L16.clone)
    bnd, by = kernel_cost.cholupdate(K, W, s, in_bytes=2).bound()
    print(f"  {name} bf16 factor: {ms16:.4f} ms in place (device time, "
          f"median of 50) beside fp32 {fp32_ms:.4f} ms and the fp32-copy "
          f"route {copy_ms:.4f} ms; bound {bnd:.5f} ms ({by}) with 2-byte "
          f"factors at K={K} W={W} s={s}")
    return ms16


def k3_retirement_operands(Lt, X, up, unscaled_ms: float) -> None:
    """K3's operands for the retirement modes at the server's fold: the
    forget scale (sqrt(K3_FORGET) on live rows, exactly 1.0 on the dead
    row) and the window's flagged downdate, which the guard skips in some
    factors; each bit for bit equal to its plain version and timed as the
    server calls it (in place), beside the unscaled fold."""
    name = "K3 cholupdate_window_t"
    K, W, s = K3_SHAPE
    scale = torch.where(X.abs().sum(dim=-1) > 0, K3_FORGET ** 0.5,
                        1.0).to(torch.float32)
    got = ops.cholupdate_window_t(Lt, X, scale=scale, backend="cuda")
    want = ops.cholupdate_window_t(Lt, X, scale=scale, backend="torch")
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    print(f"  {name} with the forget scale sqrt({K3_FORGET}): equal to its "
          f"plain version bit for bit: {equal}")
    check(equal, f"{name}: the scaled fold differs from its plain version")
    trip = (0, 5, 17)   # factors whose downdate the guard skips
    D = 0.05 * X
    for i in trip:
        D[i, -1, s // 2] = 3.0 * up[i, s // 2, s // 2]
    flags = torch.full((K,), 7, dtype=torch.int32, device=X.device)
    plain_flags = flags.clone()
    got = ops.cholupdate_window_t(up, D, -1.0, flags=flags, backend="cuda")
    want = ops.cholupdate_window_t(up, D, -1.0, flags=plain_flags,
                                   backend="torch")
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    flagged = [i for i, f in enumerate(flags.tolist()) if f]
    print(f"  {name} flagged downdate: equal to its plain version bit for "
          f"bit: {equal}; guard flags {flagged} (plain "
          f"{[i for i, f in enumerate(plain_flags.tolist()) if f]}, "
          f"engineered {list(trip)})")
    check(equal and flags.tolist() == plain_flags.tolist()
          and flagged == list(trip),
          f"{name}: the flagged downdate differs from its plain version")
    scaled_ms = device_ms(lambda dst: ops.cholupdate_window_t(
        dst, X, scale=scale, out=dst, backend="cuda"), setup=Lt.clone)
    down_ms = device_ms(lambda dst: ops.cholupdate_window_t(
        dst, D, -1.0, flags=flags, out=dst, backend="cuda"), setup=up.clone)
    bnd_s, by_s = kernel_cost.cholupdate(K, W, s, scaled=True).bound()
    bnd_d, by_d = kernel_cost.cholupdate(K, W, s, flagged=True).bound()
    print(f"  {name}: scaled {scaled_ms:.4f} ms ({scaled_ms / unscaled_ms:.3f}"
          f" x the unscaled {unscaled_ms:.4f} ms), bound {bnd_s:.5f} ms "
          f"({by_s}); flagged downdate {down_ms:.4f} ms, bound {bnd_d:.5f} ms "
          f"({by_d}); device time, median of 50, at K={K} W={W} s={s}")


def record(name, source, replaces, err, ms, plain_ms, bnd, library_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=library_ms)


def check_rel(name: str, got, want, tol: float) -> float:
    """max |got - want| <= tol * max |want|, both finite; returns the
    largest absolute error."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e = float((got - want).abs().max())
    rel = e / max(float(want.abs().max()), 1e-30)
    print(f"  {name}: max abs err {e:.3e}, relative to the largest "
          f"{rel:.3e} (tolerance {tol})")
    check(rel <= tol, f"{name}: kernel disagrees with its plain version")
    return e


def k6_k7_stats(model: DFRModel, train, cycles: float) -> dict:
    """K6 and K7 against their plain versions on ``model``'s masked ARAB
    training split at its initial (p, q): at fit_sgd's minibatch, a
    fit_ridge chunk and the whole split, each timed beside its byte bound,
    K6 beside its chain bound (``cycles`` a step) and with its frozen rows
    equal to the last live state, K7 beside one bmm.  Returns, per sample
    count, (K6 err, ms, plain ms, bound, K7 err, ms, plain ms, bound, bmm
    ms)."""
    cfg = model.cfg
    nx, nr, dev = cfg.n_nodes, cfg.n_rep, model.device
    params = model.init_params()
    u = train.u.to(dev)
    lens = train.length.to(dev)
    j_all = masking.apply_mask(model.mask, u)
    f = cfg.f()

    def k6(j, ln, backend):
        return ops.reservoir_states(j, ln, params.p, params.q, nx, f=f,
                                    backend=backend)

    def k7(x, ln, backend):
        return ops.dprr_features(x, ln, nx, backend=backend)

    stats = {}
    for n in (FIT_MINIBATCH, CHUNK, train.batch):
        j, ln = j_all[:n], lens[:n]
        t_len = j.shape[1]
        live = int(ln.sum())
        x = k6(j, ln, "cuda")
        x_plain = k6(j, ln, "torch")
        torch.cuda.synchronize()
        e6 = compare(f"K6 at B={n} Nx={nx}", (x,), (x_plain,))
        step = torch.arange(t_len, device=dev)
        last = x[torch.arange(n, device=dev), (ln.long() - 1).clamp(min=0)]
        frozen = (step[None, :] >= ln[:, None]) & (ln > 0)[:, None]
        same = bool((x == last[:, None])[frozen].all())
        print(f"  K6 at B={n}: {int(frozen.sum())} frozen rows, each equal "
              f"to the last live state: {same}")
        check(same, f"K6 at B={n}: a frozen row differs from the last live "
                    f"state")
        r = k7(x_plain, ln, "cuda")
        r_plain = k7(x_plain, ln, "torch")
        torch.cuda.synchronize()
        e7 = compare(f"K7 at B={n} Nx={nx}", (r,), (r_plain,))
        ms6 = device_ms(lambda: k6(j, ln, "cuda"))
        ms7 = device_ms(lambda: k7(x, ln, "cuda"))
        plain6 = wall_ms(lambda: k6(j, ln, "torch"), reps=3)
        plain7 = wall_ms(lambda: k7(x, ln, "torch"), reps=3)
        # the library's DPRR: one bmm of the masked X^T and the shifted X
        # with its ones column (the operands built once, outside the call)
        step = torch.arange(t_len, device=dev)
        x1m = (x * (step[None, :] < ln[:, None])[..., None]).mT.contiguous()
        x0 = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
        x0a = torch.cat([x0, torch.ones_like(x0[..., :1])], -1).contiguous()
        lib7 = device_ms(lambda: torch.bmm(x1m, x0a))
        # K6: each live step reads Nx inputs and does about Nx^2 + 5 Nx
        # flops (ring matvec, nonlinearity, wrap); every row of X is
        # written, the frozen ones too.  K7: each live row of X read once
        # and 2 Nx (Nx + 1) flops; r written once.
        b6 = bound_ms(live * nx * 4 + n * 4 + 8 + n * t_len * nx * 4,
                      live * (nx * nx + 5 * nx))
        b7 = bound_ms(live * nx * 4 + n * 4 + n * nr * 4,
                      live * 2 * nx * (nx + 1))
        print(f"  K6 at B={n} T={t_len} Nx={nx} ({live} live steps): kernel "
              f"{ms6:.4f} ms, plain {plain6:.3f} ms, bound {b6[0]:.5f} ms "
              f"({b6[1]}); "
              + chain_bound(int(ln.max()), cycles, "its step"))
        print(f"  K7 at B={n} Nx={nx}: kernel {ms7:.4f} ms, plain "
              f"{plain7:.3f} ms, one bmm {lib7:.4f} ms, bound {b7[0]:.5f} ms "
              f"({b7[1]})")
        stats[n] = (e6, ms6, plain6, b6, e7, ms7, plain7, b7, lib7)
    return stats


def training_kernel_records(model: DFRModel, train) -> dict:
    """K6, K7, K4a and K4b against their plain versions on the card at the
    training path's shapes: ARAB's masked training split (a fit_ridge chunk
    and the whole split) at the initial (p, q), and the blocked solve's
    tiles of the ridge system those features give, with tiles of 128."""
    cfg = model.cfg
    dev = model.device
    params = model.init_params()
    records = {}
    stats = k6_k7_stats(model, train,
                        CHAIN["step_cycles"]["K1/K2/K6 scan_step"])
    e6, ms6, plain6, b6, e7, ms7, plain7, b7, lib7 = stats[train.batch]
    records["K6 reservoir_states"] = record(
        "K6 reservoir_states", "src/repro_torch/kernels/csrc/reservoir.cu",
        "src/repro/kernels/reservoir.py:30",
        max(e6, stats[CHUNK][0]), ms6, plain6, b6, None)
    records["K7 dprr_features"] = record(
        "K7 dprr_features", "src/repro_torch/kernels/csrc/dprr.cu",
        "src/repro/kernels/dprr.py:28", max(e7, stats[CHUNK][4]), ms7,
        plain7, b7, lib7)

    # the ridge system of these features, and the blocked solve's tiles
    A, B = model.ridge_statistics(train, params, CHUNK)
    tiles = capture_tiles(A, ridge.regularize(B, 1e-2))
    diag = torch.cat([a for (a,) in tiles["chol_block_batched"]])
    got, want = (k_cholesky.chol_block_batched(diag, backend=be)
                 for be in ("cuda", "torch"))
    torch.cuda.synchronize()
    e4a = check_rel(f"K4a on the blocked solve's {diag.shape[0]} diagonal "
                    f"tiles",
                    got, want, K4A_REL)
    print(f"  K4a equal to its plain version bit for bit: "
          f"{bool(torch.equal(got, want))}")
    # one tile at the blocked solve's 128 and at ops' default of 256: the
    # leading diagonal tile of the regularized system
    Breg = ridge.regularize(B, 1e-2)
    for bs in (TILE, 2 * TILE):
        tile = Breg[None, :bs, :bs].contiguous()
        got = k_cholesky.chol_tile_cuda(tile)
        want = ref.chol_tile_ref(tile)
        torch.cuda.synchronize()
        err = check_rel(f"K4a one {bs}x{bs} tile", got, want, K4A_REL)
        ms = device_ms(lambda: k_cholesky.chol_tile_cuda(tile))
        plain = wall_ms(lambda: ref.chol_tile_ref(tile), reps=3)
        lib = device_ms(lambda: torch.linalg.cholesky_ex(tile))
        bnd = bound_ms(2 * bs * bs * 4, bs ** 3 // 3)
        print(f"  K4a one {bs}x{bs} tile: kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, torch.linalg.cholesky_ex {lib:.4f} ms, "
              f"bound {bnd[0]:.6f} ms ({bnd[1]})")
        if bs == TILE:
            records["K4a chol_tile"] = record(
                "K4a chol_tile", "src/repro_torch/kernels/csrc/cholesky.cu",
                "src/repro/kernels/cholesky.py:37", max(e4a, err), ms, plain,
                bnd, lib)

    e4b = 0.0
    timed = {}
    for key, fn in (("trsm_lower_t_batched", k_cholesky.trsm_lower_t_batched),
                    ("trsm_lower_batched", k_cholesky.trsm_lower_batched)):
        for rhs, L in tiles[key]:
            got, want = fn(rhs, L, backend="cuda"), fn(rhs, L, backend="torch")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            check(bool(torch.isfinite(got).all()) and rel <= K4B_REL,
                  f"K4b {key} at m={rhs.shape[1]}: relative error {rel:.3e}")
            e4b = max(e4b, err)
            timed.setdefault((key, rhs.shape[1]), (rhs, L))
    print(f"  K4b: {sum(len(tiles[k]) for k in tiles if 'trsm' in k)} "
          f"solves of the blocked solve within {K4B_REL} of the plain "
          f"version (max abs err {e4b:.3e})")
    # the factorization's largest panel (m = 896) and the substitutions'
    # right-hand side (Ny padded to 8: m = 16), each in both directions
    # (the panel's operands also solved backward)
    panel = max(m for _, m in timed)
    rows = min(m for _, m in timed)
    for m in (panel, rows):
        key = next(k for k, mm in timed if mm == m)
        rhs, L = (t.contiguous() for t in timed[(key, m)])
        for back in (False, True):
            ms = device_ms(lambda: k_cholesky.trsm_tile_cuda(rhs, L, back))
            plain_fn = ref.trsm_lower_ref if back else ref.trsm_lower_t_ref
            plain = wall_ms(lambda: plain_fn(rhs, L), reps=3)
            # X L = D is solve_triangular(L, left=False); X L^T = A with L^T
            lib = device_ms(lambda: torch.linalg.solve_triangular(
                L if back else L.mT, rhs, upper=not back, left=False))
            bnd = bound_ms((2 * m * TILE + TILE * TILE) * 4, m * TILE * TILE)
            print(f"  K4b {'backward' if back else 'forward'} m={m} "
                  f"bs={TILE}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
                  f"solve_triangular {lib:.4f} ms, bound {bnd[0]:.6f} ms "
                  f"({bnd[1]})")
            if "K4b trsm_tile" not in records:   # the forward panel
                records["K4b trsm_tile"] = record(
                    "K4b trsm_tile",
                    "src/repro_torch/kernels/csrc/cholesky.cu",
                    "src/repro/kernels/cholesky.py:101", e4b, ms, plain,
                    bnd, lib)
    ridge_solve_check(A, B, cfg.betas)
    return records


def wide_kernel_records(cfg, train, records: dict,
                        dev=torch.device("cuda")) -> None:
    """K1, K2, K6 and K7 past one warp (Nx > 32): at each of WIDE_NODES,
    K1 and K2 at the server round's 128 samples (phase 3's operands and
    lengths at that width) and K6 and K7 on ARAB's training split masked at
    that width (``k6_k7_stats``), each against its plain version and timed
    beside its byte bound and its chain bound (the step at ceil(Nx / 32)
    nodes a lane, ``scan_step_n``, measured by launch/chain_latency.py).
    Each record gains a ``wide`` entry per width."""
    S, W, T, _, ny = STREAM_SHAPE
    n = S * W
    for nx in WIDE_NODES:
        cycles = CHAIN["step_cycles"][f"scan_step_n NPL={-(-nx // 32)}"]
        rng = np.random.default_rng(nx)
        lengths = rng.integers(1, T + 1, n)
        lengths[:6] = STREAM_LENGTHS
        j, lens, p, q, Wr, b = (torch.from_numpy(a).to(dev) for a in (
            rng.normal(size=(S, W, T, nx)).astype(np.float32),
            lengths.reshape(S, W).astype(np.int32),
            rng.uniform(0.01, 0.5, S).astype(np.float32),
            rng.uniform(-0.5, 0.5, S).astype(np.float32),
            (0.01 * rng.normal(size=(S, ny, nx * (nx + 1)))).astype(
                np.float32),
            rng.normal(size=(S, ny)).astype(np.float32)))
        f = DFRConfig(n_in=1, n_classes=ny, n_nodes=nx).f()
        live = int(lengths.sum())
        chain_ms = int(lengths.max()) * cycles / CHAIN["clock_hz"] * 1e3
        for name, fn, work in (
            ("K1 train_forward",
             lambda be: ops.train_forward(j, lens, p, q, nx, f=f,
                                          backend=be),
             kernel_cost.train_forward(live, S, n, nx)),
            ("K2 streaming_logits",
             lambda be: ops.streaming_logits_slots(j, lens, p, q, Wr, b, nx,
                                                   f=f, backend=be),
             kernel_cost.streaming_logits(live, S, n, nx, ny)),
        ):
            got, want = as_tuple(fn("cuda")), as_tuple(fn("torch"))
            torch.cuda.synchronize()
            err = compare(f"{name} at Nx={nx}", got, want)
            ms = device_ms(lambda: fn("cuda"))
            plain_ms = wall_ms(lambda: fn("torch"), reps=3)
            bnd, by = work.bound()
            print(f"  {name} at Nx={nx}: kernel {ms:.4f} ms (device time, "
                  f"median of 50), plain {plain_ms:.3f} ms, bound "
                  f"{bnd:.5f} ms ({by}) at B={n} T={T} Ny={ny}, {live} live "
                  f"steps; " + chain_bound(int(lengths.max()), cycles,
                                           "scan_step_n"))
            records[name].setdefault("wide", {})[nx] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                chain_ms=chain_ms, max_abs_err=err)
        model = DFRModel.create(dataclasses.replace(cfg, n_nodes=nx),
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
        stats = k6_k7_stats(model, train, cycles)
        for size, st in stats.items():
            e6, ms6, plain6, b6, e7, ms7, plain7, b7, lib7 = st
            records["K6 reservoir_states"].setdefault("wide", {})[
                f"{nx}/{size}"] = dict(ms=ms6, plain_ms=plain6,
                                       bound_ms=b6[0], bound_by=b6[1],
                                       max_abs_err=e6)
            records["K7 dprr_features"].setdefault("wide", {})[
                f"{nx}/{size}"] = dict(ms=ms7, plain_ms=plain7,
                                       bound_ms=b7[0], bound_by=b7[1],
                                       library_ms=lib7, max_abs_err=e7)


def wide_k3_records(records: dict, dev=torch.device("cuda")) -> None:
    """K3 at the factor of Nx = WIDE_NX (s = 4161: passes of 4 rows, so a
    window of 4 folds in one) and at its limit (``max_factor``: one row a
    pass), sign +1, against its plain version (<= K3_REL of max |Lt|,
    whether bit for bit printed); timed at s = 4161 beside its byte and
    chain bounds."""
    name = "K3 cholupdate_window_t"
    for k, w, s in WIDE_K3:
        s = s or k_cholupdate.max_factor()
        g = torch.Generator().manual_seed(s)
        Lt = torch.triu(0.05 * torch.randn(k, s, s, generator=g), 1)
        Lt = (Lt + torch.diag_embed(1.0 + torch.rand(k, s, generator=g))
              ).to(dev)
        X = (0.3 * torch.randn(k, w, s, generator=g)).to(dev)
        t0 = time.perf_counter()
        want = ops.cholupdate_window_t(Lt, X, 1.0, backend="torch")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        got = ops.cholupdate_window_t(Lt, X, 1.0, backend="cuda")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        e = float((got - want).abs().max())
        rel = e / float(want.abs().max())
        rows = k_cholupdate.pass_rows(s, False)
        print(f"  {name} at K={k} W={w} s={s} ({rows} rows a pass): max "
              f"abs err {e:.3e}, relative to max |Lt| {rel:.3e} (tolerance "
              f"{K3_REL}); equal to its plain version "
              f"bit for bit: {bool(torch.equal(got, want))}; plain "
              f"{plain_s:.2f} s")
        check(rel <= K3_REL, f"{name} at s={s}: kernel disagrees with its "
                             f"plain version")
        if s != WIDE_K3[0][2]:
            continue
        ms = device_ms(lambda dst: ops.cholupdate_window_t(
            dst, X, out=dst, backend="cuda"), reps=10, setup=Lt.clone)
        bnd, by = kernel_cost.cholupdate(k, w, s).bound()
        chain_ms = s * w * K3_ROTATION_CYCLES / CHAIN["clock_hz"] * 1e3
        print(f"  {name} at K={k} W={w} s={s}: kernel {ms:.4f} ms (device "
              f"time, median of 10), plain {1e3 * plain_s:.1f} ms (once), "
              f"bound {bnd:.5f} ms ({by}); chain bound {chain_ms:.4f} ms")
        records[name].setdefault("wide", {})[s] = dict(
            ms=ms, plain_ms=1e3 * plain_s, bound_ms=bnd, bound_by=by,
            chain_ms=chain_ms, max_abs_err=e)


def capture_tiles(A, B) -> dict:
    """The tile operands the blocked solve gives K4a and K4b for
    W = A B^-1 (with tiles of TILE), from a run of the blocked solve over
    the plain tiles: no kernel launches."""
    names = ("chol_block_batched", "trsm_lower_t_batched",
             "trsm_lower_batched")
    seen = {n: [] for n in names}
    orig = {n: getattr(k_ridge, n) for n in names}

    def recorder(name):
        def fn(*args, **kw):
            seen[name].append(tuple(a.clone() for a in args))
            return orig[name](*args, **kw)
        return fn

    for n in names:
        setattr(k_ridge, n, recorder(n))
    try:
        k_ridge.ridge_solve_blocked(A, B, block=TILE, backend="torch")
    finally:
        for n in names:
            setattr(k_ridge, n, orig[n])
    return seen


def ridge_solve_check(A, B, betas) -> None:
    """ops.ridge_solve at s=931 (the blocked solve over K4a and K4b, tiles
    of 128 and 256) against the unblocked library solve, over the sweep;
    the well-posed betas must agree within SOLVE_REL."""
    for beta in betas:
        Bb = ridge.regularize(B, beta)
        want = ref.ridge_solve_ref(A, Bb)
        line = []
        for block in (TILE, 2 * TILE):
            got = ops.ridge_solve(A, Bb, block=block)
            fin = bool(torch.isfinite(got).all())
            rel = (float((got - want).abs().max() / want.abs().max())
                   if fin and bool(torch.isfinite(want).all()) else None)
            line.append(f"block {block}: finite {fin}, max |dW| / max |W| "
                        f"{rel if rel is None else f'{rel:.3e}'}")
            if beta in WELL_POSED_BETAS:
                check(rel is not None and rel <= SOLVE_REL,
                      f"ridge solve at beta {beta}, block {block}: {rel}")
        print(f"  ridge solve s={B.shape[0]} beta {beta:g} (library finite "
              f"{bool(torch.isfinite(want).all())}): " + "; ".join(line))
    Bb = ridge.regularize(B, 1e-2)
    ms = {block: device_ms(lambda: ops.ridge_solve(A, Bb, block=block),
                           reps=10) for block in (TILE, 2 * TILE)}

    def library():
        C, _ = torch.linalg.cholesky_ex(Bb)
        return torch.cholesky_solve(A.mT, C)

    lib = device_ms(library, reps=10)
    print(f"  ridge solve s={B.shape[0]}: blocked solve {ms[TILE]:.3f} ms "
          f"(tiles of {TILE}), {ms[2 * TILE]:.3f} ms (tiles of {2 * TILE}); "
          f"torch.linalg.cholesky_ex + cholesky_solve {lib:.3f} ms")


def load_arab():
    """The paper's ARAB configuration (configs/dfr_paper.py), its full
    training split as numpy arrays, and both splits as batches."""
    train, test = load("ARAB")
    cfg = paper_dfr_config("ARAB")
    arrays = (train.u.numpy(), train.length.numpy(), train.label.numpy())
    return cfg, arrays, (train, test)


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


def serve(cfg, streams, t_max, per_stream, max_streams, device, **kw):
    srv = StreamServer(cfg, t_max=t_max, max_streams=max_streams, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device=device, **kw)
    for s in streams:
        srv.submit(s)
    done = srv.run_until_drained(strict=True)
    return srv, {r.rid: r for r in done}


def graph_calls(srv) -> tuple:
    """(graph replays, eager bodies, whether any block captures) summed
    over the server's blocks."""
    graphs = [blk.graphs for blk in srv.blocks if blk.graphs is not None]
    return (sum(g.replays for g in graphs),
            sum(g.eager_calls for g in graphs), bool(graphs))


def serving_run(cfg, arrays, path: str, kind: str, profile=None,
                tuner=None, devices: int = 1, device="cuda") -> dict:
    """One full-width ARAB server of ``path`` (see PATHS) and ``kind`` (see
    KINDS) serving two waves of the same 64 streams on its 32 slots.  The
    first is the warm-up: each kernel's first load, the libraries' set-up
    and, on the captured round, the capture of each graph (a server's graphs
    hold its own tensors, so every server captures its own).  The second is
    measured, with every launch count set to 0 just before it and read just
    after, under ``profile`` (a torch.profiler context) where given.  With
    ``tuner`` (WarmPoolAutotuner's knobs) a tuner seeded 0 is attached
    before the first wave; its rounds and swaps in the measured wave are
    returned with its stats.  The peak memory is the server's over both
    waves, above what the process held before it: allocated, and reserved
    (the graphs' pool is reserved, and a replay allocates nothing).  Each
    wave starts from a collected heap.  ``devices`` splits the slots into
    that many blocks on a mesh that repeats ``device`` (None: the default
    mesh, the first ``devices`` cards); graph replays and eager bodies are
    summed over the blocks."""
    cfg, knobs = path_config(cfg, path)
    knobs = {**knobs, **KINDS[kind]}
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 64)
    knobs = window_capacity(knobs, per_stream)
    srv = StreamServer(cfg, t_max=t_max, max_streams=32, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device=device, devices=devices,
                       pool_capacity=max(s.n_samples for s in streams),
                       **knobs)
    if kind == "eager":
        srv._graphs = None   # the eager round: the captured round's oracle
    if tuner is not None:
        srv.attach_autotuner(WarmPoolAutotuner(srv, **{"seed": 0, **tuner}))
    # earlier servers (their graphs hold each other in reference cycles) are
    # freed here, not by a collection inside a timed wave
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for s in streams:
        srv.submit(s)
    srv.run_until_drained(strict=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    streams, _ = make_streams(arrays, 64)
    for rec in (srv.step_times_s, srv.dispatch_times_s, srv.drain_times_s):
        rec.clear()
    replays0, eager0, graphs = graph_calls(srv)
    step0, int8_0 = srv.global_step, srv.served_int8
    tuned0 = srv._autotuner.stats() if tuner is not None else None
    reset_launches()
    gc.collect()
    with profile if profile is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for s in streams:
            srv.submit(s)
        done = srv.run_until_drained(strict=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rounds = srv.global_step - step0
    replays, eager_calls, _ = graph_calls(srv)
    tuned = {}
    if tuner is not None:
        stats = srv._autotuner.stats()
        tuned = dict(stats=stats, tuning_rounds=stats["rounds_run"]
                     - tuned0["rounds_run"], swaps=stats["swaps_applied"]
                     - tuned0["swaps_applied"])
    return dict(**tuned,
        srv=srv, done={r.rid: r for r in done[-len(streams):]}, wall=wall,
        warm_s=warm_s, rounds=rounds, dispatches=len(srv.step_times_s),
        launches=read_launches(), lat=srv.latency_percentiles_ms(),
        replays=replays - replays0,
        eager_calls=(eager_calls - eager0) if graphs else rounds,
        served=sum(r.n_samples for r in streams),
        served_int8=srv.served_int8 - int8_0,
        peak_alloc=torch.cuda.max_memory_allocated() - base_alloc,
        peak_reserved=torch.cuda.max_memory_reserved() - base_reserved)


def path_config(cfg, path: str) -> tuple:
    """(config, server knobs) of a path of PATHS, RETIRE_PATHS or
    BF16_PATHS: a ``dtype`` knob goes onto the config."""
    knobs = dict({**PATHS, **RETIRE_PATHS, **BF16_PATHS,
                  **WIDE_PATHS}[path][0])
    dtype = knobs.pop("dtype", None)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, knobs


def window_capacity(knobs: dict, per_stream: int) -> dict:
    """The window mode's ring of half a stream (bench_stream.py)."""
    if knobs.get("retirement") == "window" and "retire_window" not in knobs:
        knobs = dict(knobs, retire_window=max(4, per_stream // 2))
    return knobs


def run_line(res: dict) -> str:
    """A serving run's numbers as one printable phrase."""
    lat, r = res["lat"], res["rounds"]
    return (f"{res['served'] / res['wall']:.1f} samples/s ({res['served']} "
            f"in {res['wall']:.3f} s, {r} rounds, {res['dispatches']} "
            f"dispatches); dispatch p50 {lat['p50_ms']:.3f} ms, p99 "
            f"{lat['p99_ms']:.3f} ms (enqueue p50 "
            f"{lat['dispatch_p50_ms']:.3f} ms, prediction read p50 "
            f"{lat['drain_p50_ms']:.3f} ms); {res['replays'] / r:.2f} graph "
            f"replays and {res['eager_calls']} eager bodies over {r} rounds; "
            f"peak memory of the server: max_memory_allocated "
            f"{res['peak_alloc'] / 2**20:.1f} MiB, max_memory_reserved "
            f"{res['peak_reserved'] / 2**20:.1f} MiB; warm-up wave "
            f"{res['warm_s']:.3f} s")


def main_path_phase(card: str, cfg, arrays, path: str) -> dict:
    """The main path ``path`` through the captured round (the default on
    the card): one measured wave with every kernel's launch count set to 0
    just before it and read just after."""
    knobs, on_path = {**PATHS, **BF16_PATHS, **WIDE_PATHS}[path]
    res = serving_run(cfg, arrays, path, "captured")
    srv, done, rounds = res["srv"], res["done"], res["rounds"]
    launches, served = res["launches"], res["served"]
    acc = float(np.mean([r.online_accuracy for r in done.values()]))
    tag = f"[{card}] {path}"
    print(f"  {tag}: ARAB Nx={cfg.n_nodes} s={cfg.s} {knobs or 'defaults'}, "
          f"captured round: {len(done)} streams, " + run_line(res))
    print(f"  {tag}: mean rolling online accuracy {acc:.4f}")
    check(res["replays"] > 0, "the captured round replayed no graph")
    if knobs.get("quantize") == "int8":
        print(f"  {tag}: {res['served_int8']} of {served} predictions "
              f"({res['served_int8'] / served:.4f}) served from armed int8 "
              f"slots")
        check(res["served_int8"] > 0, "no prediction came from an armed slot")
    print(f"  {tag}: launches: " + ", ".join(
        f"{name.split()[0]} {count}" for name, count in launches.items())
        + f" over {rounds} rounds")
    check(sum(len(r.preds) for r in done.values()) == served,
          f"served fewer than {served} samples")
    for name, count in launches.items():
        want = rounds if name in on_path else 0
        check(count == want, f"{path}: {name}: {count} launches over "
                             f"{rounds} rounds ({want} expected)")
    for r in done.values():
        st = r.final_state
        check(all(bool(torch.isfinite(t).all()) for t in
                  (st.params.p, st.params.q, st.params.W, st.params.b,
                   st.ridge.Lt)),
              f"stream {r.rid}: non-finite final state")
        check(all(0 <= x < cfg.n_classes for x in r.preds),
              f"stream {r.rid}: prediction out of range")
    if knobs.get("refresh_mode") == "incremental":
        # the live factor still factors the accumulated statistics
        tol = BF16_FACTOR_REL if "dtype" in knobs else 1e-4
        st = max(done.values(), key=lambda r: r.n_samples).final_state
        Lt = st.ridge.Lt.double()
        Bb = st.ridge.B.double() + float(st.ridge.factor_beta) * torch.eye(
            cfg.s, dtype=torch.float64, device=Lt.device)
        rel = float((Lt.T @ Lt - Bb).abs().max() / Bb.abs().max())
        print(f"  {tag}: max |Lt^T Lt - (B + beta I)| / max |B + beta I| "
              f"{rel:.3e} (tolerance {tol:g})")
        check(rel <= tol, "the live factor no longer factors B + beta I")
    res["acc"] = acc
    return res


def profile_phase(card: str, cfg, arrays, path: str, kind: str,
                  top: int = 6) -> dict:
    """Where a round's time goes: the measured wave of ``serving_run``
    under torch.profiler.  Prints the device's busy time a round and its
    idle share of the wall time, the graph launches and the kernel launches
    and copies issued outside graphs a round (runtime API calls the
    profiler saw), and the kernels and host ops that take the most time.
    Profiling slows the host, so the wave's own numbers come from phases 4
    and 4c, not from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    res = serving_run(cfg, arrays, path, kind, profile=prof)
    wall, rounds = res["wall"], res["rounds"]
    events = prof.key_averages()
    # kernel events only: an operator's device time repeats its kernels'
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in dev)
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def api_calls(*prefixes):
        return sum(e.count for e in host if e.key.startswith(prefixes))

    graph_launches = api_calls("cudaGraphLaunch")
    launches = api_calls("cudaLaunchKernel", "cuLaunchKernel")
    copies = api_calls("cudaMemcpy")
    print(f"  [{card}] {path} {kind}: profiled {rounds} rounds "
          f"({res['dispatches']} dispatches) in {wall:.3f} s; device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e3 / rounds:.3f} ms a round, "
          f"{100 * busy_us / 1e6 / wall:.1f}% of wall (idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%); a round: "
          f"{graph_launches / rounds:.2f} graph launches, "
          f"{launches / rounds:.1f} kernel launches and "
          f"{copies / rounds:.2f} copies outside graphs")
    for e in dev[:top]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy_us > 0, "the profiler saw no device time")
    if kind != "eager":
        check(graph_launches > 0, "the profiler saw no graph launch")
    k3_us = sum(e.self_device_time_total for e in dev
                if "cholupdate_kernel" in e.key)
    return dict(busy_ms=busy_us / 1e3 / rounds, k3_ms=k3_us / 1e3 / rounds,
                idle=100 - 100 * busy_us / 1e6 / wall)


def same_serving(a: dict, b: dict) -> tuple:
    """(predictions equal, final states equal bit for bit) of two runs'
    measured waves and servers."""
    preds = all(a["done"][rid].preds == r.preds
                for rid, r in b["done"].items())
    states = [(x.final_state, y.final_state) for x, y in
              ((a["done"][rid], r) for rid, r in b["done"].items())]
    states.append((a["srv"].states, b["srv"].states))
    if a["srv"].win is not None:
        states.append((a["srv"].win, b["srv"].win))
    leaves_a, leaves_b = [], []
    for sa, sb in states:
        map_leaves(leaves_a.append, sa)
        map_leaves(leaves_b.append, sb)
    return preds, all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))


def rounds_phase(card: str, cfg, arrays, path: str) -> list:
    """The captured round, the eager round and the captured round at the
    reference benchmark's pipeline_depth=2, step_block=4, each as
    ``serving_run``'s measured wave, alternated (captured, eager,
    pipelined, pipelined, eager, captured) because host speed varies within
    a call.  Every run must serve the first captured run's predictions and
    end with its final states (and window rings), bit for bit.  Returns the
    runs."""
    order = ("captured", "eager", "pipelined", "pipelined", "eager",
             "captured")
    runs = []
    for kind in order:
        res = serving_run(cfg, arrays, path, kind)
        print(f"  [{card}] {path} {kind}: " + run_line(res))
        runs.append(res)
    first = runs[0]
    for kind, res in zip(order[1:], runs[1:]):
        preds, states = same_serving(res, first)
        print(f"  {path}: {kind} against the first captured run: "
              f"predictions {'equal' if preds else 'DIFFER'}, final states "
              f"{'equal bit for bit' if states else 'DIFFER'}")
        check(preds and states,
              f"{path}: the {kind} round serves another episode")
    for kind in KINDS:
        sps = [r["served"] / r["wall"] for k, r in zip(order, runs)
               if k == kind]
        p50 = [r["lat"]["p50_ms"] for k, r in zip(order, runs) if k == kind]
        print(f"  {path} {kind}: samples/s " + ", ".join(
            f"{x:.1f}" for x in sps) + "; dispatch p50 " + ", ".join(
            f"{x:.3f} ms" for x in p50))
    check(all(r["replays"] == 0 for k, r in zip(order, runs)
              if k == "eager"), "the eager round replayed a graph")
    return runs


def retirement_phase(card: str, cfg, arrays, path: str) -> None:
    """A retirement path at ARAB's full width: its captured, eager and
    pipelined, blocked rounds alternated (``rounds_phase``),
    every kernel of the path launched its count a round in the first
    captured run (counted at replay) and no other, the final states finite
    and each live factor still factoring its statistics; then the captured
    round's measured wave under torch.profiler, for the device's busy time
    and K3's time a round."""
    knobs, per_round = RETIRE_PATHS[path]
    runs = rounds_phase(card, cfg, arrays, path)
    res = runs[0]
    rounds, launches = res["rounds"], res["launches"]
    print(f"  {path}: launches in the first captured run: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in launches.items())
        + f" over {rounds} rounds")
    for name, n in launches.items():
        want = rounds * per_round.get(name, 0)
        check(n == want, f"{path}: {name}: {n} launches over {rounds} "
                         f"rounds ({want} expected)")
    if knobs.get("quantize") == "int8":
        check(res["served_int8"] > 0, "no prediction came from an armed slot")
    worst = 0.0
    for r in res["done"].values():
        st = r.final_state
        check(all(bool(torch.isfinite(t).all()) for t in
                  (st.params.W, st.params.b, st.ridge.Lt, st.ridge.B)),
              f"{path}: stream {r.rid}: non-finite final state")
        Lt = st.ridge.Lt.double()
        M = st.ridge.B.double() + float(st.ridge.factor_beta) * torch.eye(
            cfg.s, dtype=torch.float64, device=Lt.device)
        worst = max(worst, float((Lt.T @ Lt - M).abs().max() / M.abs().max()))
    print(f"  {path}: max |Lt^T Lt - (B + factor_beta I)| / max |B + "
          f"factor_beta I| over the streams {worst:.3e} (tolerance 1e-4)")
    check(worst <= 1e-4, f"{path}: a live factor no longer factors its "
                         f"statistics")
    prof = profile_phase(card, cfg, arrays, path, "captured")
    samples = [r["served"] / r["wall"] for r in runs]
    print(f"  [{card}] {path}: samples/s {min(samples):.1f}-"
          f"{max(samples):.1f} over the {len(runs)} runs; device busy "
          f"{prof['busy_ms']:.3f} ms a round (idle {prof['idle']:.1f}% under "
          f"the profiler), K3 {prof['k3_ms']:.4f} ms a round "
          f"({per_round['K3 cholupdate_window_t']} launch(es) a round)")


def drift_phase(card: str) -> None:
    """The reference's drift cells on the card, through the captured round:
    each policy's pre/at/post-drift accuracy beside BENCH_stream_drift.json's
    columns, and adaptive's plain, blocked and int8 rows; every retirement
    policy's post-drift accuracy must beat the baseline's by DRIFT_GAIN in
    both cells."""
    bench = json.loads((ROOT / "BENCH_stream_drift.json").read_text())
    rows = {(r["table"], r["cell"]): r for r in bench["rows"]}
    for nx in DRIFT_NODES:
        cfg = DFRConfig(n_in=1, n_classes=DRIFT_CLASSES, n_nodes=nx)
        cell = f"S{DRIFT_STREAMS}/N{DRIFT_SAMPLES}/Nx{nx}/W4"
        runs = {("drift", name): dict(INC, **kw)
                for name, kw in DRIFT_POLICIES.items()}
        runs.update({("drift-adaptive-modes", mode): dict(
            INC, retirement="adaptive", **kw)
            for mode, kw in DRIFT_ADAPTIVE_MODES.items()})
        post = {}
        for (table, name), knobs in runs.items():
            arrays, switches = make_drift_label_streams(
                DRIFT_STREAMS, DRIFT_SAMPLES, DRIFT_T, DRIFT_CLASSES)
            streams = [StreamRequest(rid=i, **a) for i, a in enumerate(arrays)]
            srv = StreamServer(cfg, t_max=DRIFT_T, max_streams=DRIFT_STREAMS,
                               window=4, phase_steps=3, refresh_every=2,
                               device="cuda", **knobs)
            t0 = time.perf_counter()
            for r in streams:
                srv.submit(r)
            srv.run_until_drained(strict=True)
            wall = time.perf_counter() - t0
            bounds = drift_segment_bounds(DRIFT_SAMPLES, switches[0], 4)
            acc = [float(np.mean([np.mean(np.asarray(r.preds[lo:hi])
                                          == r.label[lo:hi])
                                  for r in streams])) for lo, hi in bounds]
            ref_row = rows[(table, cell)]
            want = [ref_row[f"{name}_{seg}_acc"] for seg in
                    ("pre", "at", "post")]
            if table == "drift":
                post[name] = acc[2]
            print(f"  [{card}] {cell} {table} {name}: pre/at/post accuracy "
                  + "/".join(f"{a:.3f}" for a in acc) + " (reference "
                  + "/".join(f"{a:.3f}" for a in want) + f"); "
                  f"{DRIFT_STREAMS * DRIFT_SAMPLES / wall:.1f} samples/s "
                  f"(first episode of a fresh server, captures included)")
        for name in ("forget", "window", "adaptive"):
            gain = post[name] - post["baseline"]
            check(gain >= DRIFT_GAIN,
                  f"{cell}: {name} post-drift accuracy {post[name]:.3f} is "
                  f"not {DRIFT_GAIN} above the baseline's "
                  f"{post['baseline']:.3f}")
        print(f"  {cell}: post-drift gain over the baseline: " + ", ".join(
            f"{n} {post[n] - post['baseline']:+.3f}" for n in
            ("forget", "window", "adaptive")) + f" (at least {DRIFT_GAIN})")


def agreement_phase(cfg, arrays, path: str,
                    n_samples: int = AGREE_SERVE_SAMPLES,
                    agree_min: float = 0.98) -> None:
    cfg, knobs = path_config(cfg, path)
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 8, n_samples=n_samples)
    knobs = window_capacity(knobs, per_stream)
    _, on_card = serve(cfg, streams, t_max, per_stream, 4, "cuda", **knobs)
    streams, _ = make_streams(arrays, 8, n_samples=n_samples)
    _, on_cpu = serve(cfg, streams, t_max, per_stream, 4, "cpu", **knobs)
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
    print(f"  {path}: card vs CPU: {agree}/{total} predictions agree "
          f"({frac:.4f}, at least {agree_min}); "
          f"largest final |dp| {diffs['p']:.3e}, |dq| {diffs['q']:.3e}, "
          f"|dW| {diffs['W']:.3e}")
    check(frac >= agree_min,
          f"{path}: card and CPU agree on {frac:.4f} < {agree_min}")


def timed(obj, name: str, log: list) -> None:
    """Wrap the bound method ``name`` of ``obj`` to append each call's wall
    seconds (synchronized) to ``log``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def chosen_beta(model: DFRModel, train, params) -> tuple:
    """The beta of the sweep whose solve gives the fitted W: fit_ridge's
    statistics and solves repeated for ``params``' (p, q), each beta's W
    compared with the fitted one.  Returns (beta, max |dW| / max |W| per
    finite beta)."""
    cfg = model.cfg
    A, B = model.ridge_statistics(train, params, CHUNK)
    dist = {}
    for beta in cfg.betas:
        Wt = ridge.ridge_solve(A, ridge.regularize(B, beta))
        if bool(torch.isfinite(Wt).all()):
            dist[beta] = float((Wt[:, :-1] - params.W).abs().max()
                               / params.W.abs().max())
    return min(dist, key=dist.get), dist


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def check_launches(what: str, launches: dict, on_path) -> None:
    """Every kernel of ``on_path`` launched, no other."""
    print(f"  {what}: launches: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in launches.items()))
    for name, n in launches.items():
        ok = n > 0 if name in on_path else n == 0
        check(ok, f"{what}: {name} launched {n} times")


def training_phase(card: str, cfg, data) -> tuple:
    """DFRModel.fit at full width, then OnlineDFR over the training split;
    returns the fit's launches of the training path's kernels, and the
    fit's wall time and test accuracy (phase 6b's Table 5 target)."""
    train, test = data
    fit_cfg = dataclasses.replace(cfg, epochs=FIT_EPOCHS)
    model = DFRModel.create(fit_cfg,
                            generator=torch.Generator().manual_seed(0))
    sgd_s, ridge_s = [], []
    timed(model, "fit_sgd", sgd_s)
    timed(model, "fit_ridge", ridge_s)
    cut = "" if FIT_EPOCHS == cfg.epochs else \
        f" (CUT from the paper's {cfg.epochs})"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params = model.fit(train, minibatch=FIT_MINIBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    del model.fit_sgd, model.fit_ridge
    tag = f"[{card}] DFRModel.fit"
    # select='val' trains on all but a quarter, minibatches of 4
    steps = FIT_EPOCHS * ((train.batch - train.batch // 4) // 4)
    print(f"  {tag}: ARAB Nx={cfg.n_nodes} s={cfg.s}, {train.batch} "
          f"samples, {FIT_EPOCHS} epochs{cut}, minibatch 4, select='val': "
          f"{wall:.2f} s; fit_sgd {sum(sgd_s):.2f} s ({steps} steps, "
          f"{1e3 * sum(sgd_s) / steps:.3f} ms a step), fit_ridge "
          f"{sum(ridge_s):.2f} s ({len(ridge_s)} calls, "
          f"{1e3 * np.median(ridge_s):.1f} ms median)")
    check_launches(tag, launches, TRAINING_KERNELS)
    check(all(bool(torch.isfinite(t).all()) for t in
              (params.p, params.q, params.W, params.b)),
          "DFRModel.fit: non-finite parameters")
    beta, dist = chosen_beta(model, train, params)
    acc_tr = float(model.accuracy(train, params))
    acc_te = float(model.accuracy(test, params))
    print(f"  {tag}: p {float(params.p):.6g}, q {float(params.q):.6g}, "
          f"beta {beta:g} (max |dW| / max |W| against each finite beta's "
          f"solve: {', '.join(f'{b:g}: {d:.2e}' for b, d in dist.items())}); "
          f"train accuracy {acc_tr:.4f}, test accuracy {acc_te:.4f} on "
          f"{test.batch}")
    check(dist[beta] <= 1e-3, "no beta of the sweep gives the fitted W")
    check(acc_te > 3.0 / cfg.n_classes, f"test accuracy {acc_te}")

    # the single-stream edge loop on the same mask: at ONLINE_LR, and at
    # the rate of the reference's own edge-loop test (JPVOW, Nx=16), which
    # at ARAB's width leaves B + 1e-2 I too ill-conditioned for fp32; that
    # episode's finiteness must match the CPU's
    for lr in (ONLINE_LR, 0.5):
        state, acc = online_episode(cfg, model.mask, train, test, lr, "cuda")
        if lr == ONLINE_LR:
            check(acc is not None and acc > 3.0 / cfg.n_classes,
                  f"OnlineDFR at lr {lr}: test accuracy {acc}")
        else:
            _, acc_cpu = online_episode(cfg, model.mask, train, test, lr,
                                        "cpu")
            print(f"  [OnlineDFR] lr {lr}: refresh finite on the card "
                  f"{acc is not None}, on the CPU {acc_cpu is not None}")
            check((acc is None) == (acc_cpu is None),
                  "OnlineDFR: card and CPU disagree on a finite refresh")

    profile_training(card, model, train, params)
    return ({name: launches[name] for name in TRAINING_KERNELS},
            dict(wall=wall, test_acc=acc_te, model=model, params=params))


def online_episode(cfg, mask, train, test, lr: float, device: str):
    """OnlineDFR over the training split in windows of 8 at learning rate
    ``lr``, then refresh_output(1e-2); on the card every call's launches
    are read apart.  Returns the state and the test accuracy (None when
    the refreshed readout is not finite)."""
    card = device == "cuda"
    online = OnlineDFR(cfg, mask=mask, device=device)
    state = online.init()
    reset_launches()
    t0 = time.perf_counter()
    for lo in range(0, train.batch - 7, 8):
        state, _ = online.step(state, train.u[lo:lo + 8],
                               train.length[lo:lo + 8],
                               train.label[lo:lo + 8], lr, lr)
    if card:
        torch.cuda.synchronize()
        check_launches(f"[OnlineDFR] lr {lr}: step", read_launches(),
                       TRAINING_KERNELS[:2])
        reset_launches()
    steps_s = time.perf_counter() - t0
    state = online.refresh_output(state, 1e-2)
    if card:
        check_launches(f"[OnlineDFR] lr {lr}: refresh_output",
                       read_launches(), TRAINING_KERNELS[2:])
        reset_launches()
    preds = online.infer(state, test.u, test.length).cpu()
    if card:
        check_launches(f"[OnlineDFR] lr {lr}: infer", read_launches(),
                       TRAINING_KERNELS[:2])
    finite = bool(torch.isfinite(state.params.W).all())
    acc = float((preds == test.label).float().mean()) if finite else None
    print(f"  [OnlineDFR] {device}, lr {lr}: {train.batch // 8} windows of "
          f"8 in {steps_s:.2f} s; p {float(state.params.p):.6g}, q "
          f"{float(state.params.q):.6g}; refresh_output(1e-2) "
          + (f"test accuracy {acc:.4f} on {test.batch}" if finite else
             "NOT FINITE (B + 1e-2 I is not positive definite in fp32)"))
    return state, acc


def profile_training(card: str, model: DFRModel, train, params,
                     top: int = 6) -> None:
    """torch.profiler over one fit_ridge at full width and over one SGD
    epoch of 256 samples: the device's busy share and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sub = TimeSeriesBatch(u=train.u[:CHUNK], length=train.length[:CHUNK],
                          label=train.label[:CHUNK])
    one_epoch = DFRModel(dataclasses.replace(model.cfg, epochs=1),
                         model.mask)
    for what, fn in (
            (f"fit_ridge, {train.batch} samples",
             lambda: model.fit_ridge(train, params)),
            ("fit_sgd, one epoch of 256 samples",
             lambda: one_epoch.fit_sgd(sub, minibatch=4))):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"  [{card}] {what}: launches " + ", ".join(
            f"{name.split()[0]} {n}" for name, n in read_launches().items()
            if n))
        events = prof.key_averages()
        dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        print(f"  [{card}] {what}: profiled {wall:.3f} s, device busy "
              f"{1e3 * busy:.3f} ms = {100 * busy / wall:.1f}% (idle "
              f"{100 - 100 * busy / wall:.1f}%)")
        for e in dev[:top]:
            print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")
        check(busy > 0, "the profiler saw no device time")


def training_agreement_phase(cfg, data, samples: int = AGREE_SAMPLES,
                             epochs: int = AGREE_EPOCHS) -> None:
    """The same reduced fit (the first ``samples`` training samples,
    ``epochs`` epochs) on the card and on the CPU."""
    train, test = data
    sub = TimeSeriesBatch(u=train.u[:samples], length=train.length[:samples],
                          label=train.label[:samples])
    small = dataclasses.replace(cfg, epochs=epochs)
    mask = DFRModel.create(small, device="cpu").mask
    out = {}
    for device in ("cuda", "cpu"):
        model = DFRModel(small, mask, device=device)
        t0 = time.perf_counter()
        params = model.fit(sub, minibatch=4)
        beta, _ = chosen_beta(model, sub, params)
        out[device] = (params, beta, model.predict(test, params).cpu(),
                       time.perf_counter() - t0)
    (pg, bg, yg, tg), (pc, bc, yc, tc) = out["cuda"], out["cpu"]
    agree = float((yg == yc).float().mean())
    dW = float((pg.W.cpu() - pc.W).abs().max() / pc.W.abs().max())
    print(f"  DFRModel.fit, Nx={cfg.n_nodes}, {samples} samples, {epochs} "
          f"epochs: "
          f"card {tg:.1f} s, CPU {tc:.1f} s; beta card {bg:g}, CPU {bc:g}; "
          f"{agree:.4f} of {test.batch} test predictions agree; |dp| "
          f"{abs(float(pg.p) - float(pc.p)):.3e}, |dq| "
          f"{abs(float(pg.q) - float(pc.q)):.3e}, max |dW| / max |W| "
          f"{dW:.3e}")
    check(bg == bc, f"card and CPU chose beta {bg:g} and {bc:g}")
    check(agree >= 0.98, f"card and CPU agree on {agree:.4f} < 0.98")


def wide_path_phase(card: str, data) -> None:
    """Phase 6d, the slice's path past one warp: the paper's ARAB at Nx =
    WIDE_NX (s = 4161).  DFRModel.fit(train, minibatch=4) cut to
    WIDE_FIT_EPOCHS (K6, K7, K4a, K4b; launches set to 0 before and read
    after), its wall time, beta and test accuracy (> 3/C); each fp32 refresh
    mode of WIDE_PATHS served as phase 4 serves (a warm-up and a measured
    wave of 64 streams on 32 slots, windows of 4, a refresh every 5
    rounds), captured (launches a round checked) and eager, equal bit for
    bit, and its captured wave profiled for the device's busy share.
    Phase 7 holds a fit on WIDE_AGREE's subset on the card against the
    CPU's."""
    train, test = data
    cfg = paper_dfr_config("ARAB", n_nodes=WIDE_NX)
    arrays = (train.u.numpy(), train.length.numpy(), train.label.numpy())
    model = DFRModel.create(dataclasses.replace(cfg, epochs=WIDE_FIT_EPOCHS),
                            generator=torch.Generator().manual_seed(0))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    params = model.fit(train, minibatch=FIT_MINIBATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tag = f"[{card}] DFRModel.fit Nx={WIDE_NX}"
    print(f"  {tag}: ARAB s={cfg.s}, {train.batch} samples, "
          f"{WIDE_FIT_EPOCHS} epochs (CUT from the paper's {cfg.epochs}), "
          f"minibatch 4, select='val': {wall:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check_launches(tag, launches, TRAINING_KERNELS)
    beta, dist = chosen_beta(model, train, params)
    acc = float(model.accuracy(test, params))
    print(f"  {tag}: p {float(params.p):.6g}, q {float(params.q):.6g}, beta "
          f"{beta:g}, test accuracy {acc:.4f} on {test.batch}")
    check(dist[beta] <= 1e-3, "no beta of the sweep gives the fitted W")
    check(acc > 3.0 / cfg.n_classes, f"test accuracy {acc}")
    del model, params

    for path in WIDE_PATHS:
        cap = main_path_phase(card, cfg, arrays, path)
        eager = serving_run(cfg, arrays, path, "eager")
        print(f"  [{card}] {path} eager: " + run_line(eager))
        preds, states = same_serving(eager, cap)
        print(f"  {path}: eager against captured: predictions "
              f"{'equal' if preds else 'DIFFER'}, final states "
              f"{'equal bit for bit' if states else 'DIFFER'}")
        check(preds and states, f"{path}: the eager round serves another "
                                f"episode")
        check(eager["replays"] == 0, "the eager round replayed a graph")
        rates = [r["served"] / r["wall"] for r in (cap, eager)]
        peak = cap["peak_alloc"] / 2**20
        del cap, eager
        prof = profile_phase(card, cfg, arrays, path, "captured")
        print(f"  {path}: samples/s captured {rates[0]:.1f}, eager "
              f"{rates[1]:.1f}; device busy {prof['busy_ms']:.3f} ms a "
              f"round, idle {prof['idle']:.1f}% (profiled captured wave); "
              f"peak memory of the captured server {peak:.1f} MiB")


def k1_population_phase(cfg, train, mask) -> None:
    """K1 at the population's shape (phase 3): one launch over K = POP_DIVS^2
    members x all ARAB training samples, each member with its own (p, q),
    against the plain version on the first POP_PLAIN_SAMPLES samples of
    every member, and timed beside its byte bound and its chain bound.

    Two sets of (p, q): K distinct pairs drawn log-uniform from the stable
    part of the search box (p, q <= 10^-0.5: the state contracts), held
    entrywise at rtol 1e-4 / atol 1e-4 as phase 3 holds K1; and the
    population's own grid, whose corner members (p = 10^-0.25 with q >=
    0.08) grow by about p / (1 - q) a step, to |r| ~ 1e19 at T = 93, where
    the same sums in another order agree to each sample's scale and not
    entrywise: held at |dr| <= 1e-4 max |r of the sample| + 1e-4."""
    dev = torch.device("cuda")
    nx, f = cfg.n_nodes, cfg.f()
    k, n = POP_DIVS ** 2, train.batch
    rng = np.random.default_rng(0)
    stable = tuple(torch.from_numpy((10.0 ** rng.uniform(lo, -0.5, k)).astype(
        np.float32)).to(dev) for lo in (candidates.P_LOG_RANGE[0],
                                        candidates.Q_LOG_RANGE[0]))
    grid = candidates.grid_candidates(POP_DIVS, device=dev)
    j = masking.apply_mask(mask.to(dev), train.u.to(dev))
    jk = j.expand(k, *j.shape).contiguous()
    lk = train.length.to(dev).expand(k, n).contiguous()
    sub = POP_PLAIN_SAMPLES

    def k1(jj, ll, pq, backend):
        return ops.train_forward(jj, ll, *pq, nx, f=f, backend=backend)

    times = {}
    for name, pq in (("stable (p, q)", stable), ("the grid's (p, q)", grid)):
        got = k1(jk, lk, pq, "cuda")
        want = k1(jk[:, :sub], lk[:, :sub], pq, "torch")
        torch.cuda.synchronize()
        got = tuple(g[:, :sub] for g in got)
        what = f"K1 at K={k} x B={sub} of one launch over K x {n}, {name}"
        if pq is stable:
            compare(what, got, want)
        else:
            worst = 0.0
            for g, w in zip(got, want):
                check(bool(torch.isfinite(g).all()), f"{what}: non-finite")
                scale = w.abs().amax(dim=-1, keepdim=True)
                err = (g - w).abs() / (scale + 1.0)
                worst = max(worst, float(err.max()))
            print(f"  {what}: max |dr| / (max |r| of the sample + 1) "
                  f"{worst:.3e} (tolerance 1e-4), largest |r| "
                  f"{float(want[0].abs().max()):.3e}")
            check(worst <= 1e-4, f"{what}: kernel disagrees with its plain "
                                 f"version")
        times[name] = device_ms(lambda: k1(jk, lk, pq, "cuda"), reps=10)
    plain_ms = wall_ms(lambda: k1(jk[:, :sub], lk[:, :sub], grid, "torch"),
                       reps=3)
    live = int(lk.sum())
    bnd, by = kernel_cost.train_forward(live, k, k * n, nx).bound()
    print(f"  K1 at the population's shape, K={k} x B={n} = {k * n} samples "
          f"(T={train.t_max}, Nx={nx}, {live} live steps, inputs "
          f"{jk.numel() * 4 / 2**20:.1f} MiB expanded): kernel "
          + ", ".join(f"{ms:.4f} ms at {name}" for name, ms in times.items())
          + f" (device time, median of 10), bound {bnd:.5f} ms ({by}), "
          f"{times["the grid's (p, q)"] / bnd:.1f}x the bound; plain on K x "
          f"{sub}: {plain_ms:.2f} ms; "
          + chain_bound(int(lk.max()),
                        CHAIN["step_cycles"]["K1/K2/K6 scan_step"],
                        "scan_step"))


def device_share(fn, key: str, top: int = 4) -> tuple:
    """(the device time of kernels whose name holds ``key``, all kernels'
    device time, the wall time, in ms, and the kernel launches) of one call
    of ``fn`` under torch.profiler; prints the ``top`` kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    mine = sum(e.self_device_time_total for e in dev if key in e.key) / 1e3
    launches = sum(e.count for e in host
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    check(busy > 0, "the profiler saw no device time")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    return mine, busy, wall * 1e3, launches


def fp32_sensitivity(cfg, train, test, mask) -> tuple:
    """The (K, n_beta) test accuracy of the population grid's ridge
    readouts solved in float64 from K1's features, and for each cell the
    most test predictions that move when every feature is perturbed by a
    relative POP_FP32_NOISE (two draws): cells where fp32 cannot resolve
    the readout.  A member whose fp32 Gram would overflow counts as moving
    every prediction."""
    dev = torch.device("cuda")
    ps, qs = candidates.grid_candidates(POP_DIVS, device=dev)
    feats = [core_population.population_features(
        cfg, mask.to(dev), ps, qs, b.u.to(dev), b.length.to(dev)).double()
        for b in (train, test)]
    y = torch.nn.functional.one_hot(train.label.long(), cfg.n_classes).to(
        dev, torch.float64)
    label = test.label.to(dev)
    eye = torch.eye(cfg.s, dtype=torch.float64, device=dev)

    def table(rt, rte):
        A, B = y.T @ rt, rt.mT @ rt
        out = []
        for beta in cfg.betas:
            W, _ = torch.linalg.solve_ex(B + beta * eye, A.mT)
            out.append((rte @ W).argmax(dim=-1) == label)
        return torch.stack(out, dim=1)                    # (K, nb, Be)

    base = table(*feats)
    gen = torch.Generator(device=dev).manual_seed(0)
    flips = torch.zeros(base.shape[:2], dtype=torch.int64, device=dev)
    for _ in range(2):
        noisy = [f * (1 + POP_FP32_NOISE * torch.randn(
            f.shape, generator=gen, dtype=f.dtype, device=dev)) for f in feats]
        flips = torch.maximum(flips, (table(*noisy) != base).sum(dim=-1))
    gram_max = train.batch * feats[0].abs().amax(dim=(1, 2)) ** 2
    flips[gram_max > torch.finfo(torch.float32).max] = test.batch
    acc64 = base.double().mean(dim=-1)
    return acc64.cpu().numpy(), flips.cpu().numpy()


def population_k1_ms(cfg, data, mask) -> tuple:
    """The device time (ms) of K1's two launches of a population evaluation
    at divs=POP_DIVS (the training and test splits), and of expanding the
    masked inputs over the members, which K1 reads contiguous."""
    dev = torch.device("cuda")
    ps, qs = candidates.grid_candidates(POP_DIVS, device=dev)
    k, k1, copy = ps.shape[0], 0.0, 0.0
    for b in data:
        j = masking.apply_mask(mask.to(dev), b.u.to(dev))
        lens = b.length.to(dev)
        jk = j.expand(k, *j.shape).contiguous()
        lk = lens.expand(k, *lens.shape).contiguous()
        k1 += device_ms(lambda: ops.train_forward(jk, lk, ps, qs, cfg.n_nodes,
                                                  f=cfg.f()), reps=10)
        copy += device_ms(lambda: j.expand(k, *j.shape).contiguous(),
                          reps=10)
    return k1, copy


def population_phase(card: str, cfg, data, fit: dict) -> None:
    """The hyperparameter search at ARAB's full width (phase 6b): the serial
    grid search (K6, K7, K4a, K4b a candidate), the population's grid search
    (K1 once a split for all members) and the population search with one
    refinement round, each with every launch count set to 0 just before it
    and read just after; then the paper's Table 5 protocol against phase
    6's fit."""
    train, test = data
    n_test = test.batch
    betas = np.asarray(cfg.betas)
    tag = f"[{card}] ARAB Nx={cfg.n_nodes} s={cfg.s}, divs={POP_DIVS}"
    out = {}
    for name, fn, on_path in (
            ("grid_search_serial", grid_search_serial,
             ("K6 reservoir_states", "K7 dprr_features", "K4a chol_tile",
              "K4b trsm_tile")),
            ("grid_search", grid_search, ("K1 train_forward",))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = fn(cfg, train, test, POP_DIVS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() - base
        out[name] = res
        print(f"  {tag}: {name}: {wall:.3f} s ({res['n_points']} points), "
              f"test accuracy {res['acc']:.4f}, p {res['p']:.6g}, q "
              f"{res['q']:.6g}, beta {res['beta']:g}; peak memory above the "
              f"data {peak / 2**20:.1f} MiB")
        check_launches(f"{name}", launches, on_path)
    check(launches["K1 train_forward"] == 2,
          "grid_search: K1 must launch once a split")
    k = POP_DIVS ** 2
    diff = np.abs(out["grid_search"]["acc_all"]
                  - out["grid_search_serial"]["acc_all"]) * n_test
    print(f"  grid_search against grid_search_serial: largest accuracy "
          f"difference over the {k} candidates, in test samples, by beta: "
          + ", ".join(f"{b:g}: {d:.0f}" for b, d in zip(betas,
                                                       diff.max(axis=0)))
          + " (held below where the cell is well posed in fp32)")
    mask = masking.make_mask(torch.Generator().manual_seed(cfg.mask_seed),
                             cfg.n_nodes, cfg.n_in, cfg.dtype)
    acc64, flips = fp32_sensitivity(cfg, train, test, mask)
    healthy = flips <= POP_TABLE_SAMPLES
    ps, qs = (x.numpy() for x in candidates.grid_candidates(POP_DIVS))
    ser = out["grid_search_serial"]["acc_all"]
    par = out["grid_search"]["acc_all"]
    for m, c in np.argwhere(~healthy):
        print(f"  ill-posed in fp32: member {m} (p {ps[m]:.4g}, q "
              f"{qs[m]:.4g}) at beta {betas[c]:g}: {flips[m, c]} test "
              f"predictions move under a {POP_FP32_NOISE:g} perturbation of "
              f"the features; accuracy serial {ser[m, c]:.4f}, population "
              f"{par[m, c]:.4f}, float64 {acc64[m, c]:.4f}")
    held = healthy & (betas >= POP_HEALTHY_BETA)[None, :]
    d64 = np.abs(par - acc64) * n_test
    print(f"  {int(held.sum())} of {held.size} cells well posed at beta >= "
          f"{POP_HEALTHY_BETA:g}: largest difference serial vs population "
          f"{diff[held].max():.0f} test samples (at most "
          f"{POP_TABLE_SAMPLES}), population vs float64 "
          f"{d64[held].max():.0f} (printed)")
    for m, c in np.argwhere(held & (d64 > POP_TABLE_SAMPLES)):
        print(f"    fp32 apart from float64: member {m} (p {ps[m]:.4g}, q "
              f"{qs[m]:.4g}) at beta {betas[c]:g}: serial {ser[m, c]:.4f}, "
              f"population {par[m, c]:.4f}, float64 {acc64[m, c]:.4f}")
    check(float(diff[held].max()) <= POP_TABLE_SAMPLES + 1e-6,
          "the two grid searches' accuracy tables disagree")
    _, busy, wall_ms_, _ = device_share(
        lambda: grid_search(cfg, train, test, POP_DIVS, mask=mask,
                            device="cuda"), "train_forward_kernel")
    # K1's two launches timed by events on their own operands (the
    # profiler's kernel records of K1 came back incomplete in this phase)
    k1_ms, copy_ms = population_k1_ms(cfg, data, mask)
    print(f"  grid_search under torch.profiler: device busy {busy:.3f} ms of "
          f"{wall_ms_:.1f} ms wall; K1's two launches {k1_ms:.3f} ms (events, "
          f"median of 10) = {100 * k1_ms / busy:.1f}% of the device time; "
          f"expanding the masked inputs over the members {copy_ms:.3f} ms")

    refine_s, eval_s = [], []
    originals = (core_population.refine_population,
                 core_population.evaluate_population)
    timed(core_population, "refine_population", refine_s)
    timed(core_population, "evaluate_population", eval_s)
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = core_population.train_population_classification(
            cfg, train, test, divs=POP_DIVS, device="cuda", **POP_REFINE)
    finally:
        (core_population.refine_population,
         core_population.evaluate_population) = originals
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = POP_REFINE["rounds"] * POP_REFINE["steps_per_round"] * (
        train.batch // POP_REFINE["minibatch"])
    print(f"  {tag}: train_population_classification {POP_REFINE}: "
          f"{wall:.3f} s (evaluations {sum(eval_s):.3f} s, refinement "
          f"{sum(refine_s):.3f} s = {1e3 * sum(refine_s) / steps:.3f} ms a "
          f"minibatch step over {steps}); best test accuracy "
          f"{res.best_acc:.4f} (round 0 {res.history[0]['best_acc']:.4f}), "
          f"p {res.best_p:.6g}, q {res.best_q:.6g}, beta {res.best_beta:g}; "
          f"launches: " + ", ".join(f"{n.split()[0]} {c}" for n, c in
                                   launches.items() if c))
    check(launches["K1 train_forward"] == 2 * (POP_REFINE["rounds"] + 1)
          + steps, "train_population: K1 must launch once a minibatch step "
                   "and once a split an evaluation")
    check(res.history[0]["best_acc"] == out["grid_search"]["acc"],
          "the population's round 0 is not grid_search's accuracy")
    check(res.best_acc >= res.history[0]["best_acc"],
          "the population lost its elite")
    sub = slice(0, POP_PROFILE_STEPS * POP_REFINE["minibatch"])
    u, ln = train.u[sub].cuda(), train.length[sub].cuda()
    y = torch.nn.functional.one_hot(train.label[sub].long(),
                                    cfg.n_classes).float().cuda()
    pop = candidates.init_population(
        cfg, *candidates.grid_candidates(POP_DIVS, device="cuda"))
    lr = torch.tensor(cfg.lr, device="cuda")

    def refine():
        core_population.refine_population(
            cfg, mask.cuda(), pop, u, ln, y, lr, lr,
            minibatch=POP_REFINE["minibatch"])

    refine()
    k1_ms, busy, wall_ms_, launches = device_share(refine,
                                                   "train_forward_kernel")
    print(f"  refine_population, {POP_PROFILE_STEPS} minibatch steps of "
          f"{k} members x {POP_REFINE['minibatch']} under torch.profiler: "
          f"{wall_ms_ / POP_PROFILE_STEPS:.3f} ms a step, "
          f"{launches / POP_PROFILE_STEPS:.1f} kernel launches a step, "
          f"device busy {busy / POP_PROFILE_STEPS:.4f} ms a step "
          f"({100 * busy / wall_ms_:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms_:.1f}%), K1 "
          f"{k1_ms / POP_PROFILE_STEPS:.4f} ms a step")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    until = grid_search_until(cfg, train, test, target_acc=fit["test_acc"],
                              max_divs=TABLE5_MAX_DIVS, device="cuda")
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  [{card}] Table 5 (grid_search_until, target "
          f"{fit['test_acc']:.4f} = phase 6's fit): reached divs="
          f"{until['divs']} (K={until['divs'] ** 2}), accuracy "
          f"{until['acc']:.4f}, total "
          f"{until['total_time_s']:.3f} s over divs 1..{until['divs']}; "
          f"backprop (DFRModel.fit) {fit['wall']:.2f} s; grid / backprop "
          f"{until['total_time_s'] / fit['wall']:.4f}; peak memory above "
          f"the data {peak / 2**30:.2f} GiB")
    check(np.isfinite(until["acc"]), "grid_search_until gave no accuracy")


def checkpoint_phase(card: str, cfg, data) -> None:
    """PopulationTrainer(ckpt_dir=...) at phase 6b's population (phase
    6b): the winner saved to a temporary directory and restored onto the
    card, its test predictions equal to the in-memory winner's bit for bit;
    the bytes on disk and the save and restore times."""
    train, test = data
    save_s = []
    original = CheckpointManager.save
    timed(CheckpointManager, "save", save_s)
    try:
        with tempfile.TemporaryDirectory(prefix="ckpt_") as tmp:
            t0 = time.perf_counter()
            pt = PopulationTrainer(PopulationTrainerConfig(
                divs=POP_DIVS, ckpt_dir=tmp, **POP_REFINE))
            res = pt.fit(cfg, train, test, device="cuda")
            fit_s = time.perf_counter() - t0
            ckpt = CheckpointManager(tmp)
            nbytes = sum(p.stat().st_size
                         for p in Path(tmp).rglob("*") if p.is_file())
            t0 = time.perf_counter()
            got = ckpt.restore_latest(res.best_params, device="cuda")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(got is not None, "the saved winner did not restore")
            tree, step, meta = got
            model = DFRModel.create(cfg, device="cuda")
            want = model.predict(test, res.best_params)
            preds = model.predict(test, tree)
            same = all(torch.equal(getattr(tree, k),
                                   getattr(res.best_params, k))
                       for k in ("p", "q", "W", "b"))
            acc = float((preds.cpu() == test.label).float().mean())
            print(f"  [{card}] PopulationTrainer(divs={POP_DIVS}, "
                  f"{POP_REFINE}, ckpt_dir=...): {fit_s:.3f} s with the save; "
                  f"saved step {step} in {sum(save_s):.4f} s, {nbytes} bytes "
                  f"on disk ({len(list(Path(tmp).rglob('*.npy')))} .npy "
                  f"files and the manifest), metadata {meta}; restored onto "
                  f"the card in {restore_s:.4f} s; leaves equal bit for bit: "
                  f"{same}; test predictions equal: "
                  f"{bool(torch.equal(preds, want))} (accuracy {acc:.4f}, "
                  f"{test.batch} samples)")
            check(same and torch.equal(preds, want) and step
                  == POP_REFINE["rounds"],
                  "the restored winner differs from the one in memory")
    finally:
        CheckpointManager.save = original


def rel_diff(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def fp64_sensitivity(A, B, beta: float) -> tuple:
    """The float64 W = A (B + beta I)^-1 of phase 6's statistics, solved on
    the CPU, and how far it moves (max |dW| / max |W|, the larger of two
    draws) when every entry of B is perturbed by a relative
    MEM_FP32_NOISE, symmetrically: the spread that two fp32 solves of this
    system may show."""
    A64, B64 = A.double().cpu(), B.double().cpu()
    eye = torch.eye(B64.shape[-1], dtype=torch.float64)
    W = torch.linalg.solve(B64 + beta * eye, A64.T).T
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for _ in range(2):
        N = torch.randn(B64.shape, generator=gen, dtype=torch.float64)
        Bp = B64 * (1.0 + MEM_FP32_NOISE * 0.5 * (N + N.T))
        worst = max(worst, rel_diff(
            torch.linalg.solve(Bp + beta * eye, A64.T).T, W))
    return worst, W


def solve_sweep(A, B, betas, method: str) -> dict:
    """W~ of each beta by ``method`` (None where not finite)."""
    out = {}
    for beta in betas:
        W = ridge.ridge_solve(A, ridge.regularize(B, beta), method)
        out[beta] = W if bool(torch.isfinite(W).all()) else None
    return out


def table8_phase(card: str, cfg, model, data, params):
    """Table 8 on the card: DFRModel.fit_ridge by each of MEM_METHODS on
    phase 6's (p, q) over the whole training split: the beta each chooses,
    the test accuracies, the packed W against the blocked W, and each
    method's wall time, launches, device time and peak memory a solve.
    Returns B + 1e-2 I of the split's statistics."""
    train, test = data
    s, ny = cfg.s, cfg.n_classes
    tag = f"[{card}] Table 8, ARAB Nx={cfg.n_nodes} s={s}"
    A, B = model.ridge_statistics(train, params, CHUNK)
    sols, chosen, correct = {}, {}, {}
    for method in MEM_METHODS:
        fitted = model.fit_ridge(train, params, method=method)
        sols[method] = solve_sweep(A, B, cfg.betas, method)
        dist = {beta: rel_diff(W[:, :-1], fitted.W)
                for beta, W in sols[method].items() if W is not None}
        check(bool(dist), f"{method}: no beta of the sweep is finite")
        chosen[method] = min(dist, key=dist.get)
        check(dist[chosen[method]] <= 1e-6,
              f"{method}: no beta of the sweep gives fit_ridge's W")
        correct[method] = int(round(float(model.accuracy(test, fitted))
                                    * test.batch))
        print(f"  {tag}: fit_ridge(method='{method}'): finite at beta "
              + ", ".join(f"{b:g}" for b, W in sols[method].items()
                          if W is not None)
              + f"; chooses beta {chosen[method]:g}; test accuracy "
              f"{correct[method] / test.batch:.4f} ({correct[method]} of "
              f"{test.batch})")
    check(len(set(chosen.values())) == 1,
          f"the ridge methods choose different betas: {chosen}")
    spread = max(correct.values()) - min(correct.values())
    print(f"  {tag}: test accuracies within {spread} samples (at most "
          f"{MEM_ACC_SAMPLES})")
    check(spread <= MEM_ACC_SAMPLES, "the ridge methods' accuracies differ")
    for beta in cfg.betas:
        sens, W64 = fp64_sensitivity(A, B, beta)
        blocked, packed = (sols[m][beta] for m in ("cholesky_blocked",
                                                    "cholesky_packed"))
        vs64 = ", ".join(
            f"{m} {rel_diff(sols[m][beta].cpu(), W64):.3e}"
            if sols[m][beta] is not None else f"{m} not finite"
            for m in MEM_METHODS)
        line = (f"  {tag}: beta {beta:g}: float64 W moves {sens:.3e} under a "
                f"{MEM_FP32_NOISE:g} perturbation of B; each fp32 W against "
                f"float64: {vs64}")
        if beta < MEM_HELD_BETA or blocked is None:
            print(line + " (not held)")
            continue
        limit = max(SOLVE_REL, sens)
        d = (rel_diff(packed, blocked) if packed is not None
             else float("inf"))
        print(line + f"; packed against blocked {d:.3e} (limit {limit:.3e})")
        check(d <= limit, f"packed W against blocked W at beta {beta}: {d}")

    Bb = ridge.regularize(B, 1e-2)
    for method in MEM_METHODS:
        def solve():
            return ridge.ridge_solve(A, Bb, method)

        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        solve()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        _, busy, wall, launches = device_share(solve, "", top=2)
        print(f"  {tag}: {method} at beta 1e-2: {1e3 * np.median(walls):.2f} "
              f"ms a solve (wall, median of 3); under torch.profiler "
              f"{wall:.2f} ms, {launches} launches, device busy {busy:.3f} "
              f"ms; peak memory above the inputs {peak / 2**20:.3f} MiB")
    print(f"  {tag}: Table 2's words x 4 bytes: naive "
          f"{ridge.memory_words_naive(s, ny) * 4 / 2**20:.3f} MiB, proposed "
          f"{ridge.memory_words_proposed(s, ny) * 4 / 2**20:.3f} MiB")
    return Bb


def packed_update_phase(card: str, cfg, model, train, params, Bb) -> None:
    """MEM_UPDATE_ROWS feature rows rotated into the packed factor of
    B + 1e-2 I (cholupdate_packed) against K3's fold of the same rows on
    the same factor."""
    s = cfg.s
    P = ridge.cholesky_packed(ridge.pack_lower(Bb), s)
    check(bool(torch.isfinite(P).all()), "the packed factor is not finite")
    rows = TimeSeriesBatch(u=train.u[:MEM_UPDATE_ROWS],
                           length=train.length[:MEM_UPDATE_ROWS],
                           label=train.label[:MEM_UPDATE_ROWS])
    X = dprr.r_tilde(model.features(rows, params))
    Lt = ridge.unpack_lower(P, s).T.contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ops.cholupdate_window_t(Lt[None], X[None], 1.0)[0]
    torch.cuda.synchronize()
    k3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for x in X:
        ridge.cholupdate_packed(P, x, s)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    d = rel_diff(ridge.unpack_lower(P, s).T, want)
    print(f"  [{card}] packed update, s={s}, {MEM_UPDATE_ROWS} rows into the "
          f"factor of B + 1e-2 I: cholupdate_packed {1e3 * packed_s:.1f} ms "
          f"(wall), K3 {1e3 * k3_s:.3f} ms (wall, one launch); max |dLt| / "
          f"max |Lt| {d:.3e} (limit {MEM_UPDATE_REL:g})")
    check(d <= MEM_UPDATE_REL, "the packed update disagrees with K3")


def gradients_phase(card: str, cfg, model, train, params) -> None:
    """The manual truncated gradients, K1's, K6 + K7's, and full BPTT's W and
    b on MEM_GRAD_SAMPLES training samples at phase 6's parameters."""
    n = MEM_GRAD_SAMPLES
    j = model.mask_inputs(train.u[:n].cuda())
    ln = train.length[:n].cuda()
    onehot = torch.nn.functional.one_hot(
        train.label[:n].long().cuda(), cfg.n_classes).float()
    f = cfg.f()
    grads, on_path = {}, {"manual": (), "K1 fused": ("K1 train_forward",),
                          "K6 + K7": ("K6 reservoir_states",
                                      "K7 dprr_features"),
                          "full BPTT": ()}
    for name, fn in (
            ("manual", lambda: backprop.grads_truncated_manual(
                params, j, onehot, f, None, ln)),
            ("K1 fused", lambda: backprop.grads_truncated_fused(
                params, j, onehot, f, ln)),
            ("K6 + K7", lambda: backprop.grads_truncated(
                params, j, onehot, f, ln)),
            ("full BPTT", lambda: backprop.grads_full_bptt(
                params, j, onehot, f, ln))):
        reset_launches()
        grads[name] = fn()[1]
        torch.cuda.synchronize()
        check_launches(f"[{card}] {name} gradients", read_launches(),
                       on_path[name])
    want = grads["manual"]
    for name, leaves, tol in (("K1 fused", "pqWb", GRAD_TOL),
                              ("K6 + K7", "pqWb", GRAD_TOL),
                              ("full BPTT", "Wb", FULL_WB_TOL)):
        for leaf in leaves:
            got, ref_ = getattr(grads[name], leaf), getattr(want, leaf)
            err = float((got - ref_).abs().max())
            print(f"  [{card}] {name} against the manual gradients, {leaf}: "
                  f"max abs err {err:.3e} of max {float(ref_.abs().max()):.3e}"
                  f" (rtol {tol['rtol']}, atol {tol['atol']})")
            check(torch.allclose(got, ref_, **tol),
                  f"{name} gradient of {leaf} disagrees with the manual one")
    full = grads["full BPTT"]
    print(f"  [{card}] full BPTT's (p, q) gradients {float(full.p):.6g}, "
          f"{float(full.q):.6g} beside the truncated {float(want.p):.6g}, "
          f"{float(want.q):.6g} (not compared)")


def table7_phase(card: str, cfg, model, train, params) -> None:
    """Table 7 on the card: the peak memory above the inputs of full BPTT
    and of K1's truncated gradients over the whole training split."""
    n, t = train.batch, train.t_max
    j = model.mask_inputs(train.u.cuda())
    ln = train.length.cuda()
    onehot = torch.nn.functional.one_hot(train.label.long().cuda(),
                                         cfg.n_classes).float()
    f = cfg.f()

    def peak(fn, b):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(params, j[:b], onehot[:b], f, ln[:b])
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, \
            time.perf_counter() - t0

    k1_peak, k1_s = peak(backprop.grads_truncated_fused, n)
    b = n
    while True:
        try:
            full_peak, full_s = peak(backprop.grads_full_bptt, b)
            break
        except torch.cuda.OutOfMemoryError:
            print(f"  [{card}] full BPTT at {b} samples does not fit")
            b //= 2
            check(b > 0, "full BPTT fits no batch")
    state_mb = n * t * cfg.n_nodes * 4 / 1e6
    print(f"  [{card}] Table 7, ARAB Nx={cfg.n_nodes}, {n} samples, T <= {t}"
          f": full BPTT ({b} samples) peak {full_peak / 1e6:.1f} MB above "
          f"the inputs in {full_s:.3f} s; K1 truncated peak "
          f"{k1_peak / 1e6:.1f} MB in {k1_s:.3f} s; ratio "
          f"{full_peak / k1_peak:.1f}; one (B, T, Nx) state tensor "
          f"{state_mb:.1f} MB; words x 4 bytes x B: naive "
          f"{backprop.storage_words_naive(cfg, t) * 4 * b / 1e6:.1f} MB, "
          f"truncated "
          f"{backprop.storage_words_truncated(cfg, t) * 4 * n / 1e6:.1f} MB")


def memory_phase(card: str, cfg, data, fit: dict) -> None:
    """The paper's memory algorithms at ARAB's full width (phase 6c), from
    phase 6's fitted model and parameters."""
    train = data[0]
    model, params = fit["model"], fit["params"]
    Bb = table8_phase(card, cfg, model, data, params)
    for row in fig9_runtime_ratio(device="cuda"):
        print(f"  Fig. 9: {json.dumps(row)}")
        check(all(row[k] > 0 for k in ("gaussian_us", "cholesky_us",
                                       "packed_us")), "Fig. 9: no time")
    packed_update_phase(card, cfg, model, train, params, Bb)
    gradients_phase(card, cfg, model, train, params)
    table7_phase(card, cfg, model, train, params)


def autotuner_phase(card: str, cfg, arrays) -> None:
    """The warm-pool autotuner on phase 4's servers (phase 4f): for each
    path an untuned run and a margin=10 tuner (bit for bit equal), then the
    tuned server's captured, eager and pipelined rounds alternated as in
    phase 4c, every run bit for bit equal to the first (stats too), K1 once
    a round plus twice a tuning round, each live factor still factoring its
    statistics; then the reference's tuner episode on the card."""
    order = ("captured", "eager", "pipelined", "pipelined", "eager",
             "captured")
    for path, (_, on_path) in PATHS.items():
        untuned = serving_run(cfg, arrays, path, "captured")
        print(f"  [{card}] {path} untuned: " + run_line(untuned))
        quiet = serving_run(cfg, arrays, path, "captured",
                            tuner=dict(margin=10.0))
        preds, states = same_serving(quiet, untuned)
        print(f"  {path} margin=10 tuner: {quiet['tuning_rounds']} tuning "
              f"rounds, {quiet['swaps']} swaps; predictions "
              f"{'equal' if preds else 'DIFFER'}, final states "
              f"{'equal bit for bit' if states else 'DIFFER'}")
        check(preds and states and quiet["tuning_rounds"] > 0
              and quiet["stats"]["swaps_applied"] == 0,
              f"{path}: a tuner that never swaps changed the episode")
        runs = []
        for kind in order:
            res = serving_run(cfg, arrays, path, kind, tuner={})
            r, tr = res["rounds"], res["tuning_rounds"]
            print(f"  [{card}] {path} tuned {kind}: " + run_line(res)
                  + f"; tuner: {tr} tuning rounds and {res['swaps']} swaps "
                  f"in the wave, {res['stats']}; K1 "
                  f"{res['launches']['K1 train_forward']} launches over "
                  f"{r} rounds")
            for name, n in res["launches"].items():
                want = (r + 2 * tr if name == "K1 train_forward"
                        else r if name in on_path else 0)
                check(n == want, f"{path} tuned {kind}: {name}: {n} launches "
                                 f"({want} expected)")
            runs.append(res)
        first = runs[0]
        check(first["stats"]["swaps_applied"] > 0,
              f"{path}: the tuner made no swap")
        acc = [float(np.mean([r.online_accuracy
                              for r in res["done"].values()]))
               for res in (untuned, first)]
        print(f"  {path}: mean rolling online accuracy of the measured wave: "
              f"untuned {acc[0]:.4f}, tuned {acc[1]:.4f}")
        for kind, res in zip(order[1:], runs[1:]):
            preds, states = same_serving(res, first)
            same = res["stats"] == first["stats"]
            print(f"  {path} tuned: {kind} against the first captured run: "
                  f"predictions {'equal' if preds else 'DIFFER'}, final "
                  f"states {'equal bit for bit' if states else 'DIFFER'}, "
                  f"tuner stats {'equal' if same else 'DIFFER'}")
            check(preds and states and same,
                  f"{path}: the tuned {kind} round serves another episode")
        if PATHS[path][0].get("refresh_mode") == "incremental":
            worst = tuned_invariant(first)
            print(f"  {path} tuned: every live factor against B + beta I "
                  f"after the swaps: largest |Lt^T Lt - (B + beta I)| "
                  f"{worst:.3e} (allclose at rtol = atol = {TUNER_TOL})")
    tuner_episode(card)


def bf16_phase(card: str, main_runs: dict, profiles: dict) -> None:
    """The bf16 path beside fp32 (phase 4's captured waves, one profiled
    captured wave each): samples/s, dispatch p50/p99, device busy a round,
    peak memory and the mean rolling online accuracy (no limit on the
    accuracy: bf16 statistics are the reference's semantics)."""
    for path in ("fp32", "bf16"):
        res, prof = main_runs[path], profiles[path, "captured"]
        lat = res["lat"]
        print(f"  [{card}] {path} captured: {res['served'] / res['wall']:.1f} "
              f"samples/s, dispatch p50 {lat['p50_ms']:.3f} ms, p99 "
              f"{lat['p99_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
              f"a round (idle {prof['idle']:.1f}%), peak memory allocated "
              f"{res['peak_alloc'] / 2**20:.1f} MiB, reserved "
              f"{res['peak_reserved'] / 2**20:.1f} MiB, mean rolling online "
              f"accuracy {res['acc']:.4f}"
              + (f" ({PATHS['fp32'][0] or 'recompute'})" if path == "fp32"
                 else " (incremental)"))


def lattice_server(cfg, arrays, knobs: dict) -> StreamServer:
    """A captured ARAB server of phase 4's shape with ``knobs``, after its
    warm-up wave (the kernels' loads, the graphs' capture)."""
    t_max = arrays[0].shape[1]
    streams, per_stream = make_streams(arrays, 64)
    srv = StreamServer(cfg, t_max=t_max, max_streams=32, window=4,
                       phase_steps=phase_steps_for(per_stream, 4),
                       refresh_every=5, device="cuda",
                       pool_capacity=max(s.n_samples for s in streams),
                       **knobs)
    for s in streams:
        srv.submit(s)
    srv.run_until_drained(strict=True)
    srv.sched.completed.clear()   # the warm-up's snapshots (wave_rate)
    return srv


def wave_rate(srv: StreamServer, arrays) -> tuple:
    """(samples/s, completed streams) of one wave of the 64 streams, timed
    from a collected heap.  The server's list of completed streams is
    emptied after the wave: each stream keeps its final state's snapshot
    (7 MB at s = 931), so twelve servers keeping every wave's would take
    gigabytes more of the card's memory each wave, and the allocator's new
    blocks would slow the later waves."""
    streams, _ = make_streams(arrays, 64)
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in streams:
        srv.submit(s)
    done = srv.run_until_drained(strict=True)[-len(streams):]
    torch.cuda.synchronize()
    rate = sum(s.n_samples for s in streams) / (time.perf_counter() - t0)
    srv.sched.completed.clear()
    return rate, done


def planner_phase(card: str, cfg, arrays) -> None:
    """The calibrated planner at full width (phase 4g): a forced
    calibration on the card into a temporary file; the plan of phase 4's
    fp32 and int8 servers; the captured samples/s of every lattice point
    with cohorts = 1 (refresh modes x step blocks; int8 incremental only,
    as phase 4's int8 server), the points alternated over PLANNER_WAVES
    measured waves each, their median; the gate (fatal): the best point's
    rate at most GATE_RATIO times the plan's; the same rates through
    replay_bench_tables from a temporary directory; and config='auto'
    serving what an explicit server with the plan's knobs serves, bit for
    bit."""
    t_max = arrays[0].shape[1]
    with tempfile.TemporaryDirectory(prefix="planner_") as tmp:
        os.environ[planner.CAL_ENV] = os.path.join(tmp,
                                                   planner.DEFAULT_CAL_FILE)
        try:
            t0 = time.perf_counter()
            cal = planner.get_calibration(force=True)
            cal_s = time.perf_counter() - t0
            coeffs = {k: v for k, v in dataclasses.asdict(cal).items()
                      if k.startswith("c_")}
            print(f"  [{card}] calibration in {cal_s:.2f} s: " + ", ".join(
                f"{k} {v:.4e}" for k, v in coeffs.items())
                + f"; fingerprint {cal.fingerprint}")
            check(all(np.isfinite(v) and v > 0 for v in coeffs.values()),
                  f"calibration: a coefficient is not positive: {coeffs}")
            plans, points = {}, []
            for path, modes in PLANNER_MODES.items():
                knobs = PATHS[path][0]
                pl = planner.Planner(
                    cfg.n_nodes, 32, 4, t_max, n_classes=cfg.n_classes,
                    refresh_every=5,
                    quantize=knobs.get("quantize", "none"), cal=cal)
                plans[path] = plan = pl.search(refresh_modes=modes)
                print(f"  {path}: plan {plan.knobs()}, predicted "
                      f"{plan.predicted_samples_per_s:.1f} samples/s, refresh "
                      f"spike {1e3 * plan.predicted_refresh_spike_s:.3f} ms; "
                      f"predicted samples/s at cohorts 1: " + ", ".join(
                          f"{m} b{b} {1.0 / pl.predict(m, 1, b):.1f}"
                          for m in modes
                          for b in planner.DEFAULT_STEP_BLOCKS))
                points += [(path, m, b) for m in modes
                           for b in planner.DEFAULT_STEP_BLOCKS]
            t0 = time.perf_counter()
            servers = {pt: lattice_server(cfg, arrays, dict(
                PATHS[pt[0]][0], refresh_mode=pt[1], step_block=pt[2],
                refresh_cohorts=1)) for pt in points}
            warm_s = time.perf_counter() - t0
            rates = {pt: [] for pt in points}
            for wave in range(PLANNER_WAVES):
                for pt in (points if wave % 2 == 0 else points[::-1]):
                    rates[pt].append(wave_rate(servers[pt], arrays)[0])
            del servers
            med = {pt: statistics.median(r) for pt, r in rates.items()}
            print(f"  lattice servers built and warmed in {warm_s:.1f} s; "
                  f"captured samples/s, median of {PLANNER_WAVES} alternated "
                  f"waves:")
            for pt in points:
                print(f"    {pt[0]} {pt[1]} step_block {pt[2]}: "
                      f"{med[pt]:.1f} (" + ", ".join(
                          f"{x:.1f}" for x in rates[pt]) + ")")
            for path, plan in plans.items():
                mine = [pt for pt in points if pt[0] == path]
                best = max(mine, key=med.get)
                pick = (path, plan.refresh_mode, plan.step_block)
                ratio = med[best] / med[pick]
                print(f"  [{card}] {path}: planner's pick {pick[1]} "
                      f"step_block {pick[2]} measured {med[pick]:.1f} "
                      f"samples/s; best {best[1]} step_block {best[2]} "
                      f"{med[best]:.1f}; best / pick {ratio:.3f} (gate "
                      f"{planner.GATE_RATIO})")
                check(ratio <= planner.GATE_RATIO,
                      f"{path}: the planner's pick is {ratio:.3f}x below the "
                      f"best measured point")
            row = {"table": "stream-quant", "t_len": t_max,
                   "cell": f"S32/Nx{cfg.n_nodes}/W4"}
            for name, (path, b) in (("fp32", ("fp32", 1)),
                                    ("int8", ("int8", 1)),
                                    ("fp32_b4", ("fp32", 4)),
                                    ("int8_b4", ("int8", 4))):
                row[f"{name}_samples_per_s"] = med[(path, "incremental", b)]
            with open(os.path.join(tmp, "BENCH_stream_quant.json"),
                      "w") as fh:
                json.dump({"bench": "stream_quant", "rows": [row]}, fh)
            for r in planner.replay_bench_tables(tmp, cal=cal):
                print(f"  replay_bench_tables on these rates (incremental, "
                      f"fp32/int8 x step_block 1/4; the reference's "
                      f"n_classes=4 pricing): {r}")
            for path in PATHS:
                auto = lattice_server(cfg, arrays, dict(
                    {k: v for k, v in PATHS[path][0].items()}, config="auto"))
                knobs = dict(PATHS[path][0], refresh_mode=auto.refresh_mode,
                             step_block=auto.step_block,
                             refresh_cohorts=auto.cohorts.n_cohorts)
                explicit = lattice_server(cfg, arrays, knobs)
                a = dict(srv=auto, done={r.rid: r for r in
                                         wave_rate(auto, arrays)[1]})
                b = dict(srv=explicit, done={r.rid: r for r in
                                             wave_rate(explicit, arrays)[1]})
                preds, states = same_serving(a, b)
                print(f"  {path}: config='auto' (plan {auto.plan.knobs()}) "
                      f"against an explicit server with "
                      f"{ {k: knobs[k] for k in ('refresh_mode', 'step_block', 'refresh_cohorts')} }: "
                      f"predictions {'equal' if preds else 'DIFFER'}, final "
                      f"states {'equal bit for bit' if states else 'DIFFER'}")
                check(preds and states, f"{path}: config='auto' serves "
                                        f"another episode")
                del auto, explicit, a, b
        finally:
            del os.environ[planner.CAL_ENV]
            planner._CAL_CACHE.clear()
        torch.cuda.empty_cache()


def batch_rounding_probe(cfg, device="cuda") -> dict:
    """Whether each batched library call of a round (BATCH_CALLS) gives the
    same bits for the first S/N problems of a batch of S as for a batch of
    S/N alone, at phase 4's shapes (S = 32 slots, windows of 4, s = 931),
    for N in SHARD_BLOCKS.  Returns {call: True where every N agrees}."""
    S, W, s, ny = 32, 4, cfg.s, cfg.n_classes
    g = torch.Generator(device=device).manual_seed(0)
    rt = torch.randn(S, W, s, device=device, generator=g)
    oh = torch.randn(S, W, ny, device=device, generator=g)
    X = torch.randn(S, s, 64, device=device, generator=g) / 8
    M = X @ X.mT + torch.eye(s, device=device)
    L = torch.linalg.cholesky(M)
    A = torch.randn(S, ny, s, device=device, generator=g)
    calls = {
        "bmm dA": lambda k: oh[:k].mT @ rt[:k],
        "bmm dB": lambda k: rt[:k].mT @ rt[:k],
        "cholesky_ex": lambda k: torch.linalg.cholesky_ex(M[:k])[0],
        "solve_triangular": lambda k: torch.linalg.solve_triangular(
            L[:k], A[:k].mT, upper=False),
        "sum over a slot's window": lambda k: rt[:k, :, :30].sum(
            dim=(-2, -1)),
    }
    same = {}
    for name, fn in calls.items():
        full = fn(S)
        same[name] = all(torch.equal(full[:S // n], fn(S // n))
                         for n in SHARD_BLOCKS)
    torch.cuda.synchronize()
    return same


def per_round_launches(path: str) -> dict:
    """Each kernel's launches a round of a one-block server of ``path``."""
    if path in RETIRE_PATHS:
        return RETIRE_PATHS[path][1]
    return {name: 1 for name in {**PATHS, **BF16_PATHS}[path][1]}


def near_serving(a: dict, b: dict) -> tuple:
    """(the share of equal predictions, whether the final states agree, the
    worst leaf and its max |d| / max |leaf|) of two runs' measured waves
    and servers: every leaf within SERVE_TOL, the int8 codes within one
    code (tests/test_torch_quant.py's episode limits)."""
    pairs = [(x, y) for rid, r in b["done"].items()
             for x, y in zip(a["done"][rid].preds, r.preds)]
    agree = sum(x == y for x, y in pairs) / len(pairs)
    trees = [(a["done"][rid].final_state, r.final_state)
             for rid, r in b["done"].items()]
    trees.append((a["srv"].states, b["srv"].states))
    named = [(convert.state_leaves(x), convert.state_leaves(y))
             for x, y in trees]
    if a["srv"].win is not None:
        named.append((convert.window_leaves(a["srv"].win),
                      convert.window_leaves(b["srv"].win)))
    close, worst = True, ("", 0.0)
    for la, lb in named:
        for name, x in la.items():
            x, y = x.astype(np.float64), lb[name].astype(np.float64)
            if name == "quant_Wq":
                close &= bool(np.abs(x - y).max() <= 1)
                continue
            close &= bool(np.allclose(y, x, **SERVE_TOL))
            rel = float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-30))
            if rel > worst[1]:
                worst = (name, rel)
    return agree, close, worst


def sharded_phase(card: str, cfg, arrays, main_runs: dict) -> None:
    """Multi-device serving at full width on one card (phase 4h): each of
    SHARD_PATHS served captured by phase 4's server split into 2 and 4
    blocks on a mesh that repeats cuda:0, each block replaying its own
    graphs; every run must serve the one-block captured run's predictions
    and end with its final states bit for bit (a path that runs a batched
    library call that rounds by batch size: within SERVE_TOL, with at least
    SERVE_AGREE of the predictions equal), with every kernel of the path
    launched its count a round in each block; then fp32 pipelined and
    blocked (pipeline_depth=2, step_block=4) on 2 blocks, and, with two
    cards, 2 blocks on the default mesh with each block's tensors on its own
    card."""
    same = batch_rounding_probe(cfg)
    print("  batched library calls, batch of S/N against the first S/N of "
          "a batch of S (N in " + ", ".join(map(str, SHARD_BLOCKS)) + "): "
          + ", ".join(f"{k} {'same bits' if v else 'DIFFER'}"
                      for k, v in same.items()))
    exact = {path: all(v for k, v in same.items() if path in BATCH_CALLS[k])
             for path in SHARD_PATHS}

    def held(path, base, res, what):
        preds, states = same_serving(base, res)
        if exact[path]:
            print(f"  {what}: predictions {'equal' if preds else 'DIFFER'}, "
                  f"final states {'equal bit for bit' if states else 'DIFFER'}"
                  f" against the one-block captured run")
            check(preds and states, f"{what} serves another episode")
            return
        agree, close, (leaf, rel) = near_serving(base, res)
        print(f"  {what}: bit for bit {preds and states}; {agree:.4f} of "
              f"the predictions equal (limit {SERVE_AGREE}), final states "
              f"within rtol {SERVE_TOL['rtol']} / atol {SERVE_TOL['atol']} "
              f"(int8 codes within 1): {close}, the largest max |d| / max "
              f"|leaf| {rel:.3e} ({leaf}) (a batched library call of the "
              f"path rounds by batch size)")
        check(agree >= SERVE_AGREE and close, f"{what} serves another "
                                              f"episode")

    for path in SHARD_PATHS:
        base = main_runs.get(path)
        if base is None:
            base = serving_run(cfg, arrays, path, "captured")
        rates = {1: base["served"] / base["wall"]}
        per_round = per_round_launches(path)
        for n in SHARD_BLOCKS:
            res = serving_run(cfg, arrays, path, "captured", devices=n)
            srv, rounds = res["srv"], res["rounds"]
            check(len(srv.blocks) == n and {
                blk.states.step.device for blk in srv.blocks} == {
                torch.device("cuda", 0)}, f"{path}: {n} blocks not all on "
                                          f"cuda:0")
            print(f"  [{card}] {path} captured, {n} blocks on cuda:0: "
                  + run_line(res))
            held(path, base, res, f"{path} on {n} blocks")
            for name, count in res["launches"].items():
                want = rounds * n * per_round.get(name, 0)
                check(count == want, f"{path} on {n} blocks: {name}: {count} "
                                     f"launches over {rounds} rounds ({want} "
                                     f"expected)")
            print(f"  {path} on {n} blocks: launches " + ", ".join(
                f"{name.split()[0]} {c}" for name, c in
                res["launches"].items() if c) + f" over {rounds} rounds "
                f"({n} a round for each kernel of a one-block round)")
            rates[n] = res["served"] / res["wall"]
            del res, srv
        print(f"  [{card}] {path}: samples/s by blocks on one card: "
              + ", ".join(f"{n} {r:.1f}" for n, r in rates.items())
              + " (one card: the blocks share its device and its host "
              "thread, so this is the blocks' dispatch overhead, not "
              "scaling)")
        gc.collect()
    res = serving_run(cfg, arrays, "fp32", "pipelined", devices=2)
    print(f"  [{card}] fp32 pipelined and blocked, 2 blocks on cuda:0: "
          + run_line(res))
    held("fp32", main_runs["fp32"], res, "fp32 pipelined on 2 blocks")
    del res
    if torch.cuda.device_count() >= 2:
        res = serving_run(cfg, arrays, "fp32", "captured", devices=2,
                          device=None)
        for d, blk in enumerate(res["srv"].blocks):
            leaves = []
            for tree in (blk.states, blk.pool):
                map_leaves(leaves.append, tree)
            check(all(x.device == torch.device("cuda", d) for x in leaves),
                  f"block {d}'s tensors are not all on cuda:{d}")
        print(f"  [{card}] fp32 captured, 2 blocks on cuda:0 and cuda:1: "
              + run_line(res))
        held("fp32", main_runs["fp32"], res, "fp32 on two cards")
        del res
    else:
        print("  real placement over cards NOT exercised: this machine has "
              "one CUDA device (the blocks above all share cuda:0)")
    gc.collect()
    torch.cuda.empty_cache()


def tuned_invariant(res: dict) -> float:
    """Check every live factor (factor_beta > 0) of the server and of the
    streams' final states against its statistics; return the largest
    absolute difference."""
    states = [res["srv"].states] + [r.final_state
                                    for r in res["done"].values()]
    worst = 0.0
    for st in states:
        rs = st.ridge
        Lt, B, fb = (t.double().reshape(-1, *t.shape[-2:]) if t.ndim >= 2
                     else t.double().reshape(-1) for t in
                     (rs.Lt, rs.B, rs.factor_beta))
        eye = torch.eye(B.shape[-1], dtype=torch.float64, device=B.device)
        for i in torch.nonzero(fb > 0).flatten().tolist():
            got, want = Lt[i].T @ Lt[i], B[i] + fb[i] * eye
            worst = max(worst, float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, rtol=TUNER_TOL,
                                      atol=TUNER_TOL)),
                  "a live factor no longer factors its statistics")
    return worst


def tuner_episode(card: str) -> None:
    """The reference's tuner episode (tests/test_adaptive.py:254-283)
    through the captured round: swaps, and at least TUNER_GAIN accuracy
    over the untuned episode."""
    acc = {}
    for name, tuner in (("untuned", None), ("tuned", TUNER_EPISODE)):
        arrays, _ = make_drift_label_streams(DRIFT_STREAMS, DRIFT_SAMPLES,
                                             DRIFT_T, DRIFT_CLASSES)
        srv = StreamServer(TUNER_CFG, device="cuda", **TUNER_SERVER)
        if tuner is not None:
            srv.attach_autotuner(WarmPoolAutotuner(srv, **tuner))
        t0 = time.perf_counter()
        for rid, a in enumerate(arrays):
            srv.submit(StreamRequest(rid=rid, **a))
        done = srv.run_until_drained(strict=True)
        wall = time.perf_counter() - t0
        check(srv._graphs.replays > 0, "the tuner episode replayed no graph")
        acc[name] = float(np.mean([np.mean(np.asarray(r.preds) == r.label)
                                   for r in done]))
        stats = srv._autotuner.stats() if tuner is not None else {}
        print(f"  [{card}] the reference's tuner episode (BAD_CFG, Nx=16, 4 "
              f"drift streams of {DRIFT_SAMPLES}), {name}: accuracy "
              f"{acc[name]:.4f}, {wall:.2f} s (a fresh server, captures "
              f"included) {stats}")
        if tuner is not None:
            check(stats["swaps_applied"] > 0, "the tuner episode made no swap")
            tuned_invariant(dict(srv=srv, done={r.rid: r for r in done}))
    gain = acc["tuned"] - acc["untuned"]
    print(f"  tuner episode: accuracy gain {gain:+.4f} (at least "
          f"{TUNER_GAIN})")
    check(gain >= TUNER_GAIN, f"the tuner gained {gain:.4f} < {TUNER_GAIN}")


def population_agreement_phase(cfg, data) -> None:
    """The same reduced population search on the card and on the CPU
    (phase 5): the first POP_AGREE['samples'] ARAB training samples, the
    whole test split; the cull's draws come from the same CPU generator on
    both."""
    train, test = data
    n = POP_AGREE["samples"]
    sub = TimeSeriesBatch(u=train.u[:n], length=train.length[:n],
                          label=train.label[:n])
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = core_population.train_population_classification(
            cfg, sub, test, divs=POP_AGREE["divs"],
            rounds=POP_AGREE["rounds"], device=device)
        out[device].time_s = time.perf_counter() - t0
    g, c = out["cuda"], out["cpu"]
    print(f"  train_population_classification, {n} samples, divs="
          f"{POP_AGREE['divs']}, rounds={POP_AGREE['rounds']}: card "
          f"{g.time_s:.1f} s, CPU {c.time_s:.1f} s; best (p, q, beta) card "
          f"({g.best_p:.6g}, {g.best_q:.6g}, {g.best_beta:g}), CPU "
          f"({c.best_p:.6g}, {c.best_q:.6g}, {c.best_beta:g}); test accuracy "
          f"card {g.best_acc:.4f}, CPU {c.best_acc:.4f} on {test.batch}")
    check(g.best_beta == c.best_beta
          and np.isclose(g.best_p, c.best_p, rtol=1e-4)
          and np.isclose(g.best_q, c.best_q, rtol=1e-4),
          "card and CPU chose different (p, q, beta)")
    check(abs(g.best_acc - c.best_acc) <= 1.0 / test.batch + 1e-9,
          "card and CPU accuracies differ by more than one test sample")


def k8_records(dev) -> dict:
    """K8 against its plain version on the card over K8_CASES, each beside
    the library's scaled_dot_product_attention, then at the query offsets
    of K8_OFFSET_CASES (checked, not timed); the JSON record holds the
    prefill case's numbers and the largest error over the bf16 cases."""
    import torch.nn.functional as F

    rec = None
    err_bf16 = 0.0
    for label, b, h, kv, tq, tk, d, causal, window, dtype, layout in \
            K8_CASES:
        g = torch.Generator(device=dev).manual_seed(tq + d)
        shapes = ((b, tq, h, d), (b, tk, kv, d), (b, tk, kv, d))
        bufs = [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in shapes]
        q, k, v = (t.transpose(1, 2) for t in bufs)
        if layout == "bhtd":
            q, k, v = (t.contiguous() for t in (q, k, v))
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, backend="cuda", **kw)
        dense = 4 * b * h * tq * tk <= K8_DENSE_MAX_BYTES
        if dense:
            plain_fn = lambda: ops.flash_attention(  # noqa: E731
                q, k, v, backend="torch", **kw)
        else:
            plain_fn = lambda: blockwise_attention(  # noqa: E731
                *bufs, **kw).transpose(1, 2)
        want = plain_fn()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K8 {label}: non-finite")
        e = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **K8_TOL[dtype])
        print(f"  K8 {label} ({layout}, plain "
              f"{'dense' if dense else 'blockwise'}): max abs err {e:.3e}, "
              f"max |want| {float(want.float().abs().max()):.3e} (tolerance "
              f"{K8_TOL[dtype]}, {dtype})")
        check(ok, f"K8 {label}: kernel disagrees with its plain version")
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, e)
        del got, want
        ms = device_ms(lambda: ops.flash_attention(q, k, v, backend="cuda",
                                                   **kw), reps=20)
        plain = wall_ms(plain_fn, reps=3 if dense else 1)
        if window:
            # the library takes a window only as a mask, on expanded heads
            q_pos = torch.arange(tq, device=dev)[:, None]
            k_pos = torch.arange(tk, device=dev)[None, :]
            mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
            ke, ve = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, ke, ve, attn_mask=mask)
        else:
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        lib = device_ms(lib_fn, reps=20)
        # the live (q, k) pairs of this mask, 4 D flops each (two products)
        rows = np.arange(tq)
        hi = np.minimum(rows, tk - 1) if causal else np.full(tq, tk - 1)
        lo = np.maximum(rows - window + 1, 0) if window else np.zeros(tq)
        pairs = int(np.clip(hi - lo + 1, 0, None).sum())
        es = torch.finfo(dtype).bits // 8
        peak = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else \
            PEAK_FP32_FLOP_S
        t_bytes = es * d * (2 * b * h * tq + 2 * b * kv * tk) / PEAK_BYTES_S
        t_ops = 4 * b * h * d * pairs / peak
        bnd = (max(t_bytes, t_ops) * 1e3,
               "bytes" if t_bytes >= t_ops else "operations")
        flop = 4 * b * h * d * pairs
        print(f"  K8 {label} B={b} H={h} KV={kv} Tq={tq} Tk={tk} D={d} "
              f"causal={causal} window={window}, {K8_ROUTES[dtype]}: kernel "
              f"{ms:.4f} ms = {flop / ms / 1e9:.1f} TFLOP/s, plain "
              f"{plain:.3f} ms, scaled_dot_product_attention {lib:.4f} ms = "
              f"{flop / lib / 1e9:.1f} TFLOP/s, bound {bnd[0]:.5f} ms "
              f"({bnd[1]}; {flop:.3e} flop, {flop / bnd[0] / 1e9:.1f} "
              f"TFLOP/s)")
        if rec is None:
            rec = record("K8 flash_attention",
                         "src/repro_torch/kernels/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:27", 0.0, ms,
                         plain, bnd, lib)
            rec["routes"] = "; ".join(f"{str(t).split('.')[-1]}: {r}"
                                      for t, r in K8_ROUTES.items())
        del q, k, v, bufs
    for b, h, kv, tq, tk, d, off, dtype in K8_OFFSET_CASES:
        g = torch.Generator(device=dev).manual_seed(tq + off)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, h, tq, d), (b, kv, tk, d),
                                 (b, kv, tk, d)))
        got = ops.flash_attention(q, k, v, q_offset=off, backend="cuda")
        want = ops.flash_attention(q, k, v, q_offset=off, backend="torch")
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        print(f"  K8 query offset {off} (B={b} H={h} KV={kv} Tq={tq} "
              f"Tk={tk} D={d}, causal, {str(dtype).split('.')[-1]}): max abs "
              f"err {e:.3e} (tolerance {K8_TOL[dtype]})")
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), **K8_TOL[dtype]),
              f"K8 at query offset {off}: kernel disagrees with its plain "
              f"version")
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, e)
        del q, k, v, got, want
    rec["max_abs_err"] = err_bf16
    return {rec["name"]: rec}


def lm_model(dtype, device: str) -> Transformer:
    """smollm-135m at full width on the flash route, from the seed-0
    init (drawn on the CPU, so every device gets the same parameters)."""
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas",
                              dtype=dtype)
    return Transformer(cfg, device=device,
                       generator=torch.Generator().manual_seed(0))


def lm_tokens(b: int, t: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def serve_lm(model: Transformer, n: int, prompt_len: int, max_tokens: int,
             max_batch: int, max_len: int) -> tuple:
    """launch/serve.py's loop: n random prompts through the Server; returns
    (server, requests by id, wall seconds)."""
    server = Server(model, max_batch=max_batch, max_len=max_len)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(n):
        prompt = rng.integers(0, model.cfg.vocab, prompt_len).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_tokens=max_tokens))
    done = server.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return server, {r.rid: r for r in done}, time.perf_counter() - t0


def lm_phase(card: str) -> dict:
    """The LM main path at full width: prefills through K8, one under the
    profiler, then the Server; returns K8's launches of the first prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = lm_model(torch.bfloat16, "cuda")
    cfg = model.cfg
    prefill = make_prefill_step(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), "
          f"{n_params} parameters in {cfg.dtype}")
    k8_launches = None
    for b, t in PREFILL_SHAPES:
        batch = {"tokens": lm_tokens(b, t, cfg.vocab, seed=t)}
        prefill(batch)             # first use: allocations, library set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        print(f"  [{card}] prefill B={b} T={t}: {wall:.4f} s, "
              f"{b * t / wall:.1f} prefill tokens/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
              f"launches: " + ", ".join(f"{n.split()[0]} {c}"
                                        for n, c in launches.items() if c))
        check(tuple(logits.shape) == (b, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"prefill B={b} T={t}: logits {tuple(logits.shape)}, or not "
              f"finite")
        for name, count in launches.items():
            want = cfg.n_layers if name == "K8 flash_attention" else 0
            check(count == want, f"prefill B={b} T={t}: {name} launched "
                                 f"{count} times ({want} expected)")
        if k8_launches is None:
            k8_launches = launches["K8 flash_attention"]
        del logits

    b, t = PREFILL_SHAPES[0]
    batch = {"tokens": lm_tokens(b, t, cfg.vocab, seed=t)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev)
    flash = sum(e.self_device_time_total for e in dev if "flash" in e.key)
    print(f"  [{card}] prefill B={b} T={t} profiled: {wall:.4f} s, device "
          f"busy {busy / 1e3:.3f} ms = {100 * busy / 1e6 / wall:.1f}% of wall "
          f"(idle {100 - 100 * busy / 1e6 / wall:.1f}%); K8 "
          f"{flash / 1e3:.3f} ms = {100 * flash / max(busy, 1e-9):.1f}% of "
          f"the device time")
    for e in dev[:8]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy > 0 and flash > 0, "the profiler saw no device time in K8")

    serve_lm(model, 2, 8, 2, 2, 32)          # first use of the decode path
    reset_launches()
    server, done, wall = serve_lm(
        model, SERVE["requests"], SERVE["prompt_len"], SERVE["max_tokens"],
        SERVE["max_batch"], SERVE["max_len"])
    launches = read_launches()
    n_tok = sum(len(r.out_tokens) for r in done.values())
    lat = np.asarray([r.finish_t - r.submit_t for r in done.values()])
    print(f"  [{card}] Server {SERVE}: {len(done)} requests, {n_tok} tokens "
          f"in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), {server.steps} "
          f"steps ({1e3 * wall / server.steps:.2f} ms a step); request "
          f"latency p50 {np.median(lat):.3f} s, p99 "
          f"{np.percentile(lat, 99):.3f} s; K8 launches "
          f"{launches['K8 flash_attention']} (decode attention is the plain "
          f"einsum in both packages, so 0)")
    check(len(done) == SERVE["requests"]
          and n_tok == SERVE["requests"] * SERVE["max_tokens"],
          f"the Server answered {len(done)} requests with {n_tok} tokens")
    check(all(0 <= x < cfg.padded_vocab for r in done.values()
              for x in r.out_tokens), "a token out of range")
    check(all(n == 0 for n in launches.values()),
          f"the Server launched {launches}: decode runs no kernel")

    # where a decode step's time goes: one wave of 8 short requests
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        server, _, wall = serve_lm(model, SERVE["max_batch"], 4, 4,
                                   SERVE["max_batch"], SERVE["max_len"])
    events = prof.key_averages()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev)
    n_launch = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"  [{card}] Server decode profiled: {server.steps} steps in "
          f"{wall:.3f} s, device busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / 1e6 / wall:.1f}% of wall (idle "
          f"{100 - 100 * busy / 1e6 / wall:.1f}%); cudaLaunchKernel "
          f"{n_launch / server.steps:.0f} a step")
    for e in dev[:5]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:5]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    check(busy > 0, "the profiler saw no device time in the decode steps")
    return {"K8 flash_attention": k8_launches}


def lm_agreement_phase() -> None:
    """The LM at full width on the card and on the CPU, same parameters: a
    prefill of B=2, T=256, checked in fp32 and bf16, and the Server on 4
    requests, checked in fp32 and printed in bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        models = {d: lm_model(dtype, d) for d in ("cuda", "cpu")}
        toks = {"tokens": lm_tokens(2, 256, models["cpu"].cfg.vocab, seed=1)}
        logits = {d: make_prefill_step(m)(toks).float().cpu()
                  for d, m in models.items()}
        rel = float((logits["cuda"] - logits["cpu"]).abs().max()
                    / logits["cpu"].abs().max())
        same = bool((logits["cuda"].argmax(-1)
                     == logits["cpu"].argmax(-1)).all())
        tokens = {d: serve_lm(m, 4, 32, 16, 4, 256)[1]
                  for d, m in models.items()}
        pairs = [(a, b) for rid in tokens["cpu"]
                 for a, b in zip(tokens["cuda"][rid].out_tokens,
                                 tokens["cpu"][rid].out_tokens)]
        agree = sum(a == b for a, b in pairs) / len(pairs)
        fp32 = dtype == torch.float32
        limit = LM_REL if fp32 else LM_BF16_REL
        print(f"  {dtype}: prefill B=2 T=256 max |dlogits| / max |logits| "
              f"{rel:.3e} (limit {limit}), argmax equal {same}; Server 4 "
              f"requests: {agree:.4f} of {len(pairs)} greedy tokens equal"
              + ("" if fp32 else " (tokens printed, not checked)"))
        check(rel <= limit and same, f"card vs CPU prefill in {dtype}: "
                                     f"{rel}, argmax equal {same}")
        if fp32:
            check(agree >= LM_AGREE, f"card vs CPU tokens agree on {agree}")
        del models


def family_config(arch: str, dtype, **updates):
    """A registry config at its published widths on the flash route."""
    return dataclasses.replace(get_config(arch), attn_impl="pallas",
                               dtype=dtype, **updates)


def k8_per_prefill(cfg) -> int:
    """K8's launches in one prefill: one a self attention on the flash
    route (none under a window schedule, which the reference keeps off
    its kernel, and none in RWKV), the hybrid's shared-block sites, and
    the encoder-decoder's encoder, decoder and cross attentions."""
    if cfg.rwkv or cfg.window_pattern:
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.is_encdec:
        return cfg.enc_layers + 2 * cfg.dec_layers
    return cfg.n_layers


def family_batch(cfg, b: int, t: int, gen: torch.Generator,
                 device: str) -> dict:
    """make_prefill_step's batch: tokens, or embeddings (the VLM's patch
    stub), or whisper's encoder frames (WHISPER_FRAMES at full width)."""
    if cfg.is_encdec or cfg.input_mode == "embeds":
        return {"embeds": (0.5 * torch.randn(
            (b, t, cfg.d_model), generator=gen, device=device)).to(cfg.dtype)}
    return {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=gen,
                                    device=device)}


def families_phase(card: str, device: str = "cuda") -> None:
    """Phase 8c: each LM family at its published widths in bf16 on the
    flash route, parameters drawn on the card, one model at a time: a
    prefill with K8's launches counted, then the Server."""
    print("  llama4-maverick-400b-a17b: not run on the card; one full-width "
          "layer of its 128 experts is 32 GB in bf16 (the CPU tests run it "
          "reduced)")
    for arch in FAMILY_ARCHS:
        t_arch = time.perf_counter()
        cfg = family_config(arch, torch.bfloat16, **FAMILY_DEPTH.get(arch, {}))
        gen = torch.Generator(device=device).manual_seed(0)
        model = Transformer(cfg, device=device, generator=gen)
        n_params = sum(p.numel() for p in model.parameters())
        cut = (f"; depth cut to {cfg.n_layers} of "
               f"{get_config(arch).n_layers} layers"
               if arch in FAMILY_DEPTH else "")
        print(f"  {arch}: family {cfg.family}, {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {n_params} parameters in bf16 "
              f"drawn on the card{cut}")
        b, t = FAMILY_PREFILL
        t = WHISPER_FRAMES if cfg.is_encdec else t
        batch = family_batch(cfg, b, t, gen, device)
        prefill = make_prefill_step(model)
        prefill(batch)               # first use: allocations, library set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = k8_per_prefill(cfg)
        what = ("1500 encoder frames and BOS" if cfg.is_encdec
                else "embeddings" if "embeds" in batch else "tokens")
        print(f"  [{card}] {arch} prefill B={b} T={t} ({what}): {wall:.4f} "
              f"s, {b * t / wall:.1f} prefill tokens/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; K8 "
              f"launches {launches['K8 flash_attention']} ({want} expected)")
        check(tuple(logits.shape) == (b, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"{arch} prefill: logits {tuple(logits.shape)}, or not finite")
        for name, count in launches.items():
            expect = want if name == "K8 flash_attention" else 0
            check(count == expect, f"{arch} prefill: {name} launched "
                                   f"{count} times ({expect} expected)")
        del logits, batch
        serve_lm(model, 1, 4, 2, 1, 16)       # first use of the decode path
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        server, done, wall = serve_lm(
            model, SERVE["requests"], SERVE["prompt_len"],
            SERVE["max_tokens"], SERVE["max_batch"], SERVE["max_len"])
        launches = read_launches()
        n_tok = sum(len(r.out_tokens) for r in done.values())
        lat = np.asarray([r.finish_t - r.submit_t for r in done.values()])
        print(f"  [{card}] {arch} Server {SERVE}: {n_tok} tokens in "
              f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s), {server.steps} "
              f"steps ({1e3 * wall / server.steps:.2f} ms a step); request "
              f"latency p50 {np.median(lat):.3f} s, p99 "
              f"{np.percentile(lat, 99):.3f} s; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        check(len(done) == SERVE["requests"]
              and n_tok == SERVE["requests"] * SERVE["max_tokens"]
              and all(0 <= x < cfg.padded_vocab for r in done.values()
                      for x in r.out_tokens),
              f"{arch}: the Server answered {len(done)} requests with "
              f"{n_tok} tokens")
        check(all(n == 0 for n in launches.values()),
              f"{arch}: the Server launched {launches}: decode runs no "
              f"kernel")
        del model, server, done
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {arch} in {time.perf_counter() - t_arch:.1f} s")


def families_agreement_phase(device: str = "cuda") -> None:
    """Phase 9b: each case of FAMILY_AGREE at full width and one layer, on
    the card and then on the CPU with the same parameters (drawn on the
    card from a seeded generator and moved: a host draw of llama4's 4.2e9
    fp32 values would take about half a minute): the prefill's last logits
    within LM_REL (fp32) or LM_BF16_REL (bf16) of max |logits|, argmax
    equal."""
    for arch, dtype, t in FAMILY_AGREE:
        full = get_config(arch)
        depth = (dict(enc_layers=1, dec_layers=1) if full.is_encdec else
                 dict(n_layers=full.attn_every) if full.family == "hybrid"
                 else dict(n_layers=1))
        cfg = family_config(arch, dtype, **depth)
        limit = LM_REL if dtype == torch.float32 else LM_BF16_REL
        gen = torch.Generator(device=device).manual_seed(1)
        model = Transformer(cfg, device=device, generator=gen)
        batch = family_batch(cfg, 1, t, gen, device)
        prefill = make_prefill_step(model)
        t0 = time.perf_counter()
        reset_launches()
        got = prefill(batch).cpu()
        k8 = read_launches()["K8 flash_attention"]
        check(k8 == k8_per_prefill(cfg), f"{arch} at one layer: K8 launched "
                                         f"{k8} times")
        model.to("cpu")
        model.device = torch.device("cpu")
        want = prefill({k: v.cpu() for k, v in batch.items()})
        rel = float((got - want).abs().max() / want.abs().max())
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        print(f"  {arch} ({', '.join(f'{k}={v}' for k, v in depth.items())}"
              f", B=1, T={t}, {str(dtype).split('.')[-1]}): max |dlogits| / "
              f"max |logits| {rel:.3e} (limit {limit}), argmax equal {same}, "
              f"K8 launches {k8}, {time.perf_counter() - t0:.1f} s")
        check(bool(torch.isfinite(got).all()) and rel <= limit and same,
              f"{arch} {dtype}: card vs CPU prefill {rel}, argmax equal "
              f"{same}")
        del model, got, want, batch
        gc.collect()
        torch.cuda.empty_cache()


def k8_grad_phase(dev) -> None:
    """Phase 3: K8's gradient at K8_GRAD_CASE in bf16 and fp32 on the
    model's transposed views, against autograd through the plain version;
    then the recompute backward's time beside the time of
    scaled_dot_product_attention's backward on the same inputs (timed
    here only; the port never calls it)."""
    import torch.nn.functional as F

    b, h, kv, t, d = K8_GRAD_CASE
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(t + d)
        bufs = [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d))]
        ct = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
        grads = []
        for plain in (False, True):
            ts = [x.clone().requires_grad_() for x in bufs]
            if plain:
                out = ref.flash_attention_ref(
                    *(x.transpose(1, 2) for x in ts)).transpose(1, 2)
            else:
                out = attn_mod.flash_attention(*ts, causal=True)
            out.backward(ct)
            grads.append([x.grad.float() for x in ts])
            del out, ts
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        for n, got, want in zip("qkv", *grads):
            check(bool(torch.isfinite(got).all()), f"K8 grad d{n}: not "
                                                   f"finite")
            err = float((got - want).abs().max())
            top = float(want.abs().max())
            print(f"  K8 gradient {name} (B={b} H={h} KV={kv} T={t} D={d}, "
                  f"causal, transposed views): d{n} max abs err {err:.3e}, "
                  f"max |d{n}| {top:.3e} (limit {K8_GRAD_REL[dtype]} of "
                  f"it)")
            check(err <= K8_GRAD_REL[dtype] * top, f"K8 gradient {name} "
                  f"d{n}: {err} against the plain version's")
        del grads
        q, k, v = bufs
        with torch.no_grad():
            out = attn_mod.flash_attention(q, k, v)
        bwd = wall_ms(lambda: attn_mod.flash_attention_backward(
            q, k, v, out, ct), reps=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in bufs)
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        lib = device_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), ct.transpose(1, 2), retain_graph=True),
            reps=10)
        print(f"  K8 gradient {name}: the recompute backward (plain "
              f"PyTorch, 512 x 1024 tiles) {bwd:.3f} ms a call (back to "
              f"back), scaled_dot_product_attention's backward "
              f"{lib:.4f} ms (device time; a yardstick only)")
        del bufs, ct, out, o, q, k, v, qt, kt, vt
        gc.collect()
        torch.cuda.empty_cache()


def train_cli_phase() -> None:
    """Phase 10a: ``python -m repro_torch.launch.train`` on the card at its
    defaults, TRAIN_CLI's steps, then again to TRAIN_CLI's resume step from
    the first run's checkpoint."""
    with tempfile.TemporaryDirectory() as ckpt:
        for steps in (TRAIN_CLI["steps"], TRAIN_CLI["resume"]):
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", LM_ARCH, "--steps", str(steps),
                   "--batch", str(TRAIN_CLI["batch"]),
                   "--seq", str(TRAIN_CLI["seq"]), "--ckpt-dir", ckpt,
                   "--ckpt-every", str(TRAIN_CLI["ckpt_every"]),
                   "--log-every", "1"]
            t0 = time.perf_counter()
            res = subprocess.run(
                cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            wall = time.perf_counter() - t0
            check(res.returncode == 0, f"launch.train --steps {steps} "
                                       f"failed: {res.stderr[-3000:]}")
            lines = res.stdout.splitlines()
            steps_run = [ln for ln in lines if ln.startswith("step ")]
            losses = [float(ln.split()[3]) for ln in steps_run]
            for ln in lines:
                if not ln.startswith("step ") or ln in (
                        steps_run[0], steps_run[-1]):
                    print(f"    {ln}")
            print(f"  launch.train --steps {steps}: {len(losses)} losses, "
                  f"{wall:.1f} s for the process")
            first = steps == TRAIN_CLI["steps"]
            want = steps if first else steps - TRAIN_CLI["steps"]
            check(len(losses) == want and bool(np.isfinite(losses).all()),
                  f"launch.train printed {len(losses)} losses: {losses}")
            check(any(ln.startswith(f"done: {steps} steps") for ln in lines),
                  "launch.train printed no 'done:' line")
            if not first:
                check(f"resumed from step {TRAIN_CLI['steps']}" in lines,
                      "launch.train did not resume from its checkpoint")


def train_phase(card: str) -> None:
    """Phase 10b-c: the Trainer on smollm-135m at full width, flash route,
    bf16 (TRAIN_SHAPE, TRAIN_STEPS, K8 counted over one step, a profiled
    step), then the replay after an injected fault."""
    model = lm_model(torch.bfloat16, "cuda")
    cfg = model.cfg
    b, t = TRAIN_SHAPE
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=t,
                                           global_batch=b))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch(s).items()}
               for s in range(TRAIN_STEPS + 1)]
    opt = adamw()
    lr_fn = cosine_schedule(TRAIN_LR, warmup=min(100, TRAIN_STEPS // 10 + 1),
                            total=TRAIN_STEPS)
    step_fn = make_train_step(model, opt, lr_fn)
    counted = {}

    def counted_step(params, state, step, batch):
        if step == TRAIN_COUNT_STEP:
            torch.cuda.synchronize()
            reset_launches()
        out = step_fn(params, state, step, batch)
        if step == TRAIN_COUNT_STEP:
            torch.cuda.synchronize()
            counted.update(read_launches())
        return out

    state = opt.init(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(TrainerConfig(ckpt_dir=ckpt, ckpt_every=10),
                          counted_step, batches.__getitem__)
        t0 = time.perf_counter()
        model, state, _ = trainer.run(model, state, REPLAY["steps"])
        at_replay = [p.detach().clone() for p in model.parameters()]
        model, state, step = trainer.run(model, state, TRAIN_STEPS,
                                         start_step=REPLAY["steps"])
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log = trainer.metrics_log
    secs = [r["sec"] for r in log[1:]]
    med = statistics.median(secs)
    losses = [r["loss"] for r in log]
    print(f"  [{card}] Trainer, {LM_ARCH} bf16, attn_impl='pallas', "
          f"remat '{cfg.remat_policy}', (B, T) = {TRAIN_SHAPE}, AdamW, "
          f"cosine peak {TRAIN_LR}: {step} steps in {wall:.2f} s "
          f"({step // 10} checkpoints included); step 0 {log[0]['sec']:.4f} s, steps "
          f"1-{step - 1} median {med:.4f} s (min {min(secs):.4f}, max "
          f"{max(secs):.4f}; host clock, the loss waited on) = "
          f"{b * t / med:.1f} tokens/s; max_memory_allocated {peak:.1f} MiB")
    print("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> "
                                  f"{losses[-1]}")
    k8 = counted["K8 flash_attention"]
    print(f"  step {TRAIN_COUNT_STEP}: launches " + ", ".join(
        f"{n.split()[0]} {c}" for n, c in counted.items() if c)
        + f" ({2 * cfg.n_layers} expected from K8: forward and recompute)")
    check(k8 == 2 * cfg.n_layers and all(
        c == 0 for n, c in counted.items() if n != "K8 flash_attention"),
        f"a train step launched {counted}")
    train_profile(card, model, state, step_fn, batches[TRAIN_STEPS],
                  TRAIN_STEPS)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    replay_phase(card, at_replay, lr_fn, batches)


def train_profile(card: str, model, state, step_fn, batch, step) -> None:
    """One train step under torch.profiler: the device's busy share, K8's
    share of the device time, and the span of the recompute backward's
    calls (CUDA events around each call on the stream: its kernels and
    the gaps between them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = []
    plain_bwd = attn_mod.flash_attention_backward

    def timed_bwd(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = plain_bwd(*args, **kw)
        ev[1].record()
        spans.append(ev)
        return out

    attn_mod.flash_attention_backward = timed_bwd
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            step_fn(model, state, step, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        attn_mod.flash_attention_backward = plain_bwd
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    flash = sum(e.self_device_time_total for e in dev
                if "flash" in e.key) / 1e3
    bwd = sum(s.elapsed_time(e) for s, e in spans)
    check(busy > 0 and flash > 0, "the profiler saw no device time in K8")
    print(f"  [{card}] one train step profiled: {wall:.3f} ms wall, device "
          f"busy {busy:.3f} ms = {100 * busy / wall:.1f}% (idle "
          f"{100 - 100 * busy / wall:.1f}%); K8 {flash:.3f} ms = "
          f"{100 * flash / busy:.1f}% of the device time; the recompute "
          f"backward's {len(spans)} calls span {bwd:.3f} ms = "
          f"{100 * bwd / wall:.1f}% of the wall")
    for e in dev[:8]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def replay_phase(card: str, want, lr_fn, batches) -> None:
    """Phase 10c: REPLAY's steps with a fault at its step: the Trainer
    restores its last checkpoint and replays; the final parameters against
    the uninterrupted run's at that step."""
    model = lm_model(torch.bfloat16, "cuda")
    init = [p.detach().float() for p in model.parameters()]
    opt = adamw()
    step_fn = make_train_step(model, opt, lr_fn)
    fired = []

    def fault(step):
        if step == REPLAY["fault_at"] and not fired:
            fired.append(step)
            raise RuntimeError("injected device loss")

    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(TrainerConfig(ckpt_dir=ckpt,
                                        ckpt_every=REPLAY["ckpt_every"]),
                          step_fn, batches.__getitem__, fault_hook=fault)
        t0 = time.perf_counter()
        model, _, step = trainer.run(model, opt.init(model), REPLAY["steps"])
        wall = time.perf_counter() - t0
    ran = [r["step"] for r in trainer.metrics_log]
    got = [p.detach().float() for p in model.parameters()]
    errs = [float((g - w.float()).abs().max()) for g, w in zip(got, want)]
    moves = [float((w.float() - p0).abs().max())
             for w, p0 in zip(want, init)]
    worst = max(e / m if m else (math.inf if e else 0.0)
                for e, m in zip(errs, moves))
    print(f"  [{card}] replay: fault at step {fired}, steps run {ran} "
          f"({wall:.1f} s); final parameters against the uninterrupted "
          f"run's: largest difference {max(errs):.3e}, {worst:.3e} of the "
          f"leaf's largest move since init (limit {REPLAY_REL}; the "
          f"smallest such move {min(moves):.3e})")
    back = REPLAY["fault_at"] // REPLAY["ckpt_every"] * REPLAY["ckpt_every"]
    check(fired == [REPLAY["fault_at"]] and step == REPLAY["steps"]
          and ran == list(range(REPLAY["fault_at"]))
          + list(range(back, REPLAY["steps"])), f"the replay ran {ran}")
    check(worst <= REPLAY_REL, f"the replay's parameters: {worst}")
    del model, init
    gc.collect()
    torch.cuda.empty_cache()


def train_agreement_phase() -> None:
    """Phase 10b (card vs CPU): one AdamW step of smollm-135m at full
    width and TRAIN_AGREE's depth, fp32, the same parameters on both: the
    loss within rtol 1e-5, grad_norm 1e-4, each parameter within 1e-3 of
    its leaf's largest move plus 1e-7 where the CPU's step is well
    conditioned (ADAM_REL), within two moves elsewhere; first the moments
    mu and nu within MOMENT_REL of each leaf's largest entry, and the
    ill-conditioned entries at most ADAM_ILL_SHARE of all."""
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas",
                              dtype=torch.float32,
                              n_layers=TRAIN_AGREE["n_layers"])
    toks = torch.from_numpy(lm_tokens(TRAIN_AGREE["b"], TRAIN_AGREE["t"],
                                      cfg.vocab, seed=2))
    runs = {}
    for d in ("cuda", "cpu"):
        model = Transformer(cfg, device=d,
                            generator=torch.Generator().manual_seed(0))
        init = [p.detach().cpu().clone() for p in model.parameters()]
        opt = adamw()
        step_fn = make_train_step(model, opt, constant_schedule(TRAIN_LR))
        batch = {"tokens": toks.to(d), "targets": toks.to(d)}
        t0 = time.perf_counter()
        reset_launches()
        model, state, metrics = step_fn(model, opt.init(model), 0, batch)
        launches = read_launches()
        runs[d] = ([p.detach().cpu() for p in model.parameters()], state,
                   {k: float(v) for k, v in metrics.items()}, launches,
                   time.perf_counter() - t0)
        del model
    (got, gstate, gm, launches, t_card), (want, state, wm, _, t_cpu) = \
        runs["cuda"], runs["cpu"]
    k8 = launches["K8 flash_attention"]
    check(k8 == 2 * cfg.n_layers, f"the card's step launched K8 {k8} times")
    loss_rel = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    gn_rel = abs(gm["grad_norm"] - wm["grad_norm"]) / abs(wm["grad_norm"])
    ratio, n_ill, n_all, moment = 0.0, 0, 0, 0.0
    for g, w, p0, gmu, gnu, mu, nu in zip(
            got, want, init, tree_leaves(gstate.mu), tree_leaves(gstate.nu),
            tree_leaves(state.mu), tree_leaves(state.nu)):
        for a, b in ((gmu.cpu(), mu), (gnu.cpu(), nu)):
            top = float(b.abs().max())
            diff = float((a - b).abs().max())
            moment = max(moment, diff / top if top else
                         (math.inf if diff else 0.0))
        # one step: m_hat = mu / (1 - b1), s = sqrt(nu / (1 - b2))
        mg, mw = gmu.cpu() / (1 - 0.9), mu / (1 - 0.9)
        sg, sw = (torch.sqrt(n / (1 - 0.95)) for n in (gnu.cpu(), nu))
        dm = (mg - mw).abs().amax(-1, keepdim=True)
        ds = (sg - sw).abs().amax(-1, keepdim=True)
        ill = dm / (sw + 1e-8) + mw.abs() * ds / (sw + 1e-8) ** 2 > ADAM_REL
        move = float((w - p0).abs().max())
        err = (g - w).abs()
        n_ill += int(ill.sum())
        n_all += err.numel()
        if bool((~ill).any()):
            ratio = max(ratio, float(err[~ill].max()) / (1e-3 * move + 1e-7))
        check(bool((err[ill] <= 2 * move).all()),
              f"an ill-conditioned parameter moved {float(err.max())}")
    print(f"  {LM_ARCH} at full width, {cfg.n_layers} layers, fp32, "
          f"B={TRAIN_AGREE['b']} T={TRAIN_AGREE['t']}, one AdamW step "
          f"(card {t_card:.2f} s, CPU {t_cpu:.2f} s; K8 {k8} launches): "
          f"loss {gm['loss']:.6f} vs {wm['loss']:.6f} (rel {loss_rel:.2e}, "
          f"limit 1e-5), grad_norm rel {gn_rel:.2e} (limit 1e-4); "
          f"mu and nu within {moment:.2e} of each leaf's largest entry "
          f"(limit {MOMENT_REL}); parameters: worst |dp| / (1e-3 move + "
          f"1e-7) {ratio:.3f} (limit 1) outside the {n_ill} of {n_all} "
          f"entries ({100 * n_ill / n_all:.3f}%, limit "
          f"{100 * ADAM_ILL_SHARE:g}%) whose CPU step is ill-conditioned")
    check(moment <= MOMENT_REL, f"card vs CPU moments: {moment}")
    check(n_ill <= ADAM_ILL_SHARE * n_all,
          f"{n_ill} of {n_all} entries ill-conditioned")
    check(loss_rel <= 1e-5 and gn_rel <= 1e-4 and ratio <= 1.0,
          f"card vs CPU train step: loss {loss_rel}, grad_norm {gn_rel}, "
          f"parameters {ratio}")


def synth_task(rng: np.random.Generator, n: int, t: int, vocab: int,
               n_classes: int) -> tuple:
    """examples_torch/lm_readout.py's task: class c = sequences biased
    toward token block c."""
    labels = rng.integers(0, n_classes, n)
    block = vocab // n_classes
    base = rng.integers(0, vocab, (n, t))
    biased = block * labels[:, None] + rng.integers(0, block, (n, t))
    toks = np.where(rng.random((n, t)) < 0.6, biased, base)
    return toks.astype(np.int32), labels.astype(np.int32)


def readout_rank(rank: int, world: int, path: str, device: str) -> None:
    """One gloo rank of phase 8b on ``device`` (cuda:0 for both ranks): its
    half of the features through accumulate and the distributed solve (one
    all_reduce of (A, B)); writes its W and b."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{path}/pg",
                            world_size=world, rank=rank)
    try:
        data = torch.load(f"{path}/features.pt")
        h, labels = data["h"], data["labels"]
        b = h.shape[0] // world
        sl = slice(rank * b, (rank + 1) * b)
        ro = DistributedDFRReadout(
            ReadoutConfig(feature_dim=h.shape[-1],
                          n_classes=READOUT_TASK["classes"],
                          n_nodes=READOUT_NODES),
            group=dist.group.WORLD, mask=data["mask"], device=device)
        params, rs = ro.init()
        rs = ro.accumulate(rs, params, h[sl], labels[sl])
        fit = ro.solve(rs, params, READOUT_BETA)
        torch.save({"W": fit.W.cpu(), "b": fit.b.cpu()},
                   f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def readout_phase(card: str) -> None:
    """The LM-feature readout at full width (phase 8b): smollm-135m's trunk
    (K8 a layer) turns READOUT_TASK's tokens into (B, T, 576) hidden
    states; DistributedDFRReadout at Nx = 30 accumulates, solves at
    READOUT_BETA, predicts and takes one SGD step on the card, with the
    launch counts set to 0 before and read after (K6, K7, K4a, K4b, K1);
    the same readout on the CPU: W within the tolerance, predictions equal
    on READOUT_AGREE; then two gloo ranks on the one card, each with half
    the batch: equal W on both, within the tolerance of the one-rank W."""
    import torch.multiprocessing as mp

    model = lm_model(torch.bfloat16, "cuda")
    cfg = model.cfg
    n, t, classes = (READOUT_TASK[k] for k in ("n", "seq", "classes"))
    toks, labels = synth_task(np.random.default_rng(1), n, t, cfg.vocab,
                              classes)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        h = model._trunk(model._embed(toks))[0].float()
    torch.cuda.synchronize()
    trunk_s = time.perf_counter() - t0
    k8 = read_launches()["K8 flash_attention"]
    print(f"  [{card}] {LM_ARCH} trunk on {n} x {t} tokens: hidden states "
          f"{tuple(h.shape)} in {trunk_s:.3f} s; K8 launches {k8}")
    check(k8 == cfg.n_layers and bool(torch.isfinite(h).all()),
          f"the trunk launched K8 {k8} times, or its states are not finite")
    del model
    torch.cuda.empty_cache()

    rcfg = ReadoutConfig(feature_dim=cfg.d_model, n_classes=classes,
                         n_nodes=READOUT_NODES)
    lab = torch.from_numpy(labels)
    runs = {}
    for device in ("cuda", "cpu"):
        ro = DistributedDFRReadout(
            rcfg, device=device,
            mask=None if device == "cuda" else runs["cuda"]["mask"])
        hd = h.to(ro.device)
        if device == "cuda":
            reset_launches()
        times = {}
        t0 = time.perf_counter()
        params, rs = ro.init()
        rs = ro.accumulate(rs, params, hd, lab)
        times["accumulate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit = ro.solve(rs, params, READOUT_BETA)
        if device == "cuda":
            torch.cuda.synchronize()
        times["solve"] = time.perf_counter() - t0
        preds = ro.predict(fit, hd).cpu()
        new, loss = ro.sgd_step(params, hd, lab, 0.1, 0.1)
        if device == "cuda":
            torch.cuda.synchronize()
            check_launches("8b readout on the card", read_launches(),
                           READOUT_ON_PATH)
        acc = float((preds == lab).float().mean())
        print(f"  [{device}] readout Nx={READOUT_NODES} s={rcfg.dfr().s}: "
              f"accumulate {times['accumulate']:.4f} s, solve "
              f"{times['solve']:.4f} s; train accuracy {acc:.4f} over "
              f"{classes} classes; SGD step loss {float(loss):.4f}")
        check(bool(torch.isfinite(fit.W).all())
              and bool(torch.isfinite(new.W).all()),
              f"{device}: the readout's W is not finite")
        runs[device] = dict(mask=ro.mask.cpu(), rs=rs, W=fit.W.cpu(),
                            preds=preds, fit=fit, ro=ro)
    sens, _ = fp64_sensitivity(runs["cpu"]["rs"].A, runs["cpu"]["rs"].B,
                               READOUT_BETA)
    tol = max(READOUT_REL, sens)
    rel_ab = max(rel_diff(getattr(runs["cuda"]["rs"], k).cpu(),
                          getattr(runs["cpu"]["rs"], k)) for k in ("A", "B"))
    rel = rel_diff(runs["cuda"]["W"], runs["cpu"]["W"])
    agree = float((runs["cuda"]["preds"] == runs["cpu"]["preds"])
                  .float().mean())
    print(f"  card vs CPU: (A, B) within {rel_ab:.3e} of their largest; "
          f"|dW| / max |W| {rel:.3e} (limit {tol:.3e}: the larger of "
          f"{READOUT_REL} and the float64 W's move under a "
          f"{MEM_FP32_NOISE} relative perturbation of B, {sens:.3e}); "
          f"{agree:.4f} of the predictions equal (limit {READOUT_AGREE})")
    check(rel <= tol and agree >= READOUT_AGREE,
          "the card's readout is not the CPU's")

    with tempfile.TemporaryDirectory() as path:
        torch.save({"h": h.cpu(), "labels": lab,
                    "mask": runs["cuda"]["mask"]}, f"{path}/features.pt")
        t0 = time.perf_counter()
        mp.spawn(readout_rank, args=(2, path, str(h.device)), nprocs=2,
                 join=True)
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{path}/rank{r}.pt") for r in range(2)]
    same = all(torch.equal(ranks[0][k], ranks[1][k]) for k in ("W", "b"))
    rel2 = rel_diff(ranks[0]["W"], runs["cuda"]["W"])
    ro, fit = runs["cuda"]["ro"], runs["cuda"]["fit"]
    fit2 = dataclasses.replace(fit, W=ranks[0]["W"].to(ro.device),
                               b=ranks[0]["b"].to(ro.device))
    preds2 = ro.predict(fit2, h).cpu()
    acc2 = float((preds2 == lab).float().mean())
    agree2 = float((preds2 == runs["cuda"]["preds"]).float().mean())
    print(f"  [{card}] 2 gloo ranks on cuda:0 (processes started, features "
          f"loaded, solved in {wall:.2f} s): W equal on both ranks {same}; "
          f"|dW| / max |W| against one rank {rel2:.3e} (limit {tol:.3e}); "
          f"train accuracy {acc2:.4f}, {agree2:.4f} of the one-rank "
          f"predictions")
    check(same and rel2 <= tol and agree2 >= READOUT_AGREE,
          "the two-rank readout is not the one-rank readout")
    if torch.cuda.device_count() < 2:
        print("  NCCL not exercised: it refuses two ranks on one device, "
              "and this machine has one")
    del runs, h
    gc.collect()
    torch.cuda.empty_cache()


def sharded_group():
    """A one-rank NCCL process group (file:// rendezvous in a temporary
    directory) and the host mesh over it, a 1 x 1 ``DeviceMesh``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import LMMesh, make_host_mesh

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    mesh = make_host_mesh(data=1, model=1)
    check(isinstance(mesh, LMMesh) and mesh.shape == {"data": 1, "model": 1},
          f"the host mesh over one NCCL rank is {mesh}")
    return mesh


def sharded_run(mesh, batches, prefill_toks, lr_fn) -> dict:
    """Phase 11's run of smollm-135m (bf16, flash route, the seed-0 init):
    SHARDED_STEPS train steps at TRAIN_SHAPE and a SHARDED_PREFILL
    prefill, sharded over ``mesh`` (parameters through guarded_shardings
    and distribute_tensor, the optimizer state and batches placed) or
    unsharded when ``mesh`` is None.  K8's launches counted over the
    second step and over the prefill."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import place_batch, place_opt_state

    model = lm_model(torch.bfloat16, "cuda")
    init = [p.detach().float().cpu() for p in model.parameters()]
    opt = adamw()
    with shd.use_mesh(mesh):
        if mesh is not None:
            placements = shd.guarded_shardings(model, model.axes(), mesh)
            model.distribute(mesh, placements=placements)
            state = place_opt_state(opt, model, mesh)
            place = lambda b: place_batch(b, mesh)  # noqa: E731
        else:
            state = opt.init(model)
            place = lambda b: b  # noqa: E731
        step_fn = make_train_step(model, opt, lr_fn)
        losses, secs, k8 = [], [], {}
        for s in range(SHARDED_STEPS):
            batch = place(batches[s])
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            model, state, metrics = step_fn(model, state, s, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if s == 1:
                k8["step"] = read_launches()["K8 flash_attention"]
        toks = place({"tokens": prefill_toks})
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = make_prefill_step(model)(toks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        k8["prefill"] = read_launches()["K8 flash_attention"]
        full = (lambda t: t.full_tensor()) if mesh is not None else \
            (lambda t: t)
        out = dict(
            losses=losses, secs=secs, k8=k8, prefill_s=prefill_s,
            logits=full(logits).float().cpu(), init=init,
            params=[full(p).detach().float().cpu()
                    for p in model.parameters()],
            mu=[full(t).cpu() for t in tree_leaves(state.mu)],
            nu=[full(t).cpu() for t in tree_leaves(state.nu)],
            placements=sorted({str(tuple(p.placements))
                               for p in model.parameters()})
            if mesh is not None else None)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_lm_phase(card: str) -> None:
    """Phase 11: smollm-135m at full width, bf16, flash route, sharded
    over a one-rank NCCL mesh beside the same steps unsharded: K8 60 times
    a step and 30 a prefill, the losses within SHARDED_REL, the parameters
    within phase 10b's rule (1e-3 of each leaf's move since init plus
    1e-7, at most ADAM_ILL_SHARE of the entries exempt as ill-conditioned
    and those within two moves), the prefill logits within LM_BF16_REL of
    max |logits| with argmax equal; each step's time beside the
    unsharded one's."""
    import torch.distributed as dist

    cfg = get_config(LM_ARCH)
    b, t = TRAIN_SHAPE
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=t,
                                           global_batch=b))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch(s).items()}
               for s in range(SHARDED_STEPS)]
    prefill_toks = torch.from_numpy(lm_tokens(*SHARDED_PREFILL, cfg.vocab,
                                              seed=3)).cuda()
    lr_fn = cosine_schedule(TRAIN_LR, warmup=min(100, TRAIN_STEPS // 10 + 1),
                            total=TRAIN_STEPS)
    t0 = time.perf_counter()
    mesh = sharded_group()
    try:
        plain = sharded_run(None, batches, prefill_toks, lr_fn)
        shard = sharded_run(mesh, batches, prefill_toks, lr_fn)
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(shard["losses"], plain["losses"]))
    ratio, n_ill, n_all = 0.0, 0, 0
    t = SHARDED_STEPS
    for g, w, p0, gmu, gnu, mu, nu in zip(
            shard["params"], plain["params"], plain["init"], shard["mu"],
            shard["nu"], plain["mu"], plain["nu"]):
        mg, mw = gmu / (1 - 0.9 ** t), mu / (1 - 0.9 ** t)
        sg, sw = torch.sqrt(gnu / (1 - 0.95 ** t)), torch.sqrt(
            nu / (1 - 0.95 ** t))
        dm = (mg - mw).abs().amax(-1, keepdim=True)
        ds = (sg - sw).abs().amax(-1, keepdim=True)
        err = (g - w).abs()
        ill = (dm / (sw + 1e-8) + mw.abs() * ds / (sw + 1e-8) ** 2
               > ADAM_REL).expand_as(err)
        move = float((w - p0).abs().max())
        n_ill += int(ill.sum())
        n_all += err.numel()
        if bool((~ill).any()):
            ratio = max(ratio, float(err[~ill].max()) / (1e-3 * move + 1e-7))
        check(bool((err[ill] <= 2 * move).all()),
              f"an ill-conditioned parameter moved {float(err.max())}")
    same = all(torch.equal(a, b)
               for a, b in zip(shard["params"], plain["params"]))
    lg, lw = shard["logits"], plain["logits"]
    logit_rel = float((lg - lw).abs().max()) / float(lw.abs().max())
    argmax = bool(torch.equal(lg.argmax(-1), lw.argmax(-1)))
    med = {k: statistics.median(r["secs"][1:]) * 1e3
           for k, r in (("plain", plain), ("sharded", shard))}
    print(f"  [{card}] {LM_ARCH} bf16 flash route, (B, T) = {TRAIN_SHAPE}, "
          f"{SHARDED_STEPS} AdamW steps on phase 10's batches, unsharded "
          f"and over a one-rank NCCL DeviceMesh (data 1, model 1; "
          f"placements {shard['placements']}), {wall:.1f} s in all")
    print(f"  losses unsharded " + " ".join(f"{x:.5f}" for x in
                                              plain["losses"]))
    print(f"  losses sharded   " + " ".join(f"{x:.5f}" for x in
                                              shard["losses"]))
    print(f"  K8 launches: a sharded step {shard['k8']['step']} (unsharded "
          f"{plain['k8']['step']}; {2 * cfg.n_layers} expected), a sharded "
          f"{SHARDED_PREFILL} prefill {shard['k8']['prefill']} (unsharded "
          f"{plain['k8']['prefill']}; {cfg.n_layers} expected)")
    print(f"  loss rel {loss_rel:.3e} (limit {SHARDED_REL}); parameters: "
          f"worst |dp| / (1e-3 move + 1e-7) {ratio:.3f} (limit 1) outside "
          f"the {n_ill} of {n_all} entries ({100 * n_ill / n_all:.3f}%, "
          f"limit {100 * ADAM_ILL_SHARE:g}%) whose step is "
          f"ill-conditioned; bit for bit equal: {same}")
    print(f"  prefill {SHARDED_PREFILL}: logits rel {logit_rel:.3e} (limit "
          f"{LM_BF16_REL}), argmax equal {argmax}; "
          f"{shard['prefill_s'] * 1e3:.1f} ms sharded, "
          f"{plain['prefill_s'] * 1e3:.1f} ms unsharded (host clock, first "
          f"call)")
    print(f"  [{card}] a step, steps 1-{SHARDED_STEPS - 1} median (host "
          f"clock, synchronized): sharded {med['sharded']:.1f} ms, "
          f"unsharded {med['plain']:.1f} ms "
          f"({med['sharded'] / med['plain']:.3f}x"
          f"; DTensor's host overhead)")
    check(shard["k8"]["step"] == 2 * cfg.n_layers
          and shard["k8"]["prefill"] == cfg.n_layers,
          f"sharded K8 launches {shard['k8']}")
    check(loss_rel <= SHARDED_REL, f"sharded vs unsharded loss {loss_rel}")
    check(ratio <= 1.0 and n_ill <= ADAM_ILL_SHARE * n_all,
          f"sharded vs unsharded parameters: {ratio}, {n_ill} ill")
    check(logit_rel <= LM_BF16_REL and argmax,
          f"sharded prefill logits {logit_rel}, argmax {argmax}")


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def become_subreaper() -> None:
    """Make this process the reaper of its orphaned descendants (a dry-run
    cell's pool worker, multiprocessing's resource tracker): they are
    re-parented here instead of to init, so stop_children() finds them."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def children() -> dict[int, str]:
    """This process's child processes (with become_subreaper(), every
    descendant whose parent has exited too), pid -> its state letter and
    command line ('Z' and its name alone once it has exited unreaped)."""
    me, kids = os.getpid(), {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmd = (entry / "cmdline").read_bytes()
        except OSError:
            continue
        name, rest = stat.split("(", 1)[1].rsplit(")", 1)
        state, ppid = rest.split()[:2]
        if int(ppid) == me:
            cmd = cmd.replace(b"\0", b" ").decode(errors="replace").strip()
            kids[int(entry.name)] = f"{state} {cmd or name}"
    return kids


def stop_children(grace: float = 5.0,
                  limit: float = 30.0) -> dict[int, str]:
    """End every process this script started that still runs, and reap it:
    multiprocessing's resource tracker is closed as multiprocessing closes
    it; any other child gets SIGTERM, then SIGKILL after ``grace`` seconds.
    Returns what it found; raises if a process outlives ``limit``."""
    from multiprocessing import resource_tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    found, t0 = {}, time.perf_counter()
    while True:
        for pid in list(found):
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, os.WNOHANG)
        kids = children()
        if not kids:
            return found
        waited = time.perf_counter() - t0
        if waited > limit:
            raise SmokeFailure(f"processes outlived SIGKILL: {kids}")
        sig = signal.SIGTERM if waited < grace else signal.SIGKILL
        for pid, cmd in kids.items():
            found.setdefault(pid, cmd)
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        time.sleep(0.05)


def start_dryrun() -> tuple:
    """Phase 11b's cells, started in the background after phase 11, the
    last timed phase: each ``python -m repro_torch.launch.dryrun`` in a
    process of its own at the lowest CPU priority (``nice 19``; a
    shape-only 'fake' group and fake tensors, no CUDA device visible), at
    most DRYRUN_PROCS at once, from a thread of this process, while the
    untimed card-vs-CPU phases run.  Returns (the thread, its results: each cell's
    command, exit code, seconds and output, and an error if the cells ran
    over DRYRUN_TIMEOUT); ``dryrun_phase`` reads them."""
    from repro_torch.configs import ALL_ARCHS

    column = {a for a, s, m, sets, _ in DRYRUN_CELLS
              if s == "train_4k" and m == "single" and sets == dryrun_sets(a)}
    check(column == set(ALL_ARCHS), f"phase 11b's train_4k column lacks "
                                    f"{set(ALL_ARCHS) - column}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    nice = [shutil.which("nice"), "-n", "19"] if shutil.which("nice") else []
    state = dict(results=[], error=None)

    def run() -> None:
        # a failing phase ends the script: main's stop_children() ends the
        # cells' processes (each with its pool's worker) with it
        pending, running = list(DRYRUN_CELLS), []
        t0 = time.perf_counter()
        while pending or running:
            while pending and len(running) < DRYRUN_PROCS:
                arch, shape, mesh, sets, tag = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--tag", tag,
                       *(a for kv in sets for a in ("--set", kv))]
                log = tempfile.TemporaryFile(mode="w+")
                running.append((cmd, time.perf_counter(), log,
                                subprocess.Popen(
                                    nice + cmd, env=env, cwd=ROOT,
                                    stdout=log, stderr=subprocess.STDOUT,
                                    text=True)))
            for item in [r for r in running if r[3].poll() is not None]:
                running.remove(item)
                cmd, start, log, proc = item
                log.seek(0)
                state["results"].append((cmd, proc.returncode,
                                         time.perf_counter() - start,
                                         log.read()))
                log.close()
            if time.perf_counter() - t0 > DRYRUN_TIMEOUT:
                state["error"] = f"the dry run ran over {DRYRUN_TIMEOUT} s"
                return
            time.sleep(0.2)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, state


def dryrun_phase(started: tuple) -> None:
    """Phase 11b: the dry run's cells started by ``start_dryrun``, waited
    for; every cell reads 'ok', or 'skipped' exactly where the reference's
    skip_shapes says; each cell's per-device argument GiB, FLOPs, bytes,
    wire bytes and dominant term."""
    from repro_torch.launch import dryrun

    thread, state = started
    thread.join(DRYRUN_TIMEOUT)
    check(not thread.is_alive(), f"the dry run ran over {DRYRUN_TIMEOUT} s")
    for cmd, code, secs, out in state["results"]:
        print(f"  {' '.join(cmd[3:])}: exit {code} after {secs:.1f} s")
        check(code == 0, f"the dry run failed:\n{out[-4000:]}")
    check(state["error"] is None, str(state["error"]))
    for arch, shape, mesh, _, tag in DRYRUN_CELLS:
        mesh = "pod2x16x16" if mesh == "multi" else "pod16x16"
        rec = json.loads(dryrun.artifact_path(arch, shape, mesh,
                                              tag).read_text())
        skip = shape in get_config(arch).skip_shapes
        want = "skipped" if skip else "ok"
        check(rec["status"] == want, f"{arch} x {shape} x {mesh} ({tag}): "
                                     f"{rec['status']} {rec.get('error')}")
        if skip:
            print(f"  {arch:26s} {shape:12s} {mesh:10s} skipped (the "
                  f"reference's skip_shapes)")
            continue
        m = rec["memory"]
        route = " pallas" if tag != "smoke" else ""
        if arch in DRYRUN_DEPTH:
            route += (f" at {DRYRUN_DEPTH[arch]} of "
                      f"{get_config(arch).n_layers} layers,")
        print(f"  {arch:26s} {shape:12s} {mesh:10s}{route} "
              f"args {m['argument_size'] / 2 ** 30:.3f} GiB, temp "
              f"{m['temp_size'] / 2 ** 30:.2f} GiB, flops "
              f"{rec['flops_per_device']:.3e}, "
              f"bytes {rec['bytes_per_device']:.3e}, wire "
              f"{rec['collective']['wire_bytes']:.3e}, "
              f"{rec['roofline']['dominant']} "
              f"(useful {rec['useful_flops_ratio']:.3f}; traced in "
              f"{rec['compile_s']:.1f} s)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    become_subreaper()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    bf16_reduction = \
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    header(f"[1] {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}; matmul.allow_tf32="
           f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
           f"{torch.backends.cudnn.allow_tf32}, "
           f"matmul.allow_bf16_reduced_precision_reduction={bf16_reduction}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")),
                        verbose=True)
    header(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
           f"(parallel nvcc, {', '.join(sorted(logs)) or 'already built'})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for lib, log in sorted(logs.items()):
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in line]
        check(not spills, f"{lib}.cu spills registers: {spills}")
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: sass.count(op) for op in K8_SASS}
    print("  flash_attention SASS: " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    check(all(counts.values()), f"K8's library lacks {counts}: the bf16 "
                                f"route must run wgmma on TMA-loaded tiles")
    imma = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("streaming_q8"))],
        capture_output=True, text=True, check=True,
        timeout=300).stdout.count("IMMA")
    print(f"  streaming_q8 SASS: IMMA {imma}")
    check(imma > 0, "K5's library has no IMMA: its DPRR product must run "
                    "mma.sync on int8")
    CHAIN.update(chain_latency.measure(), clock_hz=max_sm_clock_hz())
    print("  dependent-chain cycles of one warp (launch/chain_latency.py): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      {**CHAIN["op_cycles"], **CHAIN["step_cycles"]}.items()))

    t0 = time.perf_counter()
    cfg, arrays, data = load_arab()
    header(f"[3] kernels vs plain versions on the card (ARAB data made in "
           f"{time.perf_counter() - t0:.1f} s)")
    records = kernel_phase(dev)
    records.update(training_kernel_records(
        DFRModel.create(cfg, generator=torch.Generator().manual_seed(0)),
        data[0]))
    wide_kernel_records(cfg, data[0], records)
    wide_k3_records(records)
    records.update(k8_records(dev))
    k8_grad_phase(dev)
    k1_population_phase(cfg, data[0], masking.make_mask(
        torch.Generator().manual_seed(cfg.mask_seed), cfg.n_nodes, cfg.n_in,
        cfg.dtype))
    header("[4] main paths: StreamServer on ARAB at full width (fp32, "
           "int8 and bf16)")
    launches, main_runs = {}, {}
    for path in {**PATHS, **BF16_PATHS}:
        t0 = time.perf_counter()
        main_runs[path] = res = main_path_phase(card, cfg, arrays, path)
        if path in BF16_PATHS:
            print(f"  bf16 path in {time.perf_counter() - t0:.1f} s")
            continue
        # each kernel reports the launches of the first path it is on
        for name in PATHS[path][1]:
            launches.setdefault(name, res["launches"][name])
    header("[4b] where the server's time goes (torch.profiler)")
    profiles = {}
    for path in PATHS:
        for kind in KINDS:
            profiles[path, kind] = profile_phase(card, cfg, arrays, path,
                                                 kind)
    header("[4] the bf16 path beside fp32: one profiled captured wave")
    t0 = time.perf_counter()
    profiles["bf16", "captured"] = profile_phase(card, cfg, arrays, "bf16",
                                                 "captured")
    bf16_phase(card, main_runs, profiles)
    print(f"  in {time.perf_counter() - t0:.1f} s")
    header("[4c] captured, eager, and pipelined and blocked rounds, "
           "alternated")
    for path in {**PATHS, **BF16_PATHS}:
        t0 = time.perf_counter()
        rounds_phase(card, cfg, arrays, path)
        if path in BF16_PATHS:
            print(f"  bf16 path in {time.perf_counter() - t0:.1f} s")
    header("[4d] the retirement modes at full width: captured, eager, and "
           "pipelined and blocked rounds, alternated")
    for path in RETIRE_PATHS:
        retirement_phase(card, cfg, arrays, path)
    header("[4e] the reference's drift cells on the card")
    drift_phase(card)
    header("[4f] the warm-pool autotuner on phase 4's servers, and the "
           "reference's tuner episode")
    autotuner_phase(card, cfg, arrays)
    header("[4g] the calibrated planner at full width")
    t0 = time.perf_counter()
    planner_phase(card, cfg, arrays)
    print(f"  phase 4g in {time.perf_counter() - t0:.1f} s")
    header("[4h] multi-device serving: phase 4's servers on 2 and 4 slot "
           "blocks of one card")
    t0 = time.perf_counter()
    sharded_phase(card, cfg, arrays, main_runs)
    print(f"  phase 4h in {time.perf_counter() - t0:.1f} s")
    header("[6] the training path at full width: DFRModel.fit, OnlineDFR")
    fit_launches, fit = training_phase(card, cfg, data)
    launches.update(fit_launches)
    header("[6b] the hyperparameter search at full width: grid searches, the "
           "population, the paper's Table 5")
    population_phase(card, cfg, data, fit)
    t0 = time.perf_counter()
    checkpoint_phase(card, cfg, data)
    print(f"  the checkpoint in {time.perf_counter() - t0:.1f} s")
    header("[6c] the paper's memory algorithms at full width: Table 8, Fig. "
           "9, the packed update, the gradient paths, Table 7")
    memory_phase(card, cfg, data, fit)
    t0 = time.perf_counter()
    header(f"[6d] the slice's path past one warp: ARAB at Nx={WIDE_NX}, "
           f"DFRModel.fit and both fp32 refresh modes")
    wide_path_phase(card, data)
    print(f"  phase 6d in {time.perf_counter() - t0:.1f} s")
    header(f"[8] the LM main path at full width: {LM_ARCH}, "
           f"attn_impl='pallas', bf16")
    launches.update(lm_phase(card))
    t0 = time.perf_counter()
    header(f"[8b] the LM-feature readout at full width: {LM_ARCH}'s hidden "
           f"states through DistributedDFRReadout, 1 rank and 2 gloo ranks")
    readout_phase(card)
    print(f"  phase 8b in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    header("[8c] the other LM families at their published widths, bf16, "
           "attn_impl='pallas'")
    families_phase(card)
    print(f"  phase 8c in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    header(f"[10] LM training at full width: {LM_ARCH}, launch.train, the "
           f"Trainer, a replay")
    train_cli_phase()
    train_phase(card)
    print(f"  phase 10 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    header(f"[11] the sharded LM on the card: {LM_ARCH} over a one-rank "
           f"NCCL DeviceMesh beside the unsharded run")
    sharded_lm_phase(card)
    print(f"  phase 11 in {time.perf_counter() - t0:.1f} s")
    # the timed phases are done: the dry run's processes (phase 11b) run
    # from here on, beside the card-vs-CPU phases, whose wall times then
    # share the host's CPUs with them
    t0 = time.perf_counter()
    header("[11b] the dry run started: every arch at train_4k on pod16x16, "
           "two cells on pod2x16x16, the flash route's cell; the card-vs-CPU "
           "phases beside it (their wall times share the host's CPUs)")
    dryrun = start_dryrun()
    header("[5] agreement, card vs CPU")
    for path in PATHS:
        agreement_phase(cfg, arrays, path)
    agreement_phase(cfg, arrays, "bf16", n_samples=RETIRE_AGREE_SAMPLES,
                    agree_min=BF16_AGREE)
    for path in RETIRE_PATHS:
        agreement_phase(cfg, arrays, path, n_samples=RETIRE_AGREE_SAMPLES)
    population_agreement_phase(cfg, data)
    header("[7] training path agreement, card vs CPU")
    training_agreement_phase(cfg, data)
    training_agreement_phase(paper_dfr_config("ARAB", n_nodes=WIDE_NX), data,
                             **WIDE_AGREE)
    header("[10b] one train step at full width, card vs CPU")
    train_agreement_phase()
    header("[9] the LM at full width, card vs CPU")
    lm_agreement_phase()
    header("[9b] the LM families at full width and one layer, card vs CPU")
    families_agreement_phase()
    header("[11b] the dry run: every cell waited for")
    dryrun_phase(dryrun)
    print(f"  phase 11b in {time.perf_counter() - t0:.1f} s")
    left = stop_children()
    running = sum(not cmd.startswith("Z ") for cmd in left.values())
    header(f"[12] the script's descendants at its end: {len(left)}, all "
           f"reaped ({running} still running, ended; {len(left) - running} "
           f"exited, orphans re-parented here)"
          + "".join(f"\n  {pid} {cmd[:160]}" for pid, cmd in left.items()))

    for name, count in launches.items():
        records[name]["launches"] = count
    nodes = {**KERNEL_NODES, "K3 cholupdate_window_t":
             f"s 1-{k_cholupdate.max_factor()}",
             **{name: f"Nx 1-{KERNELS[name].max_nodes()}" for name in
                ("K1 train_forward", "K2 streaming_logits",
                 "K5 streaming_logits_q8", "K6 reservoir_states",
                 "K7 dprr_features")}}
    for name, r in records.items():
        r["nodes"] = nodes[name]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "nodes")
    print(card_line())
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + tuple(x for x in ("routes", "wide")
                                       if x in r)}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
