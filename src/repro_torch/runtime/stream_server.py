"""Continuous-batching stream server: train-while-serve for sensor streams.

The PyTorch counterpart of ``repro.runtime.stream_server`` with its refresh
modes, int8 serving and sample retirement.  Many independent sensor streams
each get an online DFR that
(a) answers every window from the parameters it had before seeing the
labels (infer-before-update) and (b) keeps adapting: truncated-BP SGD on
(p, q, W, b) while the slot is young (phase 1), then frozen-reservoir (A, B)
accumulation with a Ridge refresh of the readout every ``refresh_every``
server steps (phase 2).  A fixed number of slots holds one stream each as
row i of a slot-batched ``OnlineState``; one step advances every live slot.

On a CUDA device one server step launches each hand-written kernel once for
all slots: K1 (``kernels/csrc/train.cu``) for the shared training forward,
K2 (``kernels/csrc/streaming.cu``) for the infer-before-update logits, and,
when their knobs are set, K5 (``kernels/csrc/streaming_q8.cu``) for the
int8 logits and K3 (``kernels/csrc/cholupdate.cu``) for the fold of the
window's samples into the live factors (scaled by sqrt(lambda) under
``retirement='forget'``), and once more under ``retirement='window'`` for
the downdate of the samples the window evicts.  On the CPU the step keeps the
reference's off-TPU choices: the plain forward, and the serve step's own
logits unless ``fused_infer=True``; K5 and K3 run their plain versions.

On the card with ``staging='device'`` a round replays CUDA graphs of its
fixed-shape bodies (``runtime.graphs``) instead of launching their kernels
one by one from Python: the step, and the cohort refresh of a refresh
round.  The round updates the server's state in place there, the
counterpart of the reference's donated buffers.  The reference's
``lax.cond``-gated steps (the window mode's refactorization of a slot whose
downdate tripped the guard, the adaptive mode's anneal) are conditional
nodes of the step graph (``graphs.run_if``).  The eager round
(``_step_core``) serves on the CPU and under ``staging='host'``.

The host keeps a mirror of every slot's step count, so choosing between the
training and the frozen step never waits for the device; the one blocking
read per dispatch is the predictions, ``pipeline_depth`` dispatches later.

With ``devices=N`` the slots split into N contiguous blocks of S/N, one per
entry of a slot mesh (``launch.mesh.make_slot_mesh``), placed by the
sharding rules (``distributed.sharding.shard_blocks``); a live slot never
changes block.  One process drives every block: each round runs the same
single-device round (eager or captured, a ``RoundGraphs`` a block) on each
block's own tensors in turn, with the refresh rows of the cohorts'
shard-local schedule.  Nothing crosses blocks, so blocks on different cards
overlap, and every slot computes what it computes in one block.  The bits
are the ``devices=1`` episode's wherever the library calls round alike for
a batch of S/N and of S: on the CPU, and not at every shape on the card
(the refresh's batched ``solve_triangular`` and PyTorch's per-slot
reductions choose their kernels by batch size).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import masking, ridge
from repro_torch.core.online import (OnlineState, adaptive_detect,
                                     anneal_ridge_, fold_quant_rows,
                                     init_state, online_serve_step,
                                     refresh_output_factor_rows,
                                     refresh_output_rows, slot_logical_axes)
from repro_torch.core.types import (DFRConfig, RequestPool, RidgeState,
                                    Tensor, WindowState, map_leaves,
                                    resolve_device)
from repro_torch.distributed.sharding import shard_blocks
from repro_torch.kernels import ops
from repro_torch.launch.mesh import SlotMesh, make_slot_mesh
from repro_torch.runtime.graphs import PinnedRing, RoundGraphs, run_if
from repro_torch.runtime.planner import Planner
from repro_torch.runtime.scheduler import RefreshCohorts, SlotScheduler


@dataclasses.dataclass
class StreamRequest:
    """One sensor stream: N labeled samples served window-by-window."""

    rid: int
    u: np.ndarray             # (N, T, n_in) float32 samples
    length: np.ndarray        # (N,) int32 valid lengths
    label: np.ndarray         # (N,) int32 labels
    preds: List[int] = dataclasses.field(default_factory=list)
    correct: int = 0
    done: bool = False
    submit_t: float = 0.0
    finish_t: float = 0.0
    final_state: Optional[OnlineState] = None   # snapshot at retirement

    @property
    def n_samples(self) -> int:
        return self.u.shape[0]

    @property
    def online_accuracy(self) -> float:
        """Rolling infer-before-update accuracy over the served stream."""
        return self.correct / max(1, len(self.preds))


def _bcast_to(mask1d: Tensor, leaf: Tensor) -> Tensor:
    return mask1d.reshape((-1,) + (1,) * (leaf.ndim - 1))


@dataclasses.dataclass(frozen=True)
class Retirement:
    """A server's sample retirement (``StreamServer``'s knobs): the mode,
    ``lam`` (a device scalar: forget's lambda, or adaptive's fire-time
    lambda), the window mode's ridge ``beta`` for the guard's rebuild, and
    the adaptive detector's trip ratio and warm-up steps."""

    mode: str = "none"
    lam: Optional[Tensor] = None
    beta: float = 0.0
    ratio: float = 1.2
    warmup: int = 4


def _assign(dst: OnlineState, src: OnlineState) -> None:
    """Write every leaf of ``src`` that is not already ``dst``'s own into
    ``dst``'s tensor, in place."""
    map_leaves(lambda d, s: d if d is s else d.copy_(s), dst, src)


def _step_core(
    cfg: DFRConfig,
    mask: Tensor,
    states: OnlineState,        # leading slot axis S on every leaf
    fresh: Optional[OnlineState],  # single-system state: admission reset
    fresh_rows: Optional[Tensor],  # (K,) int64 slots admitted this step
    u: Tensor,                  # (S, W, T, n_in)
    length: Tensor,             # (S, W) int32
    label: Tensor,              # (S, W) int32
    weight: Tensor,             # (S, W) 0/1 live-sample mask
    live: Tensor,               # (S,) bool live-slot mask
    lr: Tensor,                 # scalar base learning rate
    phase_steps: int,           # slot steps of reservoir adaptation
    *,
    all_live: bool,
    train: bool,
    fused_infer: bool = True,
    fused: bool = False,
    maintain_factor: bool = False,
    quantize: str = "none",
    stats_in_place: bool = False,
    retire: Retirement = Retirement(),
    win: Optional[WindowState] = None,
    graphs: Optional[RoundGraphs] = None,
) -> Tuple[OnlineState, Tensor, Optional[Tensor]]:
    """One server step: infer-before-update + train for every live slot.

    Returns (new states, predictions (S, W), armed (S,) bool or None).
    Admitted slots start from ``fresh``; dead slots compute in their lanes
    and are frozen by ``live`` (skipped when the host knows ``all_live``).

    ``train`` picks the training or the frozen serve step: whether any live
    slot is still in phase 1.  The reference decides that on the device;
    here the caller answers from its host mirror of the slot steps, so the
    step never waits for the device.

    K2, when ``fused_infer`` is set, reads the PRE-update, post-admission
    parameters: the infer-before-update contract.

    ``quantize='int8'`` serves armed slots (``w_scale > 0``) from K5 on the
    same pre-update parameters and their int8 codes; unarmed slots keep the
    fp32 logits.  ``maintain_factor`` folds the window's gated r~ rows into
    every slot's live factor through K3, once, after the liveness select;
    dead, tail and phase-1 rows are zero, hence no-ops.

    ``stats_in_place`` adds the window's (A, B) statistics into
    ``states.ridge`` itself (the captured round's in-place update).  Dead
    slots then skip the liveness select on A and B: their rows add exact
    zeros, and A and B never hold -0, so they keep their bits.

    ``retire`` (the reference's order): 'forget' decays the statistics in
    the serve step and scales the K3 fold by its ``fold_scale`` rows;
    'window' then evicts from ``win`` (updated in place, and reset for the
    admitted rows) through ``_retire_window``; 'adaptive' runs the drift
    detector on the step's serving error after the fold and anneals the
    slots that trip.  These two steps run through ``graphs.run_if``: under
    a capture of ``graphs`` (the round's graphs) as conditional nodes;
    without ``graphs`` (the eager round) the guard's rebuild reads its flag
    on the host and the anneal runs unconditionally (its factors are
    exactly 1.0 where no slot trips).
    """
    f = cfg.f()
    if fresh_rows is not None:
        k = fresh_rows.shape[0]
        states = map_leaves(
            lambda batched, single: batched.index_copy(
                0, fresh_rows, single.expand(k, *single.shape)),
            states, fresh)
        if win is not None:
            _reset_window_rows(win, fresh_rows)

    # per-slot learning-rate phase: adapt (p, q, W, b) while the slot is
    # young, then freeze the reservoir; (A, B) accumulate only when frozen
    in_phase1 = states.step < phase_steps
    lr_slot = torch.where(in_phase1, lr, 0.0).to(cfg.dtype)
    acc_slot = torch.where(in_phase1, 0.0, 1.0).to(cfg.dtype)

    new_states, logits, metrics = online_serve_step(
        cfg, mask, states, u, length, label, lr_slot, weight, acc_slot,
        maintain_factor="defer" if maintain_factor else False, train=train,
        track_state_absmax=quantize == "int8", fused=fused,
        accumulate_in_place=stats_in_place,
        forget=retire.lam if retire.mode == "forget" else None,
    )
    if fused_infer or quantize == "int8":
        j_seq = masking.apply_mask(mask, u)
    if fused_infer:
        logits = ops.streaming_logits_slots(
            j_seq, length, states.params.p, states.params.q,
            states.params.W, states.params.b, cfg.n_nodes, f=f,
        )
    armed = None
    if quantize == "int8":
        qt = states.quant
        q_logits = ops.streaming_logits_slots_q8(
            j_seq, length, states.params.p, states.params.q, qt.Wq,
            qt.w_scale, qt.x_scale, states.params.b, cfg.n_nodes, f=f,
        )
        armed = qt.w_scale > 0
        logits = torch.where(armed[:, None, None], q_logits.to(logits.dtype),
                             logits)
    preds = logits.argmax(dim=-1)

    if not all_live:
        # a leaf the step left as it was (the deferred Lt among them) needs
        # no select; dead slots' rt_rows are zero, so the fold skips them
        new_states = map_leaves(
            lambda n, o: n if n is o else torch.where(_bcast_to(live, n), n, o),
            new_states, states)
    if maintain_factor:
        # in place: the old state is dropped once the step returns, and
        # retired rows were snapshot by clone
        ops.cholupdate_window_t(new_states.ridge.Lt, metrics["rt_rows"],
                                scale=metrics.get("fold_scale"),
                                out=new_states.ridge.Lt)
        if retire.mode == "window":
            gate = weight * acc_slot[:, None]
            onehot = torch.nn.functional.one_hot(
                label.to(torch.int64), cfg.n_classes).to(cfg.dtype)
            _retire_window(new_states.ridge, win, metrics["rt_rows"], onehot,
                           gate, retire.beta, graphs)
    if retire.mode == "adaptive":
        # the detector reads the serving error of live slots that folded
        # frozen-phase samples; the anneal scales the post-fold factor
        update = live & ~in_phase1 & (weight.sum(dim=1) > 0)
        warm = new_states.step >= phase_steps + retire.warmup
        fast, slow, trip, lam = adaptive_detect(
            new_states.loss_fast, new_states.loss_slow, 1.0 - metrics["acc"],
            update, warm, retire.ratio, retire.lam)
        new_states = dataclasses.replace(new_states, loss_fast=fast,
                                         loss_slow=slow)
        rs = new_states.ridge
        run_if(trip.any(), lambda: anneal_ridge_(rs, lam), graphs)
    return new_states, preds, armed


def _reset_window_rows(win: WindowState, rows: Tensor) -> None:
    """Empty the window rings of slot ``rows`` (admitted), in place."""
    for leaf in (win.rows, win.onehot, win.pos):
        leaf.index_fill_(0, rows, 0)


def _retire_window(rs: RidgeState, win: WindowState, rt_rows: Tensor,
                   onehot: Tensor, gate: Tensor, beta: float,
                   graphs: Optional[RoundGraphs]) -> None:
    """The window mode's eviction for every slot at once, in place on
    ``rs`` and ``win``: the reference's ``_retire_window_slot`` per slot.

    Each accumulated row (``gate`` (S, W) 0/1; the live rows of a window are
    a prefix, since ``weight`` gates the samples past a stream's end and
    ``acc`` whole slots) evicts the ring's row at the cursor, then takes its
    place, and the cursor advances.  Row t evicts the ring's row pos + t
    while t < capacity; past that it evicts this window's own row t -
    capacity, written earlier in the same round.  The evicted rows leave
    (A, B) in one product each (the reference subtracts them one by one:
    the same sum, rounded in another order), and the factor through K3 as a
    guarded downdate (sign -1).  A slot whose downdate the guard skipped
    has its factor rebuilt from B + beta I (``run_if``: a conditional node
    under a capture of ``graphs``; without ``graphs`` it reads the flag).
    Zero rows (empty ring capacity, gated rows) evict exact no-ops.
    """
    S, W = gate.shape
    cap = win.rows.shape[1]
    dev = gate.device
    t = torch.arange(W, device=dev)
    slot = torch.arange(S, device=dev)[:, None]
    m = gate.sum(dim=1).to(torch.int64)               # live rows a slot
    pos = win.pos.to(torch.int64)
    ring = (pos[:, None] + t[None, :]) % cap          # (S, W)
    ev_r, ev_o = win.rows[slot, ring], win.onehot[slot, ring]
    if W > cap:
        own = (t >= cap)[None, :, None]
        back = torch.clamp(t - cap, min=0)
        ev_r = torch.where(own, rt_rows[:, back], ev_r)
        ev_o = torch.where(own, onehot[:, back], ev_o)
    g = gate[..., None]
    ev_r, ev_o = ev_r * g, ev_o * g
    # every r~ row ends in the constant-1 feature: a real eviction
    valid = (ev_r[..., -1] > 0.5).sum(dim=1).to(rs.count.dtype)
    rs.A.sub_(ev_o.transpose(-1, -2) @ ev_r)
    rs.B.sub_(ev_r.transpose(-1, -2) @ ev_r)
    rs.count.sub_(valid)
    bad = torch.empty((S,), dtype=torch.int32, device=dev)
    ops.cholupdate_window_t(rs.Lt, ev_r, -1.0, flags=bad, out=rs.Lt)
    # ring position j keeps the last live row t with (pos + t) % cap == j
    j = torch.arange(cap, device=dev)
    t0 = (j[None, :] - pos[:, None]) % cap            # (S, cap)
    hit = t0 < m[:, None]
    last = t0 + torch.clamp(torch.div(m[:, None] - 1 - t0, cap,
                                      rounding_mode="floor"), min=0) * cap
    last = torch.clamp(last, max=W - 1)
    win.rows.copy_(torch.where(hit[..., None], rt_rows[slot, last],
                               win.rows))
    win.onehot.copy_(torch.where(hit[..., None], onehot[slot, last],
                                 win.onehot))
    win.pos.copy_((pos + m) % cap)
    flagged = bad != 0

    def rebuild():
        fresh = ridge.cholesky_or_nan(ridge.regularize(rs.B, beta)).mT
        rs.Lt.copy_(torch.where(flagged[:, None, None], fresh, rs.Lt))

    run_if(flagged.any(), rebuild, graphs, read=graphs is None)


def _gather_window(
    pool: RequestPool, cursor: Tensor, live: Tensor, window: int, dtype
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Assemble the (S, W, ...) window batch from the staged pool, one
    cursor-indexed slice per slot row.

    Live cursors are window-aligned and below capacity; a dead slot's start
    is clamped into range like the reference's ``dynamic_slice``.  Pad rows
    carry the host-staging defaults, and ``weight`` zero-gates samples past
    the stream end and every dead lane.
    """
    n_slots = cursor.shape[0]
    steps = torch.arange(window, device=cursor.device)
    start = torch.clamp(cursor, 0, pool.capacity - window)
    idx = start[:, None] + steps[None, :]
    rows = torch.arange(n_slots, device=cursor.device)[:, None]
    want = cursor[:, None] + steps[None, :]
    weight = ((want < pool.n[:, None]) & live[:, None]).to(dtype)
    return pool.u[rows, idx], pool.length[rows, idx], pool.label[rows, idx], \
        weight


class StreamServer:
    """Continuous-batching train-while-serve runtime for DFR streams.

    Fixed shapes everywhere: ``max_streams`` slots, ``window`` samples per
    slot per step, samples padded to ``t_max`` steps.  Requests whose sample
    count is not a multiple of ``window`` get a zero-weighted tail.

    ``device`` is where the state lives and the step runs.  ``None`` means
    the CUDA device, and raises on a host without one; pass
    ``device='cpu'`` to run on the CPU.

    Ported knobs (the reference's meaning):

      * ``refresh_mode='recompute'`` with ``refresh_cohorts=C``: the batched
        (s, s) Cholesky re-factorization every ``refresh_every`` steps,
        staggered over C round-robin slot cohorts.
      * ``refresh_mode='incremental'``: every admitted slot carries a live
        transposed factor of B + beta I, seeded sqrt(beta) I; each step
        rotates the window's accumulated samples into it (K3 on the card),
        and the refresh is two triangular solves, no factorization.
      * ``quantize='int8'``: armed slots serve logits computed on int8 codes
        (K5 on the card); a slot arms when its scales first fold at a
        refresh boundary (``online.fold_quant_rows``), and serves fp32
        until then.  Training, statistics and refreshes stay fp32.  Needs
        ``staging='device'``, as in the reference.  ``served_int8`` counts
        the predictions served from armed slots.
      * ``staging='device'`` (default): each stream's payload is uploaded
        once and windows are gathered on the device by cursor; the refresh
        runs inside ``step``.  On a CUDA device the round is replayed from
        CUDA graphs (``runtime.graphs``).  ``'host'`` builds and uploads
        each window batch on the host and runs the eager round.  Both serve
        the same episode.
      * ``pipeline_depth=D``: predictions leave the device by a
        non-blocking copy into pinned host memory and wait in a ring; a
        dispatch reads (and books) the entries deeper than D, so the host
        prepares the next D rounds while the device runs.  D = 0 reads each
        round's predictions before ``step`` returns.  The slot lifecycle
        stays cursor-driven at dispatch time, so D never changes what is
        served.
      * ``step_block=B``: up to B rounds in one ``step`` with one prediction
        read.  The block is clamped so that no live slot completes inside
        it and admissions happen only at its start, so a blocked episode
        serves the ``step_block=1`` episode exactly.  Needs
        ``staging='device'``, as in the reference.  An attached autotuner
        runs after each round of the block (the reference calls it once a
        dispatch), so a blocked tuned episode serves the unblocked one.
      * ``retirement``: how a slot forgets old samples, for streams that
        drift.  'forget' (lambda ``forget``): exponentially weighted RLS,
        every accumulated sample scales (A, B) by lambda and the live
        factor by sqrt(lambda) before its fold (K3's scale operand);
        lambda = 1 serves 'none' bit for bit.  'window' (capacity
        ``retire_window``, needs ``refresh_mode='incremental'``): a ring of
        each slot's last retained (r~, one-hot) rows; a new row evicts the
        oldest from (A, B) and downdates it out of the live factor (K3, sign
        -1, flagged), and a slot whose downdate the guard skipped has its
        factor rebuilt from B + beta I; a capacity of at least every
        stream's length serves 'none' bit for bit.  'adaptive': a per-slot
        drift detector (``online.adaptive_anneal``) on the serving error,
        armed ``adapt_warmup`` steps after phase 1; a slot whose fast EMA
        passes ``adapt_ratio`` x its slow EMA plus a margin has its
        statistics annealed by ``adapt_forget``; a detector that never
        trips serves 'none' bit for bit.  The refactorization and the
        anneal are conditional nodes of the captured round.
      * ``fused_infer``: serve the logits through K2 (default: on a CUDA
        device).
      * ``donate``: the reference donates the state buffers so XLA updates
        them in place.  The captured round updates the server's state in
        place whatever its value (the statistics with the same rounding,
        the factor through K3's ``out=``, the rest copied back at the end
        of each graph); the eager round replaces the state tree.

    Knobs with no effect in the port:

      * ``chunk_t``: the time-chunk size of the reference's Pallas grid, a
        TPU tiling knob; the CUDA kernels run each sample's whole time loop
        in one warp and have no chunks.

    ``attach_autotuner`` takes a ``runtime.autotuner.WarmPoolAutotuner``,
    which the server calls after each round.

    ``config='auto'`` fills ``refresh_mode``, ``refresh_cohorts``,
    ``step_block`` and ``chunk_t``, where the caller left them unset, from
    ``runtime.planner.Planner.search()`` (kept as ``self.plan``): the
    calibrated cost model of the server's device, measured once per device
    into ``.planner_calibration_torch.json``.  The planner does not see
    ``cfg.dtype``, as in the reference.

    ``cfg.dtype`` may be float32 or bfloat16.  A bf16 server keeps its
    state, its staged pool and its window batches in bf16, as the
    reference's; the kernels compute in fp32 and return bf16 (K3 folds a
    bf16 factor in fp32), and the int8 scales stay fp32.  bf16 needs
    ``refresh_mode='incremental'``: there is no bf16 Cholesky for the
    recompute refresh, in either package.

    ``devices=N`` (N > 1) splits the slots into N contiguous blocks of
    ``max_streams / N`` (which must divide), each served on its entry of a
    slot mesh: with ``device=None`` the first N CUDA devices (raising when
    fewer exist), and with an explicit ``device`` that device N times (the
    blocks then share it; the CPU tests and a one-card run use this).
    Needs ``staging='device'``, as in the reference.  Every knob above
    composes with it, and the episode is the ``devices=1`` episode
    (predictions, snapshots and final states), bit for bit where the batched
    library calls round alike for S/N and S slots (see the module
    docstring).  The admission writes a
    stream's payload on its owner's device only, and a pool growth regrows
    every block.  ``blocks`` holds the blocks; ``states``, ``win`` and
    ``pool`` are the one block's own tensors under ``devices=1`` and, under
    N blocks, every block's slots gathered onto ``device`` (a copy, for
    reading).  The planner of ``config='auto'`` takes ``devices`` as a
    constraint and plans for all ``max_streams`` slots, as the reference's.
    """

    def __init__(
        self,
        cfg: DFRConfig,
        t_max: int,
        max_streams: int = 8,
        window: int = 4,
        lr: float = 0.2,
        phase_steps: int = 8,
        refresh_every: int = 5,
        beta: float = 1e-2,
        mask=None,
        fused_infer: Optional[bool] = None,
        refresh_mode: Optional[str] = None,
        refresh_cohorts: Optional[int] = None,
        retirement: str = "none",
        forget: float = 1.0,
        retire_window: int = 0,
        adapt_forget: float = 0.12,
        adapt_ratio: float = 1.2,
        adapt_warmup: int = 4,
        staging: str = "device",
        pipeline_depth: int = 0,
        donate: bool = True,
        pool_capacity: Optional[int] = None,
        latency_window: int = 4096,
        devices: int = 1,
        quantize: str = "none",
        step_block: Optional[int] = None,
        chunk_t: Optional[int] = None,
        config: Optional[str] = None,
        device=None,
    ):
        if config not in (None, "auto"):
            raise ValueError(f"unknown config: {config!r} (None or 'auto')")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices!r}")
        if devices > 1:
            if staging != "device":
                raise ValueError(
                    "slot sharding (devices > 1) requires staging='device' "
                    "(the host-staged batch build uploads every step through "
                    "one device)")
            if max_streams % devices:
                raise ValueError(
                    f"max_streams={max_streams} must be divisible by "
                    f"devices={devices} (contiguous equal slot blocks)")
        self.devices = int(devices)
        self.mesh: Optional[SlotMesh] = None
        if self.devices > 1:
            self.mesh = make_slot_mesh(
                self.devices,
                devices=None if device is None else [device] * self.devices)
            self.device = self.mesh.devices[0]
        else:
            self.device = resolve_device(device, "StreamServer")
        # config='auto': the calibrated planner (runtime.planner) fills the
        # performance knobs left unset; explicit knobs win, and retirement,
        # quantize, staging and devices are constraints, never choices
        self.plan = None
        if config == "auto":
            self.plan = Planner(
                cfg.n_nodes, max_streams, window, t_max,
                n_classes=cfg.n_classes, refresh_every=refresh_every,
                retirement=retirement, quantize=quantize, staging=staging,
                device=self.device,
            ).search()
            if refresh_mode is None:
                refresh_mode = self.plan.refresh_mode
            if refresh_cohorts is None:
                refresh_cohorts = self.plan.refresh_cohorts
            if step_block is None:
                step_block = self.plan.step_block
            if chunk_t is None:
                chunk_t = self.plan.chunk_t
        refresh_mode = "recompute" if refresh_mode is None else refresh_mode
        if refresh_mode not in ("recompute", "incremental"):
            raise ValueError(f"unknown refresh_mode: {refresh_mode!r}")
        if retirement not in ("none", "forget", "window", "adaptive"):
            raise ValueError(f"unknown retirement: {retirement!r}")
        if retirement == "forget" and not 0.0 < forget <= 1.0:
            raise ValueError(f"forget must be in (0, 1], got {forget!r}")
        if retirement == "adaptive":
            if not 0.0 < adapt_forget <= 1.0:
                raise ValueError(
                    f"adapt_forget must be in (0, 1], got {adapt_forget!r}")
            if adapt_ratio <= 1.0:
                raise ValueError(
                    f"adapt_ratio must be > 1, got {adapt_ratio!r}")
            if adapt_warmup < 0:
                raise ValueError(
                    f"adapt_warmup must be >= 0, got {adapt_warmup!r}")
        if retirement == "window":
            if refresh_mode != "incremental":
                raise ValueError(
                    "retirement='window' needs refresh_mode='incremental' "
                    "(the eviction downdates a live factor)")
            if retire_window < 1:
                raise ValueError(
                    f"retirement='window' needs retire_window >= 1, got "
                    f"{retire_window!r}")
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize: {quantize!r}")
        step_block = 1 if step_block is None else step_block
        if step_block < 1:
            raise ValueError(f"step_block must be >= 1, got {step_block!r}")
        if pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {pipeline_depth!r}")
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"cfg.dtype must be float32 or bfloat16, got "
                             f"{cfg.dtype}")
        if cfg.dtype == torch.bfloat16 and refresh_mode == "recompute":
            raise ValueError(
                "a bfloat16 cfg.dtype needs refresh_mode='incremental': the "
                "recompute refresh factors B + beta I, and there is no bf16 "
                "Cholesky (the reference's XLA Cholesky refuses bf16 too, at "
                "its first refresh)")
        if staging not in ("device", "host"):
            raise ValueError(f"unknown staging: {staging!r}")
        if quantize == "int8" and staging != "device":
            raise ValueError(
                "quantize='int8' requires staging='device' (the scale fold "
                "rides the refresh of the device-staged step)")
        if step_block > 1 and staging != "device":
            raise ValueError(
                "step_block > 1 requires staging='device' (the blocked round "
                "gathers every sub-step's window from the staged pool)")
        if latency_window < 1:
            raise ValueError(
                f"latency_window must be >= 1, got {latency_window!r}")
        if chunk_t is not None and chunk_t < 1:
            raise ValueError(f"chunk_t must be None or >= 1, got {chunk_t!r}")
        del donate, chunk_t  # see the docstring

        self.cfg = cfg
        self.t_max = int(t_max)
        self.max_streams = int(max_streams)
        self.window = int(window)
        self.lr = torch.tensor(lr, dtype=cfg.dtype, device=self.device)
        self.phase_steps = int(phase_steps)
        self.refresh_every = int(refresh_every)
        self.beta = float(beta)
        self.refresh_mode = refresh_mode
        self.retirement = retirement
        # adaptive mode takes its fire-time lambda where forget takes its
        # lambda; 'none' and 'window' read neither
        self.retire = Retirement(
            mode=retirement,
            lam=torch.tensor(
                adapt_forget if retirement == "adaptive" else forget,
                dtype=cfg.dtype, device=self.device),
            beta=self.beta, ratio=float(adapt_ratio),
            warmup=int(adapt_warmup))
        self.retire_window = int(retire_window)
        self.quantize = quantize
        self.staging = staging
        self.pipeline_depth = int(pipeline_depth)
        self.step_block = int(step_block)
        self.cohorts = RefreshCohorts(
            self.max_streams, self.refresh_every,
            1 if refresh_cohorts is None else refresh_cohorts)
        on_card = self.device.type == "cuda"
        # on the card both forwards run through the hand-written kernels
        # (K1 for the serve step, K2 for the logits); on the CPU the
        # reference's off-TPU choices hold
        self.fused = on_card
        self.fused_infer = on_card if fused_infer is None else bool(
            fused_infer)
        if mask is None:
            mask = masking.make_mask(
                torch.Generator().manual_seed(cfg.mask_seed), cfg.n_nodes,
                cfg.n_in, cfg.dtype)
        if not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.array(mask))
        self.mask = mask.to(device=self.device, dtype=cfg.dtype)

        self.sched = SlotScheduler(self.max_streams)
        self.slot_pos = np.zeros(self.max_streams, np.int64)
        # host mirror of states.step: the train/frozen choice never syncs
        self._slot_steps = np.zeros(self.max_streams, np.int64)
        # incremental mode: admitted slots carry a live factor of the empty
        # system (sqrt(beta) I); every accumulated sample rotates it rank-1
        self._fresh_row = init_state(
            cfg, self.device,
            factor_beta=beta if refresh_mode == "incremental" else None)
        S, n_blk = self.max_streams, self.devices

        def stacked(tree):
            return map_leaves(lambda leaf: leaf.expand(S, *leaf.shape), tree)

        # every slot-batched tree split into the blocks by the sharding
        # rules: the slot axis leads every leaf, so each leaf splits
        mesh = self.mesh or make_slot_mesh(1, devices=[self.device])
        states = shard_blocks(stacked(self._fresh_row), slot_logical_axes(),
                              mesh)
        # window mode: each slot's ring of retained samples
        wins = [None] * n_blk
        if retirement == "window":
            wins = shard_blocks(
                stacked(WindowState.zeros(self.retire_window, cfg.s,
                                          cfg.n_classes, cfg.dtype,
                                          self.device)),
                WindowState.slot_axes(), mesh)
        pools = [None] * n_blk
        self._staged: Dict[int, Tuple] = {}
        if self.staging == "device":
            cap = self._round_capacity(pool_capacity or self.window)
            pools = shard_blocks(
                RequestPool.zeros(S, cap, self.t_max, cfg.n_in, cfg.dtype,
                                  self.device),
                RequestPool.slot_axes(), mesh)
        # the captured round on the card (None: the eager round)
        capture = on_card and self.staging == "device"
        self.blocks: List[_Block] = [
            _Block(self, d * (S // n_blk), S // n_blk, dev, states[d],
                   wins[d], pools[d], capture)
            for d, dev in enumerate(mesh.devices)]
        self._dispatches = 0
        # in flight: (host predictions a block, copy events, sub-steps, meta)
        self._inflight: Deque[Tuple] = deque()
        self._admitted_this_step: List[int] = []
        self.global_step = 0
        self._autotuner = None   # optional WarmPoolAutotuner
        self.served_int8 = 0   # predictions served from armed int8 slots
        self.step_times_s: Deque[float] = deque(maxlen=latency_window)
        self.dispatch_times_s: Deque[float] = deque(maxlen=latency_window)
        self.drain_times_s: Deque[float] = deque(maxlen=latency_window)

    # -- the blocks ----------------------------------------------------------

    def _gathered(self, name: str):
        trees = [getattr(blk, name) for blk in self.blocks]
        if len(trees) == 1 or trees[0] is None:
            return trees[0]
        return map_leaves(
            lambda *leaves: torch.cat([x.to(self.device) for x in leaves]),
            *trees)

    @property
    def states(self) -> OnlineState:
        """The slot-batched state (every slot's row; see the class
        docstring for several blocks)."""
        return self._gathered("states")

    @property
    def win(self) -> Optional[WindowState]:
        """The window mode's slot-batched rings (None in other modes)."""
        return self._gathered("win")

    @property
    def pool(self) -> Optional[RequestPool]:
        """The staged request pool (None under host staging)."""
        return self._gathered("pool")

    @property
    def _graphs(self) -> Optional[RoundGraphs]:
        """The first block's captured round (None: the eager round)."""
        return self.blocks[0].graphs

    @_graphs.setter
    def _graphs(self, graphs: Optional[RoundGraphs]) -> None:
        """Set the one block's round; with several blocks only None (every
        block eager), since each block captures its own graphs."""
        if graphs is not None and len(self.blocks) > 1:
            raise ValueError("each block needs its own RoundGraphs: set "
                             "blocks[d].graphs")
        for blk in self.blocks:
            blk.graphs = graphs

    def _owner(self, slot: int) -> Tuple["_Block", int]:
        """The block that holds global slot ``slot``, and its row there."""
        blk = self.blocks[slot // self.blocks[0].n]
        return blk, slot - blk.lo

    # -- request lifecycle -------------------------------------------------

    def _round_capacity(self, n: int) -> int:
        """Pool rows are window-aligned so cursor slices never clamp."""
        return max(self.window, -(-int(n) // self.window) * self.window)

    def _stage_request(self, req: StreamRequest) -> None:
        """Pad and upload the stream's full payload once, at submit (to
        ``device``; the admission copies it to its owner's block)."""
        cap = self._round_capacity(req.n_samples)
        if cap > self.blocks[0].pool.capacity:
            self._grow_pool(cap)
        cap = self.blocks[0].pool.capacity
        # numpy has no bf16: stage in float32 and round once on upload
        # (to nearest even, as the reference's ml_dtypes staging rounds)
        u = np.zeros((cap, self.t_max, self.cfg.n_in), np.float32)
        u[: req.n_samples] = req.u
        length = np.ones((cap,), np.int32)
        length[: req.n_samples] = req.length
        label = np.zeros((cap,), np.int32)
        label[: req.n_samples] = req.label
        dev = self.device
        self._staged[id(req)] = (
            torch.from_numpy(u).to(dev, self.cfg.dtype),
            torch.from_numpy(length).to(dev),
            torch.from_numpy(label).to(dev), req.n_samples, cap,
        )

    def _grow_pool(self, cap: int) -> None:
        """Grow every slot row of every block to ``cap`` samples (new
        longest stream), pad values matching the staging defaults.  The
        graphs captured the old pools' tensors, so they are captured
        again."""
        F = torch.nn.functional
        for blk in self.blocks:
            pad = cap - blk.pool.capacity
            blk.pool = RequestPool(
                u=F.pad(blk.pool.u, (0, 0, 0, 0, 0, pad)),
                length=F.pad(blk.pool.length, (0, pad), value=1),
                label=F.pad(blk.pool.label, (0, pad)),
                n=blk.pool.n,
            )
            if blk.graphs is not None:
                blk.graphs.reset()

    def attach_autotuner(self, tuner) -> None:
        """Attach a ``runtime.autotuner.WarmPoolAutotuner``: after every
        round the tuner applies the hyperparameter swaps due at a cohort
        refresh boundary, in place on the server's state, and (at its own
        low rate) runs one background (p, q, beta) tuning round.  A tuner
        that never swaps leaves the served episode unchanged, bit for
        bit."""
        if tuner.server is not self:
            raise ValueError("tuner was constructed for a different server")
        self._autotuner = tuner

    def submit(self, req: StreamRequest) -> None:
        if req.u.shape[1] != self.t_max:
            raise ValueError(
                f"stream {req.rid}: samples padded to T={req.u.shape[1]}, "
                f"server expects t_max={self.t_max}")
        req.submit_t = time.perf_counter()
        if self.staging == "device":
            self._stage_request(req)
        self.sched.submit(req)

    def _on_admit(self, i: int, req: StreamRequest) -> None:
        """Mark slot i for the fresh-state reset and write the staged
        payload into its pool row, on its block's device."""
        self.slot_pos[i] = 0
        self._slot_steps[i] = 0
        self._admitted_this_step.append(i)
        if self.staging == "device":
            blk, j = self._owner(i)
            staged = self._staged.pop(id(req), None)
            if staged is None or staged[4] != blk.pool.capacity:
                self._stage_request(req)  # the pool grew since submit
                staged = self._staged.pop(id(req))
            u, length, label, n, _ = staged
            with _on(blk.device):
                blk.pool.u[j] = u
                blk.pool.length[j] = length
                blk.pool.label[j] = label
                blk.pool.n[j] = n

    def _snapshot_row(self, i: int) -> OnlineState:
        """Copy of slot i's state (the retiring stream's final model), on
        its block's device."""
        blk, j = self._owner(i)
        with _on(blk.device):
            return map_leaves(lambda leaf: leaf[j].clone(), blk.states)

    def _refreshed(self, st: OnlineState, rows_t: Tensor, ok_t: Tensor,
                   live: Tensor) -> OnlineState:
        """Ridge refresh of slot rows ``rows_t`` on the post-step state ``st``
        (a batched Cholesky, or two triangular solves against the live
        factor in incremental mode); only live slots past phase 1 with
        accumulated samples (and ``ok_t`` rows) take the new readout -
        solving a zero-statistics system would wipe a trained W.  Under
        int8 the same rows fold their serving scales."""
        el = (ok_t & live[rows_t] & (st.step[rows_t] >= self.phase_steps)
              & (st.ridge.count[rows_t] > 0))
        if self.refresh_mode == "incremental":
            st = refresh_output_factor_rows(st, rows_t, el)
        else:
            st = refresh_output_rows(st, self.beta, rows_t, el)
        if self.quantize == "int8":
            st = fold_quant_rows(st, rows_t, el)
        return st

    # -- the serving loop --------------------------------------------------

    def step(self) -> None:
        """One dispatch: admit, advance every live slot one window (up to
        ``step_block`` windows), refreshing the due cohort after each, then
        book-keep at lag ``pipeline_depth``.

        Each round runs every block's round in turn.  The predictions enter
        the in-flight ring; entries deeper than ``pipeline_depth`` are read
        (the only blocking device read) and booked, so depth 0 is
        synchronous."""
        t_start = time.perf_counter()
        self._admitted_this_step.clear()
        self.sched.admit(self._on_admit)
        W = self.window
        live_np = np.zeros((self.max_streams,), bool)
        slots = self.sched.live()
        meta: List[Tuple] = []
        for i, req in slots:
            lo = int(self.slot_pos[i])
            live_np[i] = True
            meta.append((0, i, req, lo, min(W, req.n_samples - lo)))
        # step blocking: clamp the block so no live slot completes inside
        # it; blocks then end at every retirement boundary, so admissions
        # (the whole slot lifecycle) match the step_block=1 episode
        n_sub = 1
        if self.step_block > 1 and slots:
            n_sub = min([self.step_block] + [
                -(-(req.n_samples - lo) // W) for _, _, req, lo, _ in meta])
            for t in range(1, n_sub):
                for i, req in slots:
                    lo = int(self.slot_pos[i]) + t * W
                    meta.append((t, i, req, lo, min(W, req.n_samples - lo)))

        out_host = [blk.out_host[self._dispatches] for blk in self.blocks]
        ctl_host = [blk.ctl_host[self._dispatches] for blk in self.blocks]
        base = self.slot_pos.copy()
        for t in range(n_sub):
            cursor = base + t * W * live_np
            # one choice for every block: each block runs the round the
            # one-block server runs
            train = bool(np.any(live_np
                                & (self._slot_steps < self.phase_steps)))
            fresh = self._admitted_this_step if t == 0 else []
            self._slot_steps[live_np] += 1
            self.global_step += 1
            due, rows = self._due_rows(self.global_step)
            for d, blk in enumerate(self.blocks):
                sl = slice(blk.lo, blk.lo + blk.n)
                own = [i - blk.lo for i in fresh if blk.lo <= i < sl.stop]
                with _on(blk.device):
                    if blk.graphs is not None:
                        self._substep_graphs(blk, cursor[sl], live_np[sl],
                                             own, train, ctl_host[d][t],
                                             out_host[d][t], due, *rows[d])
                    else:
                        self._substep_eager(blk, cursor[sl], live_np[sl],
                                            own, train, meta, out_host[d][t],
                                            due, *rows[d])
            if self._autotuner is not None and t < n_sub - 1:
                # the tuner follows every round, so a blocked dispatch makes
                # the unblocked episode's swaps at the same steps; the clamp
                # keeps retirements at the block's end
                for tt, i, _req, lo, n in meta:
                    if tt == t:
                        self.slot_pos[i] = lo + n
                self._autotuner.on_step()
        events = []
        if self.device.type == "cuda":
            for dev in dict.fromkeys(blk.device for blk in self.blocks):
                with _on(dev):
                    events.append(torch.cuda.Event())
                    events[-1].record()

        # the slot lifecycle is cursor-driven, so retirement and refill
        # never wait on the predictions; meta is sub-step-major, so a slot
        # retires exactly at its block's end
        for _t, i, req, lo, n in meta:
            self.slot_pos[i] = lo + n
            if self.slot_pos[i] >= req.n_samples:
                req.final_state = self._snapshot_row(i)
                self.sched.retire(i)   # continuous batching: slot refills
        self._inflight.append((out_host, events, n_sub, meta))
        self._dispatches += 1
        if self._autotuner is not None:
            self._autotuner.on_step()
        self.dispatch_times_s.append(time.perf_counter() - t_start)
        while len(self._inflight) > self.pipeline_depth:
            self._drain_one()
        self.step_times_s.append(time.perf_counter() - t_start)

    def _due_rows(self, step: int) -> Tuple[bool, List[Tuple]]:
        """The refresh due after server step ``step``: (due, one (rows, ok)
        pair a block), fixed-shape and block-local under device staging,
        host staging's rows unpadded."""
        if self.staging != "device":
            due_slots = self.cohorts.due_slots(step)
            rows = np.asarray(due_slots or [], np.int32)
            return due_slots is not None, [(rows, np.ones(rows.shape, bool))]
        n = len(self.blocks)
        if n == 1:
            due, rows, ok = self.cohorts.due_rows_fixed(step)
            return due, [(rows, ok)]
        due, rows, ok = self.cohorts.due_rows_fixed_sharded(step, n)
        r = rows.shape[0] // n
        return due, [(rows[d * r:(d + 1) * r], ok[d * r:(d + 1) * r])
                     for d in range(n)]

    def _substep_eager(self, blk: "_Block", cursor: np.ndarray,
                       live_np: np.ndarray, fresh: List[int], train: bool,
                       meta: List[Tuple], out_host: Tensor, due: bool,
                       rows: np.ndarray, ok: np.ndarray) -> None:
        """One round of a block through the eager ``_step_core`` (the CPU,
        host staging, and the card's oracle for the captured round)."""
        W = self.window
        live = blk.cached_mask(live_np)
        fresh_rows = None
        if fresh:
            fresh_rows = torch.tensor(fresh, dtype=torch.int64,
                                      device=blk.device)
        if self.staging == "device":
            u, length, label, weight = _gather_window(
                blk.pool, torch.from_numpy(cursor).to(blk.device), live, W,
                self.cfg.dtype)
        else:
            # host staging: one block of every slot
            S = self.max_streams
            u = np.zeros((S, W, self.t_max, self.cfg.n_in), np.float32)
            length = np.ones((S, W), np.int32)  # dead samples: len 1, w 0
            label = np.zeros((S, W), np.int32)
            weight = np.zeros((S, W), np.float32)
            for _t, i, req, lo, n in meta:
                u[i, :n] = req.u[lo:lo + n]
                length[i, :n] = req.length[lo:lo + n]
                label[i, :n] = req.label[lo:lo + n]
                weight[i, :n] = 1.0
            u, length, label, weight = (
                torch.from_numpy(a).to(blk.device)
                for a in (u, length, label, weight))
            u, weight = u.to(self.cfg.dtype), weight.to(self.cfg.dtype)

        blk.states, preds, armed = _step_core(
            self.cfg, blk.mask, blk.states, blk.fresh, fresh_rows,
            u, length, label, weight, live, blk.lr, self.phase_steps,
            all_live=bool(live_np.all()), train=train,
            fused_infer=self.fused_infer, fused=self.fused,
            maintain_factor=self.refresh_mode == "incremental",
            quantize=self.quantize, retire=blk.retire, win=blk.win,
        )
        out = _served(preds, armed)
        out_host[:out.numel()].copy_(out, non_blocking=True)
        if due:
            blk.states = self._refreshed(
                blk.states, *blk.cached_rows(rows, ok), live)

    def _substep_graphs(self, blk: "_Block", cursor: np.ndarray,
                        live_np: np.ndarray, fresh: List[int], train: bool,
                        ctl_host: Tensor, out_host: Tensor, due: bool,
                        rows_np: np.ndarray, ok_np: np.ndarray) -> None:
        """One round of a block from its captured graphs: the control
        vector up, the admitted rows reset eagerly, the step graph, its
        predictions down, then the due cohort's refresh graph."""
        S, k = blk.n, len(fresh)
        ctl = ctl_host.numpy()
        ctl[:S] = cursor
        ctl[S:2 * S] = live_np
        ctl[2 * S:2 * S + k] = fresh
        blk.ctl.copy_(ctl_host, non_blocking=True)
        if k:
            # the admission reset writes whole (s, s) rows, so it stays out
            # of the fixed-shape graph: a select over all S rows would read
            # and write every slot's statistics each round
            rows = blk.ctl[2 * S:2 * S + k]
            map_leaves(lambda leaf, row: leaf.index_copy_(
                0, rows, row.expand(k, *row.shape)),
                blk.states, blk.fresh)
            if blk.win is not None:
                _reset_window_rows(blk.win, rows)
        all_live = bool(live_np.all())
        out = blk.graphs.run(("step", self.retirement, train, all_live),
                             lambda: self._step_body(blk, train, all_live))
        out_host[:out.numel()].copy_(out, non_blocking=True)
        if due:
            rows, ok = blk.cached_rows(rows_np, ok_np)
            blk.graphs.run(("refresh", rows_np.tobytes(), ok_np.tobytes()),
                           lambda: self._refresh_body(blk, rows, ok))

    def _step_body(self, blk: "_Block", train: bool,
                   all_live: bool) -> Tensor:
        """The captured step: gather, serve and train every slot of a block
        in place on its state; returns the served predictions (and
        flags)."""
        S = blk.n
        cursor, live = blk.ctl[:S], blk.ctl[S:2 * S] != 0
        u, length, label, weight = _gather_window(
            blk.pool, cursor, live, self.window, self.cfg.dtype)
        new, preds, armed = _step_core(
            self.cfg, blk.mask, blk.states, None, None, u, length, label,
            weight, live, blk.lr, self.phase_steps, all_live=all_live,
            train=train, fused_infer=self.fused_infer, fused=self.fused,
            maintain_factor=self.refresh_mode == "incremental",
            quantize=self.quantize, stats_in_place=True, retire=blk.retire,
            win=blk.win, graphs=blk.graphs,
        )
        _assign(blk.states, new)
        return _served(preds, armed)

    def _refresh_body(self, blk: "_Block", rows: Tensor, ok: Tensor) -> None:
        """The captured cohort refresh, in place on a block's state."""
        S = blk.n
        live = blk.ctl[S:2 * S] != 0
        _assign(blk.states, self._refreshed(blk.states, rows, ok, live))

    def _drain_one(self) -> None:
        """Read the oldest in-flight dispatch's predictions (the only
        blocking device read: its copies' events) and book them."""
        out_host, events, n_sub, meta = self._inflight.popleft()
        t0 = time.perf_counter()
        for event in events:
            event.synchronize()   # blocks: the served predictions
        self.drain_times_s.append(time.perf_counter() - t0)
        W = self.window
        preds, armed = [], []
        for blk, buf in zip(self.blocks, out_host):
            out = buf[:n_sub].numpy()
            preds.append(out[:, :blk.n * W].reshape(n_sub, blk.n, W))
            armed.append(out[:, blk.n * W:blk.n * (W + 1)])
        preds = np.concatenate(preds, axis=1)
        armed = np.concatenate(armed, axis=1)
        for t, i, req, lo, n in meta:
            if self.quantize == "int8" and armed[t, i]:
                self.served_int8 += n
            for k in range(n):
                pred = int(preds[t, i, k])
                req.preds.append(pred)
                req.correct += int(pred == int(req.label[lo + k]))
            if lo + n >= req.n_samples:
                req.done = True
                req.finish_t = time.perf_counter()

    def drain(self) -> None:
        """Flush the in-flight ring: read and book every dispatch's
        predictions (accuracy, completion flags).  Idempotent; called by
        ``run_until_drained``."""
        while self._inflight:
            self._drain_one()

    def run_until_drained(
        self, max_steps: int = 100000, strict: bool = False
    ) -> List[StreamRequest]:
        """Serve until every stream completes, then flush the pipeline.  A
        ``max_steps`` cut with streams still live or queued warns
        (``strict=True`` raises)."""
        steps = 0
        while self.sched.active() and steps < max_steps:
            self.step()
            steps += 1
        self.drain()
        if self.sched.active():
            undrained = len(self.sched.live()) + len(self.sched.queue)
            msg = (f"run_until_drained stopped at max_steps={max_steps} with "
                   f"{undrained} stream(s) still live or queued")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return self.sched.completed

    # -- diagnostics -------------------------------------------------------

    @property
    def completed(self) -> List[StreamRequest]:
        return self.sched.completed

    def latency_percentiles_ms(self) -> Dict[str, float]:
        """p50/p99 of the per-dispatch wall time (``p50_ms``/``p99_ms``, from
        ``step()`` entry to the end of whatever reading it did), of its
        non-blocking part up to the ring (``dispatch_*``: admission, control
        copies, launches or replays, bookkeeping) and of each blocking
        prediction read (``drain_*``, one record per drained dispatch, so a
        deep pipeline cannot hide the wait).  NaN where nothing was
        recorded."""
        out: Dict[str, float] = {}
        for prefix, rec in (("", self.step_times_s),
                            ("dispatch_", self.dispatch_times_s),
                            ("drain_", self.drain_times_s)):
            if rec:
                t = np.asarray(rec) * 1e3
                p50, p99 = (float(np.percentile(t, 50)),
                            float(np.percentile(t, 99)))
            else:
                p50 = p99 = float("nan")
            out[f"{prefix}p50_ms"] = p50
            out[f"{prefix}p99_ms"] = p99
        return out


def _served(preds: Tensor, armed: Optional[Tensor]) -> Tensor:
    """A round's served predictions (S * W), then its armed flags (S) under
    int8, as one int64 vector: one copy to the host."""
    if armed is None:
        return preds.reshape(-1)
    return torch.cat([preds.reshape(-1), armed.to(preds.dtype)])


def _on(device: torch.device):
    """Make a block's CUDA device current for its launches, captures and
    events (a kernel launches on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Block:
    """One contiguous block of a server's slots, ``[lo, lo + n)``, on one
    device: the slots' state, window rings and staged pool, the server's
    constants (the fresh row, mask, learning rate, retirement lambda) on
    that device, the round's captured graphs (``graphs``, None for the
    eager round), and the block's control and prediction buffers.  A
    ``devices=1`` server is one block of every slot."""

    def __init__(self, srv: StreamServer, lo: int, n: int,
                 device: torch.device, states: OnlineState,
                 win: Optional[WindowState], pool: Optional[RequestPool],
                 capture: bool):
        self.lo, self.n, self.device = lo, n, device
        self.states, self.win, self.pool = states, win, pool
        self.fresh = map_leaves(lambda leaf: leaf.to(device), srv._fresh_row)
        self.mask = srv.mask.to(device)
        self.lr = srv.lr.to(device)
        self.retire = dataclasses.replace(srv.retire,
                                          lam=srv.retire.lam.to(device))
        with _on(device):
            self.graphs: Optional[RoundGraphs] = (
                RoundGraphs() if capture else None)
        ring, W = srv.pipeline_depth + 1, srv.window
        # the captured round's control vector per sub-step: cursors, the
        # live mask, then the admitted rows
        self.ctl = torch.zeros((3 * n,), dtype=torch.int64, device=device)
        self.ctl_host = PinnedRing(ring, (srv.step_block, 3 * n),
                                   torch.int64, device)
        # predictions (n * W) then the armed flags (n) of each sub-step
        self.out_host = PinnedRing(ring, (srv.step_block, n * W + n),
                                   torch.int64, device)
        self._mask_cache: Dict[bytes, Tensor] = {}
        self._rows_cache: Dict[bytes, Tuple[Tensor, Tensor]] = {}

    def cached_mask(self, mask_np: np.ndarray) -> Tensor:
        """Device copy of a small (n,) bool control mask, cached by
        value."""
        key = mask_np.tobytes()
        hit = self._mask_cache.get(key)
        if hit is None:
            if len(self._mask_cache) > 64:   # bounded (masks cycle)
                self._mask_cache.clear()
            hit = self._mask_cache[key] = torch.from_numpy(
                mask_np.copy()).to(self.device)
        return hit

    def cached_rows(self, rows: np.ndarray,
                    ok: np.ndarray) -> Tuple[Tensor, Tensor]:
        """Device copies of a refresh cohort's block-local rows and flags
        (one per refresh phase), kept for the life of the server: a
        captured refresh reads them at every replay."""
        key = rows.tobytes() + ok.tobytes()
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = self._rows_cache[key] = (
                torch.from_numpy(rows.astype(np.int64)).to(self.device),
                torch.from_numpy(ok.copy()).to(self.device))
        return hit
