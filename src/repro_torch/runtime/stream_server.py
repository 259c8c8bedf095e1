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
"""
from __future__ import annotations

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
                                     refresh_output_rows)
from repro_torch.core.types import (DFRConfig, RequestPool, RidgeState,
                                    Tensor, WindowState, map_leaves,
                                    resolve_device, unported)
from repro_torch.kernels import ops
from repro_torch.runtime.graphs import PinnedRing, RoundGraphs, run_if
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
        ``staging='device'``, as in the reference.
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

    Not ported yet, each raising ``NotImplementedError`` that names its
    ROADMAP item: ``devices > 1``, ``config='auto'``, ``attach_autotuner``
    and a non-float32 ``cfg.dtype``.
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
        if config == "auto":
            raise unported("config='auto'", "Planner")
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
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices!r}")
        if devices > 1:
            raise unported("devices > 1", "Multi-device")
        if cfg.dtype != torch.float32:
            raise unported(f"cfg.dtype={cfg.dtype}", "bf16")
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
        self.device = resolve_device(device, "StreamServer")
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
        self.states: OnlineState = map_leaves(
            lambda leaf: leaf.expand(self.max_streams, *leaf.shape).clone(),
            self._fresh_row)
        # window mode: each slot's ring of retained samples
        self.win: Optional[WindowState] = None
        if retirement == "window":
            self.win = map_leaves(
                lambda leaf: leaf.expand(self.max_streams,
                                         *leaf.shape).clone(),
                WindowState.zeros(self.retire_window, cfg.s, cfg.n_classes,
                                  cfg.dtype, self.device))
        self.pool: Optional[RequestPool] = None
        self._staged: Dict[int, Tuple] = {}
        if self.staging == "device":
            cap = self._round_capacity(pool_capacity or self.window)
            self.pool = RequestPool.zeros(
                self.max_streams, cap, self.t_max, cfg.n_in, cfg.dtype,
                self.device)
        S, W, ring = self.max_streams, self.window, self.pipeline_depth + 1
        # the captured round (None: the eager round).  Its control vector
        # per sub-step: cursors, the live mask, then the admitted rows
        self._graphs: Optional[RoundGraphs] = (
            RoundGraphs() if on_card and self.staging == "device" else None)
        self._ctl = torch.zeros((3 * S,), dtype=torch.int64,
                                device=self.device)
        self._ctl_host = PinnedRing(ring, (self.step_block, 3 * S),
                                    torch.int64, self.device)
        # predictions (S * W) then the armed flags (S) of each sub-step
        self._out_host = PinnedRing(ring, (self.step_block, S * W + S),
                                    torch.int64, self.device)
        self._dispatches = 0
        # in flight: (host predictions, copy event, sub-steps, meta)
        self._inflight: Deque[Tuple] = deque()
        self._admitted_this_step: List[int] = []
        self._mask_cache: Dict[bytes, Tensor] = {}
        self._rows_cache: Dict[bytes, Tuple[Tensor, Tensor]] = {}
        self.global_step = 0
        self.served_int8 = 0   # predictions served from armed int8 slots
        self.step_times_s: Deque[float] = deque(maxlen=latency_window)
        self.dispatch_times_s: Deque[float] = deque(maxlen=latency_window)
        self.drain_times_s: Deque[float] = deque(maxlen=latency_window)

    # -- request lifecycle -------------------------------------------------

    def _round_capacity(self, n: int) -> int:
        """Pool rows are window-aligned so cursor slices never clamp."""
        return max(self.window, -(-int(n) // self.window) * self.window)

    def _stage_request(self, req: StreamRequest) -> None:
        """Pad and upload the stream's full payload once, at submit."""
        cap = self._round_capacity(req.n_samples)
        if cap > self.pool.capacity:
            self._grow_pool(cap)
        cap = self.pool.capacity
        u = np.zeros((cap, self.t_max, self.cfg.n_in), np.float32)
        u[: req.n_samples] = req.u
        length = np.ones((cap,), np.int32)
        length[: req.n_samples] = req.length
        label = np.zeros((cap,), np.int32)
        label[: req.n_samples] = req.label
        dev = self.device
        self._staged[id(req)] = (
            torch.from_numpy(u).to(dev), torch.from_numpy(length).to(dev),
            torch.from_numpy(label).to(dev), req.n_samples, cap,
        )

    def _grow_pool(self, cap: int) -> None:
        """Grow every slot row to ``cap`` samples (new longest stream), pad
        values matching the staging defaults.  The graphs captured the old
        pool's tensors, so they are captured again."""
        pad = cap - self.pool.capacity
        F = torch.nn.functional
        self.pool = RequestPool(
            u=F.pad(self.pool.u, (0, 0, 0, 0, 0, pad)),
            length=F.pad(self.pool.length, (0, pad), value=1),
            label=F.pad(self.pool.label, (0, pad)),
            n=self.pool.n,
        )
        if self._graphs is not None:
            self._graphs.reset()

    def attach_autotuner(self, tuner) -> None:
        raise unported("attach_autotuner", "Autotuner")

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
        payload into its pool row."""
        self.slot_pos[i] = 0
        self._slot_steps[i] = 0
        self._admitted_this_step.append(i)
        if self.staging == "device":
            staged = self._staged.pop(id(req), None)
            if staged is None or staged[4] != self.pool.capacity:
                self._stage_request(req)  # the pool grew since submit
                staged = self._staged.pop(id(req))
            u, length, label, n, _ = staged
            self.pool.u[i] = u
            self.pool.length[i] = length
            self.pool.label[i] = label
            self.pool.n[i] = n

    def _snapshot_row(self, i: int) -> OnlineState:
        """Copy of slot i's state (the retiring stream's final model)."""
        return map_leaves(lambda leaf: leaf[i].clone(), self.states)

    def _cached_mask(self, mask_np: np.ndarray) -> Tensor:
        """Device copy of a small (S,) bool control mask, cached by value."""
        key = mask_np.tobytes()
        hit = self._mask_cache.get(key)
        if hit is None:
            if len(self._mask_cache) > 64:   # bounded (masks cycle)
                self._mask_cache.clear()
            hit = self._mask_cache[key] = torch.from_numpy(
                mask_np.copy()).to(self.device)
        return hit

    def _cached_rows(self, rows: np.ndarray,
                     ok: np.ndarray) -> Tuple[Tensor, Tensor]:
        """Device copies of a refresh cohort's rows and flags (one per
        refresh phase), kept for the life of the server: a captured refresh
        reads them at every replay."""
        key = rows.tobytes() + ok.tobytes()
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = self._rows_cache[key] = (
                torch.from_numpy(rows.astype(np.int64)).to(self.device),
                torch.from_numpy(ok.copy()).to(self.device))
        return hit

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

        The predictions enter the in-flight ring; entries deeper than
        ``pipeline_depth`` are read (the only blocking device read) and
        booked, so depth 0 is synchronous."""
        t_start = time.perf_counter()
        self._admitted_this_step.clear()
        self.sched.admit(self._on_admit)
        S, W = self.max_streams, self.window
        live_np = np.zeros((S,), bool)
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

        out_host = self._out_host[self._dispatches]
        ctl_host = self._ctl_host[self._dispatches]
        for t in range(n_sub):
            cursor = self.slot_pos + t * W * live_np
            train = bool(np.any(live_np
                                & (self._slot_steps < self.phase_steps)))
            fresh = self._admitted_this_step if t == 0 else []
            if self._graphs is not None:
                self._substep_graphs(cursor, live_np, fresh, train,
                                     ctl_host[t], out_host[t])
            else:
                self._substep_eager(cursor, live_np, fresh, train, meta,
                                    out_host[t])
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()

        # the slot lifecycle is cursor-driven, so retirement and refill
        # never wait on the predictions; meta is sub-step-major, so a slot
        # retires exactly at its block's end
        for _t, i, req, lo, n in meta:
            self.slot_pos[i] += n
            if self.slot_pos[i] >= req.n_samples:
                req.final_state = self._snapshot_row(i)
                self.sched.retire(i)   # continuous batching: slot refills
        self._inflight.append((out_host, event, n_sub, meta))
        self._dispatches += 1
        self.dispatch_times_s.append(time.perf_counter() - t_start)
        while len(self._inflight) > self.pipeline_depth:
            self._drain_one()
        self.step_times_s.append(time.perf_counter() - t_start)

    def _after_step(self, live_np: np.ndarray) -> Tuple[bool, np.ndarray,
                                                        np.ndarray]:
        """Advance the step counters; return the refresh due after this
        step as fixed-shape (due, rows, ok), host staging's rows unpadded."""
        self._slot_steps[live_np] += 1
        self.global_step += 1
        if self.staging == "device":
            return self.cohorts.due_rows_fixed(self.global_step)
        due_slots = self.cohorts.due_slots(self.global_step)
        rows = np.asarray(due_slots or [], np.int32)
        return due_slots is not None, rows, np.ones(rows.shape, bool)

    def _substep_eager(self, cursor: np.ndarray, live_np: np.ndarray,
                       fresh: List[int], train: bool, meta: List[Tuple],
                       out_host: Tensor) -> None:
        """One round through the eager ``_step_core`` (the CPU, host
        staging, and the card's oracle for the captured round)."""
        S, W = self.max_streams, self.window
        live = self._cached_mask(live_np)
        fresh_rows = None
        if fresh:
            fresh_rows = torch.tensor(fresh, dtype=torch.int64,
                                      device=self.device)
        if self.staging == "device":
            u, length, label, weight = _gather_window(
                self.pool, torch.from_numpy(cursor).to(self.device), live, W,
                self.cfg.dtype)
        else:
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
                torch.from_numpy(a).to(self.device)
                for a in (u, length, label, weight))

        self.states, preds, armed = _step_core(
            self.cfg, self.mask, self.states, self._fresh_row, fresh_rows,
            u, length, label, weight, live, self.lr, self.phase_steps,
            all_live=bool(live_np.all()), train=train,
            fused_infer=self.fused_infer, fused=self.fused,
            maintain_factor=self.refresh_mode == "incremental",
            quantize=self.quantize, retire=self.retire, win=self.win,
        )
        out = _served(preds, armed)
        out_host[:out.numel()].copy_(out, non_blocking=True)
        due, rows, ok = self._after_step(live_np)
        if due:
            self.states = self._refreshed(
                self.states, *self._cached_rows(rows, ok), live)

    def _substep_graphs(self, cursor: np.ndarray, live_np: np.ndarray,
                        fresh: List[int], train: bool, ctl_host: Tensor,
                        out_host: Tensor) -> None:
        """One round from the captured graphs: the control vector up, the
        admitted rows reset eagerly, the step graph, its predictions down,
        then the due cohort's refresh graph."""
        S, k = self.max_streams, len(fresh)
        ctl = ctl_host.numpy()
        ctl[:S] = cursor
        ctl[S:2 * S] = live_np
        ctl[2 * S:2 * S + k] = fresh
        self._ctl.copy_(ctl_host, non_blocking=True)
        if k:
            # the admission reset writes whole (s, s) rows, so it stays out
            # of the fixed-shape graph: a select over all S rows would read
            # and write every slot's statistics each round
            rows = self._ctl[2 * S:2 * S + k]
            map_leaves(lambda leaf, row: leaf.index_copy_(
                0, rows, row.expand(k, *row.shape)),
                self.states, self._fresh_row)
            if self.win is not None:
                _reset_window_rows(self.win, rows)
        all_live = bool(live_np.all())
        out = self._graphs.run(("step", self.retirement, train, all_live),
                               lambda: self._step_body(train, all_live))
        out_host[:out.numel()].copy_(out, non_blocking=True)
        due, rows_np, ok_np = self._after_step(live_np)
        if due:
            rows, ok = self._cached_rows(rows_np, ok_np)
            self._graphs.run(("refresh", rows_np.tobytes(), ok_np.tobytes()),
                             lambda: self._refresh_body(rows, ok))

    def _step_body(self, train: bool, all_live: bool) -> Tensor:
        """The captured step: gather, serve and train every slot in place
        on ``self.states``; returns the served predictions (and flags)."""
        S = self.max_streams
        cursor, live = self._ctl[:S], self._ctl[S:2 * S] != 0
        u, length, label, weight = _gather_window(
            self.pool, cursor, live, self.window, self.cfg.dtype)
        new, preds, armed = _step_core(
            self.cfg, self.mask, self.states, None, None, u, length, label,
            weight, live, self.lr, self.phase_steps, all_live=all_live,
            train=train, fused_infer=self.fused_infer, fused=self.fused,
            maintain_factor=self.refresh_mode == "incremental",
            quantize=self.quantize, stats_in_place=True, retire=self.retire,
            win=self.win, graphs=self._graphs,
        )
        _assign(self.states, new)
        return _served(preds, armed)

    def _refresh_body(self, rows: Tensor, ok: Tensor) -> None:
        """The captured cohort refresh, in place on ``self.states``."""
        S = self.max_streams
        live = self._ctl[S:2 * S] != 0
        _assign(self.states, self._refreshed(self.states, rows, ok, live))

    def _drain_one(self) -> None:
        """Read the oldest in-flight dispatch's predictions (the only
        blocking device read: its copy's event) and book them."""
        out_host, event, n_sub, meta = self._inflight.popleft()
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()   # blocks: the served predictions
        self.drain_times_s.append(time.perf_counter() - t0)
        S, W = self.max_streams, self.window
        out = out_host[:n_sub].numpy()
        preds, armed = out[:, :S * W].reshape(n_sub, S, W), out[:, S * W:]
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
