"""Continuous-batching stream server: train-while-serve for sensor streams.

The PyTorch counterpart of ``repro.runtime.stream_server`` on its default
fp32 path.  Many independent sensor streams each get an online DFR that
(a) answers every window from the parameters it had before seeing the
labels (infer-before-update) and (b) keeps adapting: truncated-BP SGD on
(p, q, W, b) while the slot is young (phase 1), then frozen-reservoir (A, B)
accumulation with a Ridge refresh of the readout every ``refresh_every``
server steps (phase 2).  A fixed number of slots holds one stream each as
row i of a slot-batched ``OnlineState``; one step advances every live slot.

On a CUDA device one server step launches each hand-written kernel once for
all slots: K1 (``kernels/csrc/train.cu``) for the shared training forward
and K2 (``kernels/csrc/streaming.cu``) for the infer-before-update logits.
On the CPU the step keeps the reference's off-TPU choices: the plain
forward, and the serve step's own logits unless ``fused_infer=True``.

The host keeps a mirror of every slot's step count, so choosing between the
training and the frozen step never waits for the device; the one blocking
read per step is the predictions.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import masking
from repro_torch.core.online import (OnlineState, init_state,
                                     online_serve_step, refresh_output_rows)
from repro_torch.core.types import (DFRConfig, RequestPool, Tensor,
                                    map_leaves)
from repro_torch.kernels import ops
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


def _step_core(
    cfg: DFRConfig,
    mask: Tensor,
    states: OnlineState,        # leading slot axis S on every leaf
    fresh: OnlineState,         # single-system state: admission reset
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
) -> Tuple[OnlineState, Tensor, Dict[str, Tensor]]:
    """One server step: infer-before-update + train for every live slot.

    Returns (new states, predictions (S, W), per-slot metrics).  Admitted
    slots start from ``fresh``; dead slots compute in their lanes and are
    frozen by ``live`` (skipped when the host knows ``all_live``).

    ``train`` picks the training or the frozen serve step: whether any live
    slot is still in phase 1.  The reference decides that on the device;
    here the caller answers from its host mirror of the slot steps, so the
    step never waits for the device.

    K2, when ``fused_infer`` is set, reads the PRE-update, post-admission
    parameters: the infer-before-update contract.
    """
    f = cfg.f()
    if fresh_rows is not None:
        k = fresh_rows.shape[0]
        states = map_leaves(
            lambda batched, single: batched.index_copy(
                0, fresh_rows, single.expand(k, *single.shape)),
            states, fresh)

    # per-slot learning-rate phase: adapt (p, q, W, b) while the slot is
    # young, then freeze the reservoir; (A, B) accumulate only when frozen
    in_phase1 = states.step < phase_steps
    lr_slot = torch.where(in_phase1, lr, 0.0).to(cfg.dtype)
    acc_slot = torch.where(in_phase1, 0.0, 1.0).to(cfg.dtype)

    new_states, logits, metrics = online_serve_step(
        cfg, mask, states, u, length, label, lr_slot, weight, acc_slot,
        train=train, fused=fused,
    )
    if fused_infer:
        j_seq = masking.apply_mask(mask, u)
        logits = ops.streaming_logits_slots(
            j_seq, length, states.params.p, states.params.q,
            states.params.W, states.params.b, f,
        )
    preds = logits.argmax(dim=-1)

    if not all_live:
        new_states = map_leaves(
            lambda n, o: torch.where(_bcast_to(live, n), n, o),
            new_states, states)
    return new_states, preds, metrics


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


def _unported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to PyTorch yet: see ROADMAP.md, Queue 1, "
        f"'{item}'")


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
      * ``staging='device'`` (default): each stream's payload is uploaded
        once and windows are gathered on the device by cursor; the refresh
        runs inside ``step``.  ``'host'`` builds and uploads each window
        batch on the host and refreshes after the step.  Both serve the
        same episode.
      * ``fused_infer``: serve the logits through K2 (default: on a CUDA
        device).

    Knobs with no effect in the port:

      * ``donate``: JAX donates the state buffers so XLA can update them in
        place; PyTorch has no donation, and the server replaces its state
        tree every step while the caching allocator hands the freed
        buffers to the next step, so there is nothing to donate.
      * ``chunk_t``: the time-chunk size of the reference's Pallas grid, a
        TPU tiling knob; the CUDA kernels run each sample's whole time loop
        in one warp and have no chunks.

    Not ported yet, each raising ``NotImplementedError`` that names its
    ROADMAP item: ``refresh_mode='incremental'``, ``retirement`` other than
    'none', ``quantize='int8'``, ``step_block > 1``, ``pipeline_depth > 0``,
    ``devices > 1``, ``config='auto'``, ``attach_autotuner`` and a
    non-float32 ``cfg.dtype``; the reference's retirement and quantization
    parameters (``forget``, ``retire_window``, ``adapt_*``) come with them.
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
            raise _unported("config='auto'", "Planner")
        refresh_mode = "recompute" if refresh_mode is None else refresh_mode
        if refresh_mode not in ("recompute", "incremental"):
            raise ValueError(f"unknown refresh_mode: {refresh_mode!r}")
        if refresh_mode == "incremental":
            raise _unported("refresh_mode='incremental'",
                            "Incremental refresh")
        if retirement not in ("none", "forget", "window", "adaptive"):
            raise ValueError(f"unknown retirement: {retirement!r}")
        if retirement != "none":
            raise _unported(f"retirement={retirement!r}", "Retirement modes")
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize: {quantize!r}")
        if quantize == "int8":
            raise _unported("quantize='int8'", "Int8 serving")
        step_block = 1 if step_block is None else step_block
        if step_block < 1:
            raise ValueError(f"step_block must be >= 1, got {step_block!r}")
        if step_block > 1:
            raise _unported("step_block > 1", "Pipelining and step blocking")
        if pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {pipeline_depth!r}")
        if pipeline_depth > 0:
            raise _unported("pipeline_depth > 0",
                            "Pipelining and step blocking")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices!r}")
        if devices > 1:
            raise _unported("devices > 1", "Multi-device")
        if cfg.dtype != torch.float32:
            raise _unported(f"cfg.dtype={cfg.dtype}", "bf16")
        if staging not in ("device", "host"):
            raise ValueError(f"unknown staging: {staging!r}")
        if latency_window < 1:
            raise ValueError(
                f"latency_window must be >= 1, got {latency_window!r}")
        if chunk_t is not None and chunk_t < 1:
            raise ValueError(f"chunk_t must be None or >= 1, got {chunk_t!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StreamServer runs on the CUDA device by default and "
                    "this host has none; pass device='cpu' to run on the "
                    "CPU")
            device = "cuda"
        self.device = torch.device(device)
        del donate, chunk_t  # no effect in the port (see the docstring)

        self.cfg = cfg
        self.t_max = int(t_max)
        self.max_streams = int(max_streams)
        self.window = int(window)
        self.lr = torch.tensor(lr, dtype=cfg.dtype, device=self.device)
        self.phase_steps = int(phase_steps)
        self.refresh_every = int(refresh_every)
        self.beta = float(beta)
        self.staging = staging
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
        self._fresh_row = init_state(cfg, self.device)
        self.states: OnlineState = map_leaves(
            lambda leaf: leaf.expand(self.max_streams, *leaf.shape).clone(),
            self._fresh_row)
        self.pool: Optional[RequestPool] = None
        self._staged: Dict[int, Tuple] = {}
        if self.staging == "device":
            cap = self._round_capacity(pool_capacity or self.window)
            self.pool = RequestPool.zeros(
                self.max_streams, cap, self.t_max, cfg.n_in, cfg.dtype,
                self.device)
        self._admitted_this_step: List[int] = []
        self._mask_cache: Dict[bytes, Tensor] = {}
        self._rows_cache: Dict[bytes, Tuple[Tensor, Tensor]] = {}
        self.global_step = 0
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
        values matching the staging defaults."""
        pad = cap - self.pool.capacity
        F = torch.nn.functional
        self.pool = RequestPool(
            u=F.pad(self.pool.u, (0, 0, 0, 0, 0, pad)),
            length=F.pad(self.pool.length, (0, pad), value=1),
            label=F.pad(self.pool.label, (0, pad)),
            n=self.pool.n,
        )

    def attach_autotuner(self, tuner) -> None:
        raise _unported("attach_autotuner", "Autotuner")

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

    def _refresh(self, rows: np.ndarray, ok: np.ndarray,
                 live: Tensor) -> None:
        """Recompute-mode Ridge refresh of slot rows ``rows`` on the
        post-step state; only live slots past phase 1 with accumulated
        samples (and ``ok`` rows) take the new readout - solving a
        zero-statistics system would wipe a trained W."""
        key = rows.tobytes() + ok.tobytes()
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = self._rows_cache[key] = (
                torch.from_numpy(rows.astype(np.int64)).to(self.device),
                torch.from_numpy(ok.copy()).to(self.device))
        rows_t, ok_t = hit
        st = self.states
        el = (ok_t & live[rows_t] & (st.step[rows_t] >= self.phase_steps)
              & (st.ridge.count[rows_t] > 0))
        self.states = refresh_output_rows(st, self.beta, rows_t, el)

    # -- the serving loop --------------------------------------------------

    def step(self) -> None:
        """One global step: admit, advance every live slot one window,
        refresh the due cohort, then read the predictions back (the one
        blocking device read) and book-keep."""
        t_start = time.perf_counter()
        self._admitted_this_step.clear()
        self.sched.admit(self._on_admit)
        S, W = self.max_streams, self.window
        live_np = np.zeros((S,), bool)
        meta: List[Tuple] = []
        for i, req in self.sched.live():
            lo = int(self.slot_pos[i])
            n = min(W, req.n_samples - lo)
            live_np[i] = True
            meta.append((i, req, lo, n))
        live = self._cached_mask(live_np)
        fresh_rows = None
        if self._admitted_this_step:
            fresh_rows = torch.tensor(self._admitted_this_step,
                                      dtype=torch.int64, device=self.device)
        train = bool(np.any(live_np & (self._slot_steps < self.phase_steps)))

        if self.staging == "device":
            cursor = torch.from_numpy(self.slot_pos.copy()).to(self.device)
            u, length, label, weight = _gather_window(
                self.pool, cursor, live, W, self.cfg.dtype)
        else:
            u = np.zeros((S, W, self.t_max, self.cfg.n_in), np.float32)
            length = np.ones((S, W), np.int32)  # dead samples: len 1, w 0
            label = np.zeros((S, W), np.int32)
            weight = np.zeros((S, W), np.float32)
            for i, req, lo, n in meta:
                u[i, :n] = req.u[lo:lo + n]
                length[i, :n] = req.length[lo:lo + n]
                label[i, :n] = req.label[lo:lo + n]
                weight[i, :n] = 1.0
            u, length, label, weight = (
                torch.from_numpy(a).to(self.device)
                for a in (u, length, label, weight))

        self.states, preds, _ = _step_core(
            self.cfg, self.mask, self.states, self._fresh_row, fresh_rows,
            u, length, label, weight, live, self.lr, self.phase_steps,
            all_live=bool(live_np.all()), train=train,
            fused_infer=self.fused_infer, fused=self.fused,
        )
        self._slot_steps[live_np] += 1
        self.global_step += 1
        if self.staging == "device":
            due, rows, ok = self.cohorts.due_rows_fixed(self.global_step)
            if due:
                self._refresh(rows, ok, live)
        else:
            due_slots = self.cohorts.due_slots(self.global_step)
            if due_slots is not None:
                rows = np.asarray(due_slots, np.int32)
                self._refresh(rows, np.ones(rows.shape, bool), live)

        # the slot lifecycle is cursor-driven, so retirement and refill
        # never wait on the predictions
        for i, req, lo, n in meta:
            self.slot_pos[i] += n
            if self.slot_pos[i] >= req.n_samples:
                req.final_state = self._snapshot_row(i)
                self.sched.retire(i)   # continuous batching: slot refills
        self.dispatch_times_s.append(time.perf_counter() - t_start)

        t0 = time.perf_counter()
        preds_np = preds.cpu().numpy()   # blocks: the served predictions
        self.drain_times_s.append(time.perf_counter() - t0)
        for i, req, lo, n in meta:
            for k in range(n):
                pred = int(preds_np[i, k])
                req.preds.append(pred)
                req.correct += int(pred == int(req.label[lo + k]))
            if lo + n >= req.n_samples:
                req.done = True
                req.finish_t = time.perf_counter()
        self.step_times_s.append(time.perf_counter() - t_start)

    def drain(self) -> None:
        """Predictions are read back inside ``step``; nothing is in flight
        (``pipeline_depth`` is 0).  Kept for the reference's interface."""

    def run_until_drained(
        self, max_steps: int = 100000, strict: bool = False
    ) -> List[StreamRequest]:
        """Serve until every stream completes.  A ``max_steps`` cut with
        streams still live or queued warns (``strict=True`` raises)."""
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
        """p50/p99 of the per-step wall time (``p50_ms``/``p99_ms``, from
        ``step()`` entry to the end of its bookkeeping), of its
        non-blocking part up to the prediction read (``dispatch_*``) and of
        that blocking read (``drain_*``).  NaN where nothing was recorded."""
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
