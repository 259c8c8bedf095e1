"""Calibrated analytical cost-model planner for the stream server, in PyTorch.

The counterpart of ``repro.runtime.planner``, with the same names and the
same formula.  A small analytical model - per-primitive coefficients times
exact work counts - prices one serving round for each setting of the
performance knobs, and a search over the feasible knob lattice returns the
predicted-best ``Plan``:

* **Calibration** (``calibrate``): a short one-time run times seven
  primitives on this device - the host cost of one dispatch of a served
  round, a dot FLOP, a device-memory byte, a factor-fold rotation element,
  a triangular-substitution element, a Cholesky element, a quant/requant
  element - each divided by the work count of its own call, so the
  coefficients are seconds per unit of work.  The result persists to a
  small JSON file (env ``REPRO_TORCH_PLANNER_CAL``, default
  ``.planner_calibration_torch.json`` in the working directory), keyed by a
  fingerprint of the device and host, so later servers skip the
  measurement.  The file is the port's own: the reference's
  ``.planner_calibration.json`` carries another fingerprint, and the two
  would overwrite each other.

* **The cost model** (``predict_step_cost``): per served sample, term for
  term the reference's: (a) the serving-logits work of one round
  (``program_cost``: K2's, plus K5's under int8, from
  ``launch.kernel_cost``), (b) the (A, B) accumulation, (c) the refresh
  mode's maintenance (incremental: W rank-1 rotation sweeps of s^2 a slot
  and the triangular solves; recompute: s^3 / 3 Cholesky elements a slot a
  refresh round), (d) window retirement's extras, and (e) the dispatch cost
  amortized over ``step_block`` rounds.

* **The search** (``Planner.search``): the feasible (refresh_mode x
  cohorts x step_block x chunk_t) lattice, minus what the server rejects;
  the first argmin wins.  The port ignores ``chunk_t`` (its kernels run a
  sample's whole time loop), so the lattice holds ``chunk_t=None`` only
  unless the caller names others.

Where the port differs from the reference:

* the work counts are analytic (``launch.kernel_cost``), not read from a
  lowered XLA program: ``FlopCounterMode`` sees aten ops only, not the
  kernels' calls;
* the primitives are the port's own, timed on a CUDA device with CUDA
  events after a warm-up (on the CPU with the host clock), and at the
  paper's serving shape on the card (Nx = 30, s = 931, 32 slots, windows of
  4): K3's fold, ``ridge_solve_from_factor_t_batched``, the recompute
  refresh as the server captures it (``ridge_cholesky_batched`` of
  ``regularize``), one ``torch.matmul``, an elementwise pass beyond L2, the
  int8 round-and-clip.  Device times bracket device work only, so the
  dispatch constant is not subtracted from them, as the reference
  subtracts it from its host-timed programs;
* ``c_dispatch`` is the wall time of one ``StreamServer.step()`` of a tiny
  device-staged server (one slot, windows of 1, Nx = 4): on the card one
  captured round's graph replays, its control copies, the prediction read
  and the Python around them.  A near-empty kernel launch would underprice
  it, and it decides ``step_block``.

``StreamServer(..., config='auto')`` fills its unset knobs from
``Planner.search()``; explicit knobs win.  ``replay_bench_tables`` replays
a ``BENCH_stream_quant.json`` table and flags a shape where the planner's
pick measured more than ``GATE_RATIO`` (1.3x) below the best.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import platform
import statistics
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch import kernel_cost

CAL_SCHEMA = 1
CAL_ENV = "REPRO_TORCH_PLANNER_CAL"
DEFAULT_CAL_FILE = ".planner_calibration_torch.json"

#: the validation gate: the planner's pick must be within this factor of
#: the measured best for every measured shape
GATE_RATIO = 1.3


# ---------------------------------------------------------------------------
# Calibration: per-primitive seconds-per-unit coefficients
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Calibration:
    """Per-primitive cost coefficients for one (device, host) pair, in
    seconds per unit of work (exact counts), so ``predict_step_cost``
    composes them without measuring again."""

    c_dispatch: float     # s per served round's dispatch (host overhead)
    c_flop: float         # s per dot FLOP (fp32 GEMM)
    c_byte: float         # s per device-memory byte of elementwise traffic
    c_rot: float          # s per factor-fold rotation element (s^2 per row)
    c_sub: float          # s per triangular-substitution element
    c_chol: float         # s per Cholesky factorization element (~s^3/3)
    c_quant: float        # s per quant/requant element (round+clip+cast)
    backend: str = "cpu"
    fingerprint: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"schema": CAL_SCHEMA, **dataclasses.asdict(self)}

    @classmethod
    def from_json(cls, doc: Dict) -> "Calibration":
        if doc.get("schema") != CAL_SCHEMA:
            raise ValueError(f"calibration schema {doc.get('schema')!r} != "
                             f"{CAL_SCHEMA}")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in fields})


def _power_limit() -> str:
    """The card's power limit as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _host_fingerprint(device=None) -> Dict:
    """What a calibration is valid for: the device (on a card its name and
    power limit), the torch and CUDA versions, the CPU count and the
    machine."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        name, power = torch.cuda.get_device_name(dev), _power_limit()
    else:
        name, power = dev.type, None
    return {"backend": dev.type, "device": name, "power_limit": power,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cores": os.cpu_count(), "machine": platform.machine()}


def _best_time(fn, device: torch.device, reps: int = 3) -> float:
    """Median seconds of one call after a warm-up: on a CUDA device its
    device time between two events (a busy-wait kernel keeps the card
    occupied while the host enqueues, so the events bracket the call's
    device work); on the CPU the host clock."""
    fn()
    times = []
    for _ in range(max(reps, 1)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        if not t > 0.0:
            raise RuntimeError(f"calibration: a primitive timed {t!r} s")
        times.append(t)
    return statistics.median(times)


def _dispatch_time(device: torch.device, reps: int) -> float:
    """Median wall seconds of one ``StreamServer.step()`` of a tiny
    device-staged server (one slot, windows of 1, Nx = 4, T = 8), after a
    warm-up wave: on the card a captured round's replay, its control
    copies, the prediction read and the Python around them."""
    from repro_torch.core.types import DFRConfig
    from repro_torch.runtime.stream_server import StreamRequest, StreamServer

    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=4)
    n = 16 + 8 * max(reps, 1)
    rng = np.random.default_rng(0)

    def stream():
        return StreamRequest(
            rid=0, u=rng.normal(size=(n, 8, 2)).astype(np.float32),
            length=np.full((n,), 8, np.int32),
            label=rng.integers(0, 3, n).astype(np.int32))

    srv = StreamServer(cfg, t_max=8, max_streams=1, window=1, phase_steps=2,
                       refresh_every=5, device=device)
    srv.submit(stream())
    srv.run_until_drained(strict=True)      # warm-up: loads and captures
    srv.step_times_s.clear()
    srv.submit(stream())
    srv.run_until_drained(strict=True)
    times = list(srv.step_times_s)[8:]      # past the phase-1 rounds
    t = statistics.median(times)
    if not t > 0.0:
        raise RuntimeError(f"calibration: a dispatch timed {t!r} s")
    return t


def calibrate(reps: int = 3, device=None) -> Calibration:
    """The one-time micro-calibration run (a few seconds).

    Each primitive is timed on a shape large enough to dominate its launch
    - on a CUDA device the paper's serving shape (32 factors of s = 931,
    windows of 4, 10 classes) - and divided by its own work count.  A
    primitive that cannot be timed raises."""
    from repro_torch.core import ridge
    from repro_torch.kernels import ops

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("calibrate: no CUDA device; pass device='cpu'")
    on_card = dev.type == "cuda"
    f32 = torch.float32
    S0, W0, Ny0, s0 = (32, 4, 10, 931) if on_card else (8, 4, 4, 157)
    mm_n = 2048 if on_card else 256
    ew_n = (1 << 25) if on_card else (1 << 21)

    def timed(fn) -> float:
        return _best_time(fn, dev, reps)

    def coeff(t: float, units: float) -> float:
        return t / max(units, 1.0)

    # 1. dispatch: one served round of a tiny server
    c_dispatch = _dispatch_time(dev, reps)

    # 2. dot FLOPs: one GEMM
    a = torch.ones((mm_n, 2 * mm_n), dtype=f32, device=dev)
    b = torch.ones((2 * mm_n, mm_n), dtype=f32, device=dev)
    c_flop = coeff(timed(lambda: torch.matmul(a, b)),
                   2.0 * mm_n * 2 * mm_n * mm_n)

    # 3. device-memory bytes: an elementwise pass over a buffer beyond L2
    big = torch.ones((ew_n,), dtype=f32, device=dev)
    c_byte = coeff(timed(lambda: big * 1.0000001 + 0.5), 2.0 * 4 * ew_n)

    # 4. rotation: K3's fold of a window into the slots' factors, in place
    #    as the server folds
    U = ridge.seed_factor(s0, 1e-2, f32, dev).expand(S0, s0, s0).clone()
    rows = torch.full((S0, W0, s0), 0.01, dtype=f32, device=dev)
    c_rot = coeff(timed(lambda: ops.cholupdate_window_t(U, rows, out=U)),
                  S0 * W0 * s0 * s0)

    # 5/6. the two refreshes as the server runs them: two triangular solves
    #    against the live factors, and the recompute's Cholesky of B + beta I
    #    with its two solves
    A0 = torch.ones((S0, Ny0, s0), dtype=f32, device=dev)
    Uf = ridge.seed_factor(s0, 1e-2, f32, dev).expand(S0, s0, s0).clone()
    c_sub = coeff(timed(lambda: ridge.ridge_solve_from_factor_t_batched(
        A0, Uf)), S0 * s0 * s0 * Ny0)
    spd = (2.0 * torch.eye(s0, dtype=f32, device=dev)).expand(
        S0, s0, s0).clone()
    c_chol = coeff(timed(lambda: ridge.ridge_cholesky_batched(
        A0, ridge.regularize(spd, 1e-2))), S0 * s0 ** 3 / 3.0)

    # 7. quant/requant: round+clip+cast to int8 and back
    qx = torch.ones((ew_n,), dtype=f32, device=dev)

    def qdq():
        q = torch.clamp(torch.round(qx * 127.0), -127, 127).to(torch.int8)
        return q.to(f32) * (1.0 / 127.0)

    c_quant = coeff(timed(qdq), ew_n)

    return Calibration(
        c_dispatch=c_dispatch, c_flop=c_flop, c_byte=c_byte, c_rot=c_rot,
        c_sub=c_sub, c_chol=c_chol, c_quant=c_quant, backend=dev.type,
        fingerprint=_host_fingerprint(dev),
    )


def default_cal_path() -> str:
    return os.environ.get(CAL_ENV, os.path.join(os.getcwd(),
                                                DEFAULT_CAL_FILE))


_CAL_CACHE: Dict[str, Calibration] = {}


def get_calibration(path: Optional[str] = None, force: bool = False,
                    device=None) -> Calibration:
    """Load (or measure and persist) this device's calibration.

    The JSON file is reused only when its fingerprint matches this device
    and host; another machine's file is measured again.  ``force`` measures
    unconditionally.  In-process results are cached by path, so a fleet of
    ``config='auto'`` servers calibrates at most once.  The file is
    published atomically (a temporary file, then ``os.replace``), so a
    concurrent reader never sees half a document."""
    path = path or default_cal_path()
    if not force:
        hit = _CAL_CACHE.get(path)
        if hit is not None:
            return hit
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    cal = Calibration.from_json(json.load(fh))
                if cal.fingerprint == _host_fingerprint(device):
                    _CAL_CACHE[path] = cal
                    return cal
            except (ValueError, KeyError, TypeError, json.JSONDecodeError):
                pass        # a stale or foreign file: measure again
    cal = calibrate(device=device)
    try:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".",
            prefix=os.path.basename(path) + ".tmp",
        )
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(cal.to_json(), fh, indent=2)
                fh.write("\n")
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass                # a read-only directory: cached in-process only
    _CAL_CACHE[path] = cal
    return cal


# ---------------------------------------------------------------------------
# The work of one slot-batched serving-logits round
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def program_cost(n_nodes: int, n_classes: int, n_streams: int, window: int,
                 t_len: int, quantize: str = "none",
                 chunk_t: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, device-memory bytes) of one slot-batched serving-logits
    round: K2 over S slots x W windows of T live steps (``quantize='none'``)
    or K5 (``'int8'``, its int8 operations counted as FLOPs), from
    ``launch.kernel_cost``.  ``chunk_t`` is the reference's TPU tiling
    knob: the kernels have no time chunks, so it changes nothing."""
    del chunk_t
    S, W, T, Nx = n_streams, window, t_len, n_nodes
    n = S * W
    if quantize == "int8":
        work = kernel_cost.streaming_logits_q8(n * T, S, n, Nx, n_classes)
    else:
        work = kernel_cost.streaming_logits(n * T, S, n, Nx, n_classes)
    return float(work.flops + work.int_ops), float(work.nbytes)


# ---------------------------------------------------------------------------
# The analytical per-step cost model
# ---------------------------------------------------------------------------


def predict_step_cost(
    Nx: int,
    S: int,
    window: int,
    retirement: str = "none",
    refresh_mode: str = "recompute",
    cohorts: int = 1,
    step_block: int = 1,
    quantize: str = "none",
    backend: Optional[str] = None,
    *,
    chunk_t: Optional[int] = None,
    n_classes: int = 4,
    t_len: int = 24,
    refresh_every: int = 5,
    cal: Optional[Calibration] = None,
) -> float:
    """Predicted seconds per served sample for one knob setting: the
    serving logits' work, the (A, B) accumulation, the refresh mode's
    maintenance amortized over the refresh cadence, retirement's extras,
    the int8 path's second logits call, and the dispatch cost amortized
    over ``step_block`` rounds.  ``backend`` only checks the calibration:
    coefficients are measured per backend, never rescaled across one."""
    cal = cal or get_calibration()
    if backend is not None and backend != cal.backend:
        raise ValueError(
            f"calibration measured on backend={cal.backend!r} cannot price "
            f"backend={backend!r}; re-run get_calibration on that backend"
        )
    W, B, C = int(window), max(1, int(step_block)), max(1, int(cohorts))
    s = Nx * Nx + Nx + 1
    Ny = int(n_classes)

    # (a) the serving-logits round
    flops, mem = program_cost(Nx, Ny, S, W, t_len, "none", chunk_t)
    sub_step = flops * cal.c_flop + mem * cal.c_byte
    if quantize == "int8":
        # armed slots' int8 logits run in addition to the fp32 logits
        # (unarmed slots serve fp32), plus the state absmax tracking
        qf, qm = program_cost(Nx, Ny, S, W, t_len, "int8", chunk_t)
        sub_step += qf * cal.c_flop + qm * cal.c_byte
        sub_step += S * W * t_len * Nx * cal.c_quant

    # (b) statistics accumulation: A += oh r~^T, B += r~ r~^T per sample
    sub_step += 2.0 * S * W * (s * s + Ny * s) * cal.c_flop
    sub_step += S * s * s * 4.0 * cal.c_byte          # B read+write traffic

    # (c) refresh-mode maintenance, each refresh round priced by one
    # coefficient times its leading work count
    if refresh_mode == "incremental":
        rot_sweeps = 1.0 + (1.0 if retirement == "window" else 0.0)
        sub_step += rot_sweeps * S * W * s * s * cal.c_rot
        refresh_work = S * s * s * Ny * cal.c_sub
    else:
        refresh_work = S * s ** 3 / 3.0 * cal.c_chol
    # each slot refreshes once per refresh_every steps; C cohort branches
    # per period each pay a small fixed gather/scatter-and-select cost
    sub_step += (refresh_work + C * 0.5 * cal.c_dispatch) / refresh_every

    if retirement == "window":
        # ring eviction: the evicted row leaves (A, B) too
        sub_step += 2.0 * S * W * (s * s + Ny * s) * cal.c_flop

    # (e) host cost: one dispatch per block + per-sub-step control residue
    step_time = B * sub_step + cal.c_dispatch * (1.0 + 0.25 * (B - 1))
    return step_time / (B * S * W)


def predict_refresh_spike_s(
    Nx: int, S: int, refresh_mode: str = "recompute", cohorts: int = 1,
    *, n_classes: int = 4, cal: Optional[Calibration] = None,
) -> float:
    """Predicted extra wall time of a refresh-bearing step (the p99 spike
    cohort staggering divides by about C): the refresh round's work over
    the ceil(S / C) slots due at once."""
    cal = cal or get_calibration()
    s = Nx * Nx + Nx + 1
    due = -(-S // max(1, int(cohorts)))
    if refresh_mode == "incremental":
        return due * s * s * n_classes * cal.c_sub
    return due * s ** 3 / 3.0 * cal.c_chol


# ---------------------------------------------------------------------------
# The planner: search the feasible knob lattice
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """One point of the knob lattice plus its predicted cost."""

    refresh_mode: str
    refresh_cohorts: int
    step_block: int
    predicted_s_per_sample: float
    predicted_samples_per_s: float
    predicted_refresh_spike_s: float
    chunk_t: Optional[int] = None

    def knobs(self) -> Dict[str, object]:
        return {"refresh_mode": self.refresh_mode,
                "refresh_cohorts": self.refresh_cohorts,
                "step_block": self.step_block,
                "chunk_t": self.chunk_t}


DEFAULT_STEP_BLOCKS: Tuple[int, ...] = (1, 2, 4, 8)
#: the searched time-chunk sizes: the port's kernels have no time chunks,
#: so only ``None`` (the reference's off-TPU lattice)
DEFAULT_CHUNK_TS: Tuple[Optional[int], ...] = (None,)


class Planner:
    """Searches the serving-knob lattice with the calibrated cost model.

    Shape and protocol inputs mirror ``StreamServer``'s; ``retirement``,
    ``quantize`` and ``staging`` are constraints, never searched: they
    change what the server computes.  ``device`` names the device whose
    calibration prices the lattice (default: the CUDA device)."""

    def __init__(
        self,
        Nx: int,
        S: int,
        window: int,
        t_len: int,
        n_classes: int = 4,
        refresh_every: int = 5,
        retirement: str = "none",
        quantize: str = "none",
        staging: str = "device",
        cal: Optional[Calibration] = None,
        device=None,
    ):
        self.Nx, self.S, self.window = int(Nx), int(S), int(window)
        self.t_len, self.n_classes = int(t_len), int(n_classes)
        self.refresh_every = max(1, int(refresh_every))
        self.retirement = retirement
        self.quantize = quantize
        self.staging = staging
        self.cal = cal or get_calibration(device=device)

    def predict(self, refresh_mode: str, refresh_cohorts: int = 1,
                step_block: int = 1,
                chunk_t: Optional[int] = None) -> float:
        return predict_step_cost(
            self.Nx, self.S, self.window, self.retirement, refresh_mode,
            refresh_cohorts, step_block, self.quantize,
            chunk_t=chunk_t, n_classes=self.n_classes, t_len=self.t_len,
            refresh_every=self.refresh_every, cal=self.cal,
        )

    def lattice(
        self,
        refresh_modes: Optional[Sequence[str]] = None,
        cohorts: Optional[Sequence[int]] = None,
        step_blocks: Optional[Sequence[int]] = None,
        chunk_ts: Optional[Sequence[Optional[int]]] = None,
    ) -> List[Tuple[str, int, int, Optional[int]]]:
        """The feasible (refresh_mode, cohorts, step_block, chunk_t)
        lattice under the server's own validity rules."""
        modes = tuple(refresh_modes or ("recompute", "incremental"))
        if self.retirement == "window":
            # the eviction downdates a live factor: incremental only
            modes = tuple(m for m in modes if m == "incremental") or (
                "incremental",)
        cs = sorted({min(max(1, int(c)), self.refresh_every)
                     for c in (cohorts or (1, self.refresh_every))})
        blocks = tuple(step_blocks or DEFAULT_STEP_BLOCKS)
        if self.staging != "device":
            blocks = (1,)           # the blocked round needs the staged pool
        cts = tuple(DEFAULT_CHUNK_TS if chunk_ts is None else chunk_ts)
        return [(m, c, b, ct)
                for m in modes for c in cs for b in blocks for ct in cts]

    def search(
        self,
        refresh_modes: Optional[Sequence[str]] = None,
        cohorts: Optional[Sequence[int]] = None,
        step_blocks: Optional[Sequence[int]] = None,
        chunk_ts: Optional[Sequence[Optional[int]]] = None,
    ) -> Plan:
        """The predicted-best plan over the feasible lattice (throughput
        objective: cohorts only reshape the latency tail, which ``Plan``
        carries as its refresh spike).  A strict argmin keeps the first
        minimum."""
        best: Optional[Plan] = None
        for mode, c, b, ct in self.lattice(
                refresh_modes, cohorts, step_blocks, chunk_ts):
            t = self.predict(mode, c, b, ct)
            plan = Plan(
                refresh_mode=mode, refresh_cohorts=c, step_block=b,
                predicted_s_per_sample=t,
                predicted_samples_per_s=1.0 / max(t, 1e-30),
                predicted_refresh_spike_s=predict_refresh_spike_s(
                    self.Nx, self.S, mode, c, n_classes=self.n_classes,
                    cal=self.cal,
                ),
                chunk_t=ct,
            )
            if best is None or t < best.predicted_s_per_sample:
                best = plan
        assert best is not None
        return best


# ---------------------------------------------------------------------------
# The honesty gate: replay a measured table
# ---------------------------------------------------------------------------

#: table policy name -> the knobs it measured (the stream-quant table; all
#: rows ran refresh_mode='incremental', retirement='none')
_QUANT_POLICY_KNOBS: Dict[str, Dict] = {
    "fp32": {"quantize": "none", "step_block": 1},
    "int8": {"quantize": "int8", "step_block": 1},
    "fp32_b4": {"quantize": "none", "step_block": 4},
    "int8_b4": {"quantize": "int8", "step_block": 4},
}


def _parse_cell(cell: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for part in cell.split("/"):
        key = part.rstrip("0123456789")
        if key and part[len(key):]:
            out[key] = int(part[len(key):])
    return out


def replay_bench_tables(
    root: Optional[str] = None,
    cal: Optional[Calibration] = None,
    gate: float = GATE_RATIO,
) -> List[Dict]:
    """Validate the planner against the measurements of
    ``<root>/BENCH_stream_quant.json``.

    For every measured shape whose policies map onto planner knobs (the
    ``stream-quant`` table: fp32/int8 x block 1/4), the cost model ranks
    exactly the measured configs; a row fails (``ok=False``) when the
    predicted-best config's measured samples/s is more than ``gate`` below
    the measured best.  Rows, not exceptions, so a failure names every
    offending shape at once."""
    root = root or os.getcwd()
    cal = cal or get_calibration()
    results: List[Dict] = []
    path = os.path.join(root, "BENCH_stream_quant.json")
    if not os.path.exists(path):
        return results
    with open(path) as fh:
        doc = json.load(fh)
    for row in doc.get("rows", ()):
        if row.get("table") != "stream-quant":
            continue
        dims = _parse_cell(row.get("cell", ""))
        Nx, S, W = dims.get("Nx"), dims.get("S"), dims.get("W", 1)
        if not Nx or not S:
            continue
        t_len = int(row.get("t_len", 24))
        measured = {
            name: row[f"{name}_samples_per_s"]
            for name in _QUANT_POLICY_KNOBS
            if f"{name}_samples_per_s" in row
        }
        if len(measured) < 2:
            continue
        predicted = {
            name: predict_step_cost(
                Nx, S, W, "none", "incremental", 1,
                knobs["step_block"], knobs["quantize"],
                n_classes=4, t_len=t_len, refresh_every=5, cal=cal,
            )
            for name, knobs in _QUANT_POLICY_KNOBS.items()
            if name in measured
        }
        pick = min(predicted, key=predicted.get)
        best = max(measured, key=measured.get)
        ratio = measured[best] / max(measured[pick], 1e-12)
        results.append({
            "source": os.path.basename(path),
            "cell": row["cell"],
            "pick": pick,
            "best": best,
            "pick_measured_samples_per_s": measured[pick],
            "best_measured_samples_per_s": measured[best],
            "best_over_pick_ratio": round(ratio, 3),
            "ok": ratio <= gate,
        })
    return results
