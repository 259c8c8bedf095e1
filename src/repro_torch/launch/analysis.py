"""Roofline terms of a traced dry-run step.

The port of ``repro.launch.analysis``.  The reference reads its numbers
from XLA's compiled program (the HLO walker and ``cost_analysis``); the
port has no compiler to ask, so ``CostMode`` traces the step itself as it
runs once on fake tensors (``launch.steps.lower_cell``).  It is a
``TorchDispatchMode`` that lets every DTensor operation through to
DTensor's dispatch and counts the **local** operations each rank runs
(DTensor's own shape propagation, which reruns an operation at its global
shape, is left out):

* FLOPs: matrix products and attention kernels only, by
  ``torch.utils.flop_counter``'s formulas (the reference's walker counts
  dot and convolution FLOPs only); K8 counts 4 * D a live (query, key)
  pair through the formula ``kernels.flash_attention`` registers.
* HBM bytes: each operation that computes (not a view, not an in-place
  alias) reads each input once and writes each output once.
* Collectives: each ``_c10d_functional`` collective with its kind, result
  bytes and group size, priced by ``collective_stats`` with the
  reference's ring formulas (``parse_collectives``).
* Live bytes: every new local tensor adds its bytes until it is freed;
  the peak is the step's temporary memory.

The constants are one NVIDIA H100 SXM 80GB's at its 700 W limit
(NVIDIA's data sheet): 989 TFLOP/s dense bf16, 3.35 TB/s HBM, and one
NVLink direction, 450 GB/s, kept as the reference's one-link model of a
collective.  A mesh axis wider than the 8 GPUs of one NVLink node crosses
nodes over the network, so for the 16-wide production axes the link
figure is optimistic.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# --- NVIDIA H100 SXM 80GB constants (per GPU, 700 W) -----------------------
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s, one NVLink direction

# _c10d_functional op name -> the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float                   # estimated per-device wire traffic
    op_bytes: Dict[str, float]          # raw result bytes per op kind
    op_counts: Dict[str, int]

    def to_json(self):
        return dataclasses.asdict(self)


def collective_stats(records: Sequence[Tuple[str, float, int]]
                     ) -> CollectiveStats:
    """Sum collectives, each (kind, result bytes B, group size k), with the
    reference's ring model (k at least 2):

        all-reduce:          2 * B * (k-1)/k
        all-gather:          B * (k-1)/k
        reduce-scatter:      B * (k-1)            (operand = k * result)
        all-to-all:          B * (k-1)/k
        collective-permute:  B
    """
    wire = 0.0
    op_bytes: Dict[str, float] = {}
    op_counts: Dict[str, int] = {}
    for kind, b, k in records:
        k = max(k, 2)
        if kind == "all-reduce":
            w = 2.0 * b * (k - 1) / k
        elif kind == "all-gather":
            w = b * (k - 1) / k
        elif kind == "reduce-scatter":
            w = b * (k - 1)
        elif kind == "all-to-all":
            w = b * (k - 1) / k
        else:  # collective-permute
            w = b
        wire += w
        op_bytes[kind] = op_bytes.get(kind, 0.0) + b
        op_counts[kind] = op_counts.get(kind, 0) + 1
    return CollectiveStats(wire_bytes=wire, op_bytes=op_bytes,
                           op_counts=op_counts)


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
) -> Dict[str, float]:
    compute_s = flops_per_device / PEAK_FLOPS_BF16
    memory_s = bytes_per_device / HBM_BW
    collective_s = wire_bytes_per_device / LINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "roofline_fraction": compute_s / total if total > 0 else 0.0,
    }


def model_flops(cfg, shape) -> float:
    """6 N D (dense) / 6 N_active D (MoE); decode counts one token/row."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: fwd only, 1 token per row


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# frames between an operation's dispatch and DTensor's propagation call:
# 3 to 8 in torch 2.13 (the operation itself, and gen_fake_args's
# empty_strided); the rest of the stack is never walked
_PROPAGATION_DEPTH = 16


def _in_shape_propagation() -> bool:
    """True inside DTensor's propagation of an operation's global shape
    (it runs the operation on fake tensors of the global shape)."""
    f = sys._getframe(2)
    for _ in range(_PROPAGATION_DEPTH):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _aliases(func) -> bool:
    """An operation whose output aliases an input (a view, or in place)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    raise ValueError(f"no process group among {args!r}")


class CostMode(TorchDispatchMode):
    """Counts a traced step's local FLOPs, HBM bytes, collectives and live
    bytes (see the module docstring).  ``flops``, ``bytes``,
    ``collectives`` (a list of (kind, result bytes, group size)),
    ``peak_bytes`` after the block."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float, int]] = []
        self.live = 0
        self.peak_bytes = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        outs = [o for o in (out if isinstance(out, (tuple, list)) else [out])
                if isinstance(o, torch.Tensor)]
        if ns == "_c10d_functional" and name in _KINDS:
            b = sum(tensor_bytes(o) for o in outs)
            self.collectives.append((_KINDS[name], float(b),
                                     _group_size(args)))
            return out
        if ns in ("_c10d_functional", "prim") or _aliases(func):
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        ins = [a for a in list(args) + list(kwargs.values())
               if isinstance(a, torch.Tensor)]
        self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        for o in outs:
            n = tensor_bytes(o)
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out

    def collective_stats(self) -> CollectiveStats:
        return collective_stats(self.collectives)
