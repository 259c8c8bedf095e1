"""Work counts of the port's DFR kernels, and the least time the card needs.

The counterpart, for the stream server's planner (``runtime.planner``), of
the role ``repro.launch.hlo_cost`` plays in the reference: the reference
reads exact FLOPs and bytes from a lowered XLA program, while the port's
serving work runs in hand-written kernels (K1, K2, K5, K3) that
``torch.utils.flop_counter.FlopCounterMode`` does not see.  So the counts
here are analytic, one formula a kernel, counting what the inputs need
(each input read once, each output written once; frozen steps past a
sample's length need nothing):

  * K1 and K2 (the reservoir with its DPRR features): each live step reads
    Nx inputs and does 3 Nx^2 + 7 Nx flops (nonlinearity, ring matvec, DPRR
    update); K1 writes r and three boundary states a sample, K2 reads the
    readout and writes the logits (2 Nr + 1 flops a class);
  * K5 (the int8 serving logits): its codes and scales, about 12 fp32 ops
    a node and 2 (Nx^2 + Nx (Nx + 1)) int8 ops a live step, the fp32
    readout;
  * K3 (the rank-1 fold): the upper triangle of each factor read and
    written once, the rows read once, about 6 flops a factor element right
    of the diagonal a row (7 with the forget scale).

``bound_ms`` turns a count into the least time on an H100 SXM: the bytes
at its memory rate against the operations at their peak rates, the larger
of the two.  ``chip_smoke.py`` prints its kernels' bounds from here, and
the planner prices a serving round from the same counts.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W power limit
PEAK_BYTES_S = 3.35e12     # HBM3
PEAK_FP32_FLOP_S = 67e12   # fp32 outside the tensor cores
PEAK_INT8_OP_S = 1979e12   # int8 tensor cores
PEAK_BF16_FLOP_S = 989e12  # bf16 tensor cores


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call needs: bytes moved, fp32 flops, int8 ops."""

    nbytes: int
    flops: int
    int_ops: int = 0

    def bound(self) -> Tuple[float, str]:
        return bound_ms(self.nbytes, self.flops, self.int_ops)


def bound_ms(nbytes: int, flops: int, int_ops: int = 0) -> Tuple[float, str]:
    """Least time (ms) for the given work: bytes at the memory rate against
    fp32 flops and int8 operations, each at its peak rate; the larger
    bounds.  Returns (ms, 'bytes' or 'operations')."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FP32_FLOP_S + int_ops / PEAK_INT8_OP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def reservoir_steps(live_steps: int, n: int, nx: int, extra_bytes: int = 0,
                    extra_flops: int = 0, in_bytes: int = 4) -> Work:
    """The reservoir and DPRR work K1, K2 and K6 share: each live step reads
    Nx inputs of ``in_bytes`` and does 3 Nx^2 + 7 Nx flops; each of the n
    samples reads its length."""
    return Work(live_steps * nx * in_bytes + n * 4 + extra_bytes,
                live_steps * (3 * nx * nx + 7 * nx) + extra_flops)


def train_forward(live_steps: int, n_sys: int, n: int, nx: int,
                  in_bytes: int = 4) -> Work:
    """K1 over n samples of n_sys systems: (p, q) a system in, r and the
    three boundary states a sample out."""
    nr = nx * (nx + 1)
    return reservoir_steps(live_steps, n, nx,
                           8 * n_sys + in_bytes * n * (nr + 3 * nx),
                           in_bytes=in_bytes)


def streaming_logits(live_steps: int, n_sys: int, n: int, nx: int, ny: int,
                     in_bytes: int = 4) -> Work:
    """K2 over n samples of n_sys slots: (p, q), the readout W and b a slot
    in, the logits out, 2 Nr + 1 flops a logit."""
    nr = nx * (nx + 1)
    return reservoir_steps(
        live_steps, n, nx,
        8 * n_sys + in_bytes * (n_sys * ny * nr + n_sys * ny + n * ny),
        n * ny * (2 * nr + 1), in_bytes=in_bytes)


def streaming_logits_q8(live_steps: int, n_sys: int, n: int, nx: int,
                        ny: int, in_bytes: int = 4) -> Work:
    """K5 over n samples of n_sys slots: the live inputs and the lengths,
    the ring codes and powers, the scales, the readout codes and bias a
    slot, the logits; per live step an int8 ring dot (Nx^2 MACs) and DPRR
    update (Nx (Nx + 1) MACs) and about 12 fp32 ops a node, then the fp32
    readout."""
    nr = nx * (nx + 1)
    nbytes = (live_steps * nx * in_bytes + n * 4
              + n_sys * (nx * nx + 4 * nx + 16 + ny * nr + 4 * ny)
              + 4 * n * ny)
    return Work(nbytes, live_steps * 12 * nx + n * ny * (4 * nr + 1),
                live_steps * 2 * (nx * nx + nx * (nx + 1)))


def cholupdate(k: int, w: int, s: int, scaled: bool = False,
               flagged: bool = False, in_bytes: int = 4) -> Work:
    """K3 folding w rows into k factors of s: the upper triangle (diagonal
    included) read once and written once, the rows read once, 6 flops a
    factor element right of the diagonal a row; the forget scale adds its
    k w scales and one multiply an element a row, the guard its k flags."""
    nbytes = k * s * (s + 1) * in_bytes + k * w * s * in_bytes
    flops = 6 * k * w * s * (s - 1) // 2
    if scaled:
        nbytes += k * w * 4
        flops = 7 * k * w * s * (s - 1) // 2
    if flagged:
        nbytes += k * 4
    return Work(nbytes, flops)
