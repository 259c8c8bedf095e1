"""Dependent-chain latencies of one warp on the CUDA device, in SM cycles.

    python src/repro_torch/launch/chain_latency.py

The DFR kernels K1, K2, K5 and K6 run one warp a sample through a chain of
dependent steps, so their least time is the longest live length times the
cycles of one step's dependent chain.  This script measures those cycles on
the card: one warp runs a long dependent loop of each operation (and of
the whole step that K1, K2 and K6 share, ``scan_step`` in
``kernels/csrc/dfr_step.cuh`` up to 32 nodes and ``scan_step_n`` at NPL =
2, 3 and 4 nodes a lane above), timed with ``clock64`` at two loop lengths
so that the loop's set-up cancels.  It prints one JSON object: cycles per
dependent operation (``op_cycles``) and per whole step (``step_cycles``),
beside the card's name and power limit.
``chip_smoke.py``'s chain bounds use these numbers (``CHAIN``).

The probe source is written below and built with nvcc into
``build/kernels/`` at first use, as the kernels are.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cuda_runtime.h>
#include "dfr_step.cuh"

// which: the operation chained; n: its dependent repetitions
__global__ void chain_kernel(int which, int n, long long* out, float* sink) {
  const int lane = threadIdx.x & 31;
  __shared__ __align__(16) float row[2][32];
  float x = 0.5f + 0.01f * lane;
  int xi = lane + 1;
  dfr::RingScan scan;
  dfr::make_scan(0.3f, scan);
  dfr::RingScanN<2> scan2;
  dfr::make_scan_n<2>(0.3f, 64, scan2);
  dfr::RingScanN<3> scan3;
  dfr::make_scan_n<3>(0.3f, 96, scan3);
  dfr::RingScanN<4> scan4;
  dfr::make_scan_n<4>(0.3f, 128, scan4);
  float x2[2] = {x, x}, x3[3] = {x, x, x}, x4[4] = {x, x, x, x};
  const float j2[2] = {0.01f, 0.01f}, j3[3] = {0.01f, 0.01f, 0.01f};
  const float j4[4] = {0.01f, 0.01f, 0.01f, 0.01f};
  __syncwarp();
  const long long t0 = clock64();
  switch (which) {
    case 0:  // fp32 FMA (FADD and FMUL take the same pipe)
#pragma unroll 8
      for (int i = 0; i < n; ++i) x = fmaf(x, 0.999f, 0.001f);
      break;
    case 1:  // fp32 min or max
#pragma unroll 8
      for (int i = 0; i < n; ++i) x = fminf(x, 0.9f - 1e-9f * i);
      break;
    case 2:  // integer dot of four int8 pairs
#pragma unroll 8
      for (int i = 0; i < n; ++i) xi = __dp4a(xi, 0x01010101, i);
      break;
    case 3:  // shuffle up
#pragma unroll 8
      for (int i = 0; i < n; ++i) x = __shfl_up_sync(0xffffffffu, x, 1);
      break;
    case 4:  // shuffle from a lane
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        x = __shfl_sync(0xffffffffu, x, (lane + 1) & 31);
      break;
    case 5:  // a value through shared memory: store, warp barrier, load
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        row[i & 1][lane] = x;
        __syncwarp();
        x = row[i & 1][(lane + 1) & 31];
      }
      break;
    case 6:  // K1's, K2's and K6's step (scan_step, linear f)
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        x = dfr::scan_step(scan, 0.01f, x, 30, 0.2f, 0, 1.0f);
      break;
    case 7:  // the step at 2 nodes a lane (Nx 33-64, linear f)
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        dfr::scan_step_n<2>(scan2, j2, x2, 0.2f, 0, 1.0f);
      x = x2[0] + x2[1];
      break;
    case 8:  // 3 nodes a lane (Nx 65-96)
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        dfr::scan_step_n<3>(scan3, j3, x3, 0.2f, 0, 1.0f);
      x = x3[0] + x3[2];
      break;
    case 9:  // 4 nodes a lane (Nx 97-128)
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        dfr::scan_step_n<4>(scan4, j4, x4, 0.2f, 0, 1.0f);
      x = x4[0] + x4[3];
      break;
  }
  const long long t1 = clock64();
  if (lane == 0) out[which] = t1 - t0;
  sink[threadIdx.x] = x + static_cast<float>(xi);
}

extern "C" int chain_probe(int which, int n, long long* out, float* sink) {
  chain_kernel<<<1, 32>>>(which, n, out, sink);
  cudaError_t err = cudaDeviceSynchronize();
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
"""
OPS = ("fp32 FMA", "fp32 min/max", "IDP4A", "SHFL.UP", "SHFL.IDX",
       "shared store, __syncwarp, load")
STEPS = ("K1/K2/K6 scan_step", "scan_step_n NPL=2", "scan_step_n NPL=3",
         "scan_step_n NPL=4")
REPS = (1024, 2048)


def library() -> Path:
    """Build the probe (once per source) and return its path."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from repro_torch.kernels import _build
    header = (_build.CSRC / "dfr_step.cuh").read_bytes()
    key = hashlib.sha256(SOURCE.encode() + header).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libchain_latency-{key}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS,
                        "-I", str(_build.CSRC), "-o", str(out), str(src)],
                       check=True)
    return out


def measure() -> dict:
    """Cycles per dependent operation and per step, from two loop lengths."""
    import torch
    lib = ctypes.CDLL(str(library()))
    lib.chain_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    out = torch.zeros(16, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, device="cuda")
    cycles = []
    for which in range(len(OPS) + len(STEPS)):
        got = []
        for n in (REPS[0],) + REPS:  # the first run warms up
            rc = lib.chain_probe(which, n, out.data_ptr(), sink.data_ptr())
            if rc:
                raise RuntimeError(f"chain probe failed: CUDA error {rc}")
            got.append(int(out[which].item()))
        cycles.append((got[2] - got[1]) / (REPS[1] - REPS[0]))
    return {"op_cycles": dict(zip(OPS, cycles[:len(OPS)])),
            "step_cycles": dict(zip(STEPS, cycles[len(OPS):]))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chain_latency: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, **measure()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
