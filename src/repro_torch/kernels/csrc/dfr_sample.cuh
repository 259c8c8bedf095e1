// One sample's fp32 reservoir and DPRR, run by one warp: the time loop that
// K1 (train.cu) and K2 (streaming.cu) share.
//
// Per sample it computes the DPRR of paper Eq. 27-28 over the live steps,
//   acc[n][i] = sum_{k < len} x(k)_n x(k-1)_i,   sum[n] = sum_{k < len} x(k)_n,
// with x(-1) = 0, and the truncation boundary x(len-1), x(len-2) and
// j(len-1), zero where the step does not exist, as
// kernels/ref.py:train_forward_ref gives them.  Neither the states nor the
// accumulator touch device memory.
//
// What bounds it on an H100: the latency of `len` dependent steps, each
// dfr_step.cuh's scan_step (6 shuffles deep); the bytes (Nx floats a step)
// and the DPRR's 2 Nx (Nx + 1) flops a step are far below the card's rates.
// The design keeps the chain short and everything else off it:
//   * the sample's live inputs stream through shared memory ahead of the
//     steps (stage_rows.cuh), so no step waits on device memory;
//   * a step only stores x(k) in a ring of two chunks' rows in shared
//     memory, each padded with zeros to 32 floats (a zero row stands for
//     x(-1)), and adds it to the ones column's running sum;
//   * after each chunk of kStageChunk steps the warp folds the chunk's rows
//     into the DPRR, in fp32 on the CUDA cores (TF32 would break rtol
//     1e-4): lane (g, h) = (lane / 8, lane % 8) keeps the 8 x 4 register
//     tile of the padded 32 x 32 block at rows 8g.., columns 4h.., and a row
//     costs it three float4 loads and 32 fmaf, no shuffles (K7's tile,
//     dprr.cu).  Folding a chunk between the next chunk's steps instead was
//     faster in K1 and slower in K2 (ab_time.py, PERF.md);
//   * the boundary outputs are read from the two rings after the loop.
// Shared memory is bounded at any T: the rings hold chunks, not samples.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "dfr_step.cuh"
#include "stage_rows.cuh"

namespace dfr {

// Rows of the state ring: chunk c and, for its fold, the last row of chunk
// c - 1 (a power of two).
constexpr int kStateRows = 2 * kStageChunk;

struct SampleShared {
  // the input stage; take() reads up to 31 words past it, into xs
  alignas(16) float stage[kStageSlots * stage_slot_floats(kMaxNodes)];
  // x(k) in row k mod kStateRows, lanes n >= Nx zero; r after the loop
  alignas(16) float xs[kMaxNodes * (kMaxNodes + 1)];
};

struct SampleOut {
  float acc[8][4];  // lane (g, h): acc[u][v] = acc[8g + u][4h + v]
  float sum;        // lane n < Nx: sum[n]
  float x_last;     // lane n < Nx: x(len-1)_n
  float x_prev;     // lane n < Nx: x(len-2)_n
  float j_last;     // lane n < Nx: j(len-1)_n
};

// acc += x(k) x(k-1)^T from rows k and k - 1 of the state ring.
__device__ __forceinline__ void fold_row(const float* xs, int k,
                                         float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3, h = lane & 7;
  const float* const xk = xs + (k & (kStateRows - 1)) * kMaxNodes;
  const float* const xp = xs + ((k - 1) & (kStateRows - 1)) * kMaxNodes;
  const float4 a0 = *reinterpret_cast<const float4*>(xk + 8 * g);
  const float4 a1 = *reinterpret_cast<const float4*>(xk + 8 * g + 4);
  const float4 p4 = *reinterpret_cast<const float4*>(xp + 4 * h);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], p[v], acc[u][v]);
}

// Runs the sample whose (T, nx) inputs start at j, with its length and its
// system's p and q read through the given pointers.  Every lane of the warp
// must call it.
template <int kCode>
__device__ __forceinline__ void run_sample(SampleShared& sh,
                                           const float* __restrict__ j,
                                           int T, int nx,
                                           const int* __restrict__ length,
                                           const float* __restrict__ p,
                                           const float* __restrict__ q,
                                           float alpha, SampleOut& out) {
  const int lane = threadIdx.x & 31;
  const bool node = lane < nx;
  RowStage stage{sh.stage, j, nx, 0};
  stage.start_first(T);  // the copies overlap the set-up below
  const int len = stage.len = min(max(*length, 0), T);
  stage.start_rest();
  const float ps = *p;
  RingScan scan;
  make_scan(*q, scan);
  sh.xs[(kStateRows - 1) * kMaxNodes + lane] = 0.0f;  // x(-1)
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) out.acc[u][v] = 0.0f;

  float x = 0.0f, sum = 0.0f;
  for (int c = 0, k0 = 0; k0 < len; ++c, k0 += kStageChunk) {
    float jr[kStageChunk];
    stage.take(c, jr);
#pragma unroll
    for (int u = 0; u < kStageChunk; ++u)
      jr[u] = scan_input(jr[u], ps, kCode, alpha);
    float* const rows = sh.xs + (k0 & (kStateRows - 1)) * kMaxNodes;
    const int steps = min(kStageChunk, len - k0);
    if (steps == kStageChunk) {  // a whole chunk: no length checks
#pragma unroll
      for (int u = 0; u < kStageChunk; ++u) {
        x = scan_step(scan, jr[u], x, nx, ps, kCode, alpha);
        rows[u * kMaxNodes + lane] = node ? x : 0.0f;
        sum += x;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kStageChunk - 1; ++u) {
        if (u >= steps) break;
        x = scan_step(scan, jr[u], x, nx, ps, kCode, alpha);
        rows[u * kMaxNodes + lane] = node ? x : 0.0f;
        sum += x;
      }
    }
    __syncwarp();  // chunk c's rows are in the ring
#pragma unroll 4
    for (int k = k0; k < k0 + steps; ++k) fold_row(sh.xs, k, out.acc);
    __syncwarp();  // the fold has read the rows that chunk c + 1 overwrites
  }

  out.sum = sum;
  out.x_last = x;
  out.x_prev = len >= 2
                   ? sh.xs[((len - 2) & (kStateRows - 1)) * kMaxNodes + lane]
                   : 0.0f;
  // the last live chunk is still in its stage slot: no copy follows it
  out.j_last = len >= 1 ? stage.slot((len - 1) / kStageChunk)
                              [((len - 1) % kStageChunk) * nx + lane]
                        : 0.0f;
  cp_async_wait_all();  // a copy past a short length must land before exit
}

// The DPRR vector r (Nx (Nx + 1),) in its layout, the (Nx, Nx) block
// row-major and then the Nx sums, written over the state ring; returns it.
// Every lane must call it after run_sample.
__device__ __forceinline__ const float* store_r(SampleShared& sh,
                                               const SampleOut& s, int nx) {
  __syncwarp();  // every lane has read the ring
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3, h = lane & 7;
  float* const r = sh.xs;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int n = 8 * g + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = 4 * h + v;
      if (n < nx && i < nx) r[n * nx + i] = s.acc[u][v];
    }
  }
  if (lane < nx) r[nx * nx + lane] = s.sum;
  __syncwarp();
  return r;
}

}  // namespace dfr
