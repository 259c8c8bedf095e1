// One sample's fp32 reservoir and DPRR: the time loop that K1 (train.cu)
// and K2 (streaming.cu) share, run by one warp up to 32 nodes
// (run_sample) and by one block above (run_sample_wide).
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
//     costs it three float4 loads and 32 fmaf, no shuffles (npl.cuh's
//     fold_tile, which K7 runs too).  Folding a chunk between the next chunk's steps instead was
//     faster in K1 and slower in K2 (ab_time.py, PERF.md);
//   * the boundary outputs are read from the two rings after the loop.
// Shared memory is bounded at any T: the rings hold chunks, not samples.
//
// Above 32 nodes the (Nx, Nx + 1) accumulator no longer fits one warp's
// registers (16,512 floats at 128), so the fold leaves the scan warp:
// run_sample_wide runs a block of 1 + NPL^2 / kTiles warps a sample.
// Warp 0 runs the steps (scan_step_n, NPL nodes a lane) and writes each
// chunk's rows, padded to 32 NPL floats, to a ring of four chunks; fold
// warp 1 + w owns kTiles 32 x 32 tiles of the padded accumulator, side by
// side in one row of tiles, each with the register tile above.  kTiles is
// 2 at NPL = 4: 17 warps would leave 96 registers a thread (a scheduler
// holds 5 of them), too few for the scan warp, and 9 leave 168.  One block barrier a chunk: after barrier c the
// fold warps fold chunk c while warp 0 steps chunk c + 1 into the next
// slot, so the fold stays off the chain.  The kernels declare one block an SM
// as their launch bound's minimum: without it ptxas trades registers for
// occupancy and spills (its heuristic for a bound of threads alone).
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "dfr_step.cuh"
#include "npl.cuh"
#include "stage_rows.cuh"

namespace dfr {

// Rows of the state ring: chunk c and, for its fold, the last row of chunk
// c - 1 (a power of two).
constexpr int kStateRows = 2 * kStageChunk;

struct SampleShared {
  // the input stage; take() reads up to 31 words past it, into xs
  alignas(16) float stage[kStageSlots * stage_slot_floats(kWarpNodes)];
  // x(k) in row k mod kStateRows, lanes n >= Nx zero; r after the loop
  alignas(16) float xs[kWarpNodes * (kWarpNodes + 1)];
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
  const float* const xk = xs + (k & (kStateRows - 1)) * kWarpNodes;
  const float* const xp = xs + ((k - 1) & (kStateRows - 1)) * kWarpNodes;
  fold_tile(xk + 8 * g, xp + 4 * h, &acc);
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
  RowStage<> stage{sh.stage, j, nx, 0};
  stage.start_first(T);  // the copies overlap the set-up below
  const int len = stage.len = min(max(*length, 0), T);
  stage.start_rest();
  const float ps = *p;
  RingScan scan;
  make_scan(*q, scan);
  sh.xs[(kStateRows - 1) * kWarpNodes + lane] = 0.0f;  // x(-1)
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
    float* const rows = sh.xs + (k0 & (kStateRows - 1)) * kWarpNodes;
    const int steps = min(kStageChunk, len - k0);
    if (steps == kStageChunk) {  // a whole chunk: no length checks
#pragma unroll
      for (int u = 0; u < kStageChunk; ++u) {
        x = scan_step(scan, jr[u], x, nx, ps, kCode, alpha);
        rows[u * kWarpNodes + lane] = node ? x : 0.0f;
        sum += x;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kStageChunk - 1; ++u) {
        if (u >= steps) break;
        x = scan_step(scan, jr[u], x, nx, ps, kCode, alpha);
        rows[u * kWarpNodes + lane] = node ? x : 0.0f;
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
                   ? sh.xs[((len - 2) & (kStateRows - 1)) * kWarpNodes + lane]
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

// ---- Nx > 32: a block a sample ----

constexpr int kWideRing = 4 * kStageChunk;  // state ring rows: 4 chunks

template <int NPL>
struct Wide {
  static constexpr int kStride = 32 * NPL;        // floats a state row
  static constexpr int kTiles = NPL == 4 ? 2 : 1;  // tiles a fold warp
  static constexpr int kThreads = 32 * (1 + NPL * NPL / kTiles);
};

// Floats of dynamic shared memory a wide sample takes: the input stage,
// then the state ring; r (Nx (Nx + 1) floats) over both after the loop.
__host__ __device__ constexpr int wide_smem_floats(int nx, int npl) {
  return kStageSlots * stage_slot_floats(nx) + kWideRing * 32 * npl >
                 nx * (nx + 1)
             ? kStageSlots * stage_slot_floats(nx) + kWideRing * 32 * npl
             : nx * (nx + 1);
}

template <int NPL>
struct WideOut {
  // fold warp 1 + w, lane (g, h), its tiles t = w kTiles + i:
  // acc[i][u][v] = acc[32 (t / NPL) + 8g + u][32 (t % NPL) + 4h + v]
  float acc[Wide<NPL>::kTiles][8][4];
  float sum[NPL];      // warp 0, node l NPL + i < Nx: sum, x(len-1),
  float x_last[NPL];   // x(len-2) and j(len-1)
  float x_prev[NPL];
  float j_last[NPL];
};

// The sample whose (T, nx) inputs start at j, as run_sample, by the whole
// block (Wide<NPL>::kThreads threads) over `smem`
// (wide_smem_floats(nx, NPL) floats, 16-byte aligned).  Ends with a block
// barrier.
template <int kCode, int NPL>
__device__ __forceinline__ void run_sample_wide(
    float* smem, const float* __restrict__ j, int T, int nx,
    const int* __restrict__ length, const float* __restrict__ p,
    const float* __restrict__ q, float alpha, WideOut<NPL>& out) {
  constexpr int kStride = Wide<NPL>::kStride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const ring = smem + kStageSlots * stage_slot_floats(nx);
  RowStage<kMaxNodes> stage{smem, j, nx, 0};
  if (warp == 0) stage.start_first(T);
  const int len = stage.len = min(max(*length, 0), T);
  if (warp == 0) stage.start_rest();
  for (int i = threadIdx.x; i < kStride; i += Wide<NPL>::kThreads)
    ring[(kWideRing - 1) * kStride + i] = 0.0f;  // x(-1)

  if (warp == 0) {
    const float ps = *p;
    RingScanN<NPL> scan;
    make_scan_n<NPL>(*q, nx, scan);
    const int n0 = lane * NPL;
    float x[NPL], sum[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) x[i] = sum[i] = 0.0f;
    for (int c = 0, k0 = 0; k0 < len; ++c, k0 += kStageChunk) {
      float* const rows = ring + (k0 & (kWideRing - 1)) * kStride + n0;
      const int steps = min(kStageChunk, len - k0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float jr[kStageChunk / 2][NPL];
        stage.take_half<NPL>(c, half, jr);
#pragma unroll
        for (int u = 0; u < kStageChunk / 2; ++u) {
          const int k = half * (kStageChunk / 2) + u;
          if (k >= steps) break;
#pragma unroll
          for (int i = 0; i < NPL; ++i)
            jr[u][i] = scan_input(jr[u][i], ps, kCode, alpha);
          scan_step_n<NPL>(scan, jr[u], x, ps, kCode, alpha);
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            rows[k * kStride + i] = n0 + i < nx ? x[i] : 0.0f;
            sum[i] += x[i];
          }
        }
      }
      __syncthreads();  // chunk c's rows are in the ring
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const bool node = n0 + i < nx;
      out.sum[i] = sum[i];
      out.x_last[i] = x[i];
      out.x_prev[i] =
          len >= 2 && node
              ? ring[((len - 2) & (kWideRing - 1)) * kStride + n0 + i]
              : 0.0f;
      out.j_last[i] = len >= 1 && node
                          ? stage.slot((len - 1) / kStageChunk)
                                [((len - 1) % kStageChunk) * nx + n0 + i]
                          : 0.0f;
    }
    cp_async_wait_all();  // r overwrites the stage after the barrier
  } else {
    constexpr int kTiles = Wide<NPL>::kTiles;
    const int t = (warp - 1) * kTiles, g = lane >> 3, h = lane & 7;
    const int row0 = 32 * (t / NPL) + 8 * g, col0 = 32 * (t % NPL) + 4 * h;
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) out.acc[i][u][v] = 0.0f;
    for (int k0 = 0; k0 < len; k0 += kStageChunk) {
      __syncthreads();  // chunk k0 / 16's rows are in the ring
      const int k1 = min(k0 + kStageChunk, len);
#pragma unroll 2
      for (int k = k0; k < k1; ++k) {
        const float* const xk = ring + (k & (kWideRing - 1)) * kStride + row0;
        const float* const xp =
            ring + ((k - 1) & (kWideRing - 1)) * kStride + col0;
        fold_tile<kTiles>(xk, xp, out.acc);
      }
    }
  }
  __syncthreads();  // the last fold and the boundary reads are done
}

// The DPRR vector r (Nx (Nx + 1),) in its layout at smem's start (over
// the stage and the ring), by the whole block after run_sample_wide;
// ends with a block barrier and returns r.
template <int NPL>
__device__ __forceinline__ const float* store_r_wide(float* smem,
                                                     const WideOut<NPL>& s,
                                                     int nx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const r = smem;
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (lane * NPL + i < nx) r[nx * nx + lane * NPL + i] = s.sum[i];
  } else {
    constexpr int kTiles = Wide<NPL>::kTiles;
    const int t = (warp - 1) * kTiles, g = lane >> 3, h = lane & 7;
    const int row0 = 32 * (t / NPL) + 8 * g, col0 = 32 * (t % NPL) + 4 * h;
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = row0 + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = col0 + 32 * j + v;
          if (n < nx && i < nx) r[n * nx + i] = s.acc[j][u][v];
        }
      }
  }
  __syncthreads();
  return r;
}

}  // namespace dfr
