// A warp's sample inputs staged in shared memory ahead of its time loop
// (K1 and K2 through dfr_sample.cuh, K5 in streaming_q8.cu, K6 in
// reservoir.cu).
//
// A sample's live rows j(0), ..., j(len-1), Nx <= kNodes floats each (the
// template argument: kWarpNodes, or kMaxNodes for NPL > 1) and contiguous
// in device memory, stream through a ring of kStageSlots chunks of
// kStageChunk rows by cp.async, and no row past the length is read.  A
// chunk's words keep their 16-byte phase in shared memory, so the lanes copy
// its middle 16 bytes at a time and only its first and last few words 4
// bytes at a time, every copy predicated rather than branched around.
// Chunk 0 is issued before the sample's length is read (start_first), the
// other slots after (start_rest).  A chunk is taken whole into registers as
// soon as it has landed (take), which frees its slot for the chunk
// kStageSlots further on: each chunk is copied while the chunk before it
// runs, so only the first chunk's latency is waited for.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "dfr_step.cuh"

namespace dfr {

constexpr int kStageChunk = 16;                  // rows a cp.async group
constexpr int kStageSlots = 2;                   // chunks in the ring

// Floats a ring slot takes for rows of nx floats: a chunk and up to 3 words
// of phase, in whole 16-byte units.
__host__ __device__ constexpr int stage_slot_floats(int nx) {
  return (kStageChunk * nx + 3 + 3) & ~3;
}

// Predicated cp.async of 4 or 16 bytes: the predicate sits on the copy
// instruction itself, so a warp whose lanes copy different counts does not
// diverge and reconverge around each copy.
__device__ __forceinline__ void cp_async4_if(bool on, float* dst,
                                             const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(s),
      "l"(src), "r"(static_cast<int>(on)));
}

__device__ __forceinline__ void cp_async16_if(bool on, float* dst,
                                              const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(s),
      "l"(src), "r"(static_cast<int>(on)));
}

template <int kNodes = kWarpNodes>
struct RowStage {
  float* ring;        // kStageSlots * stage_slot_floats(nx) floats, 16-byte
                      // aligned, of shared memory
  const float* src;   // the sample's (T, nx) rows
  int nx;
  int len;            // live rows, in [0, T]; set before start_rest

  // Chunk c's first word in its slot: the slot plus the chunk's 16-byte
  // phase in device memory.
  __device__ __forceinline__ float* slot(int c) const {
    const float* const s0 = src + c * kStageChunk * nx;
    const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(s0) >> 2) & 3;
    return ring + (c % kStageSlots) * stage_slot_floats(nx) + ph;
  }

  // Chunk c's rows below `rows` into its slot: lane l copies the l-th
  // 16-byte piece of every 32, and lanes below 3 the 4-byte words before
  // and after them.  Every lane commits a group, empty or not, so the
  // lanes' group counts stay equal.
  __device__ __forceinline__ void issue(int c, int rows) const {
    const int lane = threadIdx.x & 31;
    const int k0 = c * kStageChunk;
    const int words = max(min(k0 + kStageChunk, rows) - k0, 0) * nx;
    const float* const s0 = src + k0 * nx;
    float* const d0 = slot(c);
    const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(s0) >> 2) & 3;
    const int head = min((4 - ph) & 3, words);
    const int quads = (words - head) >> 2;
    const int tail = words - head - 4 * quads;
    cp_async4_if(lane < head, d0 + lane, s0 + lane);
#pragma unroll
    for (int i = 0; i < kStageChunk * kNodes / 128; ++i) {
      const int v = lane + 32 * i;
      cp_async16_if(v < quads, d0 + head + 4 * v, s0 + head + 4 * v);
    }
    cp_async4_if(lane < tail, d0 + head + 4 * quads + lane,
                 s0 + head + 4 * quads + lane);
    cp_async_commit();
  }

  // Chunk 0 with the rows that exist whatever the length, so that its copy
  // may overlap the read of the length; take() reads rows past the length
  // as zeros all the same.
  __device__ __forceinline__ void start_first(int T) const {
    issue(0, T);
  }
  __device__ __forceinline__ void start_rest() const {
#pragma unroll
    for (int c = 1; c < kStageSlots; ++c) issue(c, len);
  }

  // Waits for chunk c and loads lane n's value of each of its rows into
  // jr (0 on rows past the length and on lanes n >= nx), then issues chunk
  // c + kStageSlots into the freed slot.  The loads are not predicated (a
  // predicated shared load recomputes its window address from a special
  // register each time): lanes n >= nx read up to 31 words past the slot,
  // which the caller's shared memory must hold.
  __device__ __forceinline__ void take(int c, float (&jr)[kStageChunk]) const {
    cp_async_wait<kStageSlots - 1>();  // this lane's copies of chunk c
    __syncwarp();                      // ... and every lane's
    const int lane = threadIdx.x & 31;
    const float* const rows = slot(c);
#pragma unroll
    for (int u = 0; u < kStageChunk; ++u) {
      const float v = rows[u * nx + lane];
      jr[u] = (lane < nx && c * kStageChunk + u < len) ? v : 0.0f;
    }
    __syncwarp();                      // every lane has read the slot
    issue(c + kStageSlots, len);
  }

  // take() for NPL nodes a lane (lane l's nodes l NPL + i), in two halves
  // of a chunk so that a half's rows take 8 NPL registers: half 0 waits
  // for chunk c and loads rows 0-7, half 1 loads rows 8-15 and issues
  // chunk c + kStageSlots into the freed slot.  Nodes n >= nx read up to
  // 31 words past the row, as in take().
  template <int NPL>
  __device__ __forceinline__ void take_half(int c, int half,
                                            float (&jr)[kStageChunk / 2]
                                                       [NPL]) const {
    if (half == 0) {
      cp_async_wait<kStageSlots - 1>();
      __syncwarp();
    }
    const int n0 = (threadIdx.x & 31) * NPL;
    const float* const rows = slot(c) + half * (kStageChunk / 2) * nx;
    const int k0 = c * kStageChunk + half * (kStageChunk / 2);
#pragma unroll
    for (int u = 0; u < kStageChunk / 2; ++u)
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const float v = rows[u * nx + n0 + i];
        jr[u][i] = (n0 + i < nx && k0 + u < len) ? v : 0.0f;
      }
    if (half == 1) {
      __syncwarp();
      issue(c + kStageSlots, len);
    }
  }
};

}  // namespace dfr
