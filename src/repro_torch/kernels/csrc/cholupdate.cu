// K3: rank-1 window fold of sample rows into live transposed Cholesky factors.
//
// Replaces the TPU kernel src/repro/kernels/cholupdate.py:_cholupd_tile
// (entries cholupdate_block, cholupdate_block_batched).  For each of K
// systems it rotates W rows x_w, in stream order, into the transposed factor
// Lt = L^T (upper triangular, row-major): Lt'^T Lt' = Lt^T Lt + sign x x^T
// per row, sign -1 being the hyperbolic downdate with the reference's guard
// (repro.core.ridge._guarded_rotation: an indefinite rotation becomes the
// identity).
//
// Rotation k of a row touches row k of Lt (column k of L, contiguous here)
// and the tail of x.  The kernel loops k outside and the W rows inside: at
// step k every row element j > k takes the W rotations of column k in
// stream order, which is the same sequence of operations each element sees
// in the sample-by-sample sweep, and row k of Lt is read once and written
// once per launch instead of W times.  The W rotation scalars of column k
// form a chain through the diagonal (r of row w is d of row w + 1); every
// thread computes that chain itself from the diagonal and x_w[k], so one
// block barrier per k suffices.  Zero rows are exact no-ops (r = d, c = 1,
// s = 0).
//
// Layout: one block per system; thread t owns row elements t, t + nt, ...
// of every row (nt = threads per block), the W sample rows live in shared
// memory, and the next row of Lt is prefetched into registers while the
// current one is rotated (row k + 1 is not touched by step k).  The fp32
// chain is written with round-to-nearest intrinsics in the plain version's
// order (no FMA contraction), so both compute the same operations.
//
// What bounds it on an H100: the chain of s dependent steps, each a block
// barrier plus W sqrt/divide rotations (about s x W dependent divides).  The
// fold is in place and touches only the upper triangle: each element on or
// right of the diagonal is read once, by the thread that writes it, before
// it is written once.  Those bytes would take ~0.033 ms at (32, 931, 931);
// the flops (about 6 per element per rotation) far less.
#include <cuda_runtime.h>

namespace {

constexpr float kGuardRel = 1e-6f;   // repro.core.ridge.DOWNDATE_GUARD_REL
constexpr int kMaxThreads = 1024;
constexpr int kMaxElems = 4;         // row elements per thread: s <= 4096
constexpr int kChunk = 8;            // sample rows folded per pass

__global__ void __launch_bounds__(kMaxThreads)
cholupdate_kernel(float* Lt, const float* __restrict__ X, int s, int w,
                  float sign) {
  extern __shared__ float xs[];     // (min(w, kChunk), s) sample rows
  __shared__ float diag[2];         // Lt[k][k] of the next step
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * s;
  const float* xg = X + static_cast<size_t>(blockIdx.x) * w * s;
  float* lt = Lt + base;

  for (int w0 = 0; w0 < w; w0 += kChunk) {
    const int wc = min(kChunk, w - w0);
    for (int i = tid; i < wc * s; i += nt) xs[i] = xg[w0 * s + i];

    float next[kMaxElems];
#pragma unroll
    for (int e = 0; e < kMaxElems; ++e) {
      const int jj = tid + e * nt;
      next[e] = jj < s ? lt[jj] : 0.0f;
    }
    if (tid == 0) diag[0] = next[0];
    __syncthreads();

    for (int k = 0; k < s; ++k) {
      // rotation chain of column k: (c, sign * sk, sk) of each sample row
      float c[kChunk], ssk[kChunk], sk[kChunk];
      float d = diag[k & 1];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        if (r < wc) {
          const float xk = xs[r * s + k];
          const float dd = __fmul_rn(d, d);
          const float rad = __fadd_rn(dd, __fmul_rn(__fmul_rn(sign, xk), xk));
          const bool bad = rad <= __fmul_rn(kGuardRel, dd);
          const float rr = bad ? d : __fsqrt_rn(rad);
          c[r] = __fdiv_rn(rr, d);
          sk[r] = bad ? 0.0f : __fdiv_rn(xk, d);
          ssk[r] = __fmul_rn(sign, sk[r]);
          d = rr;
        }
      }

      float row[kMaxElems];
#pragma unroll
      for (int e = 0; e < kMaxElems; ++e) {
        row[e] = next[e];
        const int jj = tid + e * nt;
        // prefetch row k + 1 from its diagonal on
        next[e] = (k + 1 < s && jj < s && jj > k)
                      ? lt[static_cast<size_t>(k + 1) * s + jj]
                      : 0.0f;
      }

      float* drow = lt + static_cast<size_t>(k) * s;
#pragma unroll
      for (int e = 0; e < kMaxElems; ++e) {
        const int jj = tid + e * nt;
        if (jj >= s) break;
        if (jj > k) {
          float v = row[e];
#pragma unroll
          for (int r = 0; r < kChunk; ++r) {
            if (r < wc) {
              const float xv = xs[r * s + jj];
              v = __fdiv_rn(__fadd_rn(v, __fmul_rn(ssk[r], xv)), c[r]);
              xs[r * s + jj] =
                  __fsub_rn(__fmul_rn(c[r], xv), __fmul_rn(sk[r], v));
            }
          }
          drow[jj] = v;
        } else if (jj == k) {
          drow[jj] = d;
        }
        // publish the next diagonal; it was prefetched with row k + 1
        if (jj == k + 1) diag[(k + 1) & 1] = next[e];
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int dfr_cholupdate_window_t(float* Lt, const float* X, int n_sys,
                                       int s, int w, float sign, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((s + kMaxElems - 1) / kMaxElems + 31) / 32 * 32;
  threads = max(threads, min(kMaxThreads, (s + 31) / 32 * 32));
  const size_t smem = sizeof(float) * static_cast<size_t>(min(w, kChunk)) * s;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cholupdate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cholupdate_kernel<<<n_sys, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(Lt, X, s, w, sign);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
