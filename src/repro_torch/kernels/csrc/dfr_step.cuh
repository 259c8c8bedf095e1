// Shared time loop of the two DFR kernels (train.cu: K1, streaming.cu: K2).
//
// One warp runs one sample.  Lane n holds node n's state x_n (Nx <= 32; the
// lanes n >= Nx hold zeros) and row n of the (Nx, Nx+1) DPRR accumulator in
// registers, so neither the state sequence X nor the accumulator ever touches
// device memory: a sample reads its (T, Nx) masked inputs once and writes its
// outputs once.
//
// Step k (paper Eq. 14 in the ring closed form):
//   a_n   = p * f(j(k)_n + x(k-1)_n)
//   x(k)_n = sum_{i<=n} q^(n-i) a_i + q^(n+1) x(k-1)_{Nx-1}
// with a_i broadcast by __shfl_sync, and the DPRR update
//   acc[n][j] += x(k)_n x(k-1)_j,   acc[n][Nx] += x(k)_n.
// The loop stops at the sample's length: past it the reference freezes the
// state and adds nothing, so the frozen steps need no work at all.
#pragma once

#include <cuda_runtime.h>

namespace dfr {

constexpr int kMaxNodes = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// Nonlinearity codes (repro_torch.core.types.NONLINEARITY_CODES).
__device__ __forceinline__ float nonlin(float z, int code, float alpha) {
  if (code == 0) return alpha * z;                 // linear
  if (code == 1) return tanhf(alpha * z);          // tanh
  return z / (1.0f + fabsf(z) * fabsf(z));         // Mackey-Glass, p = 2
}

// q^e for an integer e >= 0 with the reference's sign rule (ring_matrix):
// |q|^e, negated for odd e when q < 0.
__device__ __forceinline__ float signed_pow(float q, int e) {
  const float m = powf(fabsf(q), static_cast<float>(e));
  return (q < 0.0f && (e & 1)) ? -m : m;
}

struct SampleResult {
  float x;                    // x(T)_n
  float acc[kMaxNodes];       // acc[n][j] for j < Nx (zeros past Nx)
  float acc_sum;              // acc[n][Nx]
  float x_bnd;                // x(T-1)_n, latched before the last update
  float j_bnd;                // j(T)_n
};

// Runs one sample's reservoir and DPRR.  Every lane of the warp must call it
// with the same `len` (the shuffles use the full mask).
__device__ __forceinline__ void run_sample(const float* __restrict__ j,
                                           int T, int nx, int len, float p,
                                           float q, int code, float alpha,
                                           SampleResult& out) {
  const int lane = threadIdx.x & 31;
  const bool node = lane < nx;

  float l_row[kMaxNodes];  // row `lane` of L(q)
#pragma unroll
  for (int i = 0; i < kMaxNodes; ++i)
    l_row[i] = (node && i <= lane) ? signed_pow(q, lane - i) : 0.0f;
  const float qpow = node ? signed_pow(q, lane + 1) : 0.0f;

  float x = 0.0f, acc_sum = 0.0f, x_bnd = 0.0f, j_bnd = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxNodes; ++i) out.acc[i] = 0.0f;

  len = min(max(len, 0), T);
  float j_next = (node && len > 0) ? __ldg(j + lane) : 0.0f;
  for (int k = 0; k < len; ++k) {
    const float jk = j_next;
    if (node && k + 1 < len) j_next = __ldg(j + (k + 1) * nx + lane);
    const float xp = x;
    const float ring = __shfl_sync(kFullMask, xp, nx - 1);
    const float a = node ? p * nonlin(jk + xp, code, alpha) : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxNodes; ++i)
      s = fmaf(l_row[i], __shfl_sync(kFullMask, a, i), s);
    const float xk = node ? fmaf(ring, qpow, s) : 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxNodes; ++i)
      out.acc[i] = fmaf(xk, __shfl_sync(kFullMask, xp, i), out.acc[i]);
    acc_sum += xk;
    x_bnd = xp;  // the value of the last live step survives the loop
    j_bnd = jk;
    x = xk;
  }
  out.x = x;
  out.acc_sum = acc_sum;
  out.x_bnd = x_bnd;
  out.j_bnd = j_bnd;
}

}  // namespace dfr
