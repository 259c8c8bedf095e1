// The reservoir step of the fp32 DFR kernels: scan_step, which K1 and K2
// (through dfr_sample.cuh) and K6 (reservoir.cu) run.  K5
// (streaming_q8.cu) runs its own integer step.
//
// One warp runs one sample.  Lane n holds node n's state x_n (Nx <= 32), so
// a step is a chain of shuffles across the warp; the step below keeps that
// chain to 6 shuffles and 7 dependent operations.
//
// Step k (paper Eq. 14 in the ring closed form):
//   a_n   = p * f(j(k)_n + x(k-1)_n)
//   x(k)_n = sum_{i<=n} q^(n-i) a_i + q^(n+1) x(k-1)_{Nx-1}
// The loop stops at the sample's length: past it the reference freezes the
// state and adds nothing, so the frozen steps need no work at all.
#pragma once

#include <cuda_runtime.h>

namespace dfr {

constexpr int kMaxNodes = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Nonlinearity codes (repro_torch.core.types.NONLINEARITY_CODES).
__device__ __forceinline__ float nonlin(float z, int code, float alpha) {
  if (code == 0) return alpha * z;                 // linear
  if (code == 1) return tanhf(alpha * z);          // tanh
  return z / (1.0f + fabsf(z) * fabsf(z));         // Mackey-Glass, p = 2
}

// The ring mix of a step is the delay line's recurrence
//   x(k)_n = q x(k)_{n-1} + a_n,   x(k)_{-1} = x(k-1)_{Nx-1},
// so a Kogge-Stone scan of a over the lanes gives sum_{i<=n} q^(n-i) a_i in
// 5 rounds of __shfl_up_sync and fmaf, with q^(2^s) in registers, and the
// wrap enters at the end as q^(n+1) x(k-1)_{Nx-1}, its shuffle off the
// chain: 6 shuffles and a 7-deep dependent chain a step, and no row of the
// ring matrix L(q).  The sum is the closed form's up to fp32
// reassociation, and so is a for linear f, taken as (p alpha) j +
// (p alpha) x(k-1) so that one FMA is on the chain.  Lanes n >= Nx (given
// j = 0) carry the ring on past the last node; only lanes above them read
// their values, so the caller stores lanes n < Nx only (or zeros in their
// place).
struct RingScan {
  float qd[5];   // q^(2^s) on lanes >= 2^s, 0 below
  float qpow;    // q^(lane+1), the wrap's power
};

__device__ __forceinline__ void make_scan(float q, RingScan& scan) {
  const int lane = threadIdx.x & 31;
  float qs = q;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    scan.qd[s] = lane >= (1 << s) ? qs : 0.0f;
    qs *= qs;
  }
  float v = lane == 0 ? q : 0.0f;  // the scan of (q, 0, ..., 0)
#pragma unroll
  for (int d = 0; d < 5; ++d)
    v = fmaf(scan.qd[d], __shfl_up_sync(kFullMask, v, 1 << d), v);
  scan.qpow = v;
}

// scan_step's input term: p alpha j(k) for linear f (off the chain), else
// j(k).
__device__ __forceinline__ float scan_input(float jk, float p, int code,
                                            float alpha) {
  return code == 0 ? (p * alpha) * jk : jk;
}

// One live step from pj = scan_input(j(k)) and x(k-1).  Every lane of the
// warp must call it.
__device__ __forceinline__ float scan_step(const RingScan& scan, float pj,
                                           float xp, int nx, float p,
                                           int code, float alpha) {
  const float wrap = __shfl_sync(kFullMask, xp, nx - 1);
  float s = code == 0 ? fmaf(p * alpha, xp, pj)
                      : p * nonlin(pj + xp, code, alpha);
#pragma unroll
  for (int d = 0; d < 5; ++d)
    s = fmaf(scan.qd[d], __shfl_up_sync(kFullMask, s, 1 << d), s);
  return fmaf(scan.qpow, wrap, s);
}

}  // namespace dfr
