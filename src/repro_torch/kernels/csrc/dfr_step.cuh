// Shared reservoir steps of the DFR kernels: ring_step and the time loop
// run_sample for K1 (train.cu) and K2 (streaming.cu), scan_step for K6
// (reservoir.cu).  K5 (streaming_q8.cu) runs its own integer step.
//
// What bounds K1 and K2: the chain of ring_step, a step's 33 shuffles and
// 32 dependent FMAs, with each step's input loaded one step ahead from
// device memory.  K6's scan_step shortens the chain to 6 shuffles (below).
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

// Row `lane` of the ring matrix L(q) and the wrap power q^(lane+1), held in
// registers for the whole time loop (zeros on lanes n >= Nx).
struct Ring {
  float l_row[kMaxNodes];
  float qpow;
};

__device__ __forceinline__ void make_ring(float q, int nx, Ring& ring) {
  const int lane = threadIdx.x & 31;
  const bool node = lane < nx;
#pragma unroll
  for (int i = 0; i < kMaxNodes; ++i)
    ring.l_row[i] = (node && i <= lane) ? signed_pow(q, lane - i) : 0.0f;
  ring.qpow = node ? signed_pow(q, lane + 1) : 0.0f;
}

// One live step of the warp's sample: x(k)_lane from j(k)_lane and
// x(k-1)_lane (zeros on lanes n >= Nx).  Every lane of the warp must call it.
__device__ __forceinline__ float ring_step(const Ring& ring, float jk,
                                           float xp, int nx, float p,
                                           int code, float alpha) {
  const int lane = threadIdx.x & 31;
  const bool node = lane < nx;
  const float wrap = __shfl_sync(kFullMask, xp, nx - 1);
  const float a = node ? p * nonlin(jk + xp, code, alpha) : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxNodes; ++i)
    s = fmaf(ring.l_row[i], __shfl_sync(kFullMask, a, i), s);
  return node ? fmaf(wrap, ring.qpow, s) : 0.0f;
}

// K6's step: the x(k) of ring_step, with the ring mix taken as the linear
// scan it is.  The closed form above is the delay line's recurrence
//   x(k)_n = q x(k)_{n-1} + a_n,   x(k)_{-1} = x(k-1)_{Nx-1},
// so a Kogge-Stone scan of a over the lanes gives sum_{i<=n} q^(n-i) a_i in
// 5 rounds of __shfl_up_sync and fmaf, with q^(2^s) in registers, and the
// wrap enters at the end as q^(n+1) x(k-1)_{Nx-1}, its shuffle off the
// chain: 6 shuffles and a 7-deep dependent chain a step in place of
// ring_step's 33 shuffles and 32-deep FMA chain, and no row of L(q).  The
// sum is the same up to fp32 reassociation, and so is a for linear f,
// taken as (p alpha) j + (p alpha) x(k-1) so that one FMA is on the chain.
// Lanes n >= Nx (given j = 0) carry the ring on past the last node; only
// lanes above them read their values, so the caller stores lanes n < Nx
// only.
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

  Ring ring;
  make_ring(q, nx, ring);

  float x = 0.0f, acc_sum = 0.0f, x_bnd = 0.0f, j_bnd = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxNodes; ++i) out.acc[i] = 0.0f;

  len = min(max(len, 0), T);
  float j_next = (node && len > 0) ? __ldg(j + lane) : 0.0f;
  for (int k = 0; k < len; ++k) {
    const float jk = j_next;
    if (node && k + 1 < len) j_next = __ldg(j + (k + 1) * nx + lane);
    const float xp = x;
    const float xk = ring_step(ring, jk, xp, nx, p, code, alpha);
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
