// The reservoir step of the fp32 DFR kernels: scan_step, which K1 and K2
// (through dfr_sample.cuh) and K6 (reservoir.cu) run.  K5
// (streaming_q8.cu) runs its own integer step.
//
// One warp runs one sample.  Up to 32 nodes, lane n holds node n's state
// x_n, so a step is a chain of shuffles across the warp; the step below
// keeps that chain to 6 shuffles and 7 dependent operations.  Up to
// kMaxNodes, lane l holds the NPL = ceil(Nx / 32) contiguous nodes
// l NPL .. l NPL + NPL - 1 (scan_step_n), so the step stays on one warp
// with NPL - 1 more dependent FMAs and one more shuffle on the chain.
//
// Step k (paper Eq. 14 in the ring closed form):
//   a_n   = p * f(j(k)_n + x(k-1)_n)
//   x(k)_n = sum_{i<=n} q^(n-i) a_i + q^(n+1) x(k-1)_{Nx-1}
// The loop stops at the sample's length: past it the reference freezes the
// state and adds nothing, so the frozen steps need no work at all.
#pragma once

#include <cuda_runtime.h>

namespace dfr {

constexpr int kWarpNodes = 32;  // one node a lane (NPL = 1)
constexpr int kMaxNodes = 128;  // four nodes a lane (NPL = 4)
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

// ---- NPL > 1 nodes a lane ----
//
// Lane l's nodes n = l NPL + i.  A step runs three stages:
//   * the lane's own scan in registers, s_i = q s_{i-1} + a_i (NPL - 1
//     dependent FMAs), whose last value T_l is the lane's total;
//   * the 5-round shuffle scan of the totals, shifted up one lane first,
//     with powers of Q = q^NPL: e_l = sum_{m<l} Q^(l-1-m) T_m, the
//     carry into lane l's first node;
//   * x(k)_n = s_i + q^(i+1) e_l + q^(n+1) x(k-1)_{Nx-1}, the wrap's term
//     added while the carry is scanned, so one FMA a node after it.
// The wrap is read from the lane and register of node Nx - 1 (a shuffle
// a register, then a select), off the chain.  Nodes n >= Nx
// (given j = 0) carry the ring on past the last node; only nodes above
// them read their values, so the caller stores nodes n < Nx only.
template <int NPL>
struct RingScanN {
  float qd[5];        // Q^(2^s) on lanes >= 2^s, 0 below
  float qloc[NPL];    // q^(i+1)
  float qwrap[NPL];   // q^(l NPL + i + 1), the wrap's powers
  int wlane, wreg;    // where node Nx - 1 lives
};

template <int NPL>
__device__ __forceinline__ void make_scan_n(float q, int nx,
                                            RingScanN<NPL>& scan) {
  const int lane = threadIdx.x & 31;
  float qi = 1.0f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    qi *= q;
    scan.qloc[i] = qi;
  }
  float qs = qi;  // Q
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    scan.qd[s] = lane >= (1 << s) ? qs : 0.0f;
    qs *= qs;
  }
  float v = lane == 0 ? qi : 0.0f;  // the scan of (Q, 0, ..., 0): Q^(l+1)
#pragma unroll
  for (int d = 0; d < 5; ++d)
    v = fmaf(scan.qd[d], __shfl_up_sync(kFullMask, v, 1 << d), v);
  const float up = __shfl_up_sync(kFullMask, v, 1);
  const float ql = lane == 0 ? 1.0f : up;  // Q^l
#pragma unroll
  for (int i = 0; i < NPL; ++i) scan.qwrap[i] = ql * scan.qloc[i];
  scan.wlane = (nx - 1) / NPL;
  scan.wreg = (nx - 1) % NPL;
}

// One live step: x (lane's nodes, x(k-1) in, x(k) out) from
// pj = scan_input(j(k)) of the same nodes.  Every lane must call it.
template <int NPL>
__device__ __forceinline__ void scan_step_n(const RingScanN<NPL>& scan,
                                            const float (&pj)[NPL],
                                            float (&x)[NPL], float p,
                                            int code, float alpha) {
  const int lane = threadIdx.x & 31;
  // each register's value from the wrap's lane, then a select: selecting
  // among x's registers first would index x, and put it in local memory
  float wrap = __shfl_sync(kFullMask, x[0], scan.wlane);
#pragma unroll
  for (int i = 1; i < NPL; ++i) {
    const float w = __shfl_sync(kFullMask, x[i], scan.wlane);
    wrap = i == scan.wreg ? w : wrap;
  }
  float s[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    s[i] = code == 0 ? fmaf(p * alpha, x[i], pj[i])
                     : p * nonlin(pj[i] + x[i], code, alpha);
#pragma unroll
  for (int i = 1; i < NPL; ++i) s[i] = fmaf(scan.qloc[0], s[i - 1], s[i]);
  const float up = __shfl_up_sync(kFullMask, s[NPL - 1], 1);
  float e = lane == 0 ? 0.0f : up;
#pragma unroll
  for (int d = 0; d < 5; ++d)
    e = fmaf(scan.qd[d], __shfl_up_sync(kFullMask, e, 1 << d), e);
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    x[i] = fmaf(scan.qloc[i], e, fmaf(scan.qwrap[i], wrap, s[i]));
}

}  // namespace dfr
