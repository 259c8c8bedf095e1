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
// Rotation k of a row touches row k of Lt and the tail of x.  The kernel
// loops k (the step) outside and the rows of a pass (up to 8) inside: at
// step k every element j > k of row k takes the W rotations of column k in
// stream order, the same sequence of rounded operations each element sees
// in the plain version's sample-by-sample sweep (no FMA contraction), and
// row k of Lt is read once and written once a pass.  Zero rows are exact
// no-ops (r = d, c = 1, s = 0).
//
// What bounds it on an H100: the chain, not the bytes (~0.033 ms at
// (32, 4, 931)) nor the flops.  Step k's W rotations need x_w[k] after
// every earlier step, so the s steps are dependent, each W square roots
// down the diagonal and W divides along element k + 1.  The design keeps
// that chain short and off the rest of the block:
//   * one block of 256 threads per factor.  Warp 0 runs the chain: at step
//     t (all lanes alike) the W rotations of column t from the diagonal and
//     x_w[t] in registers, then element t + 1, which it owns for its last
//     two steps, so x_w[t + 1] is in its registers for step t + 1.  It
//     publishes the step's (c, 1/c, sign s, s) to shared memory.  Warps 1-7
//     (the trailing update) apply step t - 1 to the elements j >= t + 2,
//     one thread every 224th element, two elements at a time, while warp 0
//     runs step t: one block barrier a step;
//   * nothing on the chain reads device memory: Lt's diagonal and its first
//     two super-diagonals sit in shared memory for the whole launch, and the
//     chain writes each pass's new values there for the next pass.  The
//     trailing update's rows of Lt come by one bulk copy a row (the tensor
//     memory accelerator) into a 6-row ring, four steps ahead, each slot
//     with its barrier;
//   * the divides and square roots are the fast-path sequences of
//     rounding.cuh, 1/c refined once per rotation and shared by every
//     element's divide by c.  An operand outside their checked range makes
//     the chain's step, or a pair of trailing elements, compute again with
//     the correctly rounded intrinsics from the same operands, so the fold
//     rounds as the plain version does everywhere;
//   * a pass runs with its row count as a compile-time constant, so no
//     predicated-off rotation takes an issue slot.  One pass body with a
//     runtime row count (loops unrolled to kChunk, rows past it skipped)
//     took 1.6x as long at (32, 4, 931) on an H100
//     (src/repro_torch/launch/ab_time.py).
// What holds it now: the chain's W rotations a step, one after another,
// each a chain of dependent instructions (square root, divides, 1/c) in a
// warp alone on its scheduler, and the trailing update, which takes about
// as long a step.  A wavefront that overlaps the W rotations of a step was
// slower: its trailing update did W rotations a tick on partial rows in
// shared memory.
// Shared memory: about 4 s (rows + 9) bytes; passes of 8 rows up to
// s = 3400, fewer above (5 at s = 4096).
#include <cuda_runtime.h>

#include <cstdint>

#include "rounding.cuh"

namespace {

constexpr float kGuardRel = 1e-6f;   // repro.core.ridge.DOWNDATE_GUARD_REL
constexpr int kThreads = 256;        // warp 0: the chain; 1-7: the trailing
constexpr int kTrail = kThreads - 32;
constexpr int kChunk = 8;            // sample rows a pass, at most
constexpr int kRing = 6;             // ring slots for rows of Lt
constexpr size_t kMaxSmem = 232448;  // shared memory a block may take

struct alignas(16) Coef {
  float c, rc, ssk, sk;              // cosine, 1/c, sign * sine, sine
};
// coefficients of two steps, their two flags, the ring's barriers
constexpr size_t kHeader = 2 * kChunk * sizeof(Coef) + 16 + 8 * kRing;

// a ring slot: a row's elements from q + 3 on, from the 16-byte boundary
// at or before it, in whole 16-byte units
__host__ __device__ constexpr int slot_floats(int s) { return (s + 11) & ~3; }

__host__ __device__ constexpr size_t smem_bytes(int s, int rows) {
  return kHeader + sizeof(float) * (static_cast<size_t>(s) * (rows + 3) +
                                    static_cast<size_t>(kRing) *
                                        slot_floats(s));
}

// ---- bulk copies (the tensor memory accelerator) and their barriers ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
}

// One copy of `bytes` (a multiple of 16, both ends 16-byte aligned) that
// completes the barrier's current phase when it lands.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"(smem_u32(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Row q's elements j >= q + 3 as the ring holds them: the copy starts
// `head` floats before element q + 3, at a 16-byte boundary, and ends at
// one past the row's end (rows q <= s - 4 only, so inside the factor).
struct RowCopy {
  const float* src;
  int head;
  unsigned bytes;
};

__device__ __forceinline__ RowCopy row_copy(const float* lt, int s, int q) {
  const float* const first = lt + static_cast<size_t>(q) * s + q + 3;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(first) >> 2) & 3;
  const int n = s - (q + 3) + head;
  return {first - head, head, static_cast<unsigned>((n + 3) & ~3) * 4u};
}

// The rotations of one column for the WC rows of a pass, in stream order,
// from the diagonal d (the reference's _guarded_rotation); returns the new
// diagonal.
template <int WC, bool kExact>
__device__ __forceinline__ float rotations(float d, const float (&xk)[WC],
                                           float sign, Coef (&cf)[WC],
                                           bool& bad) {
#pragma unroll
  for (int r = 0; r < WC; ++r) {
    const float x = xk[r];
    const float dd = __fmul_rn(d, d);
    const float rad = __fadd_rn(dd, __fmul_rn(__fmul_rn(sign, x), x));
    const bool skip = rad <= __fmul_rn(kGuardRel, dd);
    const float rr = skip ? d : sqrt_rn<kExact>(skip ? 1.0f : rad, bad);
    float c, q;
    if (kExact) {
      c = __fdiv_rn(rr, d);
      q = __fdiv_rn(x, d);
    } else {
      bad |= !in_range(d, kDivLo, kDivHi);
      const float rd = rcp_refined(d);
      c = div_by(rr, d, rd, bad);
      q = div_by(x, d, rd, bad);
    }
    const float sk = skip ? 0.0f : q;
    cf[r] = Coef{c, rcp_refined(c), __fmul_rn(sign, sk), sk};
    d = rr;
  }
  return d;
}

// One element's WC rotations of a column: v, Lt's value, and xin, its
// sample rows' values, into the new v (returned) and xout (which may be
// xin).
template <int WC, bool kExact>
__device__ __forceinline__ float rotate(float v, const float (&xin)[WC],
                                        float (&xout)[WC],
                                        const Coef (&cf)[WC], bool& bad) {
#pragma unroll
  for (int r = 0; r < WC; ++r) {
    const float xv = xin[r];
    const float a = __fadd_rn(v, __fmul_rn(cf[r].ssk, xv));
    v = kExact ? __fdiv_rn(a, cf[r].c) : div_by(a, cf[r].c, cf[r].rc, bad);
    xout[r] = __fsub_rn(__fmul_rn(cf[r].c, xv), __fmul_rn(cf[r].sk, v));
  }
  return v;
}

template <int WC>
__device__ __forceinline__ bool coef_out_of_range(const Coef (&cf)[WC]) {
  bool out = false;
#pragma unroll
  for (int r = 0; r < WC; ++r) out |= !in_range(cf[r].c, kDivLo, kDivHi);
  return out;
}

// Column j of the pass's sample rows (row stride s).
template <int WC>
__device__ __forceinline__ void load_column(const float* xs, int s, int j,
                                            float (&x)[WC]) {
#pragma unroll
  for (int r = 0; r < WC; ++r) x[r] = xs[r * s + j];
}

template <int WC>
__device__ __forceinline__ void load_coef(const Coef* src, Coef (&cf)[WC]) {
#pragma unroll
  for (int r = 0; r < WC; ++r) cf[r] = src[r];
}

// The smallest j >= lo with j = jt (mod kTrail): a trailing thread's first
// element at or after lo.
__device__ __forceinline__ int first_owned(int jt, int lo) {
  return lo <= jt ? jt : jt + (lo - jt + kTrail - 1) / kTrail * kTrail;
}

struct Smem {
  Coef (*coef)[kChunk];   // [2][kChunk]: steps t and t - 1
  int* cbad;              // [2]: a c of the step outside the divide range
  uint64_t* bar;          // [kRing]: a ring slot's row has landed
  float *xs, *diag, *sup1, *sup2, *ring;
  int slot;               // floats a ring slot
};

// One pass: the WC sample rows in xs rotated into lt, steps 0 .. s - 1.
template <int WC>
__device__ void fold_pass(float* lt, int s, float sign, const Smem& sm,
                          unsigned& phases) {
  const int tid = threadIdx.x;
  const int jt = tid - 32;  // a trailing thread's elements: jt (mod kTrail)

  // chain state: x_w[t] after steps < t, and diag[t]
  float xk[WC];
  float d_next = sm.diag[0];
#pragma unroll
  for (int r = 0; r < WC; ++r) xk[r] = sm.xs[r * s];

  // trailing: row q (elements q + 3 on) into ring slot q % kRing by one
  // bulk copy, issued by the first trailing thread four steps before its
  // use; every trailing thread waits for it once, so each keeps the slots'
  // phases (across passes)
  auto load_row = [&](int q) {
    if (tid == 32 && q + 3 < s) {
      const RowCopy rc = row_copy(lt, s, q);
      bulk_load(sm.ring + (q % kRing) * sm.slot, rc.src, rc.bytes,
                sm.bar + q % kRing);
    }
  };
  for (int q = 0; q < kRing - 1; ++q) load_row(q);

  for (int t = 0; t < s; ++t) {
    const bool next = t + 1 < s;
    if (tid < 32) {
      // ---- the chain: step t, and element t + 1's steps t - 1 and t ----
      const float d0 = d_next;
      if (next) d_next = sm.diag[t + 1];
      const int jn = next ? t + 1 : 0;
      float xn[WC], xc[WC];  // element t + 1 after step t - 2, t
      load_column<WC>(sm.xs, s, jn, xn);
      const float u1 = sm.sup1[t], u2 = t >= 1 ? sm.sup2[t - 1] : 0.0f;
      const bool step_b = t >= 1 && next;
      Coef cf[WC], pv[WC];  // steps t and t - 1 (published last step)
      load_coef<WC>(sm.coef[(t - 1) & 1], pv);
      bool bad = step_b && sm.cbad[(t - 1) & 1];
      float dnew = rotations<WC, false>(d0, xk, sign, cf, bad);
      float vb = u2, vc = u1;
      if (step_b) vb = rotate<WC, false>(u2, xn, xn, pv, bad);
      bool cbad = coef_out_of_range(cf);
      bad |= next && cbad;
      if (next) vc = rotate<WC, false>(u1, xn, xc, cf, bad);
      if (bad) {  // the step again with the intrinsics (d0, xk kept)
        dnew = rotations<WC, true>(d0, xk, sign, cf, bad);
        cbad = coef_out_of_range(cf);
        load_column<WC>(sm.xs, s, jn, xn);
        if (step_b) vb = rotate<WC, true>(u2, xn, xn, pv, bad);
        if (next) vc = rotate<WC, true>(u1, xn, xc, cf, bad);
      }
      if (tid == 0) {
#pragma unroll
        for (int r = 0; r < WC; ++r) sm.coef[t & 1][r] = cf[r];
        sm.cbad[t & 1] = cbad;
        sm.diag[t] = dnew;
        lt[static_cast<size_t>(t) * s + t] = dnew;
        if (step_b) {
          sm.sup2[t - 1] = vb;
          lt[static_cast<size_t>(t - 1) * s + t + 1] = vb;
        }
        if (next) {
          sm.sup1[t] = vc;
          lt[static_cast<size_t>(t) * s + t + 1] = vc;
        }
      }
#pragma unroll
      for (int r = 0; r < WC; ++r) xk[r] = xc[r];
    } else if (t >= 1 && t + 2 < s) {
      // ---- the trailing update: step q = t - 1 on elements j >= t + 2 ----
      load_row(t + kRing - 2);
      const int q = t - 1, slot = q % kRing;
      Coef cf[WC];
      load_coef<WC>(sm.coef[q & 1], cf);
      const bool cbad = sm.cbad[q & 1];
      mbar_wait(sm.bar + slot, (phases >> slot) & 1);
      phases ^= 1u << slot;
      const float* const lrow =
          sm.ring + slot * sm.slot + row_copy(lt, s, q).head - (q + 3);
      float* const grow = lt + static_cast<size_t>(q) * s;
      for (int j = first_owned(jt, t + 2); j < s; j += 2 * kTrail) {
        // two elements at once; past the end, j again (not stored)
        const int j1 = j + kTrail < s ? j + kTrail : j;
        float xa[WC], xb[WC];
        load_column<WC>(sm.xs, s, j, xa);
        load_column<WC>(sm.xs, s, j1, xb);
        const float va0 = lrow[j], vb0 = lrow[j1];
        bool bad = cbad;
        float va = rotate<WC, false>(va0, xa, xa, cf, bad);
        float vb = rotate<WC, false>(vb0, xb, xb, cf, bad);
        if (bad) {  // again from the operands, still in shared memory
          load_column<WC>(sm.xs, s, j, xa);
          load_column<WC>(sm.xs, s, j1, xb);
          va = rotate<WC, true>(va0, xa, xa, cf, bad);
          vb = rotate<WC, true>(vb0, xb, xb, cf, bad);
        }
#pragma unroll
        for (int r = 0; r < WC; ++r) sm.xs[r * s + j] = xa[r];
        grow[j] = va;
        if (j1 != j) {
#pragma unroll
          for (int r = 0; r < WC; ++r) sm.xs[r * s + j1] = xb[r];
          grow[j1] = vb;
        }
      }
    }
    __syncthreads();
  }
  // the next pass's bulk copies read what this pass stored
  asm volatile("fence.proxy.async;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
cholupdate_kernel(float* Lt, const float* __restrict__ X, int s, int w,
                  int rows, float sign) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm;
  sm.coef = reinterpret_cast<Coef(*)[kChunk]>(smem);
  sm.cbad = reinterpret_cast<int*>(smem + 2 * kChunk * sizeof(Coef));
  sm.bar = reinterpret_cast<uint64_t*>(smem + 2 * kChunk * sizeof(Coef) + 16);
  sm.slot = slot_floats(s);
  sm.ring = reinterpret_cast<float*>(smem + kHeader);  // 16-byte aligned
  sm.xs = sm.ring + kRing * sm.slot;
  sm.diag = sm.xs + static_cast<size_t>(rows) * s;
  sm.sup1 = sm.diag + s;
  sm.sup2 = sm.sup1 + s;
  const int tid = threadIdx.x;
  if (tid < kRing) mbar_init(sm.bar + tid);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  float* const lt = Lt + static_cast<size_t>(blockIdx.x) * s * s;
  const float* const xg = X + static_cast<size_t>(blockIdx.x) * w * s;

  for (int k = tid; k < s; k += kThreads) {
    const float* const row = lt + static_cast<size_t>(k) * s + k;
    sm.diag[k] = row[0];
    sm.sup1[k] = k + 1 < s ? row[1] : 0.0f;
    sm.sup2[k] = k + 2 < s ? row[2] : 0.0f;
  }
  unsigned phases = 0;  // bit i: the parity of ring slot i's next phase
  for (int w0 = 0; w0 < w; w0 += rows) {
    const int wc = min(rows, w - w0);
    for (int i = tid; i < wc * s; i += kThreads)
      sm.xs[i] = xg[static_cast<size_t>(w0) * s + i];
    __syncthreads();
    switch (wc) {  // uniform across the block
      case 1: fold_pass<1>(lt, s, sign, sm, phases); break;
      case 2: fold_pass<2>(lt, s, sign, sm, phases); break;
      case 3: fold_pass<3>(lt, s, sign, sm, phases); break;
      case 4: fold_pass<4>(lt, s, sign, sm, phases); break;
      case 5: fold_pass<5>(lt, s, sign, sm, phases); break;
      case 6: fold_pass<6>(lt, s, sign, sm, phases); break;
      case 7: fold_pass<7>(lt, s, sign, sm, phases); break;
      default: fold_pass<8>(lt, s, sign, sm, phases); break;
    }
  }
}

}  // namespace

extern "C" int dfr_cholupdate_window_t(float* Lt, const float* X, int n_sys,
                                       int s, int w, float sign, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = kChunk;
  while (rows > 1 && smem_bytes(s, rows) > kMaxSmem) --rows;
  const size_t smem = smem_bytes(s, rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cholupdate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cholupdate_kernel<<<n_sys, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(Lt, X, s, w, rows,
                                                           sign);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
