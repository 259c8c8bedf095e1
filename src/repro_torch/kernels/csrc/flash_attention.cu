// K8: flash attention forward (online softmax, causal / sliding window, GQA).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (entry flash_attention_pallas).  For q (B, H, Tq, D) and k, v (B, KV, Tk, D)
// with g = H / KV it computes
//   out[b, h] = softmax(scale * q[b, h] k[b, h / g]^T + mask) v[b, h / g]
// where a key is live if k_pos < Tk, and k_pos <= q_pos when causal, and
// k_pos > q_pos - window when window > 0; row i of q sits at q_pos =
// q_offset + i (a slice of the query rows, as when they split over
// devices, with k and v whole).  Scores, the running max m, the
// running sum l and the accumulator are fp32; a masked score has
// probability 0, so a row with no live key ends with l = 0 and the output
// acc / max(l, 1e-30) = 0, as the TPU kernel gives.  The output is stored
// in the input type (fp32, or bf16 rounded to nearest even).
//
// What bounds it on an H100: operations.  At the LM prefill's shape (B = 4,
// H = 9, KV = 3, T = 4096, D = 64, causal) it does about 7.7e10 flops on
// 50 MB of q, k, v and out: 0.078 ms at the bf16 tensor cores' 989 TFLOP/s
// against 0.015 ms for the bytes.
//
// Two routes, chosen by dtype; neither falls back to the other.
//
// bf16 (the LM's route): Hopper's tensor cores fed by TMA.
//   * One block per (b, h, query tile of 128 rows), 3 warpgroups: warpgroup
//     0 is the producer (one thread issues every load; setmaxnreg gives its
//     registers away), warpgroups 1 and 2 each own 64 query rows, since a
//     wgmma tile has 64 rows.  Query tiles run longest-causal-first.
//   * q, k and v are read by TMA through 4-D tensor maps over their
//     (D, T, head, B) strides, built on the host for each call, so the
//     model's (B, T, H, D) activations enter as transposed views with no
//     copy.  Q loads once; K and V tiles of 128 keys go through a ring of
//     kStages slots in shared memory, kept in bf16 in the 128-byte (64-byte
//     at D = 32) swizzle that wgmma reads, each slot with a "full" mbarrier
//     (TMA completion) and an "empty" one (both consumers done), K and V
//     apart so that Q K^T starts before V has landed.  Keys past Tk are
//     zero-filled by the TMA unit and masked.
//   * S = Q K^T is wgmma.mma_async m64n128k16 bf16 -> fp32 with both
//     operands in shared memory (products of bf16 values are exact in fp32:
//     the TPU kernel's fp32 product up to summation order).  The scale, the
//     mask and the online softmax run in registers in the base-2 domain; a
//     row's max and sum are shared by the quad of lanes that hold it.
//   * O += P V is wgmma with P from registers (the S accumulator's layout
//     is the A fragment's) and V from shared memory in its (keys x D)
//     layout through wgmma's transpose.  P is not rounded to bf16 once: at
//     early causal rows a few terms can cancel and one rounding (2^-9)
//     would move the output past the bf16 limit.  It is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), two wgmmas into the same
//     fp32 accumulator (error near 2^-17, 1.5x the tensor work); l sums the
//     fp32 p.
//   * Each consumer overlaps its own work: it issues S of tile j and, behind
//     it, P V of tile j - 1, waits for S alone (wgmma groups retire in
//     order) and runs tile j's softmax on the CUDA cores while the tensor
//     cores finish P V; only then does it rescale O and split P of tile j.
//   * Key tiles above the causal diagonal or outside the window are never
//     loaded; a consumer passes over a tile that is masked for all its 64
//     rows, and only tiles that cross the diagonal, the window edge or Tk
//     run the masked softmax.
//   * The epilogue divides by max(l, 1e-30), rounds to bf16 and stores
//     through the output's strides; rows past Tq are not stored.
//
// fp32: the first version's SIMT kernel, unchanged (off the LM's path):
//   * a thread holds one query row's q and accumulator in registers; at
//     D = 128 that is 256 floats, above the 255-register limit, so a row is
//     split over LPR = D / 64 lanes (DL = D / LPR dims each), which add their
//     partial dot products with __shfl_xor_sync;
//   * the K and V tiles (kBlockK keys) are staged in shared memory as fp32;
//     every lane of a warp reads the same key, so the reads are broadcasts,
//     16 bytes at a time, and the lane parts of a key row sit kPad floats
//     apart so that the parts fall in other banks;
//   * keys are scored kChunk at a time (independent FMA chains), then the
//     row's max, sum and accumulator are rescaled once per chunk;
//   * key tiles above the causal diagonal or wholly outside the window are
//     never loaded, and the query tiles run in reverse so the longest
//     causal tiles start first; keys past Tk load as 0 and score -1e30,
//     rows past Tq are not stored.
// q, k, v and out are read and written through their strides (the last
// dimension contiguous).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kBlockK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;      // keys scored per rescale
constexpr int kPad = 4;         // floats between the lane parts of a key row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

struct Strides {
  long long b, h, t;  // elements; the head dimension is contiguous
};

// ---------------------------------------------------------------------------
// fp32 route: SIMT kernel
// ---------------------------------------------------------------------------

template <typename T, int DL, int LPR>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides sq,
             Strides sk, Strides sv, Strides so, int tq, int tk, int group,
             int causal, int window, int qoff, float scale) {
  constexpr int D = DL * LPR;
  constexpr int kRows = kThreads / LPR;    // query rows per block
  constexpr int kPart = DL + kPad;         // floats per lane part
  constexpr int kRow = LPR * kPart;        // floats per key row
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kBlockK * kRow;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int part = tid % LPR;
  const int q0 = qt * kRows;
  const int qpos = q0 + tid / LPR;
  const int qabs = qpos + qoff;  // the row's position, for the mask

  float qr[DL], acc[DL];
  {
    const T* qp = q + b * sq.b + h * sq.h +
                  static_cast<long long>(min(qpos, tq - 1)) * sq.t + part * DL;
#pragma unroll
    for (int d = 0; d < DL; ++d) {
      qr[d] = load_f32(qp + d);
      acc[d] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  // the block's key range, from its tile indices (block-uniform)
  const int q_last = min(q0 + kRows, tq) - 1;
  const int k_end = causal ? min(tk, q_last + qoff + 1) : tk;
  const int k_begin = window > 0 ? max(0, q0 + qoff - window + 1) : 0;
  const T* kb = k + b * sk.b + (h / group) * sk.h;
  const T* vb = v + b * sv.b + (h / group) * sv.h;
  const float* kpart = ks + part * kPart;
  const float* vpart = vs + part * kPart;

  for (int t0 = (k_begin / kBlockK) * kBlockK; t0 < k_end; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int key = t0 + j;
      const int dst = j * kRow + (d / DL) * kPart + d % DL;
      float kx = 0.0f, vx = 0.0f;  // keys past Tk: 0, never NaN
      if (key < tk) {
        kx = load_f32(kb + key * sk.t + d);
        vx = load_f32(vb + key * sv.t + d);
      }
      ks[dst] = kx;
      vs[dst] = vx;
    }
    __syncthreads();
    const int n_keys = min(kBlockK, k_end - t0);
    for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) s[c] = 0.0f;
#pragma unroll
      for (int d = 0; d < DL; d += 4) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float4 kk =
              *reinterpret_cast<const float4*>(kpart + (c0 + c) * kRow + d);
          s[c] = fmaf(qr[d], kk.x, s[c]);
          s[c] = fmaf(qr[d + 1], kk.y, s[c]);
          s[c] = fmaf(qr[d + 2], kk.z, s[c]);
          s[c] = fmaf(qr[d + 3], kk.w, s[c]);
        }
      }
      unsigned live = 0u;
      float m_new = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (LPR > 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
        if (LPR > 2) s[c] += __shfl_xor_sync(0xffffffffu, s[c], 2);
        const int key = t0 + c0 + c;
        bool ok = key < tk;
        if (causal) ok = ok && key <= qabs;
        if (window > 0) ok = ok && key > qabs - window;
        s[c] = ok ? s[c] * scale : kNegInf;
        live |= static_cast<unsigned>(ok) << c;
        m_new = fmaxf(m_new, s[c]);
      }
      const float corr = __expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = (live >> c) & 1u ? __expf(s[c] - m_new) : 0.0f;
        l += p;
        const float* vr = vpart + (c0 + c) * kRow;
#pragma unroll
        for (int d = 0; d < DL; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (qpos < tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + b * so.b + h * so.h + static_cast<long long>(qpos) * so.t +
            part * DL;
#pragma unroll
    for (int d = 0; d < DL; ++d) store_f32(op + d, acc[d] / denom);
  }
}

template <typename T, int DL, int LPR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int KV, int tq, int tk, int causal, int window,
                   int qoff, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / LPR;
  const int smem = 2 * kBlockK * LPR * (DL + kPad) * static_cast<int>(
      sizeof(float));
  auto kernel = flash_kernel<T, DL, LPR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, tq, tk,
      H / KV, causal, window, qoff, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(int D, const void* q, const void* k, const void* v,
                       void* o, Strides sq, Strides sk, Strides sv,
                       Strides so, int B, int H, int KV, int tq, int tk,
                       int causal, int window, int qoff, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<float, 32, 1>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq,
                                  tk, causal, window, qoff, scale, stream);
    case 64:
      return launch<float, 64, 1>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq,
                                  tk, causal, window, qoff, scale, stream);
    case 128:
      return launch<float, 64, 2>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq,
                                  tk, causal, window, qoff, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on tiles that TMA brings into an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;       // query rows per block
constexpr int kWgRows = 64;        // query rows per consumer warpgroup
constexpr int kBlockN = 128;       // keys per K/V tile
constexpr int kTmaThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240; //   <= the SM's 65,536 registers
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgCfg {
  static constexpr int kCol = D < 64 ? D : 64;   // elements per smem row
  static constexpr int kNCol = D / kCol;         // column blocks of a tile
  static constexpr int kRowBytes = 2 * kCol;     // the swizzle span
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int kBarBytes = 8 * (1 + 4 * kStages);
  // 1024 bytes of slack so the tiles start on the swizzle's 1024-byte period
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 4-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an in-flight wgmma reads or writes: the compiler must not
// move their uses across the issue or the wait, nor reuse them in between.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N, fp32) (+)= A (64 x 16, bf16, shared memory, K-major)
//                     * B (16 x N, bf16, shared memory, K-major); N is the
// key tile
static_assert(kBlockN == 128, "S = Q K^T is one m64n128k16 wgmma per k-step");
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, fp32) += A (64 x 16, bf16, registers)
//                   * B (16 x N, bf16, shared memory, N-major: transposed)
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
        "1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S (64 x 128) = Q K^T for one warpgroup: D / 16 wgmmas, both operands
// K-major in shared memory (q_wg: the warpgroup's 64 rows of Q)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockN / 2],
                                         uint32_t q_wg,
                                         uint32_t k_t) {
  using C = WgCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / C::kCol;
    const uint32_t off = (kk * 16 % C::kCol) * 2;
    const uint64_t da = smem_desc(q_wg + c * kBlockM * C::kRowBytes + off, 16,
                                  8 * C::kRowBytes, C::kLayout);
    const uint64_t db = smem_desc(k_t + c * kBlockN * C::kRowBytes + off,
                                  16, 8 * C::kRowBytes, C::kLayout);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
}

// O += P V for one warpgroup: per 16 keys, p_hi and p_lo times the same V
// rows (transposed B: D contiguous in shared memory)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[kBlockN / 4],
                                         const uint32_t (&p_lo)[kBlockN / 4],
                                         uint32_t v_t) {
  using C = WgCfg<D>;
#pragma unroll
  for (int j = 0; j < kBlockN / 16; ++j) {
    const uint64_t db =
        smem_desc(v_t + j * 16 * C::kRowBytes, kBlockN * C::kRowBytes,
                  8 * C::kRowBytes, C::kLayout);
    WgmmaRS<D>::run(acc, p_hi + 4 * j, db);
    WgmmaRS<D>::run(acc, p_lo + 4 * j, db);
  }
}

// One key tile's online softmax for this thread's two rows: scores s (fp32,
// unscaled) become probabilities in place; the row max m (log2 domain) and
// the partial sums l move on; corr is the factor for the accumulator.  The
// mask is compiled only into the version for tiles that need it, and the
// max and the sum run as 4 independent chains a row.
struct RowStats {
  float m_a, m_b, l_a, l_b;
};
struct MaskArgs {
  int key0, row_a, row_b, col_t, tk, causal, window;
};
template <bool kMasked>
__device__ __forceinline__ void online_softmax(float (&s)[kBlockN / 2], RowStats& st,
                                               float& corr_a, float& corr_b,
                                               const MaskArgs& ma,
                                               float scale_log2) {
  float mx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mx[j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * scale_log2;
      if (kMasked) {
        const int key = ma.key0 + 8 * i + ma.col_t + (e & 1);
        const int row = e < 2 ? ma.row_a : ma.row_b;
        const bool live = key < ma.tk && (!ma.causal || key <= row) &&
                          (ma.window <= 0 || key > row - ma.window);
        x = live ? x : -INFINITY;
      }
      s[4 * i + e] = x;
      // chains 0-3 for row a, 4-7 for row b
      const int j = (e < 2 ? 0 : 4) + (i % 2) * 2 + (e & 1);
      mx[j] = fmaxf(mx[j], x);
    }
  }
  float mx_a = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
  float mx_b = fmaxf(fmaxf(mx[4], mx[5]), fmaxf(mx[6], mx[7]));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  // a row with no live key yet keeps max -inf: subtract 0 instead
  const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
  const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
  corr_a = ex2(st.m_a - mu_a);
  corr_b = ex2(st.m_b - mu_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float sum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sum[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[4 * i + e] - (e < 2 ? mu_a : mu_b));
      s[4 * i + e] = p;
      sum[(e < 2 ? 0 : 4) + (i % 2) * 2 + (e & 1)] += p;
    }
  }
  st.l_a = st.l_a * corr_a + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  st.l_b = st.l_b * corr_b + ((sum[4] + sum[5]) + (sum[6] + sum[7]));
}

// the tile's softmax, with the mask where the tile crosses the causal
// diagonal, the window's edge or Tk for some of the warpgroup's rows
__device__ __forceinline__ void tile_softmax(float (&s)[kBlockN / 2], RowStats& st,
                                             float& corr_a, float& corr_b,
                                             const MaskArgs& ma, int r0w,
                                             int r1w, float scale_log2) {
  if (ma.key0 + kBlockN > ma.tk ||
      (ma.causal && ma.key0 + kBlockN - 1 > r0w) ||
      (ma.window > 0 && ma.key0 <= r1w - ma.window))
    online_softmax<true>(s, st, corr_a, corr_b, ma, scale_log2);
  else
    online_softmax<false>(s, st, corr_a, corr_b, ma, scale_log2);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float corr_a,
                                        float corr_b) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    acc[4 * i] *= corr_a;
    acc[4 * i + 1] *= corr_a;
    acc[4 * i + 2] *= corr_b;
    acc[4 * i + 3] *= corr_b;
  }
}

// p (the S accumulator's layout) into the A fragments of P V: bf16 pairs,
// p_hi = bf16(p) and p_lo = bf16(p - p_hi)
__device__ __forceinline__ void split_p(const float (&p)[kBlockN / 2],
                                        uint32_t (&p_hi)[kBlockN / 4],
                                        uint32_t (&p_lo)[kBlockN / 4]) {
#pragma unroll
  for (int i = 0; i < kBlockN / 4; ++i) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hi);
    p_hi[i] = bf16x2_bits(hi);
    p_lo[i] = bf16x2_bits(
        __floats2bfloat162_rn(p[2 * i] - hf.x, p[2 * i + 1] - hf.y));
  }
}

// the block's key range [begin, end) for query rows [r0, r1]
struct KeyRange {
  int begin, end;
};
__device__ __forceinline__ KeyRange key_range(int r0, int r1, int tk,
                                              int causal, int window) {
  return {window > 0 ? max(0, r0 - window + 1) : 0,
          causal ? min(tk, r1 + 1) : tk};
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, Strides so, int tq, int tk,
                   int group, int causal, int window, int qoff,
                   float scale_log2) {
  using C = WgCfg<D>;
  constexpr int BN = kBlockN;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kQBytes;
  const uint32_t v_s = k_s + S * C::kKVBytes;
  const uint32_t bars = v_s + S * C::kKVBytes;
  const uint32_t q_full = bars;
  // stage i: full_k, full_v, empty_k, empty_v
  auto full_k = [&](int i) { return bars + 8u * (1 + i); };
  auto full_v = [&](int i) { return bars + 8u * (1 + S + i); };
  auto empty_k = [&](int i) { return bars + 8u * (1 + 2 * S + i); };
  auto empty_v = [&](int i) { return bars + 8u * (1 + 3 * S + i); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockM;
  const KeyRange blk = key_range(q0 + qoff, min(q0 + kBlockM, tq) - 1 + qoff,
                                 tk, causal, window);
  const int t_first = blk.begin / BN;
  const int n_tiles = blk.end > blk.begin
                          ? (blk.end + BN - 1) / BN - t_first
                          : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(full_k(i), 1);
      mbar_init(full_v(i), 1);
      mbar_init(empty_k(i), kConsumerThreads);
      mbar_init(empty_v(i), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kNCol; ++c)
        tma_load(q_s + c * kBlockM * C::kRowBytes, &tm_q, q_full,
                 c * C::kCol, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % S;
        const uint32_t ph = (it / S) & 1;
        const int key0 = (t_first + it) * BN;
        mbar_wait(empty_k(st), ph ^ 1);
        mbar_expect_tx(full_k(st), C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kNCol; ++c)
          tma_load(k_s + st * C::kKVBytes + c * BN * C::kRowBytes, &tm_k,
                   full_k(st), c * C::kCol, key0, hk, b);
        mbar_wait(empty_v(st), ph ^ 1);
        mbar_expect_tx(full_v(st), C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kNCol; ++c)
          tma_load(v_s + st * C::kKVBytes + c * BN * C::kRowBytes, &tm_v,
                   full_v(st), c * C::kCol, key0, hk, b);
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = (threadIdx.x - 128) / 128;
    const int lt = threadIdx.x % 128;
    const int lane = lt % 32;
    // the warpgroup's rows and this thread's, as positions (the mask's)
    const int r0w = q0 + qoff + wg * kWgRows;
    const int r1w = r0w + kWgRows - 1;
    const int pos_a = r0w + (lt / 32) * 16 + lane / 4;
    const int pos_b = pos_a + 8;
    const int row_a = pos_a - qoff, row_b = pos_b - qoff;  // and as rows
    const int col_t = 2 * (lane % 4);           // this thread's first column
    const KeyRange wr = key_range(r0w, r1w, tk, causal, window);
    // the warpgroup's tiles [it_lo, it_hi) of the block's n_tiles; the
    // others are masked for all its rows, and it only passes them on
    const int it_lo = min(n_tiles, max(0, wr.begin / BN - t_first));
    const int it_hi =
        wr.end > wr.begin
            ? max(it_lo, min(n_tiles, (wr.end + BN - 1) / BN - t_first))
            : it_lo;
    auto pass = [&](int it) {
      const int st = it % S;
      const uint32_t ph = (it / S) & 1;
      mbar_wait(full_k(st), ph);
      mbar_arrive(empty_k(st));
      mbar_wait(full_v(st), ph);
      mbar_arrive(empty_v(st));
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    RowStats rs{-INFINITY, -INFINITY, 0.0f, 0.0f};
    float s[BN / 2];
    uint32_t p_hi[BN / 4], p_lo[BN / 4];
    float corr_a, corr_b;

    const uint32_t q_wg = q_s + wg * kWgRows * C::kRowBytes;
    mbar_wait(q_full, 0);
    for (int it = 0; it < it_lo; ++it) pass(it);

    if (it_lo < it_hi) {
      // the first tile alone: S, softmax, P
      {
        const int st = it_lo % S;
        mbar_wait(full_k(st), (it_lo / S) & 1);
        fence_regs(s);
        wgmma_fence();
        issue_qk<D>(s, q_wg, k_s + st * C::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(empty_k(st));
        const MaskArgs ma{(t_first + it_lo) * BN, pos_a, pos_b, col_t, tk,
                          causal, window};
        tile_softmax(s, rs, corr_a, corr_b, ma, r0w, r1w, scale_log2);
        split_p(s, p_hi, p_lo);
      }
      // then S of tile it on the tensor cores with P V of tile it - 1
      // behind it: the softmax of tile it overlaps the P V product
      for (int it = it_lo + 1; it < it_hi; ++it) {
        const int st = it % S, sp = (it - 1) % S;
        mbar_wait(full_k(st), (it / S) & 1);
        fence_regs(s);
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
        wgmma_fence();
        issue_qk<D>(s, q_wg, k_s + st * C::kKVBytes);
        wgmma_commit();
        mbar_wait(full_v(sp), ((it - 1) / S) & 1);
        issue_pv<D>(acc, p_hi, p_lo, v_s + sp * C::kKVBytes);
        wgmma_commit();
        wgmma_wait<1>();  // S done; P V may still run
        fence_regs(s);
        mbar_arrive(empty_k(st));
        const MaskArgs ma{(t_first + it) * BN, pos_a, pos_b, col_t, tk,
                          causal, window};
        tile_softmax(s, rs, corr_a, corr_b, ma, r0w, r1w, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
        mbar_arrive(empty_v(sp));
        rescale(acc, corr_a, corr_b);
        split_p(s, p_hi, p_lo);
      }
      // the last tile's P V
      {
        const int sp = (it_hi - 1) % S;
        mbar_wait(full_v(sp), ((it_hi - 1) / S) & 1);
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
        wgmma_fence();
        issue_pv<D>(acc, p_hi, p_lo, v_s + sp * C::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
        mbar_arrive(empty_v(sp));
      }
    }
    for (int it = it_hi; it < n_tiles; ++it) pass(it);
    float l_a = rs.l_a, l_b = rs.l_b;

    // epilogue: the quad's partial sums, the division, bf16 stores
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = o + b * so.b + h * so.h + col_t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (row_a < tq)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<long long>(row_a) * so.t + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i] / den_a,
                                  acc[4 * i + 1] / den_a);
      if (row_b < tq)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<long long>(row_b) * so.t + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2] / den_b,
                                  acc[4 * i + 3] / den_b);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time, so the
// library links no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 tensor map over (D, T, heads, B) with element strides (1, st,
// sh, sb) and a box of (cols, rows, 1, 1).  A dimension of extent 1 is never
// stepped, so its stride is replaced by one the TMA unit accepts.
bool make_map(CUtensorMap* map, const void* ptr, int D, int T, int heads,
              int B, Strides s, int cols, int rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const long long elems[3] = {s.t, s.h, s.b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] > 1 ? static_cast<cuuint64_t>(elems[i]) * 2
                                 : static_cast<cuuint64_t>(D) * 2;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         Strides sq, Strides sk, Strides sv, Strides so, int B,
                         int H, int KV, int tq, int tk, int causal, int window,
                         int qoff, float scale, cudaStream_t stream) {
  using C = WgCfg<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, tq, H, B, sq, C::kCol, kBlockM, C::kSwizzle) ||
      !make_map(&mk, k, D, tk, KV, B, sk, C::kCol, kBlockN, C::kSwizzle) ||
      !make_map(&mv, v, D, tk, KV, B, sv, C::kCol, kBlockN, C::kSwizzle))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kTmaThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), so, tq, tk, H / KV, causal,
      window, qoff, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_bf16(int D, const void* q, const void* k, const void* v,
                        void* o, Strides sq, Strides sk, Strides sv,
                        Strides so, int B, int H, int KV, int tq, int tk,
                        int causal, int window, int qoff, float scale,
                        cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wgmma<32>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                              causal, window, qoff, scale, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                              causal, window, qoff, scale, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                               causal, window, qoff, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32 (SIMT route), 1 bfloat16 (wgmma + TMA route).  Strides
// in elements, for the (B, H, T) dimensions of q, k, v and out in turn.
// q_offset is the position of q's first row (the mask's), where the query
// rows are one slice of a longer sequence.
extern "C" int dfr_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long osb,
    long long osh, long long ost, int B, int H, int KV, int tq, int tk,
    int D, int dtype, int causal, int window, int q_offset, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{qsb, qsh, qst}, sk{ksb, ksh, kst}, sv{vsb, vsh, vst},
      so{osb, osh, ost};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_f32(D, q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk, causal,
                     window, q_offset, scale, st);
  else if (dtype == 1)
    err = launch_bf16(D, q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk, causal,
                      window, q_offset, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
