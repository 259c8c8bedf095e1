// K8: flash attention forward (online softmax, causal / sliding window, GQA).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (entry flash_attention_pallas).  For q (B, H, Tq, D) and k, v (B, KV, Tk, D)
// with g = H / KV it computes
//   out[b, h] = softmax(scale * q[b, h] k[b, h / g]^T + mask) v[b, h / g]
// where a key is live if k_pos < Tk, and k_pos <= q_pos when causal, and
// k_pos > q_pos - window when window > 0.  Scores, the running max m, the
// running sum l and the accumulator are fp32; masked scores are -1e30 and
// their probabilities 0, so a row with no live key ends with l = 0 and the
// output acc / max(l, 1e-30) = 0, as the TPU kernel gives.  The output is
// stored in the input type (fp32, or bf16 rounded to nearest even).
//
// What bounds it on an H100: operations.  At the LM prefill's shape (B = 4,
// H = 9, KV = 3, T = 4096, D = 64, causal) it does about 7.7e10 flops on
// 50 MB of q, k, v and out.  This first version runs them as fp32 FMAs on
// the CUDA cores (67 TFLOP/s), not on the tensor cores (989 TFLOP/s bf16):
// wgmma, TMA and a pipelined ring of tiles come in a later version.
//
// Design.  The TPU grid (B, H, NQ, NK) with its sequential KV axis becomes
// one block per (b, h, query tile) with the KV loop inside the block:
//   * a thread holds one query row's q and accumulator in registers; at
//     D = 128 that is 256 floats, above the 255-register limit, so a row is
//     split over LPR = D / 64 lanes (DL = D / LPR dims each), which add their
//     partial dot products with __shfl_xor_sync;
//   * the K and V tiles (kBlockK keys) are staged in shared memory as fp32,
//     converted once at load; every lane of a warp reads the same key, so
//     the reads are broadcasts, 16 bytes at a time, and the lane parts of a
//     key row sit kPad floats apart so that the parts fall in other banks;
//   * keys are scored kChunk at a time (independent FMA chains), then the
//     row's max, sum and accumulator are rescaled once per chunk;
//   * the block's key range is cut by its tile indices: key tiles above the
//     causal diagonal or wholly outside the window are never loaded (the
//     counterpart of the TPU kernel's pl.when(live), which halves the causal
//     work), and the query tiles run in reverse so the longest causal tiles
//     start first;
//   * the ragged edges (Tq, Tk not multiples of the tiles) are masked in the
//     kernel: keys past Tk load as 0 and score -1e30, rows past Tq are not
//     stored.
// q, k, v and out are read and written through their strides (the last
// dimension contiguous), so the model's (B, T, H, D) activations enter as
// transposed views with no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kBlockK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;      // keys scored per rescale
constexpr int kPad = 4;         // floats between the lane parts of a key row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, h, t;  // elements; the head dimension is contiguous
};

template <typename T, int DL, int LPR>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides sq,
             Strides sk, Strides sv, Strides so, int tq, int tk, int group,
             int causal, int window, float scale) {
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
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
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
        if (causal) ok = ok && key <= qpos;
        if (window > 0) ok = ok && key > qpos - window;
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
                   float scale, cudaStream_t stream) {
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
      H / KV, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, Strides sq, Strides sk, Strides sv,
                       Strides so, int B, int H, int KV, int tq, int tk,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, 1>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                              causal, window, scale, stream);
    case 64:
      return launch<T, 64, 1>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                              causal, window, scale, stream);
    case 128:
      return launch<T, 64, 2>(q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                              causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements, for the (B, H, T)
// dimensions of q, k, v and out in turn.
extern "C" int dfr_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long osb,
    long long osh, long long ost, int B, int H, int KV, int tq, int tk,
    int D, int dtype, int causal, int window, float scale, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{qsb, qsh, qst}, sk{ksb, ksh, kst}, sv{vsb, vsh, vst},
      so{osb, osh, ost};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, o, sq, sk, sv, so, B, H, KV, tq, tk,
                            causal, window, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, sq, sk, sv, so, B, H, KV,
                                    tq, tk, causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
