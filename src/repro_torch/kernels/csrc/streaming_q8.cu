// K5: int8 fused streaming step, reservoir -> DPRR -> readout logits on codes.
//
// Replaces the TPU kernel src/repro/kernels/streaming.py:_streaming_kernel_q8
// (entry streaming_step_pallas_q8).  K2's time loop on symmetric int8 codes:
// the state lives as int32 codes xq with scale sx, the activation is
// requantized every step, the ring mix is an integer dot against the ring
// matrix codes (scale sL) and the DPRR accumulator is int32 over code outer
// products, with the ones column carrying the integer 1.  The nonlinearity,
// the ring wrap and the final dequantized readout are fp32.
//
// The codes must equal the plain version's (kernels/ref.py:streaming_q8_ref)
// bit for bit.  The integer parts are exact in any order; the two
// requantizations round fp32 values, so every fp32 operation before them is
// written with a round-to-nearest intrinsic in the plain version's order
// (nvcc would otherwise contract a multiply and an add into one FMA), and
// rounding is half to even, as torch.round.  The ring codes, the ring powers
// and the scales come from PyTorch, so both versions start from the same
// bits.
//
// What bounds it on an H100: the latency of the dependent time loop; the
// bytes (the live inputs, the int8 codes) and the integer work are far below
// the card's rates.  A step is a chain: dequantize, f, requantize the
// activation, the ring dot, the wrap, requantize the state.  The design keeps
// that chain short and everything else off it:
//   * one warp a sample and one warp a block, so the server's 128 samples
//     run on 128 SMs, each warp alone on its SM; the kernel is instantiated
//     for each f, so a step's code holds one f;
//   * the sample's inputs are staged in shared memory ahead of the loop
//     (stage_rows.cuh), so no step waits on device memory;
//   * the ring dot: lanes write their activation codes to a 32-byte row in
//     shared memory, read it back as two 16-byte broadcasts, and each lane
//     dots it with its row of the ring codes (packed 4 to a register) in 8
//     __dp4a, two chains of 4;
//   * the divisions by sx use one refined reciprocal of sx and the
//     branch-free quotient of rounding.cuh, and a code is rounded and moved
//     between float and integer by adding 1.5 * 2^23 (code_of), so no
//     conversion instruction sits on the chain.  If sx or a numerator falls
//     outside the range where the quotient's code is the correctly rounded
//     one's, the warp runs its sample again with __fdiv_rn (kExact), so the
//     codes are the plain version's either way;
//   * the DPRR accumulation is off the loop: each step only stores its state
//     codes as bytes in shared memory, node-major, once as xq(k) and once
//     shifted as xq(k-1).  Every kPeriod steps, and after the last, the
//     warp forms acc += X1^T X0 over those steps with mma.sync
//     m16n8k32 s8 x s8 -> s32 on the tensor cores, exact in integers: the
//     node axis as M (two tiles of 16), the previous state's node as N
//     (four tiles of 8), time as K, zero-padded to a multiple of 32.  The
//     ones column is a running integer sum;
//   * the readout (r . (sw Wq)^T + b) takes r's elements lane-strided from
//     shared memory, so each class's codes load coalesced, three classes
//     ahead of the one summed; the readout's codes are prefetched into L1
//     while the loop runs.  Its fp32 sums run in another order than the
//     plain version's, within the logits' tolerance.
// What holds it now: the chain itself (about 20 dependent fp32 and integer
// operations and one shared-memory round trip a step) and the readout,
// which waits on its codes.
#include <cuda_runtime.h>

#include "dfr_step.cuh"
#include "rounding.cuh"
#include "stage_rows.cuh"

namespace {

constexpr int kNodes = 32;                // one node a lane: Nx <= 32
constexpr int kPeriod = 128;              // steps of codes a product takes
constexpr int kCodeStride = kPeriod + 4;  // bytes a node's row: 33 words,
                                          // so a step's 32 byte stores hit
                                          // 32 banks
constexpr int kAccStride = kCodeStride / 4;  // the int32 (32, 33) staging

struct Shared {
  alignas(16) float ring[dfr::kStageSlots * dfr::stage_slot_floats(
      kNodes)];
  alignas(16) signed char arow[2][kNodes];       // activation codes
  alignas(16) signed char x1[kNodes * kCodeStride];  // xq(k)
  alignas(16) signed char x0[kNodes * kCodeStride];  // xq(k-1)
};

// f in the plain version's operation order (repro_torch.core.types), its
// code a template argument so that each kernel's loop holds one f.
template <bool kExact, int kCode>
__device__ __forceinline__ float nonlin_rn(float z, float alpha, bool& bad) {
  if (kCode == 0) return __fmul_rn(alpha, z);                   // linear
  if (kCode == 1) return tanhf(__fmul_rn(alpha, z));            // tanh
  const float m = fabsf(z);                                     // Mackey-Glass
  return div_rn<kExact>(z, __fadd_rn(1.0f, __fmul_rn(m, m)), bad);
}

// A code c in [-127, 127] travels as the float 1.5 * 2^23 + c: adding
// 1.5 * 2^23 to a value in [-127, 127] rounds it to an integer, half to
// even as torch.round, with no conversion instruction; the float's bits
// less kRoundBits are c, their low byte is c as an int8, and subtracting
// kRound gives c as an exact float.
constexpr float kRound = 0x1.8p23f;
constexpr int kRoundBits = 0x4B400000;

__device__ __forceinline__ int code_of(float bits) {
  return __float_as_int(bits) - kRoundBits;
}

// The divisor range of the fast quotient (2^-58 to 2^50)
constexpr unsigned kSxLo = 0x22800000u, kSxHi = 0x58800000u;

// clip(round(v / sx), -127, 127) as code bits.  The fast path divides by
// rounding.cuh's branch-free sequence from rsx = rcp_refined(sx), which is
// correctly rounded for |v| in [2^-60, 2^60] with sx in [kSxLo, kSxHi]; a
// smaller |v| gives a quotient under 1/4 in magnitude, which codes to 0 as
// the exact quotient does.  A larger or non-finite |v| sets `bad`.
template <bool kExact>
__device__ __forceinline__ float quantize(float v, float sx, float rsx,
                                          bool& bad) {
  if (kExact)
    return __int_as_float(
        min(max(__float2int_rn(__fdiv_rn(v, sx)), -127), 127) + kRoundBits);
  bad |= !(fabsf(v) <= 0x1p60f);
  const float q = __fmaf_rn(v, rsx, 0.0f);
  const float d = __fmaf_rn(rsx, __fmaf_rn(-sx, q, v), q);
  return __fadd_rn(fminf(fmaxf(d, -127.0f), 127.0f), kRound);
}

__device__ __forceinline__ unsigned word_at(const signed char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// acc += X1^T X0 over the `steps` code columns of this period.
__device__ __forceinline__ void dprr_product(Shared& sh, int steps,
                                             int (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int kpad = (steps + 31) & ~31;
  for (int k = steps; k < kpad; ++k)  // A's columns past the last step
    sh.x1[lane * kCodeStride + k] = 0;
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < kpad; kc += 32) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const signed char* r = sh.x1 + (16 * mt + g) * kCodeStride + kc + 4 * t;
      a[mt][0] = word_at(r);
      a[mt][1] = word_at(r + 8 * kCodeStride);
      a[mt][2] = word_at(r + 16);
      a[mt][3] = word_at(r + 8 * kCodeStride + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const signed char* r = sh.x0 + (8 * nt + g) * kCodeStride + kc + 4 * t;
      b[nt][0] = word_at(r);
      b[nt][1] = word_at(r + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+r"(acc[mt][nt][0]), "+r"(acc[mt][nt][1]),
              "+r"(acc[mt][nt][2]), "+r"(acc[mt][nt][3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
              "r"(b[nt][0]), "r"(b[nt][1]));
  }
  __syncwarp();  // the code rows may be written again
}

// The int32 accumulator after the loop, (32, kAccStride) in x1's bytes.
__device__ __forceinline__ int* acc_rows(Shared& sh) {
  return reinterpret_cast<int*>(sh.x1);
}

// r, dequantized, in its (Nx (Nx + 1),) layout in x0's bytes; kRDummy is
// past r whenever Nx < 32.
constexpr int kRDummy = kNodes * kAccStride - 1;
__device__ __forceinline__ float* r_flat(Shared& sh) {
  return reinterpret_cast<float*>(sh.x0);
}

struct SampleArgs {
  int nx;
  float alpha, p, sx, rsx, mix_scale, qp;
  unsigned lq[kNodes / 4];  // row `lane` of the ring codes, packed
};

// One run of the sample's time loop over the inputs that `stage` has
// started to copy.  Leaves the int32 DPRR accumulator in shared memory
// (acc_rows: row n at n * kAccStride, its ones column at column 32);
// returns whether any divide had an operand outside the fast path's range
// (never with kExact).
template <bool kExact, int kCode>
__device__ __forceinline__ bool run_sample(
    Shared& sh, const dfr::RowStage<kNodes>& stage, const SampleArgs& s) {
  const int lane = threadIdx.x & 31;
  const int nx = s.nx, len = stage.len;
  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  bool bad = false;
  float xv = 0.0f;     // the state's code as an exact float
  int k0 = 0;          // the first step of the current period
  int acc_sum = 0;     // the ones column of row `lane`
  sh.x0[lane * kCodeStride] = 0;  // xq(-1)

  // step k from the input jk (lanes n >= Nx hold zeros throughout)
  auto step = [&](float jk, int k) {
    const float x_prev = __fmul_rn(xv, s.sx);
    const float wrap = __shfl_sync(dfr::kFullMask, x_prev, nx - 1);
    const float v = __fmul_rn(
        s.p, nonlin_rn<kExact, kCode>(__fadd_rn(jk, x_prev), s.alpha, bad));
    signed char* const arow = sh.arow[k & 1];
    arow[lane] = static_cast<signed char>(
        __float_as_int(quantize<kExact>(v, s.sx, s.rsx, bad)));
    __syncwarp();
    const int4 w0 = *reinterpret_cast<const int4*>(arow);
    const int4 w1 = *reinterpret_cast<const int4*>(arow + 16);
    int y0 = __dp4a(static_cast<int>(s.lq[0]), w0.x, 0);
    int y1 = __dp4a(static_cast<int>(s.lq[4]), w1.x, 0);
    y0 = __dp4a(static_cast<int>(s.lq[1]), w0.y, y0);
    y1 = __dp4a(static_cast<int>(s.lq[5]), w1.y, y1);
    y0 = __dp4a(static_cast<int>(s.lq[2]), w0.z, y0);
    y1 = __dp4a(static_cast<int>(s.lq[6]), w1.z, y1);
    y0 = __dp4a(static_cast<int>(s.lq[3]), w0.w, y0);
    y1 = __dp4a(static_cast<int>(s.lq[7]), w1.w, y1);
    // |y| <= 32 * 127^2 < 2^22, so y + 1.5 * 2^23 is exact
    const float yf = __fsub_rn(__int_as_float(y0 + y1 + kRoundBits), kRound);
    const float x = __fadd_rn(__fmul_rn(yf, s.mix_scale),
                              __fmul_rn(wrap, s.qp));
    const float bits = quantize<kExact>(x, s.sx, s.rsx, bad);
    xv = __fsub_rn(bits, kRound);
    const signed char code = static_cast<signed char>(__float_as_int(bits));
    const int i = k - k0;
    sh.x1[lane * kCodeStride + i] = code;
    if (i + 1 < kPeriod) sh.x0[lane * kCodeStride + i + 1] = code;
    acc_sum += code_of(bits);
  };

  for (int c = 0; c * dfr::kStageChunk < len; ++c) {
    const int kc = c * dfr::kStageChunk;
    float jr[dfr::kStageChunk];
    stage.take(c, jr);
    if (kc + dfr::kStageChunk <= len) {  // a whole chunk: no length checks
#pragma unroll
      for (int u = 0; u < dfr::kStageChunk; ++u) step(jr[u], kc + u);
    } else {
#pragma unroll
      for (int u = 0; u < dfr::kStageChunk - 1; ++u) {
        if (kc + u >= len) break;
        step(jr[u], kc + u);
      }
    }
    const int k1 = kc + dfr::kStageChunk;
    if (k1 - k0 == kPeriod && k1 <= len) {  // a whole period
      dprr_product(sh, kPeriod, acc);
      k0 += kPeriod;
      sh.x0[lane * kCodeStride] =
          static_cast<signed char>(__float_as_int(xv + kRound));
    }
  }
  if (len > k0) dprr_product(sh, len - k0, acc);

  // The fragments and the ones column to shared memory, row by row
  // (acc_rows), and dequantized in r's layout for the readout (r_flat; an
  // element outside r, only when nx < 32, goes to kRDummy, past r).
  int* const rows = acc_rows(sh);
  float* const rf = r_flat(sh);
  const float sxx = __fmul_rn(s.sx, s.sx);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * mt + g + 8 * (e >> 1), i = 8 * nt + 2 * t + (e & 1);
        rows[n * kAccStride + i] = acc[mt][nt][e];
        rf[n < nx && i < nx ? n * nx + i : kRDummy] =
            __fmul_rn(static_cast<float>(acc[mt][nt][e]), sxx);
      }
  rows[lane * kAccStride + kNodes] = acc_sum;
  rf[lane < nx ? nx * nx + lane : kRDummy] =
      __fmul_rn(static_cast<float>(acc_sum), s.sx);
  __syncwarp();
  return __any_sync(dfr::kFullMask, bad);
}

template <int kCode>
__global__ void __launch_bounds__(32)
streaming_q8_kernel(const float* __restrict__ j,
                    const int* __restrict__ lengths,
                    const signed char* __restrict__ Lq,
                    const float* __restrict__ qpow,
                    const float* __restrict__ scales,
                    const signed char* __restrict__ Wq,
                    const float* __restrict__ bias, int T, int nx, int ny,
                    int spp, float alpha, float* __restrict__ out,
                    int* __restrict__ acc_out) {
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int sys = b / spp;
  const bool node = lane < nx;

  const int nr = nx * (nx + 1);
  const signed char* const w_sys = Wq + static_cast<size_t>(sys) * ny * nr;
  dfr::RowStage<kNodes> stage{sh.ring, j + static_cast<size_t>(b) * T * nx,
                              nx, 0};
  stage.start_first(T);  // the copies overlap the set-up below
  stage.len = min(max(lengths[b], 0), T);
  stage.start_rest();
  // the readout's codes into L1 while the time loop runs
  for (int i = 128 * lane; i < ny * nr; i += 32 * 128)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(w_sys + i));

  SampleArgs s;
  s.nx = nx;
  s.alpha = alpha;
  s.p = scales[sys * 4 + 0];
  s.sx = scales[sys * 4 + 1];
  const float sL = scales[sys * 4 + 2];
  const float sw = scales[sys * 4 + 3];
  s.mix_scale = __fmul_rn(s.sx, sL);
  s.qp = node ? qpow[sys * nx + lane] : 0.0f;
  const signed char* lq = Lq + (static_cast<size_t>(sys) * nx + lane) * nx;
#pragma unroll
  for (int w = 0; w < kNodes / 4; ++w) {
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * w + e;
      const unsigned v = (node && i < nx) ? static_cast<unsigned char>(lq[i])
                                          : 0u;
      word |= v << (8 * e);
    }
    s.lq[w] = word;
  }

  bool exact = !in_range(s.sx, kSxLo, kSxHi);
  if (!exact) {
    s.rsx = rcp_refined(s.sx);
    exact = run_sample<false, kCode>(sh, stage, s);
    if (exact) {  // the inputs again, for the exact run
      stage.start_first(T);
      stage.start_rest();
    }
  }
  if (exact) {
    s.rsx = 0.0f;
    run_sample<true, kCode>(sh, stage, s);
  }
  const int* const rows = acc_rows(sh);
  cp_async_wait_all();  // a copy past a short length must land before exit

  if (acc_out != nullptr) {  // r's (nx, nx + 1) rows, contiguous
    int* const dst = acc_out + static_cast<size_t>(b) * nx * (nx + 1);
    for (int e = lane; e < nx * (nx + 1); e += 32) {
      const int n = e / (nx + 1), i = e - n * (nx + 1);
      dst[e] = rows[n * kAccStride + (i < nx ? i : kNodes)];
    }
  }

  // The dequantized readout, logits = r . (sw Wq[sys])^T + b.  Lane l
  // takes r's elements l, l + 32, ..., so that each class's codes load
  // coalesced; the codes of the next kAhead classes are in flight while a
  // class is summed, and the lanes' sums of up to 32 classes meet in shared
  // memory, where lane yc adds up class yc's.
  constexpr int kTerms = (kNodes * (kNodes + 1) + 31) / 32;
  constexpr int kAhead = 3;
  const float* const rf = r_flat(sh);
  float rv[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    const int e = lane + 32 * m;
    const float v = rf[min(e, kRDummy)];
    rv[m] = e < nr ? v : 0.0f;
  }
  __syncwarp();  // acc_out has read the rows: their bytes take the sums
  float* const parts = reinterpret_cast<float*>(sh.x1);  // (32, 33)
  auto load_class = [&](int yc, int (&w)[kTerms]) {
    const signed char* const wy = w_sys + static_cast<size_t>(yc) * nr;
#pragma unroll
    for (int m = 0; m < kTerms; ++m)
      w[m] = yc < ny && lane + 32 * m < nr ? wy[lane + 32 * m] : 0;
  };
  auto emit = [&](int yc, const int (&w)[kTerms]) {
    float part[2] = {0.0f, 0.0f};  // two chains
#pragma unroll
    for (int m = 0; m < kTerms; ++m)
      part[m & 1] = fmaf(rv[m], __fmul_rn(static_cast<float>(w[m]), sw),
                         part[m & 1]);
    parts[(yc & 31) * kAccStride + lane] = part[0] + part[1];
    if ((yc & 31) == 31 || yc == ny - 1) {  // a block of classes is summed
      __syncwarp();
      const int y0 = yc & ~31;
      if (lane <= yc - y0) {
        float sum = 0.0f;
        for (int l = 0; l < 32; ++l) sum += parts[lane * kAccStride + l];
        out[static_cast<size_t>(b) * ny + y0 + lane] =
            sum + bias[sys * ny + y0 + lane];
      }
      __syncwarp();
    }
  };
  int w[kAhead + 1][kTerms];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) load_class(u, w[u]);
  for (int y0 = 0; y0 < ny; y0 += kAhead + 1) {
#pragma unroll
    for (int u = 0; u <= kAhead; ++u) {
      if (y0 + u < ny) {
        load_class(y0 + u + kAhead, w[(u + kAhead) % (kAhead + 1)]);
        emit(y0 + u, w[u]);
      }
    }
  }
}

}  // namespace

extern "C" int dfr_streaming_logits_q8(const float* j, const int* lengths,
                                       const signed char* Lq,
                                       const float* qpow, const float* scales,
                                       const signed char* Wq,
                                       const float* bias, int n_samples, int T,
                                       int nx, int ny, int spp, int code,
                                       float alpha, float* out, int* acc_out,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = code == 0   ? streaming_q8_kernel<0>
                : code == 1 ? streaming_q8_kernel<1>
                            : streaming_q8_kernel<2>;
  kernel<<<n_samples, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      j, lengths, Lq, qpow, scales, Wq, bias, T, nx, ny, spp, alpha, out,
      acc_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dfr_max_nodes() { return kNodes; }

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
