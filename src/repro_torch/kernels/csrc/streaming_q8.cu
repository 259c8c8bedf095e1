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
// One warp runs one sample (Nx <= 32): lane n holds node n's code, row n of
// the ring codes and row n of the int32 accumulator in registers; the ring
// dot gathers the activation codes with __shfl_sync.
//
// The codes must equal the plain version's (kernels/ref.py:streaming_q8_ref)
// bit for bit.  The integer parts are exact; the two requantizations round
// fp32 values, so every fp32 operation before them is written with a
// round-to-nearest intrinsic in the plain version's order (nvcc would
// otherwise contract a multiply and an add into one FMA), division is a
// true division by sx, and rounding is half to even (rintf), as torch.round.
// The ring codes, the ring powers and the scales come from PyTorch, so both
// versions start from the same bits.
//
// What bounds it on an H100: the latency of the dependent time loop, as in
// K1 and K2 (see train.cu); the bytes (the live inputs, the int8 codes) and
// the integer work are far below the card's rates.
#include "dfr_step.cuh"

namespace {

// f in the plain version's operation order (repro_torch.core.types).
__device__ __forceinline__ float nonlin_rn(float z, int code, float alpha) {
  if (code == 0) return __fmul_rn(alpha, z);                    // linear
  if (code == 1) return tanhf(__fmul_rn(alpha, z));             // tanh
  const float m = fabsf(z);                                     // Mackey-Glass
  return __fdiv_rn(z, __fadd_rn(1.0f, __fmul_rn(m, m)));
}

// clip(round(v / scale), -127, 127), round half to even.
__device__ __forceinline__ int quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(dfr::kWarpsPerBlock * 32)
streaming_q8_kernel(const float* __restrict__ j,
                    const int* __restrict__ lengths,
                    const signed char* __restrict__ Lq,
                    const float* __restrict__ qpow,
                    const float* __restrict__ scales,
                    const signed char* __restrict__ Wq,
                    const float* __restrict__ bias, int n_samples, int T,
                    int nx, int ny, int spp, int code, float alpha,
                    float* __restrict__ out, int* __restrict__ acc_out) {
  const int b = blockIdx.x * dfr::kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_samples) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int sys = b / spp;
  const bool node = lane < nx;

  const float p = scales[sys * 4 + 0];
  const float sx = scales[sys * 4 + 1];
  const float sL = scales[sys * 4 + 2];
  const float sw = scales[sys * 4 + 3];
  const float mix_scale = __fmul_rn(sx, sL);

  int l_row[dfr::kMaxNodes];  // row `lane` of the ring codes
  const signed char* lq = Lq + (static_cast<size_t>(sys) * nx + lane) * nx;
#pragma unroll
  for (int i = 0; i < dfr::kMaxNodes; ++i)
    l_row[i] = (node && i < nx) ? static_cast<int>(lq[i]) : 0;
  const float qp = node ? qpow[sys * nx + lane] : 0.0f;

  int xq = 0, acc_sum = 0;
  int acc[dfr::kMaxNodes];
#pragma unroll
  for (int i = 0; i < dfr::kMaxNodes; ++i) acc[i] = 0;

  const float* jb = j + static_cast<size_t>(b) * T * nx;
  const int len = min(max(lengths[b], 0), T);
  float j_next = (node && len > 0) ? __ldg(jb + lane) : 0.0f;
  for (int k = 0; k < len; ++k) {
    const float jk = j_next;
    if (node && k + 1 < len) j_next = __ldg(jb + (k + 1) * nx + lane);
    const int xq_prev = xq;
    const float x_prev = __fmul_rn(static_cast<float>(xq_prev), sx);
    const float ring = __shfl_sync(dfr::kFullMask, x_prev, nx - 1);
    const int aq =
        node ? quantize(__fmul_rn(p, nonlin_rn(__fadd_rn(jk, x_prev), code,
                                               alpha)),
                        sx)
             : 0;
    int y = 0;
#pragma unroll
    for (int i = 0; i < dfr::kMaxNodes; ++i)
      y += l_row[i] * __shfl_sync(dfr::kFullMask, aq, i);
    const float x = __fadd_rn(__fmul_rn(static_cast<float>(y), mix_scale),
                              __fmul_rn(ring, qp));
    const int xq_k = node ? quantize(x, sx) : 0;
#pragma unroll
    for (int i = 0; i < dfr::kMaxNodes; ++i)
      acc[i] += xq_k * __shfl_sync(dfr::kFullMask, xq_prev, i);
    acc_sum += xq_k;
    xq = xq_k;
  }

  if (acc_out != nullptr && node) {
    int* row = acc_out + (static_cast<size_t>(b) * nx + lane) * (nx + 1);
#pragma unroll
    for (int i = 0; i < dfr::kMaxNodes; ++i)
      if (i < nx) row[i] = acc[i];
    row[nx] = acc_sum;
  }

  // dequantized readout: node columns carry sx^2, the ones column sx
  const float sxx = __fmul_rn(sx, sx);
  const int nr = nx * (nx + 1);
  const signed char* w_sys = Wq + static_cast<size_t>(sys) * ny * nr;
  for (int yc = 0; yc < ny; ++yc) {
    const signed char* wy = w_sys + static_cast<size_t>(yc) * nr;
    float part = 0.0f;
    if (node) {
#pragma unroll
      for (int i = 0; i < dfr::kMaxNodes; ++i)
        if (i < nx)
          part = fmaf(__fmul_rn(static_cast<float>(acc[i]), sxx),
                      __fmul_rn(static_cast<float>(wy[lane * nx + i]), sw),
                      part);
      part = fmaf(__fmul_rn(static_cast<float>(acc_sum), sx),
                  __fmul_rn(static_cast<float>(wy[nx * nx + lane]), sw), part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(dfr::kFullMask, part, off);
    if (lane == 0)
      out[static_cast<size_t>(b) * ny + yc] = part + bias[sys * ny + yc];
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
  const int blocks =
      (n_samples + dfr::kWarpsPerBlock - 1) / dfr::kWarpsPerBlock;
  streaming_q8_kernel<<<blocks, dfr::kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      j, lengths, Lq, qpow, scales, Wq, bias, n_samples, T, nx, ny, spp, code,
      alpha, out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
