// K2: fused streaming step, reservoir -> DPRR -> readout logits.
//
// Replaces the TPU kernel src/repro/kernels/streaming.py:_streaming_kernel
// (entry streaming_step_pallas).  Per sample it runs the same time loop as
// K1 and contracts the register-resident DPRR accumulator with its system's
// readout W (Ny, Nx^2 + Nx) directly, one warp reduction per class, then
// adds the bias: logits = r . W^T + b.  Neither X nor r is stored.
//
// What bounds it on an H100: the latency of the sequential time loop, as in
// K1 (see train.cu); the readout adds Ny warp reductions at the end and
// reads the system's W once per sample from L2.  One launch covers every
// slot of a server step: p, q, W and b are read per system, so W needs no
// relayout into the TPU's (ny_pad, n_pad, n_pad) tile.
#include "dfr_step.cuh"

namespace {

__global__ void __launch_bounds__(dfr::kWarpsPerBlock * 32)
streaming_logits_kernel(const float* __restrict__ j,
                        const int* __restrict__ lengths,
                        const float* __restrict__ p,
                        const float* __restrict__ q,
                        const float* __restrict__ W,
                        const float* __restrict__ bias, int n_samples, int T,
                        int nx, int ny, int spp, int code, float alpha,
                        float* __restrict__ out) {
  const int b = blockIdx.x * dfr::kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_samples) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int sys = b / spp;

  dfr::SampleResult res;
  dfr::run_sample(j + static_cast<size_t>(b) * T * nx, T, nx, lengths[b],
                  p[sys], q[sys], code, alpha, res);

  const int nr = nx * (nx + 1);
  const float* w_sys = W + static_cast<size_t>(sys) * ny * nr;
  for (int y = 0; y < ny; ++y) {
    const float* wy = w_sys + static_cast<size_t>(y) * nr;
    float part = 0.0f;
    if (lane < nx) {
#pragma unroll
      for (int i = 0; i < dfr::kMaxNodes; ++i)
        if (i < nx) part = fmaf(res.acc[i], __ldg(wy + lane * nx + i), part);
      part = fmaf(res.acc_sum, __ldg(wy + nx * nx + lane), part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(dfr::kFullMask, part, off);
    if (lane == 0)
      out[static_cast<size_t>(b) * ny + y] = part + bias[sys * ny + y];
  }
}

}  // namespace

extern "C" int dfr_streaming_logits(const float* j, const int* lengths,
                                    const float* p, const float* q,
                                    const float* W, const float* bias,
                                    int n_samples, int T, int nx, int ny,
                                    int spp, int code, float alpha,
                                    float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      (n_samples + dfr::kWarpsPerBlock - 1) / dfr::kWarpsPerBlock;
  streaming_logits_kernel<<<blocks, dfr::kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      j, lengths, p, q, W, bias, n_samples, T, nx, ny, spp, code, alpha,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
