// K1: fused training forward, reservoir -> DPRR plus the truncation boundary.
//
// Replaces the TPU kernel src/repro/kernels/train.py:_train_forward_kernel
// (entry train_forward_pallas).  Per sample it emits r (the DPRR vector, the
// flattened (Nx, Nx) block followed by the Nx sums), x(T), x(T-1) and j(T);
// the state sequence X is never stored.
//
// What bounds it on an H100: neither bytes nor operations.  A sample is a
// chain of `length` dependent steps, each a 32-lane matvec and a DPRR update
// done with warp shuffles, so the time is the latency of that chain; the
// work (about 3 Nx^2 flops a step) and the bytes (Nx floats in a step) are
// far below what the card can stream.  The design keeps the chain short
// and off memory: one warp per sample, state and accumulator in registers,
// the next step's inputs prefetched, and the loop ends at the sample's
// length instead of running to T.  Samples run in parallel warps; one
// launch covers every slot of a server step (p and q are read per system).
#include "dfr_step.cuh"

namespace {

__global__ void __launch_bounds__(dfr::kWarpsPerBlock * 32)
train_forward_kernel(const float* __restrict__ j,
                     const int* __restrict__ lengths,
                     const float* __restrict__ p,
                     const float* __restrict__ q, int n_samples, int T,
                     int nx, int spp, int code, float alpha,
                     float* __restrict__ r, float* __restrict__ x_last,
                     float* __restrict__ x_prev, float* __restrict__ j_last) {
  const int b = blockIdx.x * dfr::kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_samples) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int sys = b / spp;

  dfr::SampleResult res;
  dfr::run_sample(j + static_cast<size_t>(b) * T * nx, T, nx, lengths[b],
                  p[sys], q[sys], code, alpha, res);
  if (lane >= nx) return;

  float* rb = r + static_cast<size_t>(b) * nx * (nx + 1);
#pragma unroll
  for (int i = 0; i < dfr::kMaxNodes; ++i)
    if (i < nx) rb[lane * nx + i] = res.acc[i];
  rb[nx * nx + lane] = res.acc_sum;
  const size_t row = static_cast<size_t>(b) * nx + lane;
  x_last[row] = res.x;
  x_prev[row] = res.x_bnd;
  j_last[row] = res.j_bnd;
}

}  // namespace

extern "C" int dfr_train_forward(const float* j, const int* lengths,
                                 const float* p, const float* q,
                                 int n_samples, int T, int nx, int spp,
                                 int code, float alpha, float* r,
                                 float* x_last, float* x_prev, float* j_last,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      (n_samples + dfr::kWarpsPerBlock - 1) / dfr::kWarpsPerBlock;
  train_forward_kernel<<<blocks, dfr::kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      j, lengths, p, q, n_samples, T, nx, spp, code, alpha, r, x_last,
      x_prev, j_last);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
