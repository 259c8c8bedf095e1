// K1: fused training forward, reservoir -> DPRR plus the truncation boundary.
//
// Replaces the TPU kernel src/repro/kernels/train.py:_train_forward_kernel
// (entry train_forward_pallas).  Per sample it emits r (the DPRR vector, the
// flattened (Nx, Nx) block followed by the Nx sums), x(T), x(T-1) and j(T);
// the state sequence X is never stored.
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of each sample's chain of dependent steps (dfr_sample.cuh, which K2
// shares, holds the time loop and its design).  One warp a sample and one
// warp a block, so the server's 128 samples run on 128 SMs, each warp alone
// on its SM; the kernel is instantiated for each f, so a step's code holds
// one f.  r leaves through shared memory in its layout, by contiguous
// stores.  One launch covers every slot of a server step (p and q are read
// per system).
#include "dfr_sample.cuh"

namespace {

template <int kCode>
__global__ void __launch_bounds__(32)
train_forward_kernel(const float* __restrict__ j,
                     const int* __restrict__ lengths,
                     const float* __restrict__ p,
                     const float* __restrict__ q, int T, int nx, int spp,
                     float alpha, float* __restrict__ r,
                     float* __restrict__ x_last, float* __restrict__ x_prev,
                     float* __restrict__ j_last) {
  __shared__ dfr::SampleShared sh;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int sys = b / spp;

  dfr::SampleOut s;
  dfr::run_sample<kCode>(
      sh, j + static_cast<size_t>(b) * T * nx, T, nx, lengths + b, p + sys,
      q + sys, alpha, s);
  if (lane < nx) {
    const size_t row = static_cast<size_t>(b) * nx + lane;
    x_last[row] = s.x_last;
    x_prev[row] = s.x_prev;
    j_last[row] = s.j_last;
  }
  const float* const rs = dfr::store_r(sh, s, nx);
  const int nr = nx * (nx + 1);
  float* const rb = r + static_cast<size_t>(b) * nr;
  for (int i = lane; i < nr; i += 32) rb[i] = rs[i];
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
  auto kernel = code == 0   ? train_forward_kernel<0>
                : code == 1 ? train_forward_kernel<1>
                            : train_forward_kernel<2>;
  kernel<<<n_samples, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      j, lengths, p, q, T, nx, spp, alpha, r, x_last, x_prev, j_last);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
