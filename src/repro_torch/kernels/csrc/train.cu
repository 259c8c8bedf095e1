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
//
// Above 32 nodes a sample takes one block of 1 + NPL^2 / kTiles warps
// (train_forward_wide_kernel, dfr_sample.cuh's run_sample_wide, NPL =
// ceil(Nx / 32) nodes a lane): warp 0 runs the chain, the other warps fold
// the DPRR's 32 x 32 tiles, and r leaves through dynamic shared memory.
// The kernel is instantiated for each NPL and f.
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

template <int kCode, int NPL>
__global__ void __launch_bounds__(dfr::Wide<NPL>::kThreads, 1)
train_forward_wide_kernel(const float* __restrict__ j,
                          const int* __restrict__ lengths,
                          const float* __restrict__ p,
                          const float* __restrict__ q, int T, int nx,
                          int spp, float alpha, float* __restrict__ r,
                          float* __restrict__ x_last,
                          float* __restrict__ x_prev,
                          float* __restrict__ j_last) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int sys = b / spp;

  dfr::WideOut<NPL> s;
  dfr::run_sample_wide<kCode, NPL>(
      smem, j + static_cast<size_t>(b) * T * nx, T, nx, lengths + b,
      p + sys, q + sys, alpha, s);
  if (threadIdx.x < 32) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int n = threadIdx.x * NPL + i;
      if (n < nx) {
        const size_t row = static_cast<size_t>(b) * nx + n;
        x_last[row] = s.x_last[i];
        x_prev[row] = s.x_prev[i];
        j_last[row] = s.j_last[i];
      }
    }
  }
  const float* const rs = dfr::store_r_wide<NPL>(smem, s, nx);
  const int nr = nx * (nx + 1);
  float* const rb = r + static_cast<size_t>(b) * nr;
  for (int i = threadIdx.x; i < nr; i += dfr::Wide<NPL>::kThreads)
    rb[i] = rs[i];
}

}  // namespace

extern "C" int dfr_max_nodes() { return dfr::kMaxNodes; }

extern "C" int dfr_train_forward(const float* j, const int* lengths,
                                 const float* p, const float* q,
                                 int n_samples, int T, int nx, int spp,
                                 int code, float alpha, float* r,
                                 float* x_last, float* x_prev, float* j_last,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || nx > dfr::kMaxNodes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int npl = (nx + 31) / 32;
  if (npl > 1)
    return static_cast<int>(dfr::for_npl(npl, [&](auto c) {
      constexpr int NPL = decltype(c)::value;
      auto kernel = code == 0   ? train_forward_wide_kernel<0, NPL>
                    : code == 1 ? train_forward_wide_kernel<1, NPL>
                                : train_forward_wide_kernel<2, NPL>;
      return dfr::launch_smem(kernel, n_samples, dfr::Wide<NPL>::kThreads,
                              sizeof(float) * dfr::wide_smem_floats(nx, NPL),
                              strm, j, lengths, p, q, T, nx, spp, alpha, r,
                              x_last, x_prev, j_last);
    }));
  auto kernel = code == 0   ? train_forward_kernel<0>
                : code == 1 ? train_forward_kernel<1>
                            : train_forward_kernel<2>;
  kernel<<<n_samples, 32, 0, strm>>>(
      j, lengths, p, q, T, nx, spp, alpha, r, x_last, x_prev, j_last);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
