// K6: the unfused reservoir, writing every state x(k) to X (N, T, Nx).
//
// Replaces the TPU kernel src/repro/kernels/reservoir.py:_reservoir_kernel
// (entry reservoir_pallas).  Per sample it runs the recurrence of paper
// Eq. 14 from x(0) = 0 and stores the whole state sequence: X[b, k] = x(k+1)
// for k < length, and the frozen last state for every row past the length,
// as run_reservoir writes them.
//
// What bounds it on an H100: the bytes, at the full split's size.  Each
// sample reads its (T, Nx) masked inputs once and writes its (T, Nx) states
// once: 2 x 73.7 MB for the 6600 ARAB samples (T = 93, Nx = 30), about
// 0.044 ms at 3.35 TB/s, against about 3 Nx^2 flops a live step.  Within a
// sample the steps are a dependent chain, so the design keeps each chain
// short and many of them in flight: one warp per sample (lane n holds node
// n, the ring matvec by __shfl_sync, dfr_step.cuh), the next input
// prefetched, and each step's Nx states stored by the Nx lanes as one
// contiguous row.  The frozen rows past a length need no arithmetic, only
// the store.
#include "dfr_step.cuh"

namespace {

__global__ void __launch_bounds__(dfr::kWarpsPerBlock * 32)
reservoir_kernel(const float* __restrict__ j, const int* __restrict__ lengths,
                 const float* __restrict__ p, const float* __restrict__ q,
                 int n_samples, int T, int nx, int spp, int code, float alpha,
                 float* __restrict__ X) {
  const int b = blockIdx.x * dfr::kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_samples) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const bool node = lane < nx;
  const int sys = b / spp;
  const float ps = p[sys];

  dfr::Ring ring;
  dfr::make_ring(q[sys], nx, ring);

  const float* jb = j + static_cast<size_t>(b) * T * nx;
  float* xb = X + static_cast<size_t>(b) * T * nx;
  const int len = min(max(lengths[b], 0), T);
  float x = 0.0f;
  float j_next = (node && len > 0) ? __ldg(jb + lane) : 0.0f;
  for (int k = 0; k < len; ++k) {
    const float jk = j_next;
    if (node && k + 1 < len) j_next = __ldg(jb + (k + 1) * nx + lane);
    x = dfr::ring_step(ring, jk, x, nx, ps, code, alpha);
    if (node) xb[k * nx + lane] = x;
  }
  if (node)
    for (int k = len; k < T; ++k) xb[k * nx + lane] = x;  // frozen rows
}

}  // namespace

extern "C" int dfr_reservoir_states(const float* j, const int* lengths,
                                    const float* p, const float* q,
                                    int n_samples, int T, int nx, int spp,
                                    int code, float alpha, float* X,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      (n_samples + dfr::kWarpsPerBlock - 1) / dfr::kWarpsPerBlock;
  reservoir_kernel<<<blocks, dfr::kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      j, lengths, p, q, n_samples, T, nx, spp, code, alpha, X);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
