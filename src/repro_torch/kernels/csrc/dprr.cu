// K7: the DPRR of stored reservoir states (paper Eq. 27-28).
//
// Replaces the TPU kernel src/repro/kernels/dprr.py:_dprr_kernel (entry
// dprr_pallas).  For each sample b it computes
//   r[b, n*Nx + i] = sum_{k < len} x(k)_n x(k-1)_i,   r[b, Nx*Nx + n] =
//   sum_{k < len} x(k)_n,   with x(-1) = 0,
// from X (N, T, Nx) and the lengths: the layout ops.dprr_features returns.
// The length mask sits on the x(k) side, as in the TPU kernel, so the rows
// past a length (the frozen state) never count; x(k-1) is read unmasked.
//
// What bounds it on an H100: the bytes.  X is read once (73.7 MB for the
// 6600 ARAB samples, T = 93, Nx = 30) and r written once (24.6 MB): about
// 0.029 ms at 3.35 TB/s, against Nx(Nx+1) multiply-adds per live step.  The
// design reads each row of X once and never stores a shifted copy: one warp
// per sample, lane n holds x(k)_n and its row of Nx+1 accumulators in
// registers, and x(k-1) reaches the lanes by __shfl_sync from the lane that
// held it one step earlier.  The loop ends at the sample's length, so the
// frozen rows are not even read.  The outer block leaves through shared
// memory so that the warp's stores are contiguous.
#include "dfr_step.cuh"

namespace {

constexpr int kNodes = dfr::kMaxNodes;

__global__ void __launch_bounds__(dfr::kWarpsPerBlock * 32)
dprr_kernel(const float* __restrict__ X, const int* __restrict__ lengths,
            int n_samples, int T, int nx, float* __restrict__ r) {
  __shared__ float stage[dfr::kWarpsPerBlock][kNodes * kNodes];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * dfr::kWarpsPerBlock + warp;
  if (b >= n_samples) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const bool node = lane < nx;

  float acc[kNodes];
#pragma unroll
  for (int i = 0; i < kNodes; ++i) acc[i] = 0.0f;
  float acc_sum = 0.0f;

  const float* xb = X + static_cast<size_t>(b) * T * nx;
  const int len = min(max(lengths[b], 0), T);
  float xp = 0.0f;  // x(k-1)_lane; x(-1) = 0
  float x_next = (node && len > 0) ? __ldg(xb + lane) : 0.0f;
  for (int k = 0; k < len; ++k) {
    const float xk = x_next;
    if (node && k + 1 < len) x_next = __ldg(xb + (k + 1) * nx + lane);
#pragma unroll
    for (int i = 0; i < kNodes; ++i)
      acc[i] = fmaf(xk, __shfl_sync(dfr::kFullMask, xp, i), acc[i]);
    acc_sum += xk;
    xp = xk;
  }

  float* st = stage[warp];
  if (node) {
#pragma unroll
    for (int i = 0; i < kNodes; ++i)
      if (i < nx) st[lane * nx + i] = acc[i];
  }
  __syncwarp();
  float* rb = r + static_cast<size_t>(b) * nx * (nx + 1);
  for (int idx = lane; idx < nx * nx; idx += 32) rb[idx] = st[idx];
  if (node) rb[nx * nx + lane] = acc_sum;
}

}  // namespace

extern "C" int dfr_dprr_features(const float* X, const int* lengths,
                                 int n_samples, int T, int nx, float* r,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      (n_samples + dfr::kWarpsPerBlock - 1) / dfr::kWarpsPerBlock;
  dprr_kernel<<<blocks, dfr::kWarpsPerBlock * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(X, lengths, n_samples, T,
                                                     nx, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
