// K2: fused streaming step, reservoir -> DPRR -> readout logits.
//
// Replaces the TPU kernel src/repro/kernels/streaming.py:_streaming_kernel
// (entry streaming_step_pallas).  Per sample it runs K1's time loop
// (dfr_sample.cuh) and contracts the DPRR vector r with its system's
// readout W (Ny, Nx^2 + Nx), then adds the bias: logits = r . W^T + b.
// Neither X nor r reaches device memory.
//
// What bounds it on an H100: the latency of the sample's chain of dependent
// steps, as in K1 (see dfr_sample.cuh for the design); one warp a sample and
// a block, and one instantiation for each f, as K1.  The readout waits on
// W[sys] (37.2 KB at Ny = 10):
//   * r goes to shared memory in its layout, and lane l takes its elements
//     l, l + 32, ..., so that each class row of W loads coalesced;
//   * kClasses classes are summed at once, with independent accumulators
//     and their warp reductions interleaved, and the loads of the next
//     kClasses classes are in flight while they are summed.  Prefetching W
//     into L1 or L2 during the time loop made the kernel slower.
// One launch covers every slot of a server step: p, q, W and b are read per
// system, so W needs no relayout into the TPU's (ny_pad, n_pad, n_pad)
// tile.
//
// Above 32 nodes a sample takes one block of 1 + NPL^2 / kTiles warps, as in K1
// (dfr_sample.cuh's run_sample_wide), and r (up to 16,512 floats, 66 KB)
// stays in dynamic shared memory for the readout: the block's warps take
// the classes in turn, each class's row of W loaded coalesced, four
// independent sums a lane.
#include "dfr_sample.cuh"

namespace {

constexpr int kTerms = (dfr::kWarpNodes * (dfr::kWarpNodes + 1) + 31) / 32;
constexpr int kClasses = 2;  // classes summed at once

template <int kCode>
__global__ void __launch_bounds__(32)
streaming_logits_kernel(const float* __restrict__ j,
                        const int* __restrict__ lengths,
                        const float* __restrict__ p,
                        const float* __restrict__ q,
                        const float* __restrict__ W,
                        const float* __restrict__ bias, int T, int nx,
                        int ny, int spp, float alpha,
                        float* __restrict__ out) {
  __shared__ dfr::SampleShared sh;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int sys = b / spp;
  const int nr = nx * (nx + 1);
  const float* const w_sys = W + static_cast<size_t>(sys) * ny * nr;

  dfr::SampleOut s;
  dfr::run_sample<kCode>(
      sh, j + static_cast<size_t>(b) * T * nx, T, nx, lengths + b, p + sys,
      q + sys, alpha, s);
  const float* const rs = dfr::store_r(sh, s, nx);
  float rv[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    const int e = lane + 32 * m;
    const float v = rs[e];  // inside the state ring whatever nr is
    rv[m] = e < nr ? v : 0.0f;
  }

  // A group's loads are unconditional, at addresses clamped into W[sys],
  // and independent, so they are all in flight together, and the next
  // group's are issued before this group is summed; rv is 0 past r, and
  // the sums of classes past Ny are not stored.
  auto load = [&](int y0, float (&w)[kClasses][kTerms]) {
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      const float* const wy =
          w_sys + static_cast<size_t>(min(y0 + c, ny - 1)) * nr;
#pragma unroll
      for (int m = 0; m < kTerms; ++m)
        w[c][m] = __ldg(wy + min(lane + 32 * m, nr - 1));
    }
  };
  auto emit = [&](int y0, const float (&w)[kClasses][kTerms]) {
    float part[kClasses];
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      part[c] = 0.0f;
#pragma unroll
      for (int m = 0; m < kTerms; ++m)
        part[c] = fmaf(rv[m], w[c][m], part[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < kClasses; ++c)
        part[c] += __shfl_xor_sync(dfr::kFullMask, part[c], off);
    float v = part[0];
#pragma unroll
    for (int c = 1; c < kClasses; ++c)
      if (lane == c) v = part[c];
    const int y = y0 + lane;
    if (lane < kClasses && y < ny)
      out[static_cast<size_t>(b) * ny + y] = v + bias[sys * ny + y];
  };
  float wa[kClasses][kTerms], wb[kClasses][kTerms];
  load(0, wa);
  for (int y0 = 0; y0 < ny; y0 += 2 * kClasses) {
    load(y0 + kClasses, wb);
    emit(y0, wa);
    if (y0 + kClasses >= ny) break;
    load(y0 + 2 * kClasses, wa);
    emit(y0 + kClasses, wb);
  }
}

template <int kCode, int NPL>
__global__ void __launch_bounds__(dfr::Wide<NPL>::kThreads, 1)
streaming_logits_wide_kernel(const float* __restrict__ j,
                             const int* __restrict__ lengths,
                             const float* __restrict__ p,
                             const float* __restrict__ q,
                             const float* __restrict__ W,
                             const float* __restrict__ bias, int T, int nx,
                             int ny, int spp, float alpha,
                             float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarps = dfr::Wide<NPL>::kThreads / 32;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = b / spp;
  const int nr = nx * (nx + 1);

  dfr::WideOut<NPL> s;
  dfr::run_sample_wide<kCode, NPL>(
      smem, j + static_cast<size_t>(b) * T * nx, T, nx, lengths + b,
      p + sys, q + sys, alpha, s);
  const float* const rs = dfr::store_r_wide<NPL>(smem, s, nx);
  for (int y = warp; y < ny; y += kWarps) {
    const float* const wy = W + (static_cast<size_t>(sys) * ny + y) * nr;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int e = lane;
    for (; e + 96 < nr; e += 128) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        part[m] = fmaf(rs[e + 32 * m], __ldg(wy + e + 32 * m), part[m]);
    }
    for (; e < nr; e += 32) part[0] = fmaf(rs[e], __ldg(wy + e), part[0]);
    float v = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(dfr::kFullMask, v, off);
    if (lane == 0)
      out[static_cast<size_t>(b) * ny + y] = v + bias[sys * ny + y];
  }
}

}  // namespace

extern "C" int dfr_max_nodes() { return dfr::kMaxNodes; }

extern "C" int dfr_streaming_logits(const float* j, const int* lengths,
                                    const float* p, const float* q,
                                    const float* W, const float* bias,
                                    int n_samples, int T, int nx, int ny,
                                    int spp, int code, float alpha,
                                    float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || nx > dfr::kMaxNodes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int npl = (nx + 31) / 32;
  if (npl > 1)
    return static_cast<int>(dfr::for_npl(npl, [&](auto c) {
      constexpr int NPL = decltype(c)::value;
      auto kernel = code == 0   ? streaming_logits_wide_kernel<0, NPL>
                    : code == 1 ? streaming_logits_wide_kernel<1, NPL>
                                : streaming_logits_wide_kernel<2, NPL>;
      return dfr::launch_smem(kernel, n_samples, dfr::Wide<NPL>::kThreads,
                              sizeof(float) * dfr::wide_smem_floats(nx, NPL),
                              strm, j, lengths, p, q, W, bias, T, nx, ny, spp,
                              alpha, out);
    }));
  auto kernel = code == 0   ? streaming_logits_kernel<0>
                : code == 1 ? streaming_logits_kernel<1>
                            : streaming_logits_kernel<2>;
  kernel<<<n_samples, 32, 0, strm>>>(
      j, lengths, p, q, W, bias, T, nx, ny, spp, alpha, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
