// K6: the unfused reservoir, writing every state x(k) to X (N, T, Nx).
//
// Replaces the TPU kernel src/repro/kernels/reservoir.py:_reservoir_kernel
// (entry reservoir_pallas).  Per sample it runs the recurrence of paper
// Eq. 14 from x(0) = 0 and stores the whole state sequence: X[b, k] = x(k+1)
// for k < length, and the frozen last state for every row past the length,
// as run_reservoir writes them.
//
// What bounds it on an H100: the chain at the sizes the fit launches it
// (31,330 launches of 4 samples a DFRModel.fit, 30 of 256 a fit_ridge), the
// bytes only at the full split (6600 ARAB samples: 2 x 73.7 MB of inputs and
// states).  Each sample is a chain of `length` dependent steps; a step is
// the x(k) of paper Eq. 14 in the ring closed form (dfr_step.cuh).  The
// design keeps that chain short and everything else off it:
//   * one warp a sample and one warp a block, at every N: at 4 and 256
//     samples each warp has an SM (or half of one) to itself, and at 6600
//     four-warp blocks were no faster;
//   * the step is scan_step, as in K1 and K2: the ring mix as a 5-round
//     shuffle scan with the wrap's shuffle off the chain, and for linear f
//     one FMA before it (dfr_step.cuh).  Its powers of q are products of q
//     in registers;
//   * the sample's live inputs stream through shared memory ahead of the
//     steps (stage_rows.cuh), so no step waits on device memory;
//   * a chunk's states go to a shared-memory buffer as the steps make them
//     and leave by one bulk copy (the tensor memory accelerator) that lane 0
//     issues after the chunk, the buffer's 16-byte phase matching X's; two
//     buffers, so a copy overlaps the next chunk.  The rows past a length
//     (the frozen state) are stored by the lanes at the end.
// What holds it now: the step's chain (6 dependent shuffles), a few hundred
// cycles at each chunk's boundary (the take of the next inputs and the
// bulk store's fence), and, at 4 and 256 samples, the launch itself.
// Above 32 nodes the same warp holds NPL = ceil(Nx / 32) contiguous nodes
// a lane (reservoir_wide_kernel, dfr_step.cuh's scan_step_n), its chunks'
// rows of Nx floats leaving by the same bulk copies.
#include <cstdint>

#include "dfr_step.cuh"
#include "npl.cuh"
#include "stage_rows.cuh"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The `words` states of one chunk from its shared-memory buffer (which
// holds word i at ph + i, ph = the 16-byte phase of dst) to dst in device
// memory: the 16-byte aligned middle by one bulk copy (the tensor memory
// accelerator) that lane 0 issues, in a bulk group of its own (empty if
// there is no middle), the rest by the lanes.  Every lane must call it
// after its last write to buf.
__device__ __forceinline__ void store_chunk(float* dst, const float* buf,
                                            int ph, int words) {
  const int lane = threadIdx.x & 31;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();  // every lane's states are in buf, visible to the copy
  const int head = min((4 - ph) & 3, words);
  const int body = (words - head) & ~3;
  const int tail = words - head - body;
  // unconditional reads inside buf and predicated stores: no branch
  const float hv = buf[min(ph + lane, ph + words)];
  const float tv = buf[min(ph + head + body + lane, ph + words)];
  if (lane < head) dst[lane] = hv;
  if (lane < tail) dst[head + body + lane] = tv;
  if (lane == 0) {
    if (body > 0)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              dst + head),
          "r"(smem_u32(buf + ph + head)), "r"(body * 4)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

__global__ void __launch_bounds__(32)
reservoir_kernel(const float* __restrict__ j, const int* __restrict__ lengths,
                 const float* __restrict__ p, const float* __restrict__ q,
                 int T, int nx, int spp, int code, float alpha,
                 float* __restrict__ X) {
  // the input ring, then two buffers of a chunk's states
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const bool node = lane < nx;
  dfr::RowStage<> stage{smem, j + static_cast<size_t>(b) * T * nx, nx, 0};
  stage.start_first(T);
  const int len = stage.len = min(max(lengths[b], 0), T);
  stage.start_rest();

  const int sys = b / spp;
  const float ps = p[sys];
  dfr::RingScan scan;
  dfr::make_scan(q[sys], scan);

  const int slot = dfr::stage_slot_floats(nx);
  float* const xb = X + static_cast<size_t>(b) * T * nx;
  float x = 0.0f;
  for (int c = 0, k0 = 0; k0 < len; ++c, k0 += dfr::kStageChunk) {
    float jr[dfr::kStageChunk];
    stage.take(c, jr);
#pragma unroll
    for (int u = 0; u < dfr::kStageChunk; ++u)
      jr[u] = dfr::scan_input(jr[u], ps, code, alpha);
    float* const dst = xb + k0 * nx;
    const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(dst) >> 2) & 3;
    float* const buf = smem + (dfr::kStageSlots + (c & 1)) * slot;
    if (c >= 2) {  // the bulk copy out of this buffer two chunks ago
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
    }
    const int steps = min(dfr::kStageChunk, len - k0);
    if (steps == dfr::kStageChunk) {  // a whole chunk: no length checks
#pragma unroll
      for (int u = 0; u < dfr::kStageChunk; ++u) {
        x = dfr::scan_step(scan, jr[u], x, nx, ps, code, alpha);
        if (node) buf[ph + u * nx + lane] = x;
      }
    } else {
#pragma unroll
      for (int u = 0; u < dfr::kStageChunk - 1; ++u) {
        if (u >= steps) break;
        x = dfr::scan_step(scan, jr[u], x, nx, ps, code, alpha);
        if (node) buf[ph + u * nx + lane] = x;
      }
    }
    store_chunk(dst, buf, ph, steps * nx);
  }
  if (node)
    for (int k = len; k < T; ++k) xb[k * nx + lane] = x;  // frozen rows
  cp_async_wait_all();  // a copy past a short length must land before exit
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int NPL>
__global__ void __launch_bounds__(32)
reservoir_wide_kernel(const float* __restrict__ j,
                      const int* __restrict__ lengths,
                      const float* __restrict__ p,
                      const float* __restrict__ q, int T, int nx, int spp,
                      int code, float alpha, float* __restrict__ X) {
  // the input ring, then two buffers of a chunk's states
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int n0 = threadIdx.x * NPL;
  dfr::RowStage<dfr::kMaxNodes> stage{
      smem, j + static_cast<size_t>(b) * T * nx, nx, 0};
  stage.start_first(T);
  const int len = stage.len = min(max(lengths[b], 0), T);
  stage.start_rest();

  const int sys = b / spp;
  const float ps = p[sys];
  dfr::RingScanN<NPL> scan;
  dfr::make_scan_n<NPL>(q[sys], nx, scan);

  const int slot = dfr::stage_slot_floats(nx);
  float* const xb = X + static_cast<size_t>(b) * T * nx;
  float x[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) x[i] = 0.0f;
  for (int c = 0, k0 = 0; k0 < len; ++c, k0 += dfr::kStageChunk) {
    float* const dst = xb + k0 * nx;
    const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(dst) >> 2) & 3;
    float* const buf = smem + (dfr::kStageSlots + (c & 1)) * slot;
    if (c >= 2) {  // the bulk copy out of this buffer two chunks ago
      if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
    }
    const int steps = min(dfr::kStageChunk, len - k0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float jr[dfr::kStageChunk / 2][NPL];
      stage.take_half<NPL>(c, half, jr);
#pragma unroll
      for (int u = 0; u < dfr::kStageChunk / 2; ++u) {
        const int k = half * (dfr::kStageChunk / 2) + u;
        if (k >= steps) break;
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          jr[u][i] = dfr::scan_input(jr[u][i], ps, code, alpha);
        dfr::scan_step_n<NPL>(scan, jr[u], x, ps, code, alpha);
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if (n0 + i < nx) buf[ph + k * nx + n0 + i] = x[i];
      }
    }
    store_chunk(dst, buf, ph, steps * nx);
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    if (n0 + i < nx)
      for (int k = len; k < T; ++k) xb[k * nx + n0 + i] = x[i];  // frozen
  cp_async_wait_all();  // a copy past a short length must land before exit
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

extern "C" int dfr_reservoir_states(const float* j, const int* lengths,
                                    const float* p, const float* q,
                                    int n_samples, int T, int nx, int spp,
                                    int code, float alpha, float* X,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || nx > dfr::kMaxNodes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (dfr::kStageSlots + 2) * dfr::stage_slot_floats(nx);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int npl = (nx + 31) / 32;
  auto kernel = npl == 1 ? reservoir_kernel : dfr::for_npl(npl, [](auto c) {
    return reservoir_wide_kernel<decltype(c)::value>;
  });
  kernel<<<n_samples, 32, smem, strm>>>(j, lengths, p, q, T, nx, spp, code,
                                        alpha, X);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dfr_max_nodes() { return dfr::kMaxNodes; }

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
