// What the fp32 reservoir kernels share past one warp (K1, K2, K6, K7):
// the DPRR's register tile and the launches over NPL = ceil(Nx / 32)
// nodes a lane.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace dfr {

// acc[i] += x(k) x(k-1)^T on lane (g, h)'s 8 x 4 register tile of kTiles
// padded 32 x 32 DPRR tiles side by side in one row of tiles: x(k)'s 8
// values at the tile's rows from xk, x(k-1)'s 4 at tile i's columns from
// xp + 32 i, each a float4 load from shared memory (16-byte aligned), and
// 32 fmaf a tile, no shuffles.
template <int kTiles = 1>
__device__ __forceinline__ void fold_tile(const float* xk, const float* xp,
                                          float (*acc)[8][4]) {
  const float4 a0 = *reinterpret_cast<const float4*>(xk);
  const float4 a1 = *reinterpret_cast<const float4*>(xk + 4);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const float4 p4 = *reinterpret_cast<const float4*>(xp + 32 * i);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[i][u][v] = fmaf(a[u], p[v], acc[i][u][v]);
  }
}

// f(std::integral_constant<int, NPL>{}) for npl = 2, 3 or 4: the wide
// kernels' instantiation for the launch's Nx.
template <typename F>
auto for_npl(int npl, F&& f) {
  return npl == 2   ? f(std::integral_constant<int, 2>{})
         : npl == 3 ? f(std::integral_constant<int, 3>{})
                    : f(std::integral_constant<int, 4>{});
}

// Launches `kernel` on `grid` blocks of `threads` with `smem` bytes of
// dynamic shared memory; above the default 48 KB the kernel's limit is
// raised first (before a CUDA graph captures the launch).
template <typename... Params, typename... Args>
cudaError_t launch_smem(void (*kernel)(Params...), int grid, int threads,
                        size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace dfr
