// Backward of the volume kernel (K1b): the gradient of the mean volume with
// respect to the 2D feature maps.
//
// The JAX package computes it outside Pallas, in
// cnrma_tpu/ops/backproject.py:_accum_core_bwd (the custom VJP of the
// volume sum: a per-view scatter-add of the volume cotangent onto the
// pixels each voxel reads), after _normalize_volume's division taken
// backwards.  K1 (volume_accum.cu) has no gradient of its own, so this is
// the port's backward for K1:
//
//     g_feat[v, p, c] = sum over voxels i with view_valid[v], valid(v, i)
//                       and pixel(v, i) == p of  g_mean[i, c] / cnt[i],
//
// where cnt is K1's fp32 view count (voxels with cnt == 0 give nothing).
// pixel(v, i) and valid(v, i) are K1's, from the same projection code
// (volume_common.cuh) under the same --fmad=false build, so a gradient
// lands on exactly the pixel whose feature the forward read.
//
// Design: K1's blocks.  A block owns an 8x8x4 voxel tile, one thread a
// voxel; the tile's views are culled as in K1; each thread loads its
// voxel's cotangent row once (g_mean / cnt in fp32) and, for every view
// that sees it, adds the 32 values into an fp32 [V, H, W, 32] buffer that
// the launcher zeroes, with eight atomicAdd on float4 (sm_90's vector
// atomic, red.global.add.v4.f32; rows are 128-byte aligned).  The wrapper
// casts the buffer to the feature dtype.
//
// Bound on the H100: the atomics.  About a hundred (voxel, view) pairs
// land on each pixel row at the ScanNet shapes (PERF.md), so same-address
// atomics serialise in L2.  The vector atomic does a quarter of the
// atomic operations of one atomicAdd a channel, and takes about a quarter
// of its time at the training shape (PERF.md, section 6).  Ways to fewer
// still (a warp pre-summing the z-neighbours that hit one pixel, a sort by
// pixel) are listed in ROADMAP.md.  The sum order of the atomics changes from run
// to run, so the result agrees with the plain version to fp32 rounding,
// not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "volume_common.cuh"

namespace {

using namespace cnrma;

__device__ __forceinline__ void load_row(const float* row, float* g) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < kC / 4; ++i) {
    const float4 v = __ldg(q + i);
    g[4 * i + 0] = v.x;
    g[4 * i + 1] = v.y;
    g[4 * i + 2] = v.z;
    g[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* row,
                                         float* g) {
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < kC / 8; ++i) {
    const uint4 v = __ldg(q + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      g[8 * i + 2 * j + 0] = f.x;
      g[8 * i + 2 * j + 1] = f.y;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
volume_accum_bwd_kernel(const T* __restrict__ g_mean,     // [X, Y, Z, C]
                        const float* __restrict__ count,  // [X, Y, Z]
                        const float* __restrict__ proj,   // [V, 3, 4]
                        const uint8_t* __restrict__ view_valid,  // [V]
                        float* __restrict__ g_feat,       // [V, H, W, C]
                        int V, int H, int W, Grid g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int3 lo, hi;
  const int n_act = tile_views(proj, view_valid, V, H, W, g, smem, &lo, &hi);
  const float* s_proj = tile_projections(smem);
  const int* s_act = tile_active(smem, V);
  const int tid = threadIdx.x;

  // this thread's voxel: z fastest inside the tile, as in K1
  const int vx = lo.x + tid / (kTileY * kTileZ),
            vy = lo.y + (tid / kTileZ) % kTileY, vz = lo.z + tid % kTileZ;
  if (vx >= g.X || vy >= g.Y || vz >= g.Z) return;   // no barrier follows
  const size_t vox = (static_cast<size_t>(vx) * g.Y + vy) * g.Z + vz;
  const float cnt = count[vox];
  if (!(cnt > 0.f)) return;                  // seen by no view: no gradient
  float gs[kC];
  load_row(g_mean + vox * kC, gs);
#pragma unroll
  for (int c = 0; c < kC; ++c) gs[c] = gs[c] / cnt;   // the mean's division
  const float x = centre(vx, g.voxel_size, g.ox);
  const float y = centre(vy, g.voxel_size, g.oy);
  const float z = centre(vz, g.voxel_size, g.oz);

  const size_t view_stride = static_cast<size_t>(H) * W * kC;
  for (int a = 0; a < n_act; ++a) {
    const int v = s_act[a];
    int px, py;
    if (project(s_proj + 12 * v, x, y, z, H, W, &px, &py)) {
      float* dst = g_feat + v * view_stride
                   + (static_cast<size_t>(py) * W + px) * kC;
      float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int c = 0; c < kC / 4; ++c)
        atomicAdd(dst4 + c, make_float4(gs[4 * c], gs[4 * c + 1],
                                        gs[4 * c + 2], gs[4 * c + 3]));
    }
  }
}

template <typename T>
int launch(const void* g_mean, const void* count, const void* proj,
           const void* view_valid, void* g_feat, int V, int H, int W,
           const Grid& g, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(
      g_feat, 0, static_cast<size_t>(V) * H * W * kC * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = n_tiles(g);
  if (tiles == 0 || V == 0) return static_cast<int>(cudaSuccess);
  const size_t shmem = tile_shared_bytes(V);
  if (shmem > 48 * 1024) {
    e = cudaFuncSetAttribute(volume_accum_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  volume_accum_bwd_kernel<T><<<tiles, kThreads, shmem, s>>>(
      static_cast<const T*>(g_mean), static_cast<const float*>(count),
      static_cast<const float*>(proj),
      static_cast<const uint8_t*>(view_valid), static_cast<float*>(g_feat),
      V, H, W, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cnrma_volume_accum_bwd(const void* g_mean, const void* count,
                                      const void* proj,
                                      const void* view_valid, void* g_feat,
                                      int V, int H, int W, int C, int X,
                                      int Y, int Z, float voxel_size,
                                      float ox, float oy, float oz,
                                      int is_bf16, void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{X, Y, Z, voxel_size, ox, oy, oz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(g_mean, count, proj, view_valid, g_feat, V, H,
                              W, g, s)
      : launch<float>(g_mean, count, proj, view_valid, g_feat, V, H, W, g,
                      s);
}
