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
// lands on exactly the pixel whose feature the forward read.  The sum is
// taken in an fp32 [V, H, W, 32] buffer that the launcher zeroes; the
// wrapper casts it to the feature dtype.
//
// Bound on the H100: the atomics into that buffer, and the latency of
// each warp's chain of them.  The function's bytes (the cotangent read
// once, the gradient written once) take 0.15 ms at the training shape (40
// views of [120, 160, 32], a 192x192x80 grid); but its 44.7 million
// (voxel, view) pairs land on 0.75 million pixel rows, about 60 a row,
// and one float4 atomic per channel quad and pair (357 million) took
// 4.92 ms (PERF.md, section 6).
//
// Design: merge each tile's pairs in shared memory first.  A block owns
// an 8x8x4 voxel tile, one thread a voxel, and culls the views as K1
// does; for each view it keeps, the cull also gives the tile's footprint,
// a pixel box that holds every voxel's pixel.  Each warp holds its 32
// voxels' cotangent rows (g_mean / cnt, fp32) lane = channel: lane c
// keeps channel c of all 32.  Per view, each lane projects its own voxel;
// then the warp walks its 32 voxels' pairs one at a time, and lane c adds
// channel c into window[pixel][c], a shared-memory fp32 copy of the
// footprint's rows (32 lanes, 32 banks; a shared atomic, since the
// block's warps share the window, which sm_90a compiles to a
// compare-and-swap loop).  After a barrier the block flushes the window:
// each 16-byte piece that is not zero goes out as one float4 atomicAdd
// and is zeroed for the next view.  So the tile's pairs on one pixel
// leave as one row of atomics: 13.6 million rows in place of 44.7 million
// pairs.  Three kinds of pair skip the window and go straight out, one
// scalar atomicAdd a channel from the warp (one 128-byte row a
// pair): a tile that crosses the camera plane (no box), a footprint
// larger than the window, and a pixel outside its box (which the box's
// margin should make rare; correctness does not rest on it).
//
// What was measured (PERF.md section 6): the time follows the warps in
// flight more than the atomics' count.  The window is 256 pixels (32 KB;
// 15% of the pairs then go straight out) and the registers are capped at
// 48 so that five blocks fit on an SM: 1.84 ms, against 3.38 with a
// 512-pixel window at 86 registers (two blocks), 1.99 with 16x16x4 tiles,
// 2.42 with every pair sent straight out, and 1.94 with the flush one
// warp a row.  The sum order of the atomics changes from run to run, so
// the result agrees with the plain version to fp32 rounding, not bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "volume_common.cuh"

namespace {

using namespace cnrma;

// the tile (backproject.K1B_TILE mirrors it), the window in pixels (32 KB
// of fp32 rows) and the blocks an SM that cap the registers at 48: the
// fastest of the forms timed (above)
using BwdTile = Tile<8, 8, 4>;
constexpr int kWindow = 256;
constexpr int kMinBlocks = 5;

__device__ __forceinline__ float load_channel(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_channel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T, class Tl, int kWin>
__global__ void __launch_bounds__(Tl::kThreads, kMinBlocks)
volume_accum_bwd_kernel(const T* __restrict__ g_mean,     // [X, Y, Z, C]
                        const float* __restrict__ count,  // [X, Y, Z]
                        const float* __restrict__ proj,   // [V, 3, 4]
                        const uint8_t* __restrict__ view_valid,  // [V]
                        float* __restrict__ g_feat,       // [V, H, W, C]
                        unsigned long long* __restrict__ direct,  // or null
                        int V, int H, int W, Grid g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);                // [kWin, kC]
  float4* win4 = reinterpret_cast<float4*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < kWin * kC / 4; i += Tl::kThreads)
    win4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // (tile_views' barriers order the zeroing before the first view)
  const TileViews tv = tile_views<Tl, true>(
      proj, view_valid, V, H, W, g, smem + kWin * kC * sizeof(float));

  // this lane's voxel: z fastest inside the tile, as in K1
  const int vx = tv.lo.x + tid / (Tl::Y * Tl::Z),
            vy = tv.lo.y + (tid / Tl::Z) % Tl::Y, vz = tv.lo.z + tid % Tl::Z;
  const bool mine = vx < g.X && vy < g.Y && vz < g.Z;
  const int vox = mine ? (vx * g.Y + vy) * g.Z + vz : 0;  // < 2**31
  const float cnt = mine ? count[vox] : 0.f;
  const bool live = cnt > 0.f;                // seen by no view: no gradient
  // the warp's 32 cotangent rows, lane = channel: gs[j] is channel `lane`
  // of voxel j's g_mean / cnt (the mean's division), one 128-byte load a
  // row in fp32
  float gs[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int vj = __shfl_sync(kFull, vox, j);
    const float cj = __shfl_sync(kFull, cnt, j);
    gs[j] = cj > 0.f
        ? load_channel(g_mean + static_cast<size_t>(vj) * kC + lane) / cj
        : 0.f;
  }
  const float x = centre(vx, g.voxel_size, g.ox);
  const float y = centre(vy, g.voxel_size, g.oy);
  const float z = centre(vz, g.voxel_size, g.oz);

  const size_t view_stride = static_cast<size_t>(H) * W * kC;
  for (int k = 0; k < tv.n; ++k) {
    const int v = tv.act[k];
    const int4 box = tv.box[v];          // x0, y0, width, height
    const bool windowed = box.z > 0 && box.z * box.w <= kWin;
    float* dst = g_feat + v * view_stride;
    // -1: no pair; >= 0: the pair's row of the window; else -2 - its pixel
    int code = -1;
    int px, py;
    if (live && project(tv.proj + 12 * v, x, y, z, H, W, &px, &py)) {
      const int lx = px - box.x, ly = py - box.y;
      code = windowed && lx >= 0 && ly >= 0 && lx < box.z && ly < box.w
          ? ly * box.z + lx : -2 - (py * W + px);
    }
    if (__any_sync(kFull, code != -1)) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = __shfl_sync(kFull, code, j);
        if (c >= 0)
          atomicAdd(win + c * kC + lane, gs[j]);
        else if (c != -1)
          atomicAdd(dst + static_cast<size_t>(-2 - c) * kC + lane, gs[j]);
      }
      if (direct != nullptr) {
        const unsigned d = __ballot_sync(kFull, code < -1);
        if (lane == 0 && d != 0u)
          atomicAdd(direct, static_cast<unsigned long long>(__popc(d)));
      }
    }
    if (windowed) {                      // the same for the whole block
      __syncthreads();
      for (int i = tid; i < box.z * box.w * (kC / 4); i += Tl::kThreads) {
        const float4 s = win4[i];
        if (s.x != 0.f || s.y != 0.f || s.z != 0.f || s.w != 0.f) {
          const int p = i / (kC / 4);
          const int row = (box.y + p / box.z) * W + box.x + p % box.z;
          atomicAdd(reinterpret_cast<float4*>(
                        dst + static_cast<size_t>(row) * kC) + i % (kC / 4),
                    s);
          win4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* g_mean, const void* count, const void* proj,
           const void* view_valid, void* g_feat, void* direct, int V, int H,
           int W, const Grid& g, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(
      g_feat, 0, static_cast<size_t>(V) * H * W * kC * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(g.X) * g.Y * g.Z >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = n_tiles<BwdTile>(g);
  if (tiles == 0 || V == 0) return static_cast<int>(cudaSuccess);
  auto kernel = volume_accum_bwd_kernel<T, BwdTile, kWindow>;
  const size_t shmem = kWindow * kC * sizeof(float)
                       + tile_shared_bytes<true>(V);
  if (shmem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<tiles, BwdTile::kThreads, shmem, s>>>(
      static_cast<const T*>(g_mean), static_cast<const float*>(count),
      static_cast<const float*>(proj),
      static_cast<const uint8_t*>(view_valid), static_cast<float*>(g_feat),
      static_cast<unsigned long long*>(direct), V, H, W, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// direct: null, or an unsigned 64-bit count on the card, to which the
// kernel adds the pairs that skipped the window.
extern "C" int cnrma_volume_accum_bwd(const void* g_mean, const void* count,
                                      const void* proj,
                                      const void* view_valid, void* g_feat,
                                      int V, int H, int W, int C, int X,
                                      int Y, int Z, float voxel_size,
                                      float ox, float oy, float oz,
                                      int is_bf16, void* direct,
                                      void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{X, Y, Z, voxel_size, ox, oy, oz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(g_mean, count, proj, view_valid, g_feat,
                              direct, V, H, W, g, s)
      : launch<float>(g_mean, count, proj, view_valid, g_feat, direct, V, H,
                      W, g, s);
}
