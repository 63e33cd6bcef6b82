// What the volume kernel (volume_accum.cu, K1) and its backward
// (volume_accum_bwd.cu, K1b) share: the voxel tile of a block, the per-tile
// view cull, and the projection of a voxel centre to its pixel.  Both
// kernels must round a voxel to the same pixel bit for bit, or a gradient
// lands on another pixel than the feature it stands for; so the projection
// is written once, here, in the plain version's operation order, and both
// files are built with --fmad=false.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cnrma {

constexpr int kC = 32;                    // feature channels (feature_dim)
constexpr int kTileX = 8, kTileY = 8, kTileZ = 4;   // voxel tile of a block
constexpr int kThreads = kTileX * kTileY * kTileZ;  // one thread a voxel

struct Grid {
  int X, Y, Z;
  float voxel_size, ox, oy, oz;
};

// Voxel centre, two roundings as in the reference: arange(n) * vs + origin.
__device__ __forceinline__ float centre(int i, float vs, float o) {
  return static_cast<float>(i) * vs + o;
}

// The pixel a voxel centre (x, y, z) lands on in the view of projection P
// ([3, 4] row-major):
//     cam = ((P0*x + P1*y) + P2*z) + P3,  inv_z = pz != 0 ? 1/pz : 0,
//     px = rint(cam_x * inv_z), py = rint(cam_y * inv_z)   (half to even);
// true where 0 <= px < W, 0 <= py < H and pz > 0.
__device__ __forceinline__ bool project(const float* P, float x, float y,
                                        float z, int H, int W, int* px,
                                        int* py) {
  const float cx = ((P[0] * x + P[1] * y) + P[2] * z) + P[3];
  const float cy = ((P[4] * x + P[5] * y) + P[6] * z) + P[7];
  const float cz = ((P[8] * x + P[9] * y) + P[10] * z) + P[11];
  const float inv_z = cz != 0.f ? 1.f / cz : 0.f;
  *px = __float2int_rn(cx * inv_z);
  *py = __float2int_rn(cy * inv_z);
  return *px >= 0 && *py >= 0 && *px < W && *py < H && cz > 0.f;
}

// Whether any voxel of the tile [lo, hi] (inclusive voxel ids) can see the
// view.  Eight lanes handle one view, one tile corner each, and reduce over
// the eight with shuffles, so every lane of the warp calls it; ok is false
// for an invalid view (and for lanes past the last view).
__device__ inline bool seen(const float* P, bool ok, int corner,
                            const Grid& g, int3 lo, int3 hi, int H, int W) {
  const float x = centre(corner & 1 ? hi.x : lo.x, g.voxel_size, g.ox);
  const float y = centre(corner & 2 ? hi.y : lo.y, g.voxel_size, g.oy);
  const float z = centre(corner & 4 ? hi.z : lo.z, g.voxel_size, g.oz);
  const float cx = ((P[0] * x + P[1] * y) + P[2] * z) + P[3];
  const float cy = ((P[4] * x + P[5] * y) + P[6] * z) + P[7];
  const float cz = ((P[8] * x + P[9] * y) + P[10] * z) + P[11];
  float scale = fabsf(P[8] * x) + fabsf(P[9] * y) + fabsf(P[10] * z)
                + fabsf(P[11]);
  float min_z = cz, max_z = cz;
  const float inv_z = 1.f / cz;            // used only when every cz > 0
  float x_lo = cx * inv_z, x_hi = x_lo, y_lo = cy * inv_z, y_hi = y_lo;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    scale = fmaxf(scale, __shfl_xor_sync(0xffffffffu, scale, off));
    min_z = fminf(min_z, __shfl_xor_sync(0xffffffffu, min_z, off));
    max_z = fmaxf(max_z, __shfl_xor_sync(0xffffffffu, max_z, off));
    x_lo = fminf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, off));
    x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, off));
    y_lo = fminf(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, off));
    y_hi = fmaxf(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, off));
  }
  if (!ok) return false;
  // pz is affine in the voxel centre, so its extremes over the tile are at
  // the corners; the margins cover fp32 rounding of the per-voxel pz
  if (max_z < -1e-4f * scale) return false;
  if (!(min_z > 1e-3f * scale)) return true;        // crosses the plane
  // in front of the camera a box projects inside its corners' pixel box;
  // widen it for the per-voxel rounding of px and of the corners
  const float m = 1.f + 1e-3f * fmaxf(fmaxf(fabsf(x_lo), fabsf(x_hi)),
                                      fmaxf(fabsf(y_lo), fabsf(y_hi)));
  return !(ceilf(x_hi + m) < 0.f || ceilf(y_hi + m) < 0.f
           || floorf(x_lo - m) > W - 1.f || floorf(y_lo - m) > H - 1.f);
}

// The shared memory of a block of either kernel: the projections, the
// views that are not culled and the per-view cull flags (53 B a view).
inline size_t tile_shared_bytes(int V) {
  return static_cast<size_t>(V) * (48 + 4 + 1);
}

// Number of 8x8x4 tiles over the grid (one block each).
inline int n_tiles(const Grid& g) {
  return ((g.X + kTileX - 1) / kTileX) * ((g.Y + kTileY - 1) / kTileY)
         * ((g.Z + kTileZ - 1) / kTileZ);
}

// The block's tile and the views it keeps.  Every thread of the block
// calls it (it holds barriers).  Loads the projections into s_proj, culls
// the views no voxel of the tile can see and lists the others, in order,
// in s_act; returns their number.  lo and hi are the tile's first and last
// voxel ids.
__device__ inline int tile_views(const float* __restrict__ proj,
                                 const uint8_t* __restrict__ view_valid,
                                 int V, int H, int W, const Grid& g,
                                 unsigned char* smem, int3* lo_out,
                                 int3* hi_out) {
  float* s_proj = reinterpret_cast<float*>(smem);             // V * 12
  int* s_act = reinterpret_cast<int*>(s_proj + 12 * V);       // V
  uint8_t* s_seen = reinterpret_cast<uint8_t*>(s_act + V);    // V
  __shared__ int s_n_act;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_z = (g.Z + kTileZ - 1) / kTileZ;
  const int tiles_y = (g.Y + kTileY - 1) / kTileY;
  const int tz = blockIdx.x % tiles_z;
  const int ty = (blockIdx.x / tiles_z) % tiles_y;
  const int tx = blockIdx.x / (tiles_z * tiles_y);
  const int3 lo = make_int3(tx * kTileX, ty * kTileY, tz * kTileZ);
  const int3 hi = make_int3(min(lo.x + kTileX, g.X) - 1,
                            min(lo.y + kTileY, g.Y) - 1,
                            min(lo.z + kTileZ, g.Z) - 1);

  for (int i = tid; i < 12 * V; i += kThreads) s_proj[i] = proj[i];
  __syncthreads();
  for (int base = 0; base < V; base += kThreads / 8) {
    const int v = base + tid / 8;
    const bool s = seen(s_proj + 12 * min(v, V - 1), v < V && view_valid[v],
                        tid & 7, g, lo, hi, H, W);
    if (v < V && (tid & 7) == 0) s_seen[v] = s;
  }
  __syncthreads();
  if (warp == 0) {                 // the views that are not culled, in order
    int n = 0;
    for (int base = 0; base < V; base += 32) {
      const int v = base + lane;
      const bool act = v < V && s_seen[v];
      const unsigned mask = __ballot_sync(0xffffffffu, act);
      if (act) s_act[n + __popc(mask & ((1u << lane) - 1))] = v;
      n += __popc(mask);
    }
    if (lane == 0) s_n_act = n;
  }
  __syncthreads();
  *lo_out = lo;
  *hi_out = hi;
  return s_n_act;
}

// The shared-memory arrays tile_views filled.
__device__ __forceinline__ const float* tile_projections(unsigned char* smem) {
  return reinterpret_cast<const float*>(smem);
}
__device__ __forceinline__ const int* tile_active(unsigned char* smem,
                                                  int V) {
  return reinterpret_cast<const int*>(
      reinterpret_cast<const float*>(smem) + 12 * V);
}

}  // namespace cnrma
