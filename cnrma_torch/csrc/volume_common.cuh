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
constexpr unsigned kFull = 0xffffffffu;   // every lane of a warp

// A block's voxel tile, one thread a voxel, z fastest inside the tile.
template <int TX, int TY, int TZ>
struct Tile {
  static constexpr int X = TX, Y = TY, Z = TZ;
  static constexpr int kThreads = TX * TY * TZ;
  static_assert(kThreads % 32 == 0 && kThreads <= 1024,
                "a tile is whole warps of one block");
};

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

// What a tile sees of a view.
enum Sight : uint8_t { kCulled = 0, kBoxed = 1, kCrosses = 2 };

// Whether any voxel of the tile [lo, hi] (inclusive voxel ids) can see the
// view, and where.  Eight lanes handle one view, one tile corner each, and
// reduce over the eight with shuffles, so every lane of the warp calls it;
// ok is false for an invalid view (and for lanes past the last view).
// kBoxed: the tile lies in front of the camera, and every voxel's pixel
// lies in *box = (x0, y0, width, height), the corners' pixel box widened
// by the margin and clamped to the image.  kCrosses: the tile crosses the
// camera plane; no box.
__device__ inline Sight footprint(const float* P, bool ok, int corner,
                                  const Grid& g, int3 lo, int3 hi, int H,
                                  int W, int4* box) {
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
    scale = fmaxf(scale, __shfl_xor_sync(kFull, scale, off));
    min_z = fminf(min_z, __shfl_xor_sync(kFull, min_z, off));
    max_z = fmaxf(max_z, __shfl_xor_sync(kFull, max_z, off));
    x_lo = fminf(x_lo, __shfl_xor_sync(kFull, x_lo, off));
    x_hi = fmaxf(x_hi, __shfl_xor_sync(kFull, x_hi, off));
    y_lo = fminf(y_lo, __shfl_xor_sync(kFull, y_lo, off));
    y_hi = fmaxf(y_hi, __shfl_xor_sync(kFull, y_hi, off));
  }
  if (!ok) return kCulled;
  // pz is affine in the voxel centre, so its extremes over the tile are at
  // the corners; the margins cover fp32 rounding of the per-voxel pz
  if (max_z < -1e-4f * scale) return kCulled;
  if (!(min_z > 1e-3f * scale)) return kCrosses;
  // in front of the camera a box projects inside its corners' pixel box;
  // widen it for the per-voxel rounding of px and of the corners
  const float m = 1.f + 1e-3f * fmaxf(fmaxf(fabsf(x_lo), fabsf(x_hi)),
                                      fmaxf(fabsf(y_lo), fabsf(y_hi)));
  const float bx0 = floorf(x_lo - m), bx1 = ceilf(x_hi + m);
  const float by0 = floorf(y_lo - m), by1 = ceilf(y_hi + m);
  if (bx1 < 0.f || by1 < 0.f || bx0 > W - 1.f || by0 > H - 1.f)
    return kCulled;
  // clamped as floats, so that the conversions stay in range
  const int x0 = static_cast<int>(fmaxf(bx0, 0.f));
  const int y0 = static_cast<int>(fmaxf(by0, 0.f));
  *box = make_int4(x0, y0, static_cast<int>(fminf(bx1, W - 1.f)) - x0 + 1,
                   static_cast<int>(fminf(by1, H - 1.f)) - y0 + 1);
  return kBoxed;
}

// The shared memory tile_views fills: per view the footprint box (K1b
// only), the projection, its place in the list of views kept and its
// sight (53 B a view, 69 with the box).
template <bool kBoxes>
inline size_t tile_shared_bytes(int V) {
  return static_cast<size_t>(V) * ((kBoxes ? 16 : 0) + 48 + 4 + 1);
}

// Number of tiles over the grid (one block each).
template <class Tl>
inline int n_tiles(const Grid& g) {
  return ((g.X + Tl::X - 1) / Tl::X) * ((g.Y + Tl::Y - 1) / Tl::Y)
         * ((g.Z + Tl::Z - 1) / Tl::Z);
}

// What tile_views gives a block: its tile, and in shared memory the
// projections [V, 12], the n views not culled, in order, and (K1b) each
// view's footprint box, width 0 for a view whose tile crosses its camera
// plane.
struct TileViews {
  int3 lo, hi;              // the tile's first and last voxel ids
  int n;
  const int* act;           // [n]
  const float* proj;        // [V, 12]
  const int4* box;          // [V], indexed by view
};

// The block's tile and the views it keeps.  Every thread of the block
// calls it (it holds barriers).  Loads the projections into shared
// memory, culls the views no voxel of the tile can see and lists the
// others, in order; with kBoxes, keeps each view's footprint box.
template <class Tl, bool kBoxes>
__device__ inline TileViews tile_views(const float* __restrict__ proj,
                                       const uint8_t* __restrict__ view_valid,
                                       int V, int H, int W, const Grid& g,
                                       unsigned char* smem) {
  int4* s_box = reinterpret_cast<int4*>(smem);                      // V
  float* s_proj = reinterpret_cast<float*>(smem + (kBoxes ? 16 * V : 0));
  int* s_act = reinterpret_cast<int*>(s_proj + 12 * V);             // V
  uint8_t* s_seen = reinterpret_cast<uint8_t*>(s_act + V);          // V
  __shared__ int s_n_act;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_z = (g.Z + Tl::Z - 1) / Tl::Z;
  const int tiles_y = (g.Y + Tl::Y - 1) / Tl::Y;
  const int tz = blockIdx.x % tiles_z;
  const int ty = (blockIdx.x / tiles_z) % tiles_y;
  const int tx = blockIdx.x / (tiles_z * tiles_y);
  TileViews tv;
  tv.lo = make_int3(tx * Tl::X, ty * Tl::Y, tz * Tl::Z);
  tv.hi = make_int3(min(tv.lo.x + Tl::X, g.X) - 1,
                    min(tv.lo.y + Tl::Y, g.Y) - 1,
                    min(tv.lo.z + Tl::Z, g.Z) - 1);

  for (int i = tid; i < 12 * V; i += Tl::kThreads) s_proj[i] = proj[i];
  __syncthreads();
  for (int base = 0; base < V; base += Tl::kThreads / 8) {
    const int v = base + tid / 8;
    int4 box = make_int4(0, 0, 0, 0);
    const Sight s = footprint(s_proj + 12 * min(v, V - 1),
                              v < V && view_valid[v], tid & 7, g, tv.lo,
                              tv.hi, H, W, &box);
    if (v < V && (tid & 7) == 0) {
      s_seen[v] = s != kCulled;
      if (kBoxes) s_box[v] = box;
    }
  }
  __syncthreads();
  if (warp == 0) {                 // the views that are not culled, in order
    int n = 0;
    for (int base = 0; base < V; base += 32) {
      const int v = base + lane;
      const bool act = v < V && s_seen[v];
      const unsigned mask = __ballot_sync(kFull, act);
      if (act) s_act[n + __popc(mask & ((1u << lane) - 1))] = v;
      n += __popc(mask);
    }
    if (lane == 0) s_n_act = n;
  }
  __syncthreads();
  tv.n = s_n_act;
  tv.act = s_act;
  tv.proj = s_proj;
  tv.box = s_box;
  return tv;
}

}  // namespace cnrma
