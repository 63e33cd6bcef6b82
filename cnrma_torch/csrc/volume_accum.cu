// Fused multi-view volume accumulation: the mean of the pixel features that
// each voxel centre projects onto, over all valid views.
//
// Replaces the TPU kernel cnrma_tpu/ops/pallas_bp.py:rect_gather (and the
// tile / rect selection, one-hot gather and read-modify-write accumulation
// around it in cnrma_tpu/ops/backproject.py).  It computes the function
// that kernel serves, the dense `tile=0` accumulation
// (backproject.py:_project_indices, _accum_impl, _normalize_volume), not its
// steps: its rects and capacities are not kept, so no view's contribution
// can be dropped.
//
// Per voxel and view, in the plain version's operation order:
//     cam = ((P0*x + P1*y) + P2*z) + P3,  inv_z = pz != 0 ? 1/pz : 0,
//     px = rint(cam_x * inv_z), py = rint(cam_y * inv_z)   (half to even),
// and where 0 <= px < W, 0 <= py < H and pz > 0 the 32-channel pixel row is
// added to an fp32 sum and one to an fp32 count, over v = 0 .. V-1 in order.
// The mean (sum / count, 0 where count == 0) is written once in the feature
// dtype in the [X, Y, Z, C] layout, with the count and the [X, Y, Z] valid
// mask.  Built with --fmad=false so pixel ids agree bit for bit with the
// plain torch version.
//
// Design.  A block owns an 8x8x4 voxel tile, one thread a voxel (z fastest
// inside the tile).  Once per block it projects the tile's 8 corner voxel
// centres into every view (8 lanes a view, reduced with shuffles) and culls
// the views that no voxel of the tile can see: the tile lies behind the
// camera, or its footprint (the corners' pixel box, widened by
// 1 + 1e-3 |px| pixels for rounding) misses the image.  A tile that
// crosses the camera plane is never culled.  Only the footprint's margins
// decide a cull, and they are wide enough that a voxel of a culled view
// would project outside the image in fp32 too.  Every voxel then runs over
// the views that are not culled, in order, and reads its row from global
// memory through the read-only path, so the L1 serves the rows that
// neighbouring voxels share.  (Staging each footprint in shared memory with
// cp.async was tried and was slower: its block-wide barrier per view and
// its copy of each whole footprint cost more than the L1 reuse they
// replace; PERF.md, section 6.)
//
// Bound on the H100: the projection and the pixel-row reads.  At the full
// ScanNet shape (256x256x96 voxels, 50 views of [120, 160, 32]) a ring of
// cameras sees each tile from a minority of the views, so the cull spares
// most projections, and the 97M row reads (for 0.94M distinct rows, as
// chip_smoke.py counts them) hit neighbouring rows within a block.  The sum
// never round-trips through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                    // feature channels (feature_dim)
constexpr int kTileX = 8, kTileY = 8, kTileZ = 4;   // voxel tile of a block
constexpr int kThreads = kTileX * kTileY * kTileZ;  // one thread a voxel

// A voxel's 32-channel pixel row added to acc: 16-byte loads through the
// read-only path.
__device__ __forceinline__ void add_row(const float* row, float* acc) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < kC / 4; ++i) {
    const float4 v = __ldg(q + i);
    acc[4 * i + 0] += v.x;
    acc[4 * i + 1] += v.y;
    acc[4 * i + 2] += v.z;
    acc[4 * i + 3] += v.w;
  }
}

__device__ __forceinline__ void add_row(const __nv_bfloat16* row,
                                        float* acc) {
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < kC / 8; ++i) {
    const uint4 v = __ldg(q + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[8 * i + 2 * j + 0] += f.x;
      acc[8 * i + 2 * j + 1] += f.y;
    }
  }
}

__device__ __forceinline__ void store_row(float* out, const float* acc,
                                          float cnt) {
  float4* q = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < kC / 4; ++i) {
    float4 v;
    v.x = cnt > 0.f ? acc[4 * i + 0] / cnt : 0.f;
    v.y = cnt > 0.f ? acc[4 * i + 1] / cnt : 0.f;
    v.z = cnt > 0.f ? acc[4 * i + 2] / cnt : 0.f;
    v.w = cnt > 0.f ? acc[4 * i + 3] / cnt : 0.f;
    q[i] = v;
  }
}

__device__ __forceinline__ void store_row(__nv_bfloat16* out,
                                          const float* acc, float cnt) {
  uint4* q = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int i = 0; i < kC / 8; ++i) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = cnt > 0.f ? acc[8 * i + 2 * j + 0] / cnt : 0.f;
      const float b = cnt > 0.f ? acc[8 * i + 2 * j + 1] / cnt : 0.f;
      h[j] = __floats2bfloat162_rn(a, b);
    }
    q[i] = v;
  }
}

struct Grid {
  int X, Y, Z;
  float voxel_size, ox, oy, oz;
};

// Voxel centre, two roundings as in the reference: arange(n) * vs + origin.
__device__ __forceinline__ float centre(int i, float vs, float o) {
  return static_cast<float>(i) * vs + o;
}

// Whether any voxel of the tile [lo, hi] (inclusive voxel ids) can see the
// view.  Eight lanes handle one view, one tile corner each, and reduce over
// the eight with shuffles, so every lane of the warp calls it; ok is false
// for an invalid view (and for lanes past the last view).
__device__ bool seen(const float* P, bool ok, int corner, const Grid& g,
                     int3 lo, int3 hi, int H, int W) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
volume_accum_kernel(const T* __restrict__ feats,       // [V, H, W, C]
                    const float* __restrict__ proj,    // [V, 3, 4]
                    const uint8_t* __restrict__ view_valid,  // [V]
                    T* __restrict__ out,               // [X, Y, Z, C]
                    float* __restrict__ count,         // [X, Y, Z]
                    uint8_t* __restrict__ valid,       // [X, Y, Z]
                    int V, int H, int W, Grid g) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int n_act = s_n_act;

  // this thread's voxel: z fastest inside the tile
  const int vx = lo.x + tid / (kTileY * kTileZ),
            vy = lo.y + (tid / kTileZ) % kTileY, vz = lo.z + tid % kTileZ;
  const bool mine = vx < g.X && vy < g.Y && vz < g.Z;
  const float x = centre(vx, g.voxel_size, g.ox);
  const float y = centre(vy, g.voxel_size, g.oy);
  const float z = centre(vz, g.voxel_size, g.oz);

  const size_t view_stride = static_cast<size_t>(H) * W * kC;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  float cnt = 0.f;
  // each view that is not culled: project the voxel and add the row it
  // lands on
  for (int a = 0; a < n_act; ++a) {
    const int v = s_act[a];
    const float* P = s_proj + 12 * v;
    const float cx = ((P[0] * x + P[1] * y) + P[2] * z) + P[3];
    const float cy = ((P[4] * x + P[5] * y) + P[6] * z) + P[7];
    const float cz = ((P[8] * x + P[9] * y) + P[10] * z) + P[11];
    const float inv_z = cz != 0.f ? 1.f / cz : 0.f;
    const int px = __float2int_rn(cx * inv_z);     // round half to even
    const int py = __float2int_rn(cy * inv_z);
    if (mine && px >= 0 && py >= 0 && px < W && py < H && cz > 0.f) {
      add_row(feats + v * view_stride + (static_cast<size_t>(py) * W + px)
                                            * kC,
              acc);
      cnt += 1.f;
    }
  }

  if (mine) {
    const size_t vox = (static_cast<size_t>(vx) * g.Y + vy) * g.Z + vz;
    store_row(out + vox * kC, acc, cnt);
    count[vox] = cnt;
    valid[vox] = cnt > 0.f;
  }
}

template <typename T>
int launch(const void* feats, const void* proj, const void* view_valid,
           void* out, void* count, void* valid, int V, int H, int W,
           const Grid& g, cudaStream_t s) {
  const int tiles = ((g.X + kTileX - 1) / kTileX)
                    * ((g.Y + kTileY - 1) / kTileY)
                    * ((g.Z + kTileZ - 1) / kTileZ);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const size_t shmem = static_cast<size_t>(V) * (48 + 4 + 1);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        volume_accum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  volume_accum_kernel<T><<<tiles, kThreads, shmem, s>>>(
      static_cast<const T*>(feats), static_cast<const float*>(proj),
      static_cast<const uint8_t*>(view_valid), static_cast<T*>(out),
      static_cast<float*>(count), static_cast<uint8_t*>(valid), V, H, W, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cnrma_volume_accum(const void* feats, const void* proj,
                                  const void* view_valid, void* out,
                                  void* count, void* valid, int V, int H,
                                  int W, int C, int X, int Y, int Z,
                                  float voxel_size, float ox, float oy,
                                  float oz, int is_bf16, void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{X, Y, Z, voxel_size, ox, oy, oz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(feats, proj, view_valid, out, count, valid, V,
                              H, W, g, s)
      : launch<float>(feats, proj, view_valid, out, count, valid, V, H, W, g,
                      s);
}

extern "C" const char* cnrma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
