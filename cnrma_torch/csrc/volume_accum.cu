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

#include "volume_common.cuh"

namespace {

using namespace cnrma;

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

// K1's tile
using VolumeTile = Tile<8, 8, 4>;

template <typename T>
__global__ void __launch_bounds__(VolumeTile::kThreads)
volume_accum_kernel(const T* __restrict__ feats,       // [V, H, W, C]
                    const float* __restrict__ proj,    // [V, 3, 4]
                    const uint8_t* __restrict__ view_valid,  // [V]
                    T* __restrict__ out,               // [X, Y, Z, C]
                    float* __restrict__ count,         // [X, Y, Z]
                    uint8_t* __restrict__ valid,       // [X, Y, Z]
                    int V, int H, int W, Grid g) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Tl = VolumeTile;
  const TileViews tv = tile_views<Tl, false>(proj, view_valid, V, H, W, g,
                                             smem);
  const int tid = threadIdx.x;

  // this thread's voxel: z fastest inside the tile
  const int vx = tv.lo.x + tid / (Tl::Y * Tl::Z),
            vy = tv.lo.y + (tid / Tl::Z) % Tl::Y, vz = tv.lo.z + tid % Tl::Z;
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
  for (int a = 0; a < tv.n; ++a) {
    const int v = tv.act[a];
    const float* P = tv.proj + 12 * v;
    int px, py;
    if (mine && project(P, x, y, z, H, W, &px, &py)) {
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
  const int tiles = n_tiles<VolumeTile>(g);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const size_t shmem = tile_shared_bytes<false>(V);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        volume_accum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  volume_accum_kernel<T><<<tiles, VolumeTile::kThreads, shmem, s>>>(
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
