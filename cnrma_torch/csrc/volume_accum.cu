// Fused multi-view volume accumulation: the mean of the pixel features that
// each voxel centre projects onto, over all valid views.
//
// Replaces the TPU kernel cnrma_tpu/ops/pallas_bp.py:rect_gather (and the
// tile / rect selection, one-hot gather and read-modify-write accumulation
// around it in cnrma_tpu/ops/backproject.py).  It computes the function
// that kernel serves, the dense `tile=0` accumulation
// (backproject.py:_project_indices, _accum_impl, _normalize_volume), not its
// steps: there are no tiles, rects, one-hots or capacities, so no view's
// contribution can be dropped.
//
// Design: one thread owns one voxel.  It loops over the views (their 3x4
// projections and valid flags sit in shared memory), projects its centre
// with the reference's operation order
//     cam = ((P0*x + P1*y) + P2*z) + P3,  inv_z = pz != 0 ? 1/pz : 0,
//     px = rint(cam_x * inv_z), py = rint(cam_y * inv_z)   (half to even),
// and, where 0 <= px < W, 0 <= py < H and pz > 0, adds the 32-channel pixel
// row (64 B in bf16, 128 B in fp32, read as 16-byte vector loads) to an fp32
// sum in registers and one to an fp32 count.  It writes the mean once
// (sum / count, 0 where count == 0) in the feature dtype in the [X, Y, Z, C]
// layout, the count, and the [X, Y, Z] valid mask.  Built with
// --fmad=false so no multiply-add is contracted and pixel ids agree bit for
// bit with the plain torch version.
//
// Bound on the H100: the pixel-row reads.  At the full ScanNet shape
// (256x256x96 voxels, 50 views of [120, 160, 32]) that is up to 6.3M voxels
// x 50 views x 64 B; the 1.2 MB bf16 feature map of a view stays in the
// 50 MB L2, so the reads are served mostly from L2, and the sum never
// round-trips through device memory (the TPU path's accumulator did, once
// per chunk of views).  The projection is a few dozen flops per voxel and
// view and is not the bound.  Later work: several voxels per thread along
// z (neighbouring voxels hit neighbouring pixels) and a per-view cull of
// blocks outside the frustum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;          // feature channels (the model's feature_dim)
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
volume_accum_kernel(const T* __restrict__ feats,       // [V, H, W, C]
                    const float* __restrict__ proj,    // [V, 3, 4]
                    const uint8_t* __restrict__ view_valid,  // [V]
                    T* __restrict__ out,               // [X, Y, Z, C]
                    float* __restrict__ count,         // [X, Y, Z]
                    uint8_t* __restrict__ valid,       // [X, Y, Z]
                    int V, int H, int W, int X, int Y, int Z,
                    float voxel_size, float ox, float oy, float oz) {
  extern __shared__ float smem[];
  float* s_proj = smem;                                           // V * 12
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(smem + 12 * V);      // V
  for (int i = threadIdx.x; i < 12 * V; i += blockDim.x) s_proj[i] = proj[i];
  for (int i = threadIdx.x; i < V; i += blockDim.x) s_ok[i] = view_valid[i];
  __syncthreads();

  const long long n = static_cast<long long>(X) * Y * Z;
  const long long vox = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  if (vox >= n) return;
  const int iz = static_cast<int>(vox % Z);
  const long long rest = vox / Z;
  const int iy = static_cast<int>(rest % Y);
  const int ix = static_cast<int>(rest / Y);
  // arange(X) * voxel_size + origin, two roundings as in the reference
  const float x = static_cast<float>(ix) * voxel_size + ox;
  const float y = static_cast<float>(iy) * voxel_size + oy;
  const float z = static_cast<float>(iz) * voxel_size + oz;

  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  float cnt = 0.f;
  const size_t view_stride = static_cast<size_t>(H) * W * kC;
  for (int v = 0; v < V; ++v) {
    if (!s_ok[v]) continue;
    const float* P = s_proj + 12 * v;
    const float cx = ((P[0] * x + P[1] * y) + P[2] * z) + P[3];
    const float cy = ((P[4] * x + P[5] * y) + P[6] * z) + P[7];
    const float cz = ((P[8] * x + P[9] * y) + P[10] * z) + P[11];
    const float inv_z = cz != 0.f ? 1.f / cz : 0.f;
    const int px = __float2int_rn(cx * inv_z);     // round half to even
    const int py = __float2int_rn(cy * inv_z);
    if (px >= 0 && py >= 0 && px < W && py < H && cz > 0.f) {
      add_row(feats + v * view_stride
                  + (static_cast<size_t>(py) * W + px) * kC, acc);
      cnt += 1.f;
    }
  }
  store_row(out + vox * kC, acc, cnt);
  count[vox] = cnt;
  valid[vox] = cnt > 0.f;
}

}  // namespace

extern "C" int cnrma_volume_accum(const void* feats, const void* proj,
                                  const void* view_valid, void* out,
                                  void* count, void* valid, int V, int H,
                                  int W, int C, int X, int Y, int Z,
                                  float voxel_size, float ox, float oy,
                                  float oz, int is_bf16, void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(X) * Y * Z;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const size_t shmem = static_cast<size_t>(V) * (12 * sizeof(float) + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    volume_accum_kernel<__nv_bfloat16><<<blocks, kThreads, shmem, s>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<const float*>(proj),
        static_cast<const uint8_t*>(view_valid),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(count),
        static_cast<uint8_t*>(valid), V, H, W, X, Y, Z, voxel_size, ox, oy,
        oz);
  } else {
    volume_accum_kernel<float><<<blocks, kThreads, shmem, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(proj),
        static_cast<const uint8_t*>(view_valid), static_cast<float*>(out),
        static_cast<float*>(count), static_cast<uint8_t*>(valid), V, H, W, X,
        Y, Z, voxel_size, ox, oy, oz);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cnrma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
