// Rect gather of the back-projection probe: for every tile k and voxel
// column v, the 32 channels of the pixel that code[k, v] names inside the
// tile's rect of the packed feature map.
//
// Replaces the TPU kernel tools/pallas_bp_probe.py:make_kernel, the
// prototype of cnrma_tpu/ops/pallas_bp.py:rect_gather.  Contract, as the
// probe's numpy oracle ref_gather states it:
//     featq [Hq, W, 4*C] bf16 (four image rows share the last axis)
//     p = code >> 2, ym = code & 3
//     out[k, :, v] = featq[ryq0[k] + p / Rw, rx0[k] + p % Rw, ym*C : ym*C+C]
//                    where 0 <= p < Rhq*Rw, else 0
// out [K1, C, t3] bf16, channel-major.  A pixel outside the feature map
// gives 0 as well (the probe never draws one; the check keeps the kernel in
// bounds).
//
// The TPU kernel keeps the map resident in VMEM and selects with a one-hot
// MXU product, because the TPU has no fast gather; its 16-column rect
// alignment and tiles-per-grid-step exist for Mosaic.  On the H100 the map
// (1.2 MB at the bench shape) sits in L2 and the select is a load: one
// thread per (k, v) column reads the 64 B channel row with four 16-byte
// loads and writes the 32 channels, so that neighbouring threads write
// neighbouring v of each channel row.  bf16 is copied to bf16: exact.
//
// Bound on the H100: the output write (201 MB at the bench shape, 6,144
// tiles x 32 channels x 512 voxels x 2 B) plus the 12.6 MB of codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;          // channels (the probe's and the model's)
constexpr int kPack = 4;        // image rows sharing the last axis
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rect_gather_kernel(const __nv_bfloat16* __restrict__ featq,  // [Hq, W, 4C]
                   const int32_t* __restrict__ ryq0,         // [K1]
                   const int32_t* __restrict__ rx0,          // [K1]
                   const int32_t* __restrict__ code,         // [K1, t3]
                   __nv_bfloat16* __restrict__ out,          // [K1, C, t3]
                   int Hq, int W, int Rhq, int Rw, int t3, int K1) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= static_cast<long long>(K1) * t3) return;
  const int k = static_cast<int>(i / t3);
  const int v = static_cast<int>(i % t3);
  const int c = code[i];
  const int p = c >> 2;
  const int ym = c & 3;
  uint4 row[kC / 8];
  bool ok = p >= 0 && p < Rhq * Rw;
  if (ok) {
    const int y = ryq0[k] + p / Rw;
    const int x = rx0[k] + p % Rw;
    ok = y >= 0 && y < Hq && x >= 0 && x < W;
    if (ok) {
      const uint4* src = reinterpret_cast<const uint4*>(
          featq + ((static_cast<size_t>(y) * W + x) * kPack + ym) * kC);
#pragma unroll
      for (int q = 0; q < kC / 8; ++q) row[q] = __ldg(src + q);
    }
  }
  if (!ok) {
#pragma unroll
    for (int q = 0; q < kC / 8; ++q) row[q] = make_uint4(0, 0, 0, 0);
  }
  const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(row);
  __nv_bfloat16* dst = out + static_cast<size_t>(k) * kC * t3 + v;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) dst[static_cast<size_t>(ch) * t3] = vals[ch];
}

}  // namespace

extern "C" int cnrma_rect_gather(const void* featq, const void* ryq0,
                                 const void* rx0, const void* code, void* out,
                                 int Hq, int W, int Rhq, int Rw, int C, int t3,
                                 int K1, void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(K1) * t3;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  rect_gather_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(featq),
      static_cast<const int32_t*>(ryq0), static_cast<const int32_t*>(rx0),
      static_cast<const int32_t*>(code), static_cast<__nv_bfloat16*>(out), Hq,
      W, Rhq, Rw, t3, K1);
  return static_cast<int>(cudaGetLastError());
}
