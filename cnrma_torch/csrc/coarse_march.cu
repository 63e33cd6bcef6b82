// Coarse empty-space march of the NeuS ray marcher: for every ray, the first
// coarse sample that lands in an occupied cell of the coarse occupancy grid.
//
// Replaces the TPU kernel cnrma_tpu/ops/pallas_ray.py:onehot_lookup and the
// computation its lookups feed (cnrma_tpu/ops/ray_marching.py:346-359):
// the TPU version builds all HW x n_coarse sample positions, looks each
// occupancy value up with a one-hot MXU contraction, and reduces the hits
// with any/argmax.  Here one thread walks one ray and stops at its first
// hit, so no position, code or hit matrix is ever written to memory.
//
// Per ray r and coarse step j = 0 .. n_coarse-1, in the reference's
// operation order:
//     tc   = (j * coarse_step + coarse_step * 0.5) * t_one
//     p    = o + d[r] * tc
//     id   = rint((p - origin) / cell_size)        (IEEE division, half even)
//     hit  = id inside the grid && occupancy[id] > 0.5
// Output: j0[r] = first j with a hit (0 when there is none, like argmax of
// an all-false row) and has_hit[r].  Built with --fmad=false: a contracted
// o + d * tc flips ids that sit on a .5 boundary.
//
// Bound on the H100: neither bytes nor flops.  The occupancy grid is held in
// shared memory as one byte per cell (12,288 B at the full ScanNet shape,
// 23,552 B at the TPU kernel's MAX_ROWS bound), every lookup is a shared
// memory read, and the only device-memory traffic is 12 B of direction per
// ray in and 5 B out.  The march is latency bound by its dependent
// divide-round-lookup chain per step (at most 38 steps); 19,200 rays per
// view give 75 blocks, fewer than the 132 SMs, which is what a later PR
// should address by marching several views in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coarse_march_kernel(const float* __restrict__ o,        // [3]
                    const float* __restrict__ d,        // [n_rays, 3]
                    const float* __restrict__ origin,   // [3]
                    const float* __restrict__ occ,      // [Xc, Yc, Zc]
                    int32_t* __restrict__ j0,           // [n_rays]
                    uint8_t* __restrict__ has_hit,      // [n_rays]
                    int n_rays, int n_coarse, int coarse_step, int Xc,
                    int Yc, int Zc, float t_one, float cell_size) {
  extern __shared__ uint8_t s_occ[];
  __shared__ float s_o[3], s_org[3];
  const int n_cells = Xc * Yc * Zc;
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x)
    s_occ[i] = occ[i] > 0.5f;
  if (threadIdx.x < 3) {
    s_o[threadIdx.x] = o[threadIdx.x];
    s_org[threadIdx.x] = origin[threadIdx.x];
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float step = static_cast<float>(coarse_step);
  int first = 0;
  uint8_t hit = 0;
  for (int j = 0; j < n_coarse; ++j) {
    const float tc = (static_cast<float>(j) * step + step * 0.5f) * t_one;
    const int ix = __float2int_rn((s_o[0] + dx * tc - s_org[0]) / cell_size);
    const int iy = __float2int_rn((s_o[1] + dy * tc - s_org[1]) / cell_size);
    const int iz = __float2int_rn((s_o[2] + dz * tc - s_org[2]) / cell_size);
    if (ix >= 0 && ix < Xc && iy >= 0 && iy < Yc && iz >= 0 && iz < Zc
        && s_occ[(ix * Yc + iy) * Zc + iz]) {
      first = j;
      hit = 1;
      break;
    }
  }
  j0[r] = first;
  has_hit[r] = hit;
}

}  // namespace

extern "C" int cnrma_coarse_march(const void* o, const void* d,
                                  const void* origin, const void* occ,
                                  void* j0, void* has_hit, int n_rays,
                                  int n_coarse, int coarse_step, int Xc,
                                  int Yc, int Zc, float t_one,
                                  float cell_size, void* stream) {
  const size_t shmem = static_cast<size_t>(Xc) * Yc * Zc;
  const unsigned blocks = static_cast<unsigned>((n_rays + kThreads - 1)
                                                / kThreads);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  coarse_march_kernel<<<blocks, kThreads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(origin), static_cast<const float*>(occ),
      static_cast<int32_t*>(j0), static_cast<uint8_t*>(has_hit), n_rays,
      n_coarse, coarse_step, Xc, Yc, Zc, t_one, cell_size);
  return static_cast<int>(cudaGetLastError());
}
