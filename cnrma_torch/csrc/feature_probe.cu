// Feature checks of the kernel toolchain: seven small kernels, each the
// Hopper form of one Mosaic feature that tools/pallas_feature_probe.py:main
// probed on the TPU (its kernels at :57, :67, :77, :95, :110, :126, :143).
// Each computes what the probe's kernel computed, on the probe's inputs:
//
//   basic      out = x + 1                          (whole-block VPU add)
//   dot        C = A @ B, bf16 in, fp32 out, on the tensor cores through
//              nvcuda::wmma (mma.sync m16n8k16 bf16/f32 on sm_90a): one
//              warp per 16x16 tile of C            (MXU matmul)
//   dyn_slice  out = x[s : s + rows], s read from device memory by the
//              kernel and clamped to the table like lax.dynamic_slice
//                                                   (pl.ds, runtime start)
//   prefetch   block k reads tids[k] itself and writes 2 x[k] to out block
//              tids[k]                      (scalar-prefetch index map)
//   alias      acc += x in place                    (input_output_aliases)
//   onehot     out = float(tab[idx]) from a bf16 table staged in dynamic
//              shared memory above 48 KB (64 KB at the probe's shape), 0
//              where idx is outside the table  (one-hot gather-by-matmul)
//   dma        rows [row0, row0 + rows) copied global -> shared by one
//              bulk asynchronous copy completed on an mbarrier, then
//              doubled                           (make_async_copy HBM->VMEM)
//
// At the probes' shapes (a few KB to 192 KB) every kernel is bound by its
// launch latency; the point is that each feature builds through this
// library's route (-gencode arch=compute_90a,code=sm_90a, ctypes) and gives
// exact results: every check is a copy, a gather or a product of small
// integers, so results equal the plain torch versions bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;           // wmma tile edge (m16n16k16)
constexpr int kOnehotRows = 16;     // output rows per onehot block

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__global__ void basic_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

__global__ void dot_kernel(const __nv_bfloat16* __restrict__ a,  // [M, K]
                           const __nv_bfloat16* __restrict__ b,  // [K, N]
                           float* __restrict__ c,                // [M, N]
                           int N, int K) {
  using namespace nvcuda;
  const int tm = blockIdx.y, tn = blockIdx.x;
  wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16,
                 wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16,
                 wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int k = 0; k < K; k += kTile) {
    wmma::load_matrix_sync(fa, a + static_cast<size_t>(tm) * kTile * K + k,
                           K);
    wmma::load_matrix_sync(fb, b + static_cast<size_t>(k) * N + tn * kTile,
                           N);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(c + static_cast<size_t>(tm) * kTile * N
                              + tn * kTile, acc, N, wmma::mem_row_major);
}

__global__ void dyn_slice_kernel(const int32_t* __restrict__ start,
                                 const float* __restrict__ x,
                                 float* __restrict__ out, int R, int rows,
                                 int D) {
  const int s = min(max(*start, 0), R - rows);
  const float* src = x + static_cast<size_t>(s) * D;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows * D;
       i += gridDim.x * blockDim.x)
    out[i] = src[i];
}

__global__ void prefetch_kernel(const int32_t* __restrict__ tids,
                                const float* __restrict__ x,
                                float* __restrict__ out, int block_elems,
                                int n_out_blocks) {
  const int k = blockIdx.x;
  const int t = tids[k];
  if (t < 0 || t >= n_out_blocks) return;
  const float* src = x + static_cast<size_t>(k) * block_elems;
  float* dst = out + static_cast<size_t>(t) * block_elems;
  for (int i = threadIdx.x; i < block_elems; i += blockDim.x)
    dst[i] = src[i] * 2.0f;
}

__global__ void alias_kernel(float* __restrict__ acc,
                             const float* __restrict__ x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) acc[i] += x[i];
}

__global__ void onehot_kernel(const int32_t* __restrict__ idx,        // [M]
                              const __nv_bfloat16* __restrict__ tab,  // [R, D]
                              float* __restrict__ out,                // [M, D]
                              int M, int R, int D) {
  extern __shared__ __align__(16) unsigned char onehot_smem[];
  __nv_bfloat16* s_tab = reinterpret_cast<__nv_bfloat16*>(onehot_smem);
  const int n16 = R * D / 8;                     // 16-byte chunks
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    reinterpret_cast<uint4*>(s_tab)[i] = reinterpret_cast<const uint4*>(tab)[i];
  __syncthreads();
  const int row0 = blockIdx.x * kOnehotRows;
  for (int e = threadIdx.x; e < kOnehotRows * D; e += blockDim.x) {
    const int r = row0 + e / D;
    if (r >= M) break;
    const int j = e % D;
    const int t = idx[r];
    out[static_cast<size_t>(r) * D + j] =
        (t >= 0 && t < R) ? __bfloat162float(s_tab[t * D + j]) : 0.f;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void dma_kernel(const float* __restrict__ x,   // [R, D]
                           float* __restrict__ out,       // [rows, D]
                           int row0, int rows, int D) {
  extern __shared__ __align__(128) unsigned char dma_smem[];
  __shared__ __align__(8) uint64_t bar;
  const float* buf = reinterpret_cast<const float*>(dma_smem);
  const uint32_t bytes = static_cast<uint32_t>(rows) * D * sizeof(float);
  const uint32_t bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar_addr), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dma_smem)),
           "l"(x + static_cast<size_t>(row0) * D), "r"(bytes),
           "r"(bar_addr)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {                 // phase 0 completes when the bytes land
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar_addr), "r"(0) : "memory");
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    out[i] = buf[i] * 2.0f;
}

}  // namespace

extern "C" int cnrma_probe_basic(const void* x, void* out, int n,
                                 void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  basic_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_dot(const void* a, const void* b, void* c, int M,
                               int N, int K, void* stream) {
  if (M % kTile || N % kTile || K % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  dot_kernel<<<dim3(N / kTile, M / kTile), 32, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_dyn_slice(const void* start, const void* x,
                                     void* out, int R, int rows, int D,
                                     void* stream) {
  if (rows > R) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * D == 0) return static_cast<int>(cudaSuccess);
  dyn_slice_kernel<<<blocks_for(static_cast<long long>(rows) * D), kThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start), static_cast<const float*>(x),
      static_cast<float*>(out), R, rows, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_prefetch(const void* tids, const void* x,
                                    void* out, int n_blocks, int block_elems,
                                    int n_out_blocks, void* stream) {
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  prefetch_kernel<<<n_blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tids), static_cast<const float*>(x),
      static_cast<float*>(out), block_elems, n_out_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_alias(void* acc, const void* x, int n,
                                 void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  alias_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(acc), static_cast<const float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_onehot(const void* idx, const void* tab, void* out,
                                  int M, int R, int D, void* stream) {
  if ((R * D) % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const int shmem = R * D * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  onehot_kernel<<<(M + kOnehotRows - 1) / kOnehotRows, kThreads, shmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const __nv_bfloat16*>(tab), static_cast<float*>(out), M, R,
      D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_dma(const void* x, void* out, int R, int row0,
                               int rows, int D, void* stream) {
  const long long bytes = static_cast<long long>(rows) * D * sizeof(float);
  // within the 48 KB a launch may take without opting in, beside the
  // kernel's static mbarrier
  if (row0 < 0 || row0 + rows > R || bytes % 16 || bytes > 47 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == 0) return static_cast<int>(cudaSuccess);
  dma_kernel<<<1, kThreads, static_cast<size_t>(bytes),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), row0, rows, D);
  return static_cast<int>(cudaGetLastError());
}
