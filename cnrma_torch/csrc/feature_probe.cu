// Feature checks of the kernel toolchain: seven small kernels, each the
// Hopper form of one Mosaic feature that tools/pallas_feature_probe.py:main
// probed on the TPU (its kernels at :57, :67, :77, :95, :110, :126, :143),
// and an empty kernel that measures the cost of a launch.  Each computes
// what the probe's kernel computed, on the probe's inputs:
//
//   basic      out = x + 1                          (whole-block VPU add)
//   dot        C = A @ B, bf16 in, fp32 out: one warpgroup a 64x64 tile of
//              C, A and B brought into shared memory by TMA in 64-wide
//              K-chunks with 128-byte swizzle, multiplied by wgmma from
//              shared memory                        (MXU matmul)
//   dyn_slice  out = x[s : s + rows], s read from device memory by the
//              kernel and clamped to the table like lax.dynamic_slice
//                                                   (pl.ds, runtime start)
//   prefetch   block k reads tids[k] itself and writes 2 x[k] to out block
//              tids[k]                      (scalar-prefetch index map)
//   alias      acc += x in place                    (input_output_aliases)
//   onehot     out = float(tab[idx]), each thread loading 8 bf16 of a
//              table row (16 bytes) and storing them widened as two float4,
//              0 where idx is outside the table  (one-hot gather-by-matmul)
//   dma        rows [row0, row0 + rows) copied global -> shared, each
//              thread its own 16 bytes by cp.async, waited on by that
//              thread alone, then doubled    (make_async_copy HBM->VMEM)
//   empty      nothing: one block of 32 threads that touches no memory, the
//              least device time a launch takes (the launch floor)
//
// At the probes' shapes (a few KB to 192 KB) every kernel is bound by its
// launch latency; the point is that each feature builds through this
// library's route (-gencode arch=compute_90a,code=sm_90a, ctypes) and gives
// exact results: every check is a copy, a gather or a product of small
// integers, so results equal the plain torch versions bit for bit.
//
// onehot is a direct row gather: on Hopper a gather by index is a load, and
// the MXU one-hot was the TPU's way around having none.  The form it
// replaced staged the whole table in each block's dynamic shared memory
// (64 KB at the probe's shape, 8 blocks: 512 KB of loads for the 32 KB that
// 128 indices reach) behind a block barrier and raised the shared-memory
// attribute on every launch: 0.00501 ms device, 5.7x an empty launch, on an
// H100 SXM (700 W).  The direct gather's cost is two dependent L2 round
// trips (the index, then the row) and 64 KB of stores: 1.53-1.54x the
// empty launch in blocks of 16 x 4 threads.  In other calls 1-D blocks of
// 32 or 64 threads, one a piece (which divide to find their row), measured
// 1.55-1.57x, and 1-D blocks of 256 1.74-1.81x (loads and stores through 8
// SMs, not 32-64); dyn_slice, the other kernel with two dependent loads,
// 1.39-1.46x.  The 16 x 4 blocks were kept on that comparison across calls
// alone, a difference of 1-3%.
// dot (64 KB + 1 KB) is now the library's one kernel that opts into more
// than 48 KB of shared memory.
//
// dot is the library's wgmma + TMA kernel.  At the probe's 128x256x128 its byte
// bound (160 KB, 0.05 us) and operation bound (8.4 MFLOP, 0.008 us) are far
// below one launch (an empty kernel takes about 0.9 us of device time on an
// H100 SXM); what it costs beyond that is the latency of the first operand
// bytes reaching shared memory and of the dependent chain of 16 wgmma.  So each
// block (4 at 128x128) has thread 0 prefetch the tensor maps and issue every
// K-chunk's loads before the block's first barrier, each chunk completing on
// its own mbarrier, and the first wgmma starts when the first chunk lands while
// the later ones are still in flight.  For K above 256 the chunks go through a
// ring of 4 stages.  Measured on an H100 SXM (700 W) at the probe's shape:
// issuing the loads before the first barrier gained 1%; a 64x128 tile (2
// blocks, m64n128k16) was 18% slower than 64x64, and the wmma kernel this one
// replaced (one warp a 16x16 tile, fragments loaded from global memory) 73%
// slower.  The tensor maps are encoded in the launcher and passed as
// __grid_constant__ parameters; TMA zero-fills the part of a box outside the
// matrices, so M, N and K need only be multiples of 16.  B is [K, N] row-major,
// which is N-major for wgmma: its descriptor takes the 128-byte swizzled
// MN-major layout and the instruction's transpose flag.

#include <cuda.h>           // CUtensorMap and the tensor-map encoder's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// onehot: small blocks, so that its loads and stores spread over SMs
constexpr int kOnehotThreads = 64;

// dot: a block is one warpgroup and owns a 64 x 64 tile of C
constexpr int kDotThreads = 128;
constexpr int kDotBM = 64;          // wgmma m64
constexpr int kDotBN = 64;          // wgmma n64
constexpr int kDotBK = 64;          // a K-chunk: one 128-byte swizzle row
constexpr int kDotStages = 4;       // chunks in shared memory: K = 256 whole
constexpr uint32_t kDotChunk = 64 * 64 * 2;   // one 64 x 64 bf16 TMA box
constexpr uint32_t kDotStage = 2 * kDotChunk; // A's chunk, then B's
// + 1 KB so that the tiles can start on a 1024-byte boundary, where the
// 128-byte swizzle pattern (8 rows of 128 bytes) starts
constexpr int kDotSmem = kDotStages * kDotStage + 1024;

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__global__ void basic_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed; a
// copy that never lands (some 2**24 polls, seconds) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// box {c0 (inner), c1} of a 2-D tensor map into shared memory at dst; the
// bytes complete on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile at `addr`:
// start, leading and stride byte offsets in 16-byte units, layout 1 (B128)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | 1ull << 62;
}

#define CNRMA_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64 fp32, the warpgroup's fragments] += A[64 x 16] B[16 x 64]:
// A K-major, B MN-major (transpose flag 1), both bf16 in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : CNRMA_ACC8(0), CNRMA_ACC8(8), CNRMA_ACC8(16), CNRMA_ACC8(24)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef CNRMA_ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator register
// across the asynchronous wgmma that writes it
__device__ __forceinline__ void fence_register(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const __grid_constant__ CUtensorMap map_a,   // A [M, K] bf16
           const __grid_constant__ CUtensorMap map_b,   // B [K, N] bf16
           float* __restrict__ c,                       // C [M, N]
           int M, int N, int K) {
  extern __shared__ unsigned char dot_smem[];
  __shared__ __align__(8) uint64_t full[kDotStages];
  const uint32_t base = (smem_addr(dot_smem) + 1023) & ~1023u;
  const int m0 = blockIdx.y * kDotBM, n0 = blockIdx.x * kDotBN;
  const int n_chunks = (K + kDotBK - 1) / kDotBK;
  const int tid = threadIdx.x;
  // chunk k: A[m0 : m0 + 64, 64k : 64k + 64] and B[64k : 64k + 64,
  // n0 : n0 + 64] into stage k % kDotStages, on that stage's barrier
  const CUtensorMap* pa = &map_a;
  const CUtensorMap* pb = &map_b;
  auto load = [=](int k) {
    const int s = k % kDotStages;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t tile_a = base + s * kDotStage;
    mbar_expect_tx(bar, kDotStage);
    tma_load_2d(tile_a, pa, k * kDotBK, m0, bar);
    tma_load_2d(tile_a + kDotChunk, pb, n0, k * kDotBK, bar);
  };
  // thread 0 fetches the tensor maps, sets up the barriers and issues the
  // first kDotStages chunks before the block's first barrier, so that the
  // copies are in flight while the other threads arrive
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(pa)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(pb)) : "memory");
    for (int s = 0; s < kDotStages; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(n_chunks, kDotStages); ++k) load(k);
  }
  __syncthreads();

  float d[kDotBN / 2];
#pragma unroll
  for (int i = 0; i < kDotBN / 2; ++i) d[i] = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % kDotStages;
    mbar_wait(smem_addr(&full[s]), (k / kDotStages) & 1);
    const uint32_t tile_a = base + s * kDotStage;
    const uint32_t tile_b = tile_a + kDotChunk;
    const int steps = min(kDotBK, K - k * kDotBK) / 16;
#pragma unroll
    for (int i = 0; i < kDotBN / 2; ++i) fence_register(d[i]);
    wgmma_fence();
    for (int j = 0; j < steps; ++j) {
      // A: rows of 128 bytes, 8-row groups 1024 bytes apart; a k16 step is
      // 32 bytes along the row.  B: rows of 128 bytes (64 columns), one per
      // K, 8-K groups 1024 bytes apart; a k16 step is 16 rows.  B's leading
      // offset (to the next 64 columns) is never reached at n64; it is set
      // to the stride offset.
      wgmma_m64n64k16(d, wgmma_desc(tile_a + 32 * j, 16, 1024),
                      wgmma_desc(tile_b + 2048 * j, 1024, 1024));
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < kDotBN / 2; ++i) fence_register(d[i]);
    if (k + kDotStages < n_chunks) {   // ring: refill this stage
      wgmma_wait_all();
      __syncthreads();
      if (tid == 0) load(k + kDotStages);
    }
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < kDotBN / 2; ++i) fence_register(d[i]);

  // fragment i of thread (warp w, lane l): row 16 w + l / 4 + 8 ((i / 2) % 2),
  // columns 8 (i / 4) + 2 (l % 4) + {0, 1} for i even
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < kDotBN / 2; i += 2) {
    const int row = m0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
    if (row < M && col < N)
      *reinterpret_cast<float2*>(c + static_cast<size_t>(row) * N + col) =
          make_float2(d[i], d[i + 1]);
  }
}

__global__ void empty_kernel() {}

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

// one thread per piece of an output row: 8 elements where D is a multiple
// of 8 and the table and output are 16-byte aligned (a 16-byte load of 8
// bf16, two float4 stores), else one element.  A block is (pieces, rows):
// threadIdx.y picks the row, whose index each thread reads once (the lanes
// of a row read one address, which the load broadcasts), and no thread
// divides to find its row.
__global__ void __launch_bounds__(kOnehotThreads)
onehot_kernel(const int32_t* __restrict__ idx,        // [M]
              const __nv_bfloat16* __restrict__ tab,  // [R, D]
              float* __restrict__ out,                // [M, D]
              int M, int R, int D, int vec8) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= M) return;
  const int t = __ldg(idx + r);
  const bool ok = static_cast<unsigned>(t) < static_cast<unsigned>(R);
  const __nv_bfloat16* row = tab + static_cast<size_t>(ok ? t : 0) * D;
  float* dst = out + static_cast<size_t>(r) * D;
  const int pieces = vec8 ? D / 8 : D;
  for (int q = blockIdx.y * blockDim.x + threadIdx.x; q < pieces;
       q += gridDim.y * blockDim.x) {
    if (!vec8) {
      dst[q] = ok ? __bfloat162float(row[q]) : 0.f;
      continue;
    }
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (ok) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + q);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 f0 = __bfloat1622float2(h[0]);
      const float2 f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]);
      const float2 f3 = __bfloat1622float2(h[3]);
      lo = make_float4(f0.x, f0.y, f1.x, f1.y);
      hi = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
    reinterpret_cast<float4*>(dst)[2 * q] = lo;
    reinterpret_cast<float4*>(dst)[2 * q + 1] = hi;
  }
}

constexpr int kDmaThreads = 64;

// dma: each thread copies its own 16-byte piece global -> shared with
// cp.async (LDGSTS), waits for its own copy alone (it reads back no other
// thread's bytes, so no barrier and no mbarrier), doubles it and stores it
// as one float4.  A block copies kDmaThreads pieces into its own shared
// memory, so any size of a multiple of 16 bytes goes.  At the probe's 4 KB
// the time is the launch and one dependent chain (global load, shared
// store and load, global store).  Blocks of 64 threads, one piece each,
// were the fastest form timed, 1-3% ahead of blocks of 32, 128 or 256 and
// of 2 to 8 pieces a thread; one bulk copy a warp on its own mbarrier
// took as long as the one bulk copy a block it would replace (PERF.md,
// section 6).
__global__ void __launch_bounds__(kDmaThreads)
dma_kernel(const float4* __restrict__ x,    // the rows' first piece
           float4* __restrict__ out, int n4) {
  __shared__ __align__(16) float4 buf[kDmaThreads];
  const int i = blockIdx.x * kDmaThreads + threadIdx.x;
  if (i >= n4) return;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(buf + threadIdx.x)), "l"(x + i)
               : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const float4 v = buf[threadIdx.x];
  out[i] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
}

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime: it is
// reached through the runtime's entry-point query, so that the library
// links against the runtime alone
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a row-major bf16 [rows, cols] matrix read in 64 x 64 boxes with 128-byte
// swizzle; out-of-range elements of a box read as zero
cudaError_t bf16_tile_map(CUtensorMap* map, const void* ptr, int rows,
                          int cols) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  if (M % 16 || N % 16 || K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(
        c, 0, static_cast<size_t>(M) * N * sizeof(float), s));
  CUtensorMap map_a, map_b;
  cudaError_t err = bf16_tile_map(&map_a, a, M, K);
  if (err == cudaSuccess) err = bf16_tile_map(&map_b, b, K, N);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDotSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_kernel<<<dim3((N + kDotBN - 1) / kDotBN, (M + kDotBM - 1) / kDotBM),
               kDotThreads, kDotSmem, s>>>(map_a, map_b,
                                           static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
  if (static_cast<long long>(M) * D == 0) return static_cast<int>(cudaSuccess);
  const int vec8 = D % 8 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int pieces = vec8 ? D / 8 : D;
  const int bx = pieces < 32 ? pieces : 32;
  const dim3 block(bx, kOnehotThreads / bx);     // 16 x 4 at D = 128
  const int by_pieces = (pieces + bx - 1) / bx;
  const dim3 grid((M + block.y - 1) / block.y,
                  by_pieces < 65535 ? by_pieces : 65535);
  onehot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const __nv_bfloat16*>(tab), static_cast<float*>(out), M, R,
      D, vec8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_probe_dma(const void* x, void* out, int R, int row0,
                               int rows, int D, void* stream) {
  const long long n = static_cast<long long>(rows) * D;
  if (row0 < 0 || rows < 0 || row0 + rows > R || n % 4 || n / 4 >= (1ll << 31)
      || (reinterpret_cast<uintptr_t>(x) + 4ull * row0 * D) % 16
      || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = static_cast<int>(n / 4);
  if (n4 == 0) return static_cast<int>(cudaSuccess);
  dma_kernel<<<(n4 + kDmaThreads - 1) / kDmaThreads, kDmaThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(static_cast<const float*>(x)
                                      + static_cast<size_t>(row0) * D),
      static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}
