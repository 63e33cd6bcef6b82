// Table gathers of the ray-march gather probe, at the shape of the fine
// TSDF window lookup: a 192x192x80 fp32 table (11.8 MB) and 5.76M queries
// (19,200 rays x 300 samples).
//
// Replaces the TPU kernels of tools/pallas_gather_probe.py:
//   lane_gather  <- pl_lane_true:  out[i, j] = T[idx[i, j], j]   (T [R, L])
//   flat_gather  <- pl_lane_bcast: out[q] = T.ravel()[idx[q]]
// An index outside the table gives 0 (the probe draws none).  The TPU
// kernels exist to test Mosaic's in-VMEM dynamic_gather; pl_lane_bcast also
// replicates each result over 128 lanes, which was the TPU's layout and is
// dropped: flat_gather returns the [NQ] vector the probe keeps.
//
// Both take one thread per output element, neighbouring threads on
// neighbouring outputs, so index reads and result writes are coalesced.
// The table is too large for shared memory (227 KB a block) and is read
// through L2 (50 MB), where it stays resident across launches, as it would
// for the ray march.  lane_gather's reads are coalesced too when a warp's
// rows agree.
//
// lane_gather was measured against a column-stripe form, since column j of
// the output reads only column j of the table: a thread block cluster of C
// blocks held a stripe of w columns in its shared memory, rows split by
// rank, staged with cp.async, and each thread read its element through mapa
// + ld.shared::cluster after a cluster barrier.  On an H100 SXM (700 W), at
// the probe's [23040, 128] table warm in L2, every form (w/C from 2/1 to
// 32/16, one or two clusters a stripe) took 0.041-0.086 ms against this
// kernel's 0.026: random 4-byte reads from other blocks' shared memory ran
// at 0.74-0.92 billion a second per SM, no faster than this kernel's random
// L2 sectors (0.86), and at 180 KB a block only 15 clusters of 8 fit at
// once.  The stripe form was deleted; PERF.md has its table.
//
// Bound on the H100: bytes.  lane_gather moves idx and out (11.8 MB each)
// and the table elements the indices reach; flat_gather the 23 MB of
// indices, the 23 MB of results and the 10.1 MB of table elements reached
// (0.0168 ms at 3.35 TB/s).  flat_gather's table reads are random 4-byte
// reads: each pulls a whole 32-byte L2 sector to its SM, 184 MB for the
// 5.76M queries, and a warp's 32 reads touch 32 different lines.  That, not
// the bytes, sets its time.  Measured on an H100 SXM (700 W): the two
// streams alone take 0.019 ms, the same gather from a 64 KB table that
// stays in L1 0.022 ms, the gather from the 11.8 MB table 0.049-0.050 ms.
// So the design moves only what it can: the indices are read and the
// results written with streaming hints, and the table loads carry an L2
// evict_last policy so that the streams do not push the table out of L2.
// Together the hints gain 0.3% with the table warm; after a 128 MB copy
// between calls every form is 5% slower, with or without evict_last.  Four
// or eight queries a thread with 16-byte index loads and result stores,
// over a grid sized to the resident blocks, measured 3% and 19% slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const float* __restrict__ table,   // [R, L]
                   const int32_t* __restrict__ idx,   // [n_rows, L]
                   float* __restrict__ out,           // [n_rows, L]
                   int R, int L, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const int j = static_cast<int>(i % L);
  const int t = idx[i];
  out[i] = (t >= 0 && t < R) ? __ldg(table + static_cast<size_t>(t) * L + j)
                             : 0.f;
}

// L2 policy for the table's lines: evicted after the index and result
// streams' lines, which are read or written once
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ float load_kept(const float* p, uint64_t policy) {
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
               : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(const float* __restrict__ table,   // [n_table]
                   const int32_t* __restrict__ idx,   // [n]
                   float* __restrict__ out,           // [n]
                   int n_table, long long n) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (q >= n) return;
  const int t = __ldcs(idx + q);
  // an index outside the table loads element 0 and gives 0, so the load
  // goes out unpredicated
  const bool ok = static_cast<unsigned>(t) < static_cast<unsigned>(n_table);
  const float v = load_kept(table + (ok ? t : 0), evict_last_policy());
  __stcs(out + q, ok ? v : 0.f);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int cnrma_lane_gather(const void* table, const void* idx,
                                 void* out, int R, int L, int n_rows,
                                 void* stream) {
  const long long n = static_cast<long long>(n_rows) * L;
  if (n == 0) return static_cast<int>(cudaSuccess);
  lane_gather_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), R, L, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnrma_flat_gather(const void* table, const void* idx,
                                 void* out, int n_table, int n_queries,
                                 void* stream) {
  const long long n = n_queries;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_table == 0)                // every query is outside the table
    return static_cast<int>(cudaMemsetAsync(out, 0, n * sizeof(float), s));
  flat_gather_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_table, n);
  return static_cast<int>(cudaGetLastError());
}
