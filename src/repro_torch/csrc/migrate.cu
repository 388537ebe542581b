// Sort-free counting scatter: the migration manifest's destinations.
//
// Replaces the TPU kernel repro/kernels/migrate/kernel.py
// scatter_dest_pallas (body _scatter_kernel).  For owner ids (n,) and C
// buckets it returns counts (C,) and dest[i] = offsets[id_i] + the stable
// rank of item i among the earlier items with the same id — the inverse of
// a stable argsort by id.  Ids outside [0, C) (padding) are not counted
// and get the sentinel dest = n.
//
// What bounds it on the H100: bytes.  It reads the ids twice and writes
// dest once (12 bytes an item) with a handful of integer operations per
// item.  Design: three launches instead of the TPU's sequential two-phase
// grid, because blocks here run in parallel and in no order:
//   1. count_kernel: per-block bucket counts (shared-memory integer
//      atomics, exact in any order) into a (blocks, C) array;
//   2. scan_kernel: one block exclusive-scans that array in bucket-major
//      order, giving each (bucket, block) pair its first slot, and the
//      per-bucket totals;
//   3. rank_kernel: each block walks its tile in order, NT items at a
//      time; a warp finds its equal ids with __match_any_sync and ranks
//      each item by __popc of the lower lanes of its group, and per-warp
//      bucket counts in shared memory order the warps — so ties keep
//      their previous position, as a stable sort keeps them.
// All arithmetic is int32 and exact (no f32 slot bound as on the TPU).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads per block in kernels 1 and 3
constexpr int NWARP = NT / 32;
constexpr int TILE = 4096;         // items per block
constexpr int NS = 1024;           // threads of the scan block

__global__ void count_kernel(const int* __restrict__ ids,
                             int* __restrict__ blk_counts, int n, int C) {
  extern __shared__ int cnt[];
  for (int c = threadIdx.x; c < C; c += NT) cnt[c] = 0;
  __syncthreads();
  const int start = blockIdx.x * TILE;
  const int end = min(start + TILE, n);
  for (int i = start + threadIdx.x; i < end; i += NT) {
    const int id = ids[i];
    if (id >= 0 && id < C) atomicAdd(&cnt[id], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT)
    blk_counts[blockIdx.x * C + c] = cnt[c];
}

__global__ void __launch_bounds__(NS) scan_kernel(
    const int* __restrict__ blk_counts, int* __restrict__ base,
    int* __restrict__ counts, int nb, int C) {
  __shared__ int sh[NS];
  const int M = C * nb;                  // element f = c * nb + b
  const int per = (M + NS - 1) / NS;
  const int lo = min((int)threadIdx.x * per, M);
  const int hi = min(lo + per, M);
  int local = 0;
  for (int f = lo; f < hi; ++f) local += blk_counts[(f % nb) * C + f / nb];
  sh[threadIdx.x] = local;
  __syncthreads();
  for (int off = 1; off < NS; off <<= 1) {   // inclusive Hillis-Steele
    const int v = (int)threadIdx.x >= off ? sh[threadIdx.x - off] : 0;
    __syncthreads();
    sh[threadIdx.x] += v;
    __syncthreads();
  }
  int run = sh[threadIdx.x] - local;
  for (int f = lo; f < hi; ++f) {
    base[f] = run;
    run += blk_counts[(f % nb) * C + f / nb];
  }
  __syncthreads();                       // base visible to the block
  const int total = sh[NS - 1];
  for (int c = threadIdx.x; c < C; c += NS) {
    const int next = c + 1 < C ? base[(c + 1) * nb] : total;
    counts[c] = next - base[c * nb];
  }
}

__global__ void rank_kernel(const int* __restrict__ ids,
                            const int* __restrict__ base,
                            int* __restrict__ dest, int n, int C, int nb) {
  extern __shared__ int sm[];
  int* running = sm;                     // [C] next free slot per bucket
  int* wcnt = sm + C;                    // [NWARP][C] this chunk's counts
  for (int c = threadIdx.x; c < C; c += NT)
    running[c] = base[c * nb + blockIdx.x];
  for (int e = threadIdx.x; e < NWARP * C; e += NT) wcnt[e] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int start = blockIdx.x * TILE;
  const int end = min(start + TILE, n);
  for (int chunk = start; chunk < end; chunk += NT) {   // uniform bound
    const int i = chunk + threadIdx.x;
    const int id = i < end ? ids[i] : -1;
    const bool valid = id >= 0 && id < C;
    // invalid lanes get a key of their own, so they group with no one
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? id : -1 - lane);
    if (valid && __ffs(peers) - 1 == lane) wcnt[warp * C + id] = __popc(peers);
    __syncthreads();
    if (valid) {
      int r = running[id] + __popc(peers & lower);
      for (int w = 0; w < warp; ++w) r += wcnt[w * C + id];
      dest[i] = r;
    } else if (i < end) {
      dest[i] = n;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += NT) {
      int tot = 0;
      for (int w = 0; w < NWARP; ++w) {
        tot += wcnt[w * C + c];
        wcnt[w * C + c] = 0;
      }
      running[c] += tot;
    }
    __syncthreads();
  }
}

}  // namespace

// blk_counts and base are (ceil(n / 4096) * C,) int32 scratch.
extern "C" int scatter_dest_launch(void* ids, void* dest, void* counts,
                                   void* blk_counts, void* base, int n, int C,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (n + TILE - 1) / TILE;
  count_kernel<<<nb, NT, C * sizeof(int), s>>>((const int*)ids,
                                               (int*)blk_counts, n, C);
  scan_kernel<<<1, NS, 0, s>>>((const int*)blk_counts, (int*)base,
                               (int*)counts, nb, C);
  rank_kernel<<<nb, NT, (C + NWARP * C) * sizeof(int), s>>>(
      (const int*)ids, (const int*)base, (int*)dest, n, C, nb);
  return (int)cudaGetLastError();
}
