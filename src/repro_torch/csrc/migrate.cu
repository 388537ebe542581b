// Sort-free counting scatter: the migration manifest's destinations.
//
// Replaces the TPU kernel repro/kernels/migrate/kernel.py
// scatter_dest_pallas (body _scatter_kernel).  For owner ids (n,) and C
// buckets it returns counts (C,), offsets (C+1,) (their exclusive scan)
// and dest[i] = offsets[id_i] + the stable rank of item i among the
// earlier items with the same id — the inverse of a stable argsort by id.
// Ids outside [0, C) (padding) are not counted and get the sentinel n.
// All arithmetic is int32 and exact.
//
// What bounds it on the H100: bytes.  The least work reads the ids once
// and writes dest once (8 bytes an item: 0.0401 ms at n = 2^24); any
// design in which an item's slot depends on the global totals reads the
// ids twice (12 bytes an item: 0.0601 ms).  What held the first port
// back (0.18 ms of device time at n = 2^24, C = 8 on one NVIDIA H100
// 80GB HBM3 at 700 W): three launches and a scratch round trip,
// shared-memory atomics on one address when the ids are bucketed (after
// an exchange), a one-block strided scan, and three barriers every 256
// items.
//
// Design: two launches over the same segmentation of the input (each
// block a stretch of whole 4096-item tiles, the blocks in input order).
//   1. count_kernel: the block's per-bucket counts into a bucket-major
//      (C, blocks) table, so a bucket's blocks are contiguous; the last
//      block to finish (a ticket it resets itself) scans the table with
//      all its threads and coalesced 16-byte loads, in place, into each
//      (bucket, block)'s first slot, and writes counts and offsets.
//   2. rank_kernel: each block walks its tiles in order from those slots.
// Two forms, picked by the wrapper (kernels/migrate/ops.py scatter_plan):
//   * small (C <= ops.SMALL_MAX_C): each thread owns 16 consecutive items
//     (four int4 loads) and a column of a bucket-major shared table
//     (h[c * 256 + thread], its own bank).  It counts and ranks its items
//     in order through a run of equal ids kept in registers, touching its
//     column once a run, so neither order contends and a bucketed input
//     costs almost nothing.  One exclusive scan of the columns a bucket
//     (a warp a bucket, carrying the block's running slot) gives every
//     thread its first slot in the tile: one barrier pair a tile.
//   * shared (C <= ops.SHARED_MAX_C): a warp owns 512 consecutive items of
//     a tile, read 32 at a time (coalesced); lanes holding equal ids find
//     each other with __match_any_sync and rank by __popc of the lower
//     lanes of their group, and one of them adds the group's size to the
//     warp's table (pass 1: one table a block).  One scan of the warps'
//     tables a bucket a tile orders the warps: one barrier pair a tile.
// Every load and store of a warp covers contiguous bytes (512 in the
// count pass and the small form, whose blocked items go through a padded
// per-warp transpose; 128 in the shared form's rank pass), and the count
// pass walks a block's tiles last to first, so the rank pass finds its
// first tiles in L2.  Above SHARED_MAX_C the wrapper
// composes stable scatters of radix digits (ops.scatter_by_digits) and
// counts through scatter_count_launch.
// Measured on the same card (n = 2^24, C = 8, the small form): 0.0705
// ms of device time bucketed, 0.0787-0.0803 in the initial order (PERF.md,
// section 6).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;              // threads a block
constexpr int NW = NT / 32;          // warps a block
constexpr int VEC = 4;               // int4 vectors a thread a tile (small)
constexpr int IPT = 4 * VEC;         // 16 consecutive items a thread (small)
constexpr int TILE = NT * IPT;       // 4096 items a tile (both forms)
constexpr int ROUNDS = TILE / NT;    // 16 rounds of 32 items a warp (shared)
constexpr int SPT = 32;              // table entries a thread a scan round
constexpr unsigned FULL = 0xffffffffu;

// blocks of count_kernel that have finished; the last one resets it
__device__ unsigned int g_ticket;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ bool valid_id(int id, int C) {
  return (unsigned)id < (unsigned)C;
}

// ids of items [i, i + 4) (i a multiple of 4); items at or past n read -1
__device__ __forceinline__ int4 load4(const int* __restrict__ ids, int i,
                                      int n) {
  if (i + 4 <= n) return __ldg(reinterpret_cast<const int4*>(ids + i));
  int4 r = make_int4(-1, -1, -1, -1);
  if (i < n) r.x = ids[i];
  if (i + 1 < n) r.y = ids[i + 1];
  if (i + 2 < n) r.z = ids[i + 2];
  return r;
}

__device__ __forceinline__ void store4(int* __restrict__ dest, int i, int n,
                                       int4 v) {
  if (i + 4 <= n) {
    __stcs(reinterpret_cast<int4*>(dest + i), v);
    return;
  }
  if (i < n) dest[i] = v.x;
  if (i + 1 < n) dest[i + 1] = v.y;
  if (i + 2 < n) dest[i + 2] = v.z;
}

// the tile's 16-byte vectors k * NT + thread, k < VEC: each load of a
// warp reads 512 contiguous bytes
__device__ __forceinline__ void load_striped(const int* __restrict__ ids,
                                             int tile, int n,
                                             int4 (&q)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    q[k] = load4(ids, tile + 4 * (k * NT + (int)threadIdx.x), n);
}

__device__ __forceinline__ void unpack(const int4 (&q)[VEC], int (&id)[IPT]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    id[4 * k] = q[k].x;
    id[4 * k + 1] = q[k].y;
    id[4 * k + 2] = q[k].z;
    id[4 * k + 3] = q[k].w;
  }
}

// A warp's 128 vectors of a tile between the striped order of the loads
// and stores (vector k * 32 + lane) and the blocked order of the ranking
// (lane * 4 + k): one int4 of padding every 8 keeps both conflict-free.
constexpr int STAGE = 128 + 16;          // int4 a warp
__device__ __forceinline__ int staged(int v) { return v + (v >> 3); }

// this block's items [*begin, *end): tiles_per_block whole tiles
__device__ __forceinline__ void stretch(int n, int tpb, int* begin,
                                        int* end) {
  const long long b = (long long)blockIdx.x * tpb * TILE;
  *begin = (int)min(b, (long long)n);
  *end = (int)min(b + (long long)tpb * TILE, (long long)n);
}

// The last block: the bucket-major table (M = C * nb entries, nb a
// multiple of 4, written by the other blocks of this launch: read through
// L2) scanned in place into exclusive prefixes, each thread SPT
// consecutive entries a round in 16-byte loads; then counts and offsets.
__device__ void scan_table(int* __restrict__ table, int* __restrict__ counts,
                           int* __restrict__ offsets, int C, int nb) {
  __shared__ int wsum[NW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int M = C * nb;
  int carry = 0;
  for (int r0 = 0; r0 < M; r0 += NT * SPT) {
    const int e0 = r0 + t * SPT;
    int v[SPT];
#pragma unroll
    for (int k = 0; k < SPT / 4; ++k) {
      const int e = e0 + 4 * k;
      const int4 q = e < M ? __ldcg(reinterpret_cast<const int4*>(table + e))
                           : make_int4(0, 0, 0, 0);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    int s = 0;
#pragma unroll
    for (int j = 0; j < SPT; ++j) s += v[j];
    const int incl = warp_incl_scan(s, lane);
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int x = wsum[w];
      before += w < warp ? x : 0;
      total += x;
    }
    int run = carry + before + incl - s;
#pragma unroll
    for (int k = 0; k < SPT / 4; ++k) {
      const int e = e0 + 4 * k;
      int4 q;
      q.x = run;
      run += v[4 * k];
      q.y = run;
      run += v[4 * k + 1];
      q.z = run;
      run += v[4 * k + 2];
      q.w = run;
      run += v[4 * k + 3];
      if (e < M) __stcg(reinterpret_cast<int4*>(table + e), q);
    }
    carry += total;
    __syncthreads();                     // wsum is reused; table visible
  }
  for (int c = t; c < C; c += NT) {
    const int lo = __ldcg(table + c * nb);
    const int hi = c + 1 < C ? __ldcg(table + (c + 1) * nb) : carry;
    offsets[c] = lo;
    counts[c] = hi - lo;
  }
  if (t == 0) offsets[C] = carry;
}

// Pass 1.  Dynamic shared memory: small C * NT ints, shared C ints.
template <bool SMALL>
__global__ void __launch_bounds__(NT) count_kernel(
    const int* __restrict__ ids, int* __restrict__ table,
    int* __restrict__ counts, int* __restrict__ offsets, int n, int C,
    int tpb) {
  extern __shared__ int h[];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nb = gridDim.x;
  int begin, end;
  stretch(n, tpb, &begin, &end);
  // tiles last to first, the next one loading while this one counts: the
  // first tiles are then the ones in L2 when the rank pass starts
  const int ntl = (end - begin + TILE - 1) / TILE;
  int4 q[VEC];
  int id[IPT];
  if (ntl > 0) load_striped(ids, begin + (ntl - 1) * TILE, n, q);
  if (SMALL) {
    // this thread's column; a run of equal ids is added when it ends
    for (int c = 0; c < C; ++c) h[c * NT + t] = 0;
    int cur = -1, len = 0;
    for (int j = ntl - 1; j >= 0; --j) {
      unpack(q, id);
      if (j > 0) load_striped(ids, begin + (j - 1) * TILE, n, q);
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        if (id[k] == cur) {
          ++len;
        } else {
          if (valid_id(cur, C)) h[cur * NT + t] += len;
          cur = id[k];
          len = 1;
        }
      }
    }
    if (valid_id(cur, C)) h[cur * NT + t] += len;
    __syncthreads();
    // bucket c on warp c % NW: lane l sums columns l, l + 32, ...
    for (int c = warp; c < C; c += NW) {
      int s = 0;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) s += h[c * NT + lane + 32 * j];
      s = warp_sum(s);
      if (lane == 0) __stcg(table + c * nb + blockIdx.x, s);
    }
  } else {
    for (int c = t; c < C; c += NT) h[c] = 0;
    __syncthreads();
    for (int j = ntl - 1; j >= 0; --j) {
      unpack(q, id);
      if (j > 0) load_striped(ids, begin + (j - 1) * TILE, n, q);
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        // one add a group of lanes holding equal ids
        const unsigned peers = __match_any_sync(FULL, id[k]);
        if (valid_id(id[k], C) && __ffs(peers) - 1 == lane)
          atomicAdd(h + id[k], __popc(peers));
      }
    }
    __syncthreads();
    for (int c = t; c < C; c += NT)
      __stcg(table + c * nb + blockIdx.x, h[c]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&g_ticket, 1u) == (unsigned)nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_table(table, counts, offsets, C, nb);
  if (t == 0) g_ticket = 0;              // for the next launch
}

// Pass 2, small form.  Dynamic shared memory: NW * STAGE int4, then
// (C * NT + C) ints.
__global__ void __launch_bounds__(NT) rank_small_kernel(
    const int* __restrict__ ids, const int* __restrict__ base,
    int* __restrict__ dest, int n, int C, int tpb) {
  extern __shared__ int4 stage_all[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int4* stage = stage_all + warp * STAGE;
  int* h = reinterpret_cast<int*>(stage_all + NW * STAGE);  // [C][NT]
  int* run = h + C * NT;                 // the block's next slot a bucket
  int* col = h + t;                      // this thread's column
  int begin, end;
  stretch(n, tpb, &begin, &end);
  for (int c = t; c < C; c += NT) run[c] = base[c * gridDim.x + blockIdx.x];
  // the warp's vectors k * 32 + lane of a tile (coalesced), next tile's
  // in flight while this one is ranked
  int4 q[VEC];
  const int wv = 4 * warp * (32 * VEC);  // the warp's first item in a tile
  auto load = [&](int tile) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      q[k] = load4(ids, tile + wv + 4 * (k * 32 + lane), n);
  };
  if (begin < end) load(begin);
  for (int tile = begin; tile < end; tile += TILE) {
    // striped to blocked: this thread's 16 consecutive items
    int id[IPT];
    __syncwarp();                        // the last tile's reads of stage
#pragma unroll
    for (int k = 0; k < VEC; ++k) stage[staged(k * 32 + lane)] = q[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < VEC; ++k) q[k] = stage[staged(lane * VEC + k)];
    unpack(q, id);
    if (tile + TILE < end) load(tile + TILE);
    // this thread's count a bucket, a run at a time
    for (int c = 0; c < C; ++c) col[c * NT] = 0;
    int cur = -1, len = 0;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      if (id[k] == cur) {
        ++len;
      } else {
        if (valid_id(cur, C)) col[cur * NT] += len;
        cur = id[k];
        len = 1;
      }
    }
    if (valid_id(cur, C)) col[cur * NT] += len;
    __syncthreads();
    // bucket c on warp c % NW: the columns' exclusive scan from the
    // block's running slot, eight rows of 32 threads scanned at once
    for (int c = warp; c < C; c += NW) {
      int v[NT / 32], x[NT / 32];
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) x[j] = v[j] = h[c * NT + 32 * j + lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < NT / 32; ++j) {
          const int u = __shfl_up_sync(FULL, x[j], o);
          if (lane >= o) x[j] += u;
        }
      }
      int carry = run[c];
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        h[c * NT + 32 * j + lane] = carry + x[j] - v[j];
        carry += __shfl_sync(FULL, x[j], 31);
      }
      if (lane == 0) run[c] = carry;
    }
    __syncthreads();
    // each item its bucket's next slot in this thread's column
    int d[IPT], slot = 0;
    cur = -1;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int x = id[k];
      if (!valid_id(x, C)) {
        d[k] = n;
        continue;
      }
      if (x != cur) {
        if (cur >= 0) col[cur * NT] = slot;
        cur = x;
        slot = col[x * NT];
      }
      d[k] = slot++;
    }
    // blocked to striped: each store of a warp writes 512 contiguous bytes
    __syncwarp();
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      stage[staged(lane * VEC + k)] =
          make_int4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      store4(dest, tile + wv + 4 * (k * 32 + lane), n,
             stage[staged(k * 32 + lane)]);
  }
}

// Pass 2, shared form.  Dynamic shared memory: (NW * C + C) ints.
__global__ void __launch_bounds__(NT) rank_shared_kernel(
    const int* __restrict__ ids, const int* __restrict__ base,
    int* __restrict__ dest, int n, int C, int tpb) {
  extern __shared__ int wc[];            // [NW][C] warp tables, then run[C]
  int* run = wc + NW * C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* mine = wc + warp * C;
  const unsigned lower = (1u << lane) - 1u;
  int begin, end;
  stretch(n, tpb, &begin, &end);
  for (int c = t; c < C; c += NT) run[c] = base[c * gridDim.x + blockIdx.x];
  for (int tile = begin; tile < end; tile += TILE) {
    const int i0 = tile + warp * (ROUNDS * 32) + lane;
    int id[ROUNDS], rk[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = i0 + 32 * r;
      id[r] = i < n ? __ldg(ids + i) : -1;
    }
    __syncwarp();                        // the last tile's reads of mine
    for (int c = lane; c < C; c += 32) mine[c] = 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int x = id[r];
      const bool valid = valid_id(x, C);
      // invalid lanes get a key of their own, so they group with no one
      const unsigned peers = __match_any_sync(FULL, valid ? x : -1 - lane);
      rk[r] = valid ? mine[x] + __popc(peers & lower) : 0;
      __syncwarp();
      if (valid && __ffs(peers) - 1 == lane) mine[x] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // bucket c on thread c % NT: the warps' exclusive scan from the
    // block's running slot
    for (int c = t; c < C; c += NT) {
      int carry = run[c];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int v = wc[w * C + c];
        wc[w * C + c] = carry;
        carry += v;
      }
      run[c] = carry;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = i0 + 32 * r;
      if (i < n) __stcs(dest + i, valid_id(id[r], C) ? mine[id[r]] + rk[r] : n);
    }
  }
}

// Per-bucket counts straight into device memory (integer atomics: exact
// in any order), one add a group of lanes holding equal ids.
__global__ void __launch_bounds__(NT) count_global_kernel(
    const int* __restrict__ ids, int* __restrict__ counts, int n, int C) {
  const int lane = threadIdx.x & 31;
  const int n4 = (n + 3) / 4;
  const int warp0 = (blockIdx.x * NT + threadIdx.x) - lane;
  for (int v0 = warp0; v0 < n4; v0 += gridDim.x * NT) {   // warp-uniform
    const int4 q = v0 + lane < n4 ? load4(ids, 4 * (v0 + lane), n)
                                  : make_int4(-1, -1, -1, -1);
    const int id[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned peers = __match_any_sync(FULL, id[k]);
      if (valid_id(id[k], C) && __ffs(peers) - 1 == lane)
        atomicAdd(counts + id[k], __popc(peers));
    }
  }
}

cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// form 0: small, 1: shared.  ids 16-byte aligned; table is blocks * C
// int32 scratch (blocks a multiple of 4; it ends holding each (bucket,
// block)'s first slot); counts (C,) and offsets (C+1,) are written by
// the kernel; smem_count / smem_rank are the passes' dynamic shared
// memory in bytes.
extern "C" int scatter_dest_launch(void* ids, void* dest, void* counts,
                                   void* offsets, void* table, int n, int C,
                                   int form, int blocks, int tiles_per_block,
                                   int smem_count, int smem_rank,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (form != 0 && form != 1) return (int)cudaErrorInvalidValue;
  const bool small = form == 0;
  const void* count_fn = small ? (const void*)count_kernel<true>
                               : (const void*)count_kernel<false>;
  const void* rank_fn = small ? (const void*)rank_small_kernel
                              : (const void*)rank_shared_kernel;
  cudaError_t err = allow_smem(count_fn, smem_count);
  if (err == cudaSuccess) err = allow_smem(rank_fn, smem_rank);
  if (err != cudaSuccess) return (int)err;
  if (small) {
    count_kernel<true><<<blocks, NT, smem_count, s>>>(
        (const int*)ids, (int*)table, (int*)counts, (int*)offsets, n, C,
        tiles_per_block);
  } else {
    count_kernel<false><<<blocks, NT, smem_count, s>>>(
        (const int*)ids, (int*)table, (int*)counts, (int*)offsets, n, C,
        tiles_per_block);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (small) {
    rank_small_kernel<<<blocks, NT, smem_rank, s>>>(
        (const int*)ids, (const int*)table, (int*)dest, n, C,
        tiles_per_block);
  } else {
    rank_shared_kernel<<<blocks, NT, smem_rank, s>>>(
        (const int*)ids, (const int*)table, (int*)dest, n, C,
        tiles_per_block);
  }
  return (int)cudaGetLastError();
}

// counts (C,) of the ids in [0, C) (zeroed here: one memset of C ints is
// cheaper than any tag scheme for an output); ids 16-byte aligned.
extern "C" int scatter_count_launch(void* ids, void* counts, int n, int C,
                                    int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)C * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  count_global_kernel<<<blocks, NT, 0, s>>>((const int*)ids, (int*)counts, n,
                                            C);
  return (int)cudaGetLastError();
}
