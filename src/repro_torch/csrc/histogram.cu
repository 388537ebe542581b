// Segment histogram: out[c] = sum_i w_i [ids_i = c], ids outside [0, C)
// ignored — the per-chare load measurement of every PIC step.
//
// Replaces the TPU kernel repro/kernels/histogram/kernel.py
// histogram_pallas (body _hist_kernel), which bins with a one-hot matmul
// because scatter-add serializes on the TPU.
//
// What bounds it on the H100: bytes (8 bytes an item read, C floats
// written), 0.0401 ms at n = 2^24.  What stood in the way of the first
// port (shared-memory atomics, 0.4388 ms after an exchange on one NVIDIA
// H100 80GB HBM3 at 700 W): after an exchange the particles lie bucketed
// by PE, the 32 lanes of a warp hit one or two bins, and atomics on one
// address serialize.
// Design, two forms picked by the wrapper (kernels/histogram/ops.py
// histogram_plan):
//   * private (C <= 226): one persistent block of 256 threads an SM, each
//     block a contiguous stretch of the input, read as int4 ids and float4
//     weights, four vectors a thread in flight ahead of the adds.  Each
//     thread keeps a run (id, sum) in registers and adds it, when the id
//     changes, into its own column of a bin-major shared histogram
//     (h[c * 256 + thread]: a thread always hits its own bank), so there
//     is no atomic and no contention in any order, and a bucketed input
//     costs almost no shared-memory traffic.  The block sums its 256
//     columns a bin by a fixed shuffle tree into one partial; the last
//     block to finish (an atomic ticket it resets itself) sums the blocks'
//     partials in a fixed order and writes out.  One launch; results
//     repeat bit for bit for any f32 weights.
//   * shared (C > 226, up to 12288): the same loads; one histogram a
//     block, into which the lanes of a warp holding equal ids add one
//     shuffle-tree sum atomically (__match_any_sync; where a warp holds
//     more than four ids, each lane its own), then global atomicAdd into
//     out (zeroed by a memset).  Float sums then depend on the order of
//     the atomics and may differ from run to run in the last bits;
//     integer-valued weights are exact while a bin's total stays below
//     2^24.
// Measured on one NVIDIA H100 80GB HBM3 at 700 W (n = 2^24, C = 144, the
// PIC path's shape): 0.063 ms of device time in the initial order and
// after an exchange alike, 63 % of the byte bound (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads a block (both forms)
constexpr int U = 4;         // 16-byte vectors a thread has in flight
constexpr unsigned FULL = 0xffffffffu;

// blocks of the private form that have finished; the last one resets it
__device__ unsigned int g_ticket;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// a run of equal ids in registers
struct Run {
  int id = -1;
  float sum = 0.0f;
};

// this thread's column of the bin-major histogram: a run is added when
// the id changes
struct PrivateBins {
  float* h;
  int C;
  __device__ void flush(const Run& r) const {
    if ((unsigned)r.id < (unsigned)C) h[r.id * NT + threadIdx.x] += r.sum;
  }
  __device__ void add(Run& r, int id, float w) const {
    if (id == r.id) {
      r.sum += w;
    } else {
      flush(r);
      r.id = id;
      r.sum = w;
    }
  }
};

// the block's histogram, one item a lane at a time in warp lockstep: lanes
// with equal ids (__match_any_sync) sum their weights by a shuffle tree
// and one of them adds the sum atomically; where a warp holds more than
// four distinct ids each lane adds its own (little contention then)
struct SharedBins {
  float* h;
  int C;
  __device__ void flush(const Run&) const {}
  __device__ void add(Run&, int id, float w) const {
    const unsigned peers = __match_any_sync(FULL, id);
    const int lane = threadIdx.x & 31;
    const bool valid = (unsigned)id < (unsigned)C;
    const unsigned leaders = __ballot_sync(FULL, __ffs(peers) - 1 == lane);
    if (__popc(leaders) > 4) {
      if (valid) atomicAdd(h + id, w);
      return;
    }
    for (unsigned m = leaders; m; m &= m - 1) {
      const int l = __ffs(m) - 1;
      const float s = warp_sum((peers >> l) & 1u ? w : 0.0f);
      if (lane == l && valid) atomicAdd(h + id, s);
    }
  }
};

// this block's stretch of vectors [v0, v1) in block-uniform steps (lanes
// past the end carry the invalid id -1), then the n % 4 items past the
// last vector in the last block
template <class Bins>
__device__ __forceinline__ void bin_stretch(const int* __restrict__ ids,
                                            const float* __restrict__ w,
                                            int n, const Bins& bins) {
  const int n4 = n >> 2;
  const int per = (n4 + gridDim.x - 1) / gridDim.x;
  const int v0 = blockIdx.x * per;
  const int v1 = min(n4, v0 + per);
  const int4* id4 = reinterpret_cast<const int4*>(ids);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  Run r;
  int4 a[U];
  float4 b[U];
  auto load = [&](int base, int4* aa, float4* bb) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = base + (int)threadIdx.x + u * NT;
      if (v < v1) {
        aa[u] = __ldcs(id4 + v);
        bb[u] = __ldcs(w4 + v);
      } else {
        aa[u] = make_int4(-1, -1, -1, -1);
        bb[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  load(v0, a, b);
  for (int base = v0; base < v1; base += U * NT) {
    int4 na[U];
    float4 nb[U];
    load(base + U * NT, na, nb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bins.add(r, a[u].x, b[u].x);
      bins.add(r, a[u].y, b[u].y);
      bins.add(r, a[u].z, b[u].z);
      bins.add(r, a[u].w, b[u].w);
      a[u] = na[u];
      b[u] = nb[u];
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int i = 4 * n4 + (int)threadIdx.x;
    const bool tail = i < n;
    bins.add(r, tail ? ids[i] : -1, tail ? w[i] : 0.0f);
  }
  bins.flush(r);
}

// dynamic shared memory: C * NT floats; at most NT blocks
__global__ void __launch_bounds__(NT, 1) hist_private_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    float* __restrict__ partial, float* __restrict__ out, int n, int C) {
  extern __shared__ float h[];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = NT / 32;
  for (int i = threadIdx.x; i < C * NT; i += NT) h[i] = 0.0f;
  __syncthreads();
  bin_stretch(ids, w, n, PrivateBins{h, C});
  __syncthreads();
  // bin c on warp c % NW: lane l sums columns l, l + 32, ... in order
  for (int c = warp; c < C; c += NW) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NT / 32; ++j) s += h[c * NT + lane + 32 * j];
    s = warp_sum(s);
    if (lane == 0) __stcg(partial + c * gridDim.x + blockIdx.x, s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the partials (bin-major, a bin's blocks contiguous)
  // into shared memory in one copy, then bin c on warp c % NW, lane l
  // summing blocks l, l + 32, ... in order, by a fixed tree
  const int nb = gridDim.x;
#pragma unroll 8
  for (int i = threadIdx.x; i < C * nb; i += NT) h[i] = __ldcg(partial + i);
  __syncthreads();
  for (int c = warp; c < C; c += NW) {
    float s = 0.0f;
    for (int b = lane; b < nb; b += 32) s += h[c * nb + b];
    s = warp_sum(s);
    if (lane == 0) out[c] = s;
  }
  if (threadIdx.x == 0) g_ticket = 0;   // for the next launch
}

// dynamic shared memory: C floats
__global__ void __launch_bounds__(NT) hist_shared_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    float* __restrict__ out, int n, int C) {
  extern __shared__ float h[];
  for (int c = threadIdx.x; c < C; c += NT) h[c] = 0.0f;
  __syncthreads();
  bin_stretch(ids, w, n, SharedBins{h, C});
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT)
    if (h[c] != 0.0f) atomicAdd(out + c, h[c]);
}

// the ordered form: w sorted stably by bin, bounds (C + 1) each bin's run;
// one thread a bin adds its run one item at a time in index order (the
// order of a sequential scatter-add), so the bits are those of the CPU
__global__ void __launch_bounds__(NT) hist_ordered_kernel(
    const float* __restrict__ w, const long long* __restrict__ bounds,
    float* __restrict__ out, long long C) {
  const long long c = (long long)blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (long long j = bounds[c], e = bounds[c + 1]; j < e; ++j)
    s = __fadd_rn(s, w[j]);
  out[c] = s;
}

// the ordered form on few items: ids and w as given; one thread a bin
// walks every item in index order and adds its bin's (no sort)
__global__ void __launch_bounds__(NT) hist_ordered_scan_kernel(
    const int* __restrict__ ids, const float* __restrict__ w,
    float* __restrict__ out, int n, int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (int i = 0; i < n; ++i)
    if (ids[i] == c) s = __fadd_rn(s, w[i]);
  out[c] = s;
}

}  // namespace

// ids i32 and w f32 as given, n items (few: each thread reads them all)
extern "C" int histogram_ordered_scan_launch(void* ids, void* w, void* out,
                                             int n, int C, void* stream) {
  if (C <= 0) return 0;
  hist_ordered_scan_kernel<<<(C + NT - 1) / NT, NT, 0,
                             (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (float*)out, n, C);
  return (int)cudaGetLastError();
}

// w (sorted by bin) f32, bounds (C + 1) i64 offsets of the bins' runs
extern "C" int histogram_ordered_launch(void* w, void* bounds, void* out,
                                        long long C, void* stream) {
  if (C <= 0) return 0;
  const long long blocks = (C + NT - 1) / NT;
  hist_ordered_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const long long*)bounds, (float*)out, C);
  return (int)cudaGetLastError();
}

// form 0: private (partial is C * blocks f32 scratch, blocks <= 256);
// form 1: shared
// (out is zeroed here).  ids and w 16-byte aligned; smem in bytes.
extern "C" int histogram_launch(void* ids, void* w, void* partial, void* out,
                                int n, int C, int form, int blocks, int smem,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          hist_private_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return (int)err;
    }
    hist_private_kernel<<<blocks, NT, smem, s>>>(
        (const int*)ids, (const float*)w, (float*)partial, (float*)out, n,
        C);
    return (int)cudaGetLastError();
  }
  if (form != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  hist_shared_kernel<<<blocks, NT, smem, s>>>(
      (const int*)ids, (const float*)w, (float*)out, n, C);
  return (int)cudaGetLastError();
}
