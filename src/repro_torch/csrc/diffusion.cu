// Fused diffusion S-sweep chunk (stage 2 of the balancer, paper §III.B).
//
// Replaces the TPU kernel repro/kernels/diffusion/kernel.py
// diffusion_nsweeps_pallas (body _nsweeps_kernel): S early-exit-gated
// sweeps on the carry (x, own, flow, it, res, stall).  Each sweep pushes
// max(alpha (x_i - x_j), 0) on masked edges, rescales each row to the
// node's remaining own load (single-hop), receives by the reverse-slot
// gather recv[i,k] = push[nbr[i,k], rev[i,k]], and updates the residual
// and stall counters.  The predicate (it < max_iters) & (res > tol) &
// (stall < 3) is checked before each sweep, as in the plain chunk.
//
// What bounds it on the H100: latency, not bytes or operations.  A sweep
// is three dependent phases (push, receive, neighbourhood deviation) and
// four sums over all nodes whose result gates the next sweep; the bytes
// (17 P K + 8 P) are 1.2 MB at P = 8192, K = 8, a 0.0004 ms read.
// Design: three forms of one arithmetic (the row functions below), picked
// by the wrapper from (P, K) (kernels/diffusion/ops.py k1_form):
//   * warp  — one block of one warp, the state in shared memory; phases
//             separated by __syncwarp, sums by shuffles (the PIC path,
//             P = 8, K = 4);
//   * block — one block of 512 threads, the state in shared memory; sums
//             by shuffles and one shared stage;
//   * grid  — a cooperative launch of as many blocks of 256 threads as are
//             co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//             the state in global memory served from L2, two grid barriers
//             a sweep: [receive] | [deviation + the next sweep's push] |
//             per-block partials, which every block then reduces in the
//             same fixed order, so every block takes the same gate decision
//             from the same bits (a block that disagreed would deadlock the
//             next barrier).
// Every sum is a fixed tree (xor shuffles are commutative at each level,
// so all lanes hold the same bits), so each form repeats bit for bit.
// Measured on one NVIDIA H100 80GB HBM3 at 700 W, one S = 8 chunk: the
// warp form 0.0084 ms of device time at P = 8, K = 4 (the wrapper's host
// work, 0.04-0.1 ms, is the longer); the grid form 0.114 ms at P = 8192,
// K = 8 and 0.140 ms at P = 32768, K = 8, against 0.79 and 0.93 ms for the
// streaming chunk of K2 (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GRID_NT = 256;     // threads a block of the grid form

// The load of a state word: shared memory in the one-block forms; in the
// grid form global memory written by other blocks during the launch,
// read through L2 (ld.cg), never a stale L1 line.
template <bool GLOBAL>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  return *p;
}

struct Tables {
  const int* nbr;
  const int* rev;
  const uint8_t* mask;
};

// push[i, :] from x (single-hop: rescaled to the node's own load)
template <bool GLOBAL>
__device__ __forceinline__ void push_row(int i, int K, const float* x,
                                         const float* own, Tables t,
                                         float* push, float alpha,
                                         int single_hop) {
  const float xi = ld<GLOBAL>(x + i);
  float tot = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int e = i * K + k;
    float p = 0.0f;
    if (t.mask[e]) p = fmaxf(alpha * (xi - ld<GLOBAL>(x + t.nbr[e])), 0.0f);
    push[e] = p;
    tot += p;
  }
  if (single_hop) {
    const float scale =
        tot > 0.0f ? fminf(1.0f, ld<GLOBAL>(own + i) / (tot + 1e-30f))
                   : 1.0f;
    for (int k = 0; k < K; ++k) push[i * K + k] *= scale;
  }
}

// gathered receive and the row's carry update; adds |dx|, |x|, x to acc
template <bool GLOBAL>
__device__ __forceinline__ void recv_row(int i, int K, float* x, float* own,
                                         float* flow, const float* push,
                                         Tables t, float4& acc) {
  float sent = 0.0f, recv = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int e = i * K + k;
    const float p = ld<GLOBAL>(push + e);
    const float r =
        t.mask[e] ? ld<GLOBAL>(push + t.nbr[e] * K + t.rev[e]) : 0.0f;
    sent += p;
    recv += r;
    flow[e] = ld<GLOBAL>(flow + e) + (p - r);
  }
  const float xi = ld<GLOBAL>(x + i);
  const float x2 = (xi - sent) + recv;
  own[i] = ld<GLOBAL>(own + i) - sent;
  x[i] = x2;
  acc.x += fabsf(x2 - xi);
  acc.y += fabsf(x2);
  acc.z += x2;
}

// max |load - neighbourhood mean| over {i} ∪ N(i)
template <bool GLOBAL>
__device__ __forceinline__ float dev_row(int i, int K, const float* x,
                                         Tables t) {
  const float xi = ld<GLOBAL>(x + i);
  float acc = xi;
  int cnt = 1;
  for (int k = 0; k < K; ++k) {
    const int e = i * K + k;
    if (t.mask[e]) {
      acc += ld<GLOBAL>(x + t.nbr[e]);
      ++cnt;
    }
  }
  const float mean = acc / (float)cnt;
  float dev = fabsf(xi - mean);
  for (int k = 0; k < K; ++k) {
    const int e = i * K + k;
    if (t.mask[e]) dev = fmaxf(dev, fabsf(ld<GLOBAL>(x + t.nbr[e]) - mean));
  }
  return dev;
}

// (sum, sum, sum, max) over a warp; every lane ends with the same bits
__device__ __forceinline__ float4 warp_reduce(float4 v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(FULL, v.x, o);
    v.y += __shfl_xor_sync(FULL, v.y, o);
    v.z += __shfl_xor_sync(FULL, v.z, o);
    v.w = fmaxf(v.w, __shfl_xor_sync(FULL, v.w, o));
  }
  return v;
}

// over the block, every thread ends with the same bits (stage: NT / 32)
template <int NT>
__device__ __forceinline__ float4 block_reduce(float4 v, float4* stage) {
  v = warp_reduce(v, 32);
  if constexpr (NT == 32) {
    __syncwarp();
    return v;
  } else {
    constexpr int NW = NT / 32;
    if ((threadIdx.x & 31) == 0) stage[threadIdx.x >> 5] = v;
    __syncthreads();
    // lanes l and l + NW read the same entry, so the tree over NW lanes
    // leaves the same bits in all 32
    return warp_reduce(stage[threadIdx.x & (NW - 1)], NW);
  }
}

template <int NT>
__device__ __forceinline__ void block_sync() {
  if constexpr (NT == 32) __syncwarp();
  else __syncthreads();
}

// the gate and the carry's scalars after a sweep's four sums
struct Scalars {
  int it, stall;
  float res;
  __device__ bool active(int max_iters, float tol) const {
    return it < max_iters && res > tol && stall < 3;
  }
  __device__ void update(float4 s, int P) {
    const bool stalled = s.x <= 1e-6f * (s.y / (float)P + 1e-30f);
    res = s.w / (s.z / (float)P + 1e-30f);
    it += 1;
    stall = stalled ? stall + 1 : 0;
  }
};

// ---------------------------------------------------- one-block forms --

template <int NT>
__global__ void __launch_bounds__(NT) chunk_block_kernel(
    const float* __restrict__ x_in, const float* __restrict__ own_in,
    const float* __restrict__ flow_in, const int* __restrict__ gnbr,
    const int* __restrict__ grev, const uint8_t* __restrict__ gmask,
    const int* __restrict__ it_in, const float* __restrict__ res_in,
    const int* __restrict__ stall_in, float* __restrict__ x_out,
    float* __restrict__ own_out, float* __restrict__ flow_out,
    int* __restrict__ stat_out, int P, int K, int n_sweeps, int max_iters,
    int single_hop, float alpha, float tol) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float4 stage[NT / 32];
  const int PK = P * K;
  // layout: x[P] own[P] flow[PK] push[PK] nbr[PK] rev[PK] mask[PK]
  float* x = reinterpret_cast<float*>(smem);
  float* own = x + P;
  float* flow = own + P;
  float* push = flow + PK;
  int* nbr = reinterpret_cast<int*>(push + PK);
  int* rev = nbr + PK;
  uint8_t* mask = reinterpret_cast<uint8_t*>(rev + PK);
  for (int i = threadIdx.x; i < P; i += NT) {
    x[i] = x_in[i];
    own[i] = own_in[i];
  }
  for (int e = threadIdx.x; e < PK; e += NT) {
    flow[e] = flow_in[e];
    nbr[e] = gnbr[e];
    rev[e] = grev[e];
    mask[e] = gmask[e];
  }
  const Tables t{nbr, rev, mask};
  Scalars sc{*it_in, *stall_in, *res_in};
  block_sync<NT>();

  for (int s = 0; s < n_sweeps; ++s) {
    // uniform across the block: every thread holds the same scalars.  An
    // inactive sweep leaves the carry unchanged, so later ones are too.
    if (!sc.active(max_iters, tol)) break;
    for (int i = threadIdx.x; i < P; i += NT)
      push_row<false>(i, K, x, own, t, push, alpha, single_hop);
    block_sync<NT>();
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < P; i += NT)
      recv_row<false>(i, K, x, own, flow, push, t, acc);
    block_sync<NT>();
    for (int i = threadIdx.x; i < P; i += NT)
      acc.w = fmaxf(acc.w, dev_row<false>(i, K, x, t));
    // its barrier also orders this deviation pass before the next push
    sc.update(block_reduce<NT>(acc, stage), P);
  }

  for (int i = threadIdx.x; i < P; i += NT) {
    x_out[i] = x[i];
    own_out[i] = own[i];
  }
  for (int e = threadIdx.x; e < PK; e += NT) flow_out[e] = flow[e];
  if (threadIdx.x == 0) {
    stat_out[0] = sc.it;
    stat_out[1] = __float_as_int(sc.res);
    stat_out[2] = sc.stall;
  }
}

// ----------------------------------------------------------- grid form --

// arrival count and generation of the grid barrier; the count is back at
// 0 after every barrier, so back-to-back launches on a stream start clean
__device__ unsigned int g_barrier[2];

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every block of the (co-resident, cooperative) grid arrives before any
// leaves; writes before it are visible to loads after it
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(&g_barrier[1]);
    __threadfence();
    if (atomicAdd(&g_barrier[0], 1u) == gridDim.x - 1) {
      atomicExch(&g_barrier[0], 0u);
      __threadfence();
      atomicAdd(&g_barrier[1], 1u);
    } else {
      while (ld_acquire(&g_barrier[1]) == gen) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(GRID_NT) chunk_grid_kernel(
    const float* __restrict__ x_in, const float* __restrict__ own_in,
    const float* __restrict__ flow_in, const int* __restrict__ nbr,
    const int* __restrict__ rev, const uint8_t* __restrict__ mask,
    const int* __restrict__ it_in, const float* __restrict__ res_in,
    const int* __restrict__ stall_in, float* x, float* own, float* flow,
    int* __restrict__ stat_out, float* push, float4* part, int P, int K,
    int n_sweeps, int max_iters, int single_hop, float alpha, float tol) {
  __shared__ float4 stage[GRID_NT / 32];
  const int stride = gridDim.x * GRID_NT;
  const int first = blockIdx.x * GRID_NT + threadIdx.x;
  const Tables t{nbr, rev, mask};
  // the carry into the outputs, and sweep 0's push from the inputs (a
  // push that the gate then refuses is scratch, never read)
  for (int i = first; i < P; i += stride) {
    x[i] = x_in[i];
    own[i] = own_in[i];
    for (int k = 0; k < K; ++k) flow[i * K + k] = flow_in[i * K + k];
    push_row<false>(i, K, x_in, own_in, t, push, alpha, single_hop);
  }
  Scalars sc{*it_in, *stall_in, *res_in};
  grid_barrier();

  for (int s = 0; s < n_sweeps; ++s) {
    if (!sc.active(max_iters, tol)) break;   // same bits in every block
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = first; i < P; i += stride)
      recv_row<true>(i, K, x, own, flow, push, t, acc);
    grid_barrier();
    // x is final: its deviation, and the next sweep's push (push was last
    // read before the barrier)
    for (int i = first; i < P; i += stride) {
      acc.w = fmaxf(acc.w, dev_row<true>(i, K, x, t));
      push_row<true>(i, K, x, own, t, push, alpha, single_hop);
    }
    acc = block_reduce<GRID_NT>(acc, stage);
    if (threadIdx.x == 0) __stcg(part + blockIdx.x, acc);
    grid_barrier();
    // every warp of every block: block b's partial on lane b % 32, lanes
    // in block order, then the fixed xor tree
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = threadIdx.x & 31; b < (int)gridDim.x; b += 32) {
      const float4 p = __ldcg(part + b);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w = fmaxf(v.w, p.w);
    }
    // part is next written after the next sweep's first barrier, which
    // every block reaches only once it has read it here
    sc.update(warp_reduce(v, 32), P);
  }
  if (first == 0) {
    stat_out[0] = sc.it;
    stat_out[1] = __float_as_int(sc.res);
    stat_out[2] = sc.stall;
  }
}

// co-resident blocks of the grid form on the current device (cached)
int grid_capacity() {
  static int cap[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_grid_kernel,
                                                  GRID_NT, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cap[dev] = per_sm * sms;
  }
  return cap[dev];
}

template <int NT>
cudaError_t launch_block(size_t smem, cudaStream_t s, const float* x_in,
                         const float* own_in, const float* flow_in,
                         const int* nbr, const int* rev, const uint8_t* mask,
                         const int* it_in, const float* res_in,
                         const int* stall_in, float* x_out, float* own_out,
                         float* flow_out, int* stat_out, int P, int K,
                         int n_sweeps, int max_iters, int single_hop,
                         float alpha, float tol) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_block_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  chunk_block_kernel<NT><<<1, NT, smem, s>>>(
      x_in, own_in, flow_in, nbr, rev, mask, it_in, res_in, stall_in, x_out,
      own_out, flow_out, stat_out, P, K, n_sweeps, max_iters, single_hop,
      alpha, tol);
  return cudaGetLastError();
}

}  // namespace

// form: 0 warp, 1 block (shared-memory state of smem bytes), 2 grid (blocks
// wanted, capped at the co-resident count; push is (P, K) f32 scratch and
// part 16-byte-aligned scratch of one float4 a block).  stat_out is
// (it, res as f32 bits, stall).
extern "C" int diffusion_nsweeps_launch(
    void* x_in, void* own_in, void* flow_in, void* nbr, void* rev,
    void* mask, void* it_in, void* res_in, void* stall_in, void* x_out,
    void* own_out, void* flow_out, void* stat_out, void* push, void* part,
    int P, int K, int n_sweeps, int max_iters, int single_hop, float alpha,
    float tol, int form, int blocks, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *xi = (const float*)x_in, *oi = (const float*)own_in,
              *fi = (const float*)flow_in;
  const int *nb = (const int*)nbr, *rv = (const int*)rev;
  const uint8_t* mk = (const uint8_t*)mask;
  const int *iti = (const int*)it_in, *sti = (const int*)stall_in;
  const float* ri = (const float*)res_in;
  float *xo = (float*)x_out, *oo = (float*)own_out, *fo = (float*)flow_out;
  int* so = (int*)stat_out;
  if (form == 0)
    return (int)launch_block<32>((size_t)smem, s, xi, oi, fi, nb, rv, mk,
                                 iti, ri, sti, xo, oo, fo, so, P, K,
                                 n_sweeps, max_iters, single_hop, alpha,
                                 tol);
  if (form == 1)
    return (int)launch_block<512>((size_t)smem, s, xi, oi, fi, nb, rv, mk,
                                  iti, ri, sti, xo, oo, fo, so, P, K,
                                  n_sweeps, max_iters, single_hop, alpha,
                                  tol);
  if (form != 2) return (int)cudaErrorInvalidValue;
  const int cap = grid_capacity();
  int grid = blocks < cap ? blocks : cap;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  float* pu = (float*)push;
  float4* pa = (float4*)part;
  void* args[] = {&xi, &oi, &fi, &nb, &rv, &mk, &iti, &ri, &sti, &xo, &oo,
                  &fo, &so, &pu, &pa, &P, &K, &n_sweeps, &max_iters,
                  &single_hop, &alpha, &tol};
  return (int)cudaLaunchCooperativeKernel((void*)chunk_grid_kernel,
                                          dim3(grid), dim3(GRID_NT), args,
                                          0, s);
}
