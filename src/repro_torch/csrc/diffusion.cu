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
// What bounds it on the H100: latency, not bytes or operations.  Each
// sweep needs two block-wide reductions and three barrier-separated
// phases, and at the PIC's P = 8 nodes the whole working set is a few
// hundred bytes.  Design: the TPU kernel's own "one program, everything
// on chip" — one thread block runs the S sweeps with the state in shared
// memory (17 P K + 8 P bytes) when it fits in 227 KB, and in global
// memory (served from L2) otherwise; no launch or host round trip between
// sweeps.  Reductions run in a fixed tree order, so a run repeats bit for
// bit.  Multi-block variants for large P are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;  // threads per block (power of two for the trees)

__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  float out = red[0];
  __syncthreads();
  return out;
}

__device__ float block_max(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  float out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(NT) nsweeps_kernel(
    float* __restrict__ gx, float* __restrict__ gown,
    float* __restrict__ gflow, const int* __restrict__ gnbr,
    const int* __restrict__ grev, const uint8_t* __restrict__ gmask,
    float* __restrict__ gpush, const int* __restrict__ it_in,
    const int* __restrict__ stall_in, const float* __restrict__ res_in,
    int* __restrict__ istat_out, float* __restrict__ res_out, int P, int K,
    int n_sweeps, int max_iters, int single_hop, float alpha, float tol,
    int use_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NT];

  const int PK = P * K;
  float *x = gx, *own = gown, *flow = gflow, *push = gpush;
  const int *nbr = gnbr, *rev = grev;
  const uint8_t* mask = gmask;
  if (use_smem) {
    // layout: x[P] own[P] flow[PK] push[PK] nbr[PK] rev[PK] mask[PK]
    float* f = reinterpret_cast<float*>(smem);
    x = f;
    own = f + P;
    flow = f + 2 * P;
    push = f + 2 * P + PK;
    int* nb = reinterpret_cast<int*>(f + 2 * P + 2 * PK);
    int* rv = nb + PK;
    uint8_t* mk = reinterpret_cast<uint8_t*>(rv + PK);
    for (int i = threadIdx.x; i < P; i += NT) {
      x[i] = gx[i];
      own[i] = gown[i];
    }
    for (int e = threadIdx.x; e < PK; e += NT) {
      flow[e] = gflow[e];
      nb[e] = gnbr[e];
      rv[e] = grev[e];
      mk[e] = gmask[e];
    }
    nbr = nb;
    rev = rv;
    mask = mk;
    __syncthreads();
  }

  int it = it_in[0];
  int stall = stall_in[0];
  float res = res_in[0];

  for (int s = 0; s < n_sweeps; ++s) {
    // uniform across the block: every thread holds the same scalars.  An
    // inactive sweep leaves the carry unchanged, so later ones are too.
    if (!(it < max_iters && res > tol && stall < 3)) break;

    // phase A: push matrix (reads x of the neighbours)
    for (int i = threadIdx.x; i < P; i += NT) {
      const float xi = x[i];
      float tot = 0.0f;
      for (int k = 0; k < K; ++k) {
        const int e = i * K + k;
        float p = 0.0f;
        if (mask[e]) p = fmaxf(alpha * (xi - x[nbr[e]]), 0.0f);
        push[e] = p;
        tot += p;
      }
      if (single_hop) {
        const float scale =
            tot > 0.0f ? fminf(1.0f, own[i] / (tot + 1e-30f)) : 1.0f;
        for (int k = 0; k < K; ++k) push[i * K + k] *= scale;
      }
    }
    __syncthreads();

    // phase B: gathered receive, carry update (each row touches only its
    // own x, own and flow; push is read-only here)
    float moved = 0.0f, absx = 0.0f, sumx = 0.0f;
    for (int i = threadIdx.x; i < P; i += NT) {
      float sent = 0.0f, recv = 0.0f;
      for (int k = 0; k < K; ++k) {
        const int e = i * K + k;
        const float p = push[e];
        const float r = mask[e] ? push[nbr[e] * K + rev[e]] : 0.0f;
        sent += p;
        recv += r;
        flow[e] += p - r;
      }
      const float xi = x[i];
      const float x2 = (xi - sent) + recv;
      own[i] -= sent;
      x[i] = x2;
      moved += fabsf(x2 - xi);
      absx += fabsf(x2);
      sumx += x2;
    }
    moved = block_sum(moved, red);   // barriers inside: x is now final
    absx = block_sum(absx, red);
    sumx = block_sum(sumx, red);

    // phase C: neighbourhood deviation of the new loads
    float maxdev = 0.0f;
    for (int i = threadIdx.x; i < P; i += NT) {
      const float xi = x[i];
      float acc = xi;
      int cnt = 1;
      for (int k = 0; k < K; ++k) {
        const int e = i * K + k;
        if (mask[e]) {
          acc += x[nbr[e]];
          ++cnt;
        }
      }
      const float mean = acc / (float)cnt;
      float dev = fabsf(xi - mean);
      for (int k = 0; k < K; ++k) {
        const int e = i * K + k;
        if (mask[e]) dev = fmaxf(dev, fabsf(x[nbr[e]] - mean));
      }
      maxdev = fmaxf(maxdev, dev);
    }
    maxdev = block_max(maxdev, red);

    const bool stalled = moved <= 1e-6f * (absx / (float)P + 1e-30f);
    res = maxdev / (sumx / (float)P + 1e-30f);
    it += 1;
    stall = stalled ? stall + 1 : 0;
  }

  if (use_smem) {
    for (int i = threadIdx.x; i < P; i += NT) {
      gx[i] = x[i];
      gown[i] = own[i];
    }
    for (int e = threadIdx.x; e < PK; e += NT) gflow[e] = flow[e];
  }
  if (threadIdx.x == 0) {
    istat_out[0] = it;
    istat_out[1] = stall;
    res_out[0] = res;
  }
}

}  // namespace

extern "C" int diffusion_nsweeps_launch(
    void* x, void* own, void* flow, void* nbr, void* rev, void* mask,
    void* push, void* it_in, void* stall_in, void* res_in, void* istat_out,
    void* res_out, int P, int K, int n_sweeps, int max_iters, int single_hop,
    float alpha, float tol, int use_smem, void* stream) {
  const size_t smem = use_smem ? (size_t)17 * P * K + (size_t)8 * P : 0;
  cudaFuncSetAttribute(nsweeps_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  nsweeps_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      (float*)x, (float*)own, (float*)flow, (const int*)nbr,
      (const int*)rev, (const uint8_t*)mask, (float*)push,
      (const int*)it_in, (const int*)stall_in, (const float*)res_in,
      (int*)istat_out, (float*)res_out, P, K, n_sweeps, max_iters,
      single_hop, alpha, tol, use_smem);
  return (int)cudaGetLastError();
}
