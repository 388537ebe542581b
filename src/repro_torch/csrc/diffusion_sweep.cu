// Streaming diffusion sweep (stage 2 of the balancer, paper §III.B): one
// sweep in two passes, for tables past the fused kernel's limit
// (kernels/diffusion/ops.py FUSED_MAX_PK) and for callers that plan sweep
// by sweep (LBEngine(step_fn=ops.diffusion_sweep)).
//
// Replaces the TPU kernel repro/kernels/diffusion/kernel.py
// diffusion_sweep_pallas (pass A _push_kernel, pass B _recv_kernel) and
// computes exactly core/virtual_lb.py reference_sweep:
//
//   push[i,k] = max(alpha (x_i - x_nbr[i,k]), 0) on masked slots, each row
//               scaled by sigma_i = min(1, own_i / (sum_k push + 1e-30))
//               where the row sum is positive (single-hop), else by 1;
//   recv[i,k] = push[nbr[i,k], rev[i,k]] on masked slots;
//   x_new = (x - sent) + sum_k recv, own_new = own - sent,
//   flow_step = push - recv.
//
// What bounds it on the H100: bytes.  The least a sweep moves is
// 16 P + 13 P K (x, own, nbr, rev, mask read; x, own, flow written):
// 125.8 MB, 0.0376 ms at 3.35 TB/s for P = 2^20, K = 8.  The TPU kernel's
// form (pass A writes the (P, K) push matrix, pass B reads it back and
// gathers it at push[nbr K + rev]) moves at least 26 P K + 24 P.
//
// Design: no push matrix.
//   * A table pass (once per neighbour table, not per sweep; the wrapper
//     keeps the result while the tables are unchanged) packs each row's
//     mask into one 32-bit word and a second word of reciprocity bits:
//     bit k is set where slot k is masked in and node i sits at slot
//     rev[i,k] of j = nbr[i,k]'s list, masked in there too.
//   * Pass A writes one f32 sigma_i a row and nothing else (single-hop
//     only; without it sigma is 1 and pass A is not launched).
//   * Pass B recomputes each slot's own push from x_i, x_j and sigma_i,
//     and the reverse push push[j, rev] from x_j and sigma_j: on a
//     reciprocal slot nbr[j, rev] = i, so it is max(alpha (x_j - x_i), 0)
//     sigma_j.  A slot that is not reciprocal (reverse_slots leaves rev = 0
//     where i is absent from j's list) reads nbr[j, rev] and j's mask bit
//     and recomputes push[j, rev] from them, as the plain version reads it.
//     Recomputed pushes equal stored ones bit for bit: the same operands,
//     the same operations, no FMA contraction (-fmad=false), and
//     max(a, 0) * 1.0f is max(a, 0).
//   * A thread a row: the row's indices in 16-byte loads (K % 4 == 0,
//     aligned), its flow in 16-byte stores; tot, sent and recv summed in
//     registers in slot order 0..K-1, the order the fused kernel
//     (diffusion.cu) sums in, so the two agree bit for bit.  The gathers
//     of x and sigma (P f32 each, 4 MB at P = 2^20) stay in the 50 MB L2.
//   By count a single-hop sweep then reads x, own, the row's indices and
//   its mask word in pass A (12 + 4 K bytes a row) and x, own, sigma, the
//   indices and both words in pass B (20 + 4 K), and writes sigma, x, own
//   and flow (12 + 4 K): 44 + 12 K bytes a row, 140 at K = 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads (rows) a block

// the K (<= KB) entries of row i of a (P, K) i32 table; vec: K % 4 == 0
// and the table 16-byte aligned, so the row is K / 4 aligned int4s
template <int KB>
__device__ __forceinline__ void load_row(const int* __restrict__ t,
                                         long long i, int K, bool vec,
                                         int (&v)[KB]) {
  const int* row = t + i * K;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int q = 0; q < KB / 4; ++q) {
      if (4 * q < K) {
        const int4 w = __ldg(r4 + q);
        v[4 * q] = w.x;
        v[4 * q + 1] = w.y;
        v[4 * q + 2] = w.z;
        v[4 * q + 3] = w.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k < K) v[k] = __ldg(row + k);
  }
}

// bits[i] = mask word of row i, bits[P + i] = its reciprocity word
__global__ void __launch_bounds__(NT) tables_kernel(
    const int* __restrict__ nbr, const int* __restrict__ rev,
    const uint8_t* __restrict__ mask, unsigned* __restrict__ bits, int P,
    int K) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= P) return;
  unsigned m = 0u, rc = 0u;
  for (int k = 0; k < K; ++k) {
    const long long e = (long long)i * K + k;
    if (!mask[e]) continue;
    m |= 1u << k;
    const long long f = (long long)nbr[e] * K + rev[e];
    if (nbr[f] == i && mask[f]) rc |= 1u << k;
  }
  bits[i] = m;
  bits[P + i] = rc;
}

// pass A: sigma_i, the row's single-hop scale
template <int KB>
__global__ void __launch_bounds__(NT) sigma_kernel(
    const float* __restrict__ x, const float* __restrict__ own,
    const int* __restrict__ nbr, const unsigned* __restrict__ bits,
    float* __restrict__ sigma, int P, int K, float alpha, int vec) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= P) return;
  int nb[KB];
  load_row<KB>(nbr, i, K, vec, nb);
  const unsigned m = __ldg(bits + i);
  const float xi = __ldg(x + i);
  // a masked-out slot adds +0 in the fused kernel: the same bits as
  // skipping it (tot is never -0)
  float tot = 0.0f;
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (k < K && ((m >> k) & 1u))
      tot += fmaxf(alpha * (xi - __ldg(x + nb[k])), 0.0f);
  sigma[i] = tot > 0.0f ? fminf(1.0f, __ldg(own + i) / (tot + 1e-30f))
                        : 1.0f;
}

// pass B: each slot's push and received push, the row's flow and carry
template <int KB, bool SCALED>
__global__ void __launch_bounds__(NT) recv_kernel(
    const float* __restrict__ x, const float* __restrict__ own,
    const float* __restrict__ sigma, const int* __restrict__ nbr,
    const int* __restrict__ rev, const unsigned* __restrict__ bits,
    float* __restrict__ x_out, float* __restrict__ own_out,
    float* __restrict__ flow, int P, int K, float alpha, int vec) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= P) return;
  int nb[KB];
  load_row<KB>(nbr, i, K, vec, nb);
  const unsigned m = __ldg(bits + i), rc = __ldg(bits + P + i);
  const float xi = __ldg(x + i);
  const float si = SCALED ? __ldg(sigma + i) : 1.0f;
  float fl[KB];
  float sent = 0.0f, recv = 0.0f;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k >= K) break;
    float p = 0.0f, q = 0.0f;
    if ((m >> k) & 1u) {
      const int j = nb[k];
      const float xj = __ldg(x + j);
      p = fmaxf(alpha * (xi - xj), 0.0f);
      if ((rc >> k) & 1u) {
        q = fmaxf(alpha * (xj - xi), 0.0f);
      } else {
        // not reciprocal: push[j, rev[i,k]], whatever node it pushes to
        const int r = __ldg(rev + (long long)i * K + k);
        if ((__ldg(bits + j) >> r) & 1u)
          q = fmaxf(alpha * (xj - __ldg(x + __ldg(nbr + (long long)j * K + r))),
                    0.0f);
      }
      if (SCALED) {
        p *= si;
        q *= __ldg(sigma + j);
      }
    }
    fl[k] = p - q;
    sent += p;
    recv += q;
  }
  float* frow = flow + (long long)i * K;
  if (vec) {
    float4* f4 = reinterpret_cast<float4*>(frow);
#pragma unroll
    for (int q = 0; q < KB / 4; ++q)
      if (4 * q < K)
        f4[q] = make_float4(fl[4 * q], fl[4 * q + 1], fl[4 * q + 2],
                            fl[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k < K) frow[k] = fl[k];
  }
  x_out[i] = (xi - sent) + recv;
  own_out[i] = __ldg(own + i) - sent;
}

template <int KB>
cudaError_t launch_sweep(cudaStream_t s, unsigned blocks, const float* x,
                         const float* own, const int* nbr, const int* rev,
                         const unsigned* bits, float* sigma, float* x_out,
                         float* own_out, float* flow, int P, int K,
                         float alpha, int single_hop, int vec) {
  if (single_hop) {
    sigma_kernel<KB><<<blocks, NT, 0, s>>>(x, own, nbr, bits, sigma, P, K,
                                           alpha, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    recv_kernel<KB, true><<<blocks, NT, 0, s>>>(
        x, own, sigma, nbr, rev, bits, x_out, own_out, flow, P, K, alpha,
        vec);
  } else {
    recv_kernel<KB, false><<<blocks, NT, 0, s>>>(
        x, own, nullptr, nbr, rev, bits, x_out, own_out, flow, P, K, alpha,
        vec);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// The table pass.  nbr, rev (P, K) i32; mask (P, K) u8; bits (2, P) u32
// out.  Returns the CUDA error of the launch (0 on success).
extern "C" int diffusion_sweep_tables_launch(void* nbr, void* rev, void* mask,
                                             void* bits, int P, int K,
                                             void* stream) {
  if (K < 1 || K > 32 || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  tables_kernel<<<(P + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      (const int*)nbr, (const int*)rev, (const uint8_t*)mask,
      (unsigned*)bits, P, K);
  return (int)cudaGetLastError();
}

// One sweep.  x, own (P,) f32; nbr, rev (P, K) i32; bits (2, P) u32 from
// the table pass over the same tables; sigma (P,) f32 scratch (unused
// without single_hop); outputs x_out, own_out (P,), flow_out (P, K) f32.
// Returns the CUDA error of the launches (0 on success).
extern "C" int diffusion_sweep_launch(
    void* x, void* own, void* nbr, void* rev, void* bits, void* sigma,
    void* x_out, void* own_out, void* flow_out, int P, int K, float alpha,
    int single_hop, void* stream) {
  if (K < 1 || K > 32 || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int vec = K % 4 == 0 && aligned16(nbr) && aligned16(flow_out);
  const unsigned blocks = (unsigned)((P + NT - 1) / NT);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xs = (const float*)x, *ow = (const float*)own;
  const int *nb = (const int*)nbr, *rv = (const int*)rev;
  const unsigned* bt = (const unsigned*)bits;
  float *sg = (float*)sigma, *xo = (float*)x_out, *oo = (float*)own_out,
        *fo = (float*)flow_out;
  cudaError_t err;
  if (K <= 4)
    err = launch_sweep<4>(s, blocks, xs, ow, nb, rv, bt, sg, xo, oo, fo, P,
                          K, alpha, single_hop, vec);
  else if (K <= 8)
    err = launch_sweep<8>(s, blocks, xs, ow, nb, rv, bt, sg, xo, oo, fo, P,
                          K, alpha, single_hop, vec);
  else if (K <= 16)
    err = launch_sweep<16>(s, blocks, xs, ow, nb, rv, bt, sg, xo, oo, fo, P,
                           K, alpha, single_hop, vec);
  else
    err = launch_sweep<32>(s, blocks, xs, ow, nb, rv, bt, sg, xo, oo, fo, P,
                           K, alpha, single_hop, vec);
  return (int)err;
}
