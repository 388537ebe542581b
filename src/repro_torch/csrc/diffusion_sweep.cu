// Streaming diffusion sweep (stage 2 of the balancer, paper §III.B): one
// sweep in two passes, for node counts past what one thread block holds.
//
// Replaces the TPU kernel repro/kernels/diffusion/kernel.py
// diffusion_sweep_pallas (pass A _push_kernel, pass B _recv_kernel) and
// computes exactly core/virtual_lb.py reference_sweep:
//
//   pass A  push[i,k] = max(alpha (x_i - x_nbr[i,k]), 0) on masked slots,
//           each row scaled by min(1, own_i / (sum_k push + 1e-30)) where
//           the row sum is positive (single-hop);
//   pass B  recv[i,k] = push[nbr[i,k], rev[i,k]] on masked slots (the
//           symmetric graph's reverse-slot gather: no scatter, no atomic);
//           x_new = (x - sent) + sum_k recv, own_new = own - sent,
//           flow_step = push - recv.
//
// The passes are two launches: pass B reads other rows' push, and a launch
// boundary is the grid-wide barrier between them (the TPU kernel's two
// pallas_calls).
//
// What bounds it on the H100: bytes, 16 P + 13 P K a sweep (x, own, nbr,
// rev, mask read, x, own, flow written), about 0.9 MB at P = 8192, K = 8,
// 0.3 us at 3.35 TB/s; at such sizes the launch itself dominates.  Design:
// one thread per (node, slot), a row on a power-of-two segment of a warp
// (K <= 32), so P = 8192, K = 8 spreads over 65536 threads instead of
// 8192.  Row sums are taken in slot order 0..K-1 by warp shuffles, the
// order the fused kernel (diffusion.cu) sums in, so a run repeats bit for
// bit and the two kernels' sweeps agree.  x, own and push are read through
// the read-only cache (__ldg); the gathers stay in the 50 MB L2.  Built
// with -fmad=false so the plain version's separate multiply and add are
// matched.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block (a multiple of the warp)

// sum of v over the K lanes [base, base + K) of this lane's row segment, in
// lane order; every lane of the warp must call it (it shuffles)
__device__ __forceinline__ float row_sum(float v, int base, int K) {
  float s = 0.0f;
  for (int j = 0; j < K; ++j) s += __shfl_sync(0xffffffffu, v, base + j);
  return s;
}

__global__ void __launch_bounds__(NT) push_kernel(
    const float* __restrict__ x, const float* __restrict__ own,
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    float* __restrict__ push, int P, int K, int log_seg, float alpha,
    int single_hop) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  const int seg = 1 << log_seg;
  const int k = (int)(t & (seg - 1));
  const long long i = t >> log_seg;
  const bool live = i < P && k < K;
  const long long e = i * K + k;
  float p = 0.0f;
  if (live && mask[e]) {
    p = fmaxf(alpha * (__ldg(x + i) - __ldg(x + nbr[e])), 0.0f);
  }
  if (single_hop) {
    // no early return above: the whole warp reaches the shuffles
    const float tot = row_sum(p, (threadIdx.x & 31) & ~(seg - 1), K);
    if (live && tot > 0.0f) p *= fminf(1.0f, __ldg(own + i) / (tot + 1e-30f));
  }
  if (live) push[e] = p;
}

__global__ void __launch_bounds__(NT) recv_kernel(
    const float* __restrict__ x, const float* __restrict__ own,
    const float* __restrict__ push, const int* __restrict__ nbr,
    const int* __restrict__ rev, const uint8_t* __restrict__ mask,
    float* __restrict__ x_out, float* __restrict__ own_out,
    float* __restrict__ flow_out, int P, int K, int log_seg) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  const int seg = 1 << log_seg;
  const int k = (int)(t & (seg - 1));
  const long long i = t >> log_seg;
  const bool live = i < P && k < K;
  const long long e = i * K + k;
  float p = 0.0f, r = 0.0f;
  if (live) {
    p = __ldg(push + e);
    if (mask[e]) r = __ldg(push + (long long)nbr[e] * K + rev[e]);
    flow_out[e] = p - r;
  }
  const int base = (threadIdx.x & 31) & ~(seg - 1);
  const float sent = row_sum(p, base, K);
  const float recv = row_sum(r, base, K);
  if (live && k == 0) {
    x_out[i] = (__ldg(x + i) - sent) + recv;
    own_out[i] = __ldg(own + i) - sent;
  }
}

}  // namespace

// One sweep.  x, own (P,) f32; nbr, rev (P, K) i32; mask (P, K) u8; push
// (P, K) f32 scratch; outputs x_out, own_out (P,), flow_out (P, K) f32.
// Returns the CUDA error of the launches (0 on success).
extern "C" int diffusion_sweep_launch(
    void* x, void* own, void* nbr, void* rev, void* mask, void* push,
    void* x_out, void* own_out, void* flow_out, int P, int K, float alpha,
    int single_hop, void* stream) {
  if (K < 1 || K > 32 || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  int log_seg = 0;
  while ((1 << log_seg) < K) ++log_seg;
  const long long threads = (long long)P << log_seg;
  const unsigned blocks = (unsigned)((threads + NT - 1) / NT);
  cudaStream_t s = (cudaStream_t)stream;
  push_kernel<<<blocks, NT, 0, s>>>(
      (const float*)x, (const float*)own, (const int*)nbr,
      (const uint8_t*)mask, (float*)push, P, K, log_seg, alpha, single_hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_kernel<<<blocks, NT, 0, s>>>(
      (const float*)x, (const float*)own, (const float*)push,
      (const int*)nbr, (const int*)rev, (const uint8_t*)mask, (float*)x_out,
      (float*)own_out, (float*)flow_out, P, K, log_seg);
  return (int)cudaGetLastError();
}
