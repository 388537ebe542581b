// Segment histogram: out[c] = sum_i w_i [ids_i = c], ids outside [0, C)
// ignored — the per-chare load measurement of every PIC step.
//
// Replaces the TPU kernel repro/kernels/histogram/kernel.py
// histogram_pallas (body _hist_kernel), which bins with a one-hot matmul
// because scatter-add serializes on the TPU.
//
// What bounds it on the H100: bytes (8 bytes an item read, C floats
// written), until many lanes of a warp add to one bin: after an exchange
// the particles lie bucketed by PE, a warp sees a few chare ids, and its
// shared-memory atomics serialize (on the PIC path it runs at about a
// tenth of its byte bound; a warp-aggregated add is the next step).
// Design: each block bins a tile of 16384 items into a shared-memory
// histogram with atomicAdd and writes it as one row of per-block
// partials; a second launch sums the partials of each bin in block
// order.  Determinism: the partials are exact, and so repeatable
// from run to run, when the weights are integer-valued and a bin's
// per-block sum stays below 2^24 — the PIC case (weights are ones).  For
// other weights the order of the shared-memory atomics varies, so the
// result may differ from run to run in the last bits.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int TILE = 16384;

__global__ void hist_partial_kernel(const int* __restrict__ ids,
                                    const float* __restrict__ w,
                                    float* __restrict__ partial, int n,
                                    int C) {
  extern __shared__ float h[];
  for (int c = threadIdx.x; c < C; c += NT) h[c] = 0.0f;
  __syncthreads();
  const int start = blockIdx.x * TILE;
  const int end = min(start + TILE, n);
  for (int i = start + threadIdx.x; i < end; i += NT) {
    const int id = ids[i];
    if (id >= 0 && id < C) atomicAdd(&h[id], w[i]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT)
    partial[blockIdx.x * C + c] = h[c];
}

__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int nb, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) s += partial[b * C + c];
  out[c] = s;
}

}  // namespace

// partial is (ceil(n / 16384) * C,) f32 scratch.
extern "C" int histogram_launch(void* ids, void* w, void* partial, void* out,
                                int n, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (n + TILE - 1) / TILE;
  hist_partial_kernel<<<nb, NT, C * sizeof(float), s>>>(
      (const int*)ids, (const float*)w, (float*)partial, n, C);
  hist_reduce_kernel<<<(C + 127) / 128, 128, 0, s>>>(
      (const float*)partial, (float*)out, nb, C);
  return (int)cudaGetLastError();
}
