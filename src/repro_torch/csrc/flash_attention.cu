// GQA flash attention with causal / sliding-window / prefix-LM masks built
// from positions: out (B, Sq, KV, G, hd) for q (B, Sq, KV, G, hd), k and v
// (B, T, KV, hd), q_pos (B, Sq) and kv_pos (B, T) int32, where a position
// >= 2^29 marks an unwritten cache slot.  Every attention layer of the
// served model calls it, in prefill and in decode.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (body _flash_kernel), and computes what its
// oracle repro/models/attention.py chunked_attention computes:
//   * scores s = (q . k) / sqrt(hd) in f32 from q and k upcast to f32;
//   * allowed = kpos <= qpos (causal and valid), and (qpos - kpos) <
//     window when window != 0, or (kpos < prefix_len and kpos < 2^29)
//     when prefix_len != 0; a masked score is -1e30 (not -inf), so a row
//     with no allowed key averages V over the keys it masked;
//   * an online softmax with f32 m, l and o; p is rounded to v's type
//     before the PV product (as the oracle's p.astype(v.dtype)) while l
//     sums the unrounded p; out = o / max(l, 1e-30) in q's type.
// q and k/v are f32 or bf16, independently (the served model computes in
// bf16 while an engine may keep its cache in f32).
//
// What bounds it on the H100: the bytes of q, o and the visited k/v over
// 3.35 TB/s, against 4 B H Sq T_visited hd flops over 989 TFLOP/s of bf16
// tensor-core rate.  Prefill at Sq ~ 1000 is flop-bound by that measure;
// decode (Sq = 1) is byte-bound.  This first design uses no tensor
// cores, no TMA and no wgmma: it is simple and right, and runs the
// products as f32 FMAs from shared memory, so it sits far above the flop
// bound in prefill; a tensor-core (mma/wgmma) form is later work.
//
// Design.  One block per (b * KV + kv head, tile of `rows` query rows),
// one warp per (query row, group) pair, so rows * G warps a block.  The
// block walks the key tiles of 32 keys (one key a lane) in slot order,
// staging each K tile (rows padded to hd + 1 floats, so lane j reading
// key j's row hits a distinct bank) and V tile in dynamic shared memory
// as f32; with hd = 288 that is 74 KB, above the 48 KB of static shared
// memory, so the launch raises the block's limit first and reports a
// refused launch through cudaGetLastError.  Lane j computes key j's
// score against the warp's query row (held in shared memory, read as a
// broadcast); the tile's max and sum are warp shuffles; for the PV
// product lane c owns output columns c, c + 32, ... (hd / 32 <= 9 of
// them in registers) and takes each key's p by a shuffle.  The sum's
// shuffles end in a broadcast from lane 0, so l is the same on every
// lane.  A block visits only the key tiles below the causal bound of its
// query tile, min((hi + 32) / 32 + 1, ceil(T / 32)) with hi the largest
// non-sentinel query position (the TPU kernel's bound), raised to cover
// the prefix when prefix_len != 0.  That bound assumes slot order =
// position order, which holds for a global cache and for a ring cache
// that has not wrapped; once decode passes a window, a query position
// hi >= T and the bound covers every slot.  Keys past T in the last
// tile score -inf and contribute nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KB = 32;               // keys a tile: one a lane
constexpr int MAX_HD = 288;          // 9 output columns a lane
constexpr int NC = MAX_HD / 32;
constexpr int POS_VALID = 1 << 29;   // positions at or above: unwritten
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// butterfly sum, then lane 0's value everywhere (the lanes' sums may
// differ in the last bits: they pair the terms in different orders)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return __shfl_sync(FULL, x, 0);
}

template <typename TQ, typename TKV>
__global__ void flash_kernel(const TQ* __restrict__ q,
                             const TKV* __restrict__ k,
                             const TKV* __restrict__ v,
                             const int* __restrict__ qpos,
                             const int* __restrict__ kvpos,
                             TQ* __restrict__ out, int Sq, int T, int KV,
                             int G, int hd, int rows, int window,
                             int prefix_len, float scale) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int ldk = hd + 1;
  float* k_s = smem;                         // KB x (hd + 1)
  float* v_s = k_s + KB * ldk;               // KB x hd
  float* q_s = v_s + KB * hd;                // nwarps x hd
  int* kp_s = reinterpret_cast<int*>(q_s + nwarps * hd);   // KB
  __shared__ int n_tiles_s;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int r0 = blockIdx.y * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = r0 + warp / G, g = warp % G;
  const bool active = r < Sq;

  if (threadIdx.x == 0) {
    int hi = -1;
    for (int i = r0; i < min(r0 + rows, Sq); ++i) {
      const int p = qpos[b * Sq + i];
      if (p < POS_VALID) hi = max(hi, p);
    }
    if (prefix_len) hi = max(hi, prefix_len - 1);
    n_tiles_s = min((hi + KB) / KB + 1, (T + KB - 1) / KB);
  }
  const size_t qoff = ((static_cast<size_t>(b) * Sq + r) * KV + kvh) * G + g;
  if (active)
    for (int d = lane; d < hd; d += 32)
      q_s[warp * hd + d] = to_f(q[qoff * hd + d]);
  __syncthreads();
  const int n_tiles = n_tiles_s;
  const int qp = active ? qpos[b * Sq + r] : 0;

  float m = -INFINITY, l = 0.0f;
  float o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * KB;
    const int nk = min(KB, T - t0);
    __syncthreads();                         // the last tile is consumed
    for (int idx = threadIdx.x; idx < nk * hd; idx += blockDim.x) {
      const int j = idx / hd, d = idx - j * hd;
      const size_t src =
          ((static_cast<size_t>(b) * T + t0 + j) * KV + kvh) * hd + d;
      k_s[j * ldk + d] = to_f(k[src]);
      v_s[j * hd + d] = to_f(v[src]);
    }
    if (threadIdx.x < nk) kp_s[threadIdx.x] = kvpos[b * T + t0 + threadIdx.x];
    __syncthreads();
    if (!active) continue;

    float s = -INFINITY;
    if (lane < nk) {
      const float* kr = k_s + lane * ldk;
      const float* qr = q_s + warp * hd;
      float acc = 0.0f;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      s = acc * scale;
      const int kp = kp_s[lane];
      bool ok = kp <= qp;
      if (window) ok = ok && (qp - kp) < window;
      if (prefix_len) ok = ok || (kp < prefix_len && kp < POS_VALID);
      if (!ok) s = -1e30f;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = lane < nk ? expf(s - m_new) : 0.0f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
    const float pr = to_f(from_f<TKV>(p));   // p in v's type
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] *= corr;
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(FULL, pr, j);
      const float* vr = v_s + j * hd;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) o[c] = fmaf(pj, vr[d], o[c]);
      }
    }
  }

  if (active) {
    const float den = fmaxf(l, 1e-30f);
    TQ* orow = out + qoff * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = from_f<TQ>(o[c] / den);
    }
  }
}

template <typename TQ, typename TKV>
int launch(void* q, void* k, void* v, void* qpos, void* kvpos, void* out,
           int B, int Sq, int T, int KV, int G, int hd, int window,
           int prefix_len, cudaStream_t stream) {
  // rows * G warps a block: about 16 warps, at least one query row
  const int rows = max(1, min(Sq, 16 / G));
  const int nwarps = rows * G;
  const size_t smem =
      sizeof(float) * (KB * (hd + 1) + KB * hd + nwarps * hd) +
      sizeof(int) * KB;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * KV, (Sq + rows - 1) / rows);
  flash_kernel<TQ, TKV><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<TQ*>(out), Sq, T, KV, G,
      hd, rows, window, prefix_len, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper checks 1 <= G <= 32, hd <= 288, Sq >= 1, T >= 1, and
// contiguous tensors; q_bf16 / kv_bf16 select bf16 (1) or f32 (0).
extern "C" int flash_attention_launch(void* q, void* k, void* v, void* qpos,
                                      void* kvpos, void* out, int B, int Sq,
                                      int T, int KV, int G, int hd,
                                      int window, int prefix_len, int q_bf16,
                                      int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, qpos, kvpos, out, B, Sq, T, KV, G, hd, window, prefix_len, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, qpos, kvpos, out, B, Sq, T,
                                        KV, G, hd, window, prefix_len, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, qpos, kvpos, out, B, Sq, T,
                                        KV, G, hd, window, prefix_len, s);
  return launch<float, float>(q, k, v, qpos, kvpos, out, B, Sq, T, KV, G, hd,
                              window, prefix_len, s);
}
