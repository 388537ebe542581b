// Backward of the GQA flash attention K6 (flash_attention.cu): given q
// (B, Sq, KV, G, hd), k and v (B, T, KV, hd), q_pos (B, Sq) and kv_pos
// (B, T) int32, the forward's output o (B, Sq, KV, G, hd) and its
// cotangent do (same shape and type as q), it writes dq (q's type), dk and
// dv (k's type).  Every attention layer's backward on the training path
// calls it, through the torch.autograd.Function in
// kernels/flash_attention/ops.py.
//
// Counterpart of the TPU package's training attention: XLA autodiff of
// the pure-JAX chunked_attention (repro/models/attention.py, each query
// chunk under jax.checkpoint); the Pallas kernel it sits beside,
// repro/kernels/flash_attention/kernel.py flash_attention_pallas, has no
// backward.  Its plain version is the autograd of ref.chunked_attention.
//
// What it computes, with the forward's masks and keys exactly:
//   * s = (q . k) / sqrt(hd) in f32 from q and k upcast to f32 (MLA's
//     rescale stays outside, in mla_attention);
//   * allowed = kpos <= qpos, and (qpos - kpos) < window when window != 0,
//     or (kpos < prefix_len and kpos < 2^29) when prefix_len != 0; a
//     masked score is -1e30 and a constant (no gradient flows through it);
//   * the keys a row visits are the forward's: slots [0, vis) with vis =
//     min(n * 32, T), n = min((hi + 32) / 32 + 1, ceil(T / 32)), hi the
//     largest non-sentinel query position of the row's group of
//     rows = max(1, min(Sq, 16 / G)) query rows (raised to prefix_len - 1
//     with a prefix); slots past vis take no part, not even in the
//     softmax's sum;
//   * P = exp(s - m) / l over the visited keys, D = rowsum(do * o),
//     dS = P (do . v - D) where allowed, else 0;
//     dq = scale sum_j dS_j k_j, dk_j = scale sum_(i,g) dS q,
//     dv_j = sum_(i,g) P do: dk and dv sum over the G query heads of a kv
//     head.
//
// Design (simple and deterministic; tensor cores are a later step):
//   * dq_kernel — one warp per (query row, group) pair, 16 pairs of one
//     (b, kv head) a block (8 at hd > 288).  The warp stages its q and do
//     rows as f32 and sums D; pass 1 walks the block's visited 32-key K
//     tiles (f32 in shared memory, rows padded to hd + 1 floats: lane j
//     reads key j's row without bank conflicts), lane j scoring key j, and
//     keeps the online max and sum (written out for dkdv_kernel); pass 2
//     walks K and V tiles again, lane j forms dS_j, and every lane adds
//     dS_j k_j to its output columns c, c + 32, ... (keys in order, dS_j
//     broadcast by shuffles).
//   * dkdv_kernel — one warp per key, 16 keys of one (b, kv head) a block
//     (8 at hd > 288).  It walks the pairs of all G heads in tiles of 32
//     (q and do rows staged as f32, padded likewise), skipping a tile none
//     of whose rows visits the block's keys; lane p forms P and dS of pair
//     p against the warp's key, and every lane adds P do_p and dS q_p to
//     its columns (pairs in order, broadcast by shuffles).
//   * No float atomics: each output element is one thread's sum in one
//     fixed order, so two calls give the same bits.
// Work: 5 products of 2 hd flops per visited (pair, key): scores twice
// (one a kernel), do . v, dS k and (P do, dS q) — about 2.5 times the
// forward's 2 products.  On the H100 that is flop-bound against the bf16
// tensor-core rate at the training shapes; these kernels run on the f32
// FMA units, so their roof is the 67 TFLOP/s f32 rate.
// Limits: those of K6's SIMT form, G <= 128, hd <= 576; the C entry
// returns cudaErrorInvalidValue past them.  Shared memory above 48 KB is
// dynamic: each launch raises the kernel's limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KB = 32;               // keys a tile (dq) / pairs a tile (dkdv)
constexpr int NC_SMALL = 9;          // columns a lane up to hd = 288
constexpr int NC_LARGE = 18;         // up to hd = 576
constexpr int MAX_HD = 32 * NC_LARGE;
constexpr int MAX_G = 128;
constexpr int POS_VALID = 1 << 29;   // positions at or above: unwritten
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;        // a masked score

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// butterfly sum, then lane 0's value everywhere
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return __shfl_sync(FULL, x, 0);
}

__device__ __forceinline__ bool allowed(int kp, int qp, int window,
                                        int prefix_len) {
  bool ok = kp <= qp;
  if (window) ok = ok && (qp - kp) < window;
  if (prefix_len) ok = ok || (kp < prefix_len && kp < POS_VALID);
  return ok;
}

// slots query row r visits: those of its group of `rows` rows (the
// forward's rule, flash_attention.cu visit_end)
__device__ __forceinline__ int visit_end(const int* __restrict__ qpos_b,
                                         int r, int Sq, int rows, int T,
                                         int prefix_len) {
  const int r0 = r / rows * rows, r1 = min(r0 + rows, Sq);
  int hi = -1;
  for (int i = r0; i < r1; ++i) {
    const int p = qpos_b[i];
    if (p < POS_VALID) hi = max(hi, p);
  }
  if (prefix_len) hi = max(hi, prefix_len - 1);
  return min(min((hi + KB) / KB + 1, (T + KB - 1) / KB) * KB, T);
}

// row of pair p = i * G + g of (b, kv head) in the (B, Sq, KV, G) layout
__device__ __forceinline__ size_t pair_row(int b, int kvh, int p, int Sq,
                                           int KV, int G) {
  const int i = p / G, g = p - i * G;
  return ((static_cast<size_t>(b) * Sq + i) * KV + kvh) * G + g;
}

// ----------------------------------------------------------- dq kernel --

template <typename TQ, typename TKV, int NC>
__global__ void __launch_bounds__(512)
    dq_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ qpos,
              const int* __restrict__ kvpos, const TQ* __restrict__ o,
              const TQ* __restrict__ dout, TQ* __restrict__ dq,
              float* __restrict__ m_out, float* __restrict__ l_out,
              float* __restrict__ D_out, int Sq, int T, int KV, int G,
              int hd, int rows, int window, int prefix_len, float scale) {
  extern __shared__ float smem[];
  const int W = blockDim.x >> 5;
  const int ld = hd + 1;
  float* k_s = smem;                          // KB x (hd + 1)
  float* v_s = k_s + KB * ld;                 // KB x (hd + 1)
  float* q_s = v_s + KB * ld;                 // W x hd
  float* do_s = q_s + W * hd;                 // W x hd
  int* kp_s = reinterpret_cast<int*>(do_s + W * hd);   // KB
  int* vis_s = kp_s + KB;                     // W

  const int bk = blockIdx.y, b = bk / KV, kvh = bk - b * KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NP = Sq * G;
  const int p = blockIdx.x * W + warp;
  const bool active = p < NP;
  const int* qpos_b = qpos + static_cast<size_t>(b) * Sq;
  const size_t row = active ? pair_row(b, kvh, p, Sq, KV, G) : 0;
  const int qp = active ? qpos_b[p / G] : 0;
  const int vis = active ? visit_end(qpos_b, p / G, Sq, rows, T, prefix_len)
                         : 0;

  float dsum = 0.0f;
  if (active)
    for (int d = lane; d < hd; d += 32) {
      const float x = to_f(q[row * hd + d]);
      const float y = to_f(dout[row * hd + d]);
      q_s[warp * hd + d] = x;
      do_s[warp * hd + d] = y;
      dsum = fmaf(y, to_f(o[row * hd + d]), dsum);
    }
  const float Dp = warp_sum(dsum);
  if (lane == 0) vis_s[warp] = vis;
  __syncthreads();
  int blk_vis = 0;
  for (int w = 0; w < W; ++w) blk_vis = max(blk_vis, vis_s[w]);
  const int n_tiles = (blk_vis + KB - 1) / KB;
  const float* qr = q_s + warp * hd;
  const float* dr = do_s + warp * hd;
  const size_t kv_stride = static_cast<size_t>(KV) * hd;
  const TKV* kb = k + (static_cast<size_t>(b) * T * KV + kvh) * hd;
  const TKV* vb = v + (static_cast<size_t>(b) * T * KV + kvh) * hd;

  // pass 1: the row's max and sum over its visited keys
  float m = -INFINITY, l = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * KB, nk = min(KB, blk_vis - t0);
    __syncthreads();                          // the last tile is consumed
    for (int idx = threadIdx.x; idx < nk * hd; idx += blockDim.x) {
      const int j = idx / hd, d = idx - j * hd;
      k_s[j * ld + d] = to_f(kb[(t0 + j) * kv_stride + d]);
    }
    if (threadIdx.x < nk)
      kp_s[threadIdx.x] = kvpos[static_cast<size_t>(b) * T + t0 + threadIdx.x];
    __syncthreads();
    if (!active || t0 >= vis) continue;
    float s = -INFINITY;
    if (lane < nk && t0 + lane < vis) {
      const float* kr = k_s + lane * ld;
      float acc = 0.0f;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      s = allowed(kp_s[lane], qp, window, prefix_len) ? acc * scale : NEG;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float e = (s == -INFINITY) ? 0.0f : expf(s - m_new);
    l = l * expf(m - m_new) + warp_sum(e);
    m = m_new;
  }
  if (active && lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
    D_out[row] = Dp;
  }
  const float inv_l = 1.0f / l;

  // pass 2: dS a key, dq += dS k
  float acc_q[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc_q[c] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * KB, nk = min(KB, blk_vis - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * hd; idx += blockDim.x) {
      const int j = idx / hd, d = idx - j * hd;
      const size_t src = (t0 + j) * kv_stride + d;
      k_s[j * ld + d] = to_f(kb[src]);
      v_s[j * ld + d] = to_f(vb[src]);
    }
    if (threadIdx.x < nk)
      kp_s[threadIdx.x] = kvpos[static_cast<size_t>(b) * T + t0 + threadIdx.x];
    __syncthreads();
    if (!active || t0 >= vis) continue;
    float ds = 0.0f;
    if (lane < nk && t0 + lane < vis) {
      const float* kr = k_s + lane * ld;
      const float* vr = v_s + lane * ld;
      float acc = 0.0f, dp = 0.0f;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        acc = fmaf(qr[d], kr[d], acc);
        dp = fmaf(dr[d], vr[d], dp);
      }
      if (allowed(kp_s[lane], qp, window, prefix_len)) {
        const float pr = expf(acc * scale - m) * inv_l;
        ds = pr * (dp - Dp);
      }
    }
    const int jn = min(nk, vis - t0);
    for (int j = 0; j < jn; ++j) {
      const float dsj = __shfl_sync(FULL, ds, j);
      const float* kr = k_s + j * ld;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) acc_q[c] = fmaf(dsj, kr[d], acc_q[c]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) dq[row * hd + d] = from_f<TQ>(acc_q[c] * scale);
    }
  }
}

// --------------------------------------------------------- dkdv kernel --

template <typename TQ, typename TKV, int NC>
__global__ void __launch_bounds__(512)
    dkdv_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                const TKV* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kvpos, const TQ* __restrict__ dout,
                const float* __restrict__ m_in, const float* __restrict__ l_in,
                const float* __restrict__ D_in, TKV* __restrict__ dk,
                TKV* __restrict__ dv, int Sq, int T, int KV, int G, int hd,
                int rows, int window, int prefix_len, float scale) {
  extern __shared__ float smem[];
  const int W = blockDim.x >> 5;
  const int ld = hd + 1;
  float* q_s = smem;                          // KB pairs x (hd + 1)
  float* do_s = q_s + KB * ld;                // KB pairs x (hd + 1)
  float* k_s = do_s + KB * ld;                // W keys x hd
  float* v_s = k_s + W * hd;                  // W keys x hd
  float* m_s = v_s + W * hd;                  // KB
  float* il_s = m_s + KB;                     // KB: 1 / l
  float* d_s = il_s + KB;                     // KB
  int* qp_s = reinterpret_cast<int*>(d_s + KB);   // KB
  int* vis_s = qp_s + KB;                     // KB

  const int bk = blockIdx.y, b = bk / KV, kvh = bk - b * KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NP = Sq * G;
  const int j0 = blockIdx.x * W;
  const int j = j0 + warp;
  const bool active = j < T;
  const int* qpos_b = qpos + static_cast<size_t>(b) * Sq;
  const size_t krow = (static_cast<size_t>(b) * T + (active ? j : 0)) * KV +
                      kvh;

  if (active)
    for (int d = lane; d < hd; d += 32) {
      k_s[warp * hd + d] = to_f(k[krow * hd + d]);
      v_s[warp * hd + d] = to_f(v[krow * hd + d]);
    }
  const int kp = active ? kvpos[static_cast<size_t>(b) * T + j] : 0;

  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    acc_k[c] = 0.0f;
    acc_v[c] = 0.0f;
  }
  const float* kr = k_s + warp * hd;
  const float* vr = v_s + warp * hd;
  const int n_ptiles = (NP + KB - 1) / KB;
  for (int pt = 0; pt < n_ptiles; ++pt) {
    const int p0 = pt * KB, np = min(KB, NP - p0);
    __syncthreads();                          // the last tile is consumed
    if (threadIdx.x < KB) {
      const int pp = p0 + threadIdx.x;
      int e = 0;
      if (threadIdx.x < np) {
        const size_t row = pair_row(b, kvh, pp, Sq, KV, G);
        e = visit_end(qpos_b, pp / G, Sq, rows, T, prefix_len);
        qp_s[threadIdx.x] = qpos_b[pp / G];
        m_s[threadIdx.x] = m_in[row];
        il_s[threadIdx.x] = 1.0f / l_in[row];
        d_s[threadIdx.x] = D_in[row];
      }
      vis_s[threadIdx.x] = e;
    }
    __syncthreads();
    int tile_vis = 0;
    for (int i = 0; i < KB; ++i) tile_vis = max(tile_vis, vis_s[i]);
    if (tile_vis <= j0) continue;             // no row visits these keys
    for (int idx = threadIdx.x; idx < np * hd; idx += blockDim.x) {
      const int pp = idx / hd, d = idx - pp * hd;
      const size_t row = pair_row(b, kvh, p0 + pp, Sq, KV, G);
      q_s[pp * ld + d] = to_f(q[row * hd + d]);
      do_s[pp * ld + d] = to_f(dout[row * hd + d]);
    }
    __syncthreads();
    if (!active) continue;
    float pr = 0.0f, ds = 0.0f;
    if (lane < np && j < vis_s[lane]) {
      const float* qr = q_s + lane * ld;
      const float* dr = do_s + lane * ld;
      float acc = 0.0f, dp = 0.0f;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        acc = fmaf(qr[d], kr[d], acc);
        dp = fmaf(dr[d], vr[d], dp);
      }
      const bool ok = allowed(kp, qp_s[lane], window, prefix_len);
      pr = expf((ok ? acc * scale : NEG) - m_s[lane]) * il_s[lane];
      if (ok) ds = pr * (dp - d_s[lane]);
    }
    if (!__any_sync(FULL, pr != 0.0f || ds != 0.0f)) continue;
    for (int i = 0; i < np; ++i) {
      const float pi = __shfl_sync(FULL, pr, i);
      const float dsi = __shfl_sync(FULL, ds, i);
      const float* qr = q_s + i * ld;
      const float* dr = do_s + i * ld;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          acc_v[c] = fmaf(pi, dr[d], acc_v[c]);
          acc_k[c] = fmaf(dsi, qr[d], acc_k[c]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dk[krow * hd + d] = from_f<TKV>(acc_k[c] * scale);
        dv[krow * hd + d] = from_f<TKV>(acc_v[c]);
      }
    }
  }
}

template <typename TQ, typename TKV, int NC>
int launch_nc(void* q, void* k, void* v, void* qpos, void* kvpos, void* o,
              void* dout, void* dq, void* dk, void* dv, void* m_buf,
              void* l_buf, void* d_buf, int B, int Sq, int T, int KV, int G,
              int hd, int window, int prefix_len, cudaStream_t stream) {
  // 16 warps a block, 8 at 18 columns a lane (registers, shared memory)
  const int W = NC > NC_SMALL ? 8 : 16;
  const int rows = max(1, min(Sq, 16 / G));
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const size_t smem_dq = sizeof(float) * (2 * KB * (hd + 1) + 2 * W * hd) +
                         sizeof(int) * (KB + W);
  const size_t smem_kv = sizeof(float) * (2 * KB * (hd + 1) + 2 * W * hd +
                                          3 * KB) +
                         sizeof(int) * 2 * KB;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<TQ, TKV, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel<TQ, TKV, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NP = Sq * G;
  const dim3 grid_q((NP + W - 1) / W, B * KV);
  dq_kernel<TQ, TKV, NC><<<grid_q, W * 32, smem_dq, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<const TQ*>(o),
      static_cast<const TQ*>(dout), static_cast<TQ*>(dq),
      static_cast<float*>(m_buf), static_cast<float*>(l_buf),
      static_cast<float*>(d_buf), Sq, T, KV, G, hd, rows, window,
      prefix_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((T + W - 1) / W, B * KV);
  dkdv_kernel<TQ, TKV, NC><<<grid_kv, W * 32, smem_kv, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<const TQ*>(dout),
      static_cast<const float*>(m_buf), static_cast<const float*>(l_buf),
      static_cast<const float*>(d_buf), static_cast<TKV*>(dk),
      static_cast<TKV*>(dv), Sq, T, KV, G, hd, rows, window, prefix_len,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch(void* q, void* k, void* v, void* qpos, void* kvpos, void* o,
           void* dout, void* dq, void* dk, void* dv, void* m_buf, void* l_buf,
           void* d_buf, int B, int Sq, int T, int KV, int G, int hd,
           int window, int prefix_len, cudaStream_t stream) {
  if (hd < 1 || hd > MAX_HD || G < 1 || G > MAX_G || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32 * NC_SMALL)
    return launch_nc<TQ, TKV, NC_SMALL>(q, k, v, qpos, kvpos, o, dout, dq,
                                        dk, dv, m_buf, l_buf, d_buf, B, Sq,
                                        T, KV, G, hd, window, prefix_len,
                                        stream);
  return launch_nc<TQ, TKV, NC_LARGE>(q, k, v, qpos, kvpos, o, dout, dq, dk,
                                      dv, m_buf, l_buf, d_buf, B, Sq, T, KV,
                                      G, hd, window, prefix_len, stream);
}

}  // namespace

// q, o, do, dq in q's type; k, v, dk, dv in k's type (f32 or bf16 each);
// m_buf, l_buf, d_buf: B * Sq * KV * G f32 scratch (the rows' max, sum and
// rowsum(do * o), written by the dq kernel, read by the dk/dv kernel).
extern "C" int flash_attention_bwd_launch(
    void* q, void* k, void* v, void* qpos, void* kvpos, void* o, void* dout,
    void* dq, void* dk, void* dv, void* m_buf, void* l_buf, void* d_buf,
    int B, int Sq, int T, int KV, int G, int hd, int window, int prefix_len,
    int q_bf16, int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_BWD(TQ, TKV)                                                      \
  launch<TQ, TKV>(q, k, v, qpos, kvpos, o, dout, dq, dk, dv, m_buf, l_buf,  \
                  d_buf, B, Sq, T, KV, G, hd, window, prefix_len, s)
  if (q_bf16 && kv_bf16) return FA_BWD(bf16, bf16);
  if (q_bf16) return FA_BWD(bf16, float);
  if (kv_bf16) return FA_BWD(float, bf16);
  return FA_BWD(float, float);
#undef FA_BWD
}
