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
// Two forms, one C entry each, chosen by ops.bwd_form
// (kernels/flash_attention/ops.py) from shapes and types alone.  Both are
// a dq kernel that also writes each (query row, group) pair's softmax max
// m, sum l and D = rowsum(do * o), then a dk/dv kernel that reads them.
// Neither uses float atomics or splits a sum across blocks: each output
// element is one thread's sum in one fixed order of tiles, so two calls
// give the same bits.
//
// * mma (bf16 q and k/v, hd % 16 == 0, hd <= 128, G <= 32: the training
//   path's attention).  FlashAttention-2's order on
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with ldmatrix fragments;
//   every tile reaches shared memory by cp.async on a ring of 3 slots, as
//   bf16 rows of 2 hd + 16 bytes (conflict-free for ldmatrix), so no
//   thread waits on a global load inside the loops; softmax in base 2
//   (scores times scale * log2(e), ex2.approx).
//   - dq_mma_kernel: 64 pairs of one (b, kv head) a block, 16 a warp,
//     packed into M as the forward's mma form packs them; grid (B * KV, M
//     tiles), the latest query rows first.  The block's Q and dO tiles
//     stay in shared memory; 64-key K (and V) tiles stream by (32 at
//     hd > 64).  Pass 1: S = Q K^T, the visit limit and masks on the S
//     fragments, the online m and l.  Pass 2: S again, dP = dO V^T,
//     dS = P (dP - D) in registers, rounded to bf16 as the A operand of
//     dQ += dS K (K through ldmatrix.trans).  It also writes each pair's
//     m, 1 / l, D and visit end, and each 64-pair tile's record (largest
//     and smallest visit end, smallest and largest position).
//   - dkdv_mma_kernel: 64 keys of one (b, kv head) a block, 16 a warp (keys
//     as M); grid (B * KV, key tiles), the earliest keys (the most query
//     tiles) first.  The block's K and V stay in shared memory; tiles of
//     64 pairs (32 at hd > 64) of all G heads, with their m, 1/l, D,
//     positions, visit ends and record, stream by in pair order, a tile
//     whose record visits none of the block's keys skipped.  S^T = K Q^T
//     and dP^T = V dO^T, P^T and dS^T in registers as bf16 A operands,
//     then dV += P^T dO and dK += dS^T Q (dO and Q through
//     ldmatrix.trans).
//   A warp's tile that every pair of it visits and is allowed to see (the
//   causal interior, known from the positions' extremes) skips the
//   per-element masks: without that, the masks' integer tests issued more
//   instructions than the products.  hd 64 and 128 are compiled with hd
//   fixed (the k-loops unrolled whole); other multiples of 16 take hd at
//   run time.  The dk/dv accumulators take hd / 2 registers each a thread
//   (16 x hd f32 a warp): 128 at hd = 128, hence the limit.
//   Work: 8 products of 2 hd flops per visited (pair, key): scores twice
//   and dO V^T in the dq kernel, scores, dO V^T, P^T dO and dS^T Q in the
//   dk/dv kernel.  The bound it is held to is the function's work, not
//   this kernel's: 2.5 x the forward's 2 products at the bf16 tensor-core
//   rate (989 TFLOP/s on the H100).
// * simt (everything else: f32 and mixed types, hd % 16 != 0, hd > 128,
//   G > 32, up to G <= 128, hd <= 576 — MLA's latent attention, gemma3's
//   hd 168).  f32 FMAs, no tensor cores:
//   - dq_kernel: one warp per (query row, group) pair, 16 pairs of one
//     (b, kv head) a block (8 at hd > 288).  The warp stages its q and do
//     rows as f32 and sums D; pass 1 walks the block's visited 32-key K
//     tiles (f32 in shared memory, rows padded to hd + 1 floats: lane j
//     reads key j's row without bank conflicts), lane j scoring key j, and
//     keeps the online max and sum; pass 2 walks K and V tiles again, lane
//     j forms dS_j, and every lane adds dS_j k_j to its output columns c,
//     c + 32, ... (keys in order, dS_j broadcast by shuffles).
//   - dkdv_kernel: one warp per key, 16 keys of one (b, kv head) a block
//     (8 at hd > 288).  It walks the pairs of all G heads in tiles of 32
//     (q and do rows staged as f32, padded likewise), skipping a tile none
//     of whose rows visits the block's keys; lane p forms P and dS of pair
//     p against the warp's key, and every lane adds P do_p and dS q_p to
//     its columns (pairs in order, broadcast by shuffles).
//   Work: 5 products of 2 hd flops per visited (pair, key) (scores twice,
//   do . v, dS k and (P do, dS q)), on the f32 FMA units, whose roof is
//   67 TFLOP/s.
// Limits: the C entries return cudaErrorInvalidValue past G <= 128,
// hd <= 576 (simt) and the mma form's own.  Shared memory above 48 KB is
// dynamic: each launch raises the kernel's limit first.
// ptxas (sm_90a), registers a thread, no spills: dq_mma_kernel 184 (hd
// 64), 171 (hd 128), 182-203 (hd at run time); dkdv_mma_kernel 224 (hd
// 64), 242 (hd 128), 188-240 (hd at run time): two blocks of 4 warps an
// SM.  SIMT form: dq_kernel 64-83, dkdv_kernel 64 (24 bytes of stack at
// 18 columns a lane).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// ------------------------------------------ mma form (bf16, tensor cores) --
// (cp_async16 ... pack_bf16 are flash_attention.cu's own, copied so that
// this source builds alone)

constexpr int MMA_MAX_HD = 128;
constexpr int MMA_MAX_G = 32;
constexpr int MW = 4;                // warps a block
constexpr int BM = 16 * MW;          // pairs (dq) / keys (dk/dv) a block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !full (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where !full (src unread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1,
                                          unsigned& r2, unsigned& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// 2^x on the SFU alone (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc[N / 8][4] += A_w (16 x hd rows at aw, ld apart) . B^T, B the N rows
// at bt (N x hd, ld apart): a warp's 16 x N score tile
template <int N>
__device__ __forceinline__ void rows_dot(float (*acc)[4], const bf16* aw,
                                         const bf16* bt, int ld, int hd,
                                         int lane) {
#pragma unroll
  for (int ks = 0; ks < hd; ks += 16) {
    unsigned a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, aw + (lane & 15) * ld + ks + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      unsigned b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              bt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld + ks
                  + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// acc[NDT][4] += X (16 x N, the C fragments x, rounded to bf16) . R, R the
// N rows at rt (N x hd, ld apart) through ldmatrix.trans
template <int N, int NDT>
__device__ __forceinline__ void frag_times_rows(float (*acc)[4],
                                                float (*x)[4],
                                                const bf16* rt, int ld,
                                                int hd, int lane) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const unsigned a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const unsigned a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const unsigned a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const unsigned a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      if (dp * 16 < hd) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  rt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                      + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[2 * dp + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }
}

// A block: BM (query row, group) pairs of one (b, kv head), 16 a warp; a
// thread holds rows gq and gq + 8 of its warp's 16 (gq = lane / 4) and, of
// each n8 tile, columns 2 (lane % 4) and 2 (lane % 4) + 1.  NDT n8 tiles
// of dq columns (hd <= 8 NDT); KT keys a tile, ST tiles in flight.  Grid
// (B * KV, M tiles): the latest query rows of every (b, kv head) first.
// Besides dq it writes, for the dk/dv kernel, each pair's m (in log2
// units: scores times scale * log2(e)), 1 / l, D and visit end, and each
// M tile's record: largest and smallest visit end, smallest and largest
// position.  A warp's tile of keys that every pair of the warp visits and
// is allowed to see (the causal interior) skips the per-element masks.
template <int NDT, int KT, int ST, int HD>
__global__ void __launch_bounds__(MW * 32, 2)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ qpos,
              const int* __restrict__ kvpos, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, bf16* __restrict__ dq,
              float* __restrict__ m_out, float* __restrict__ il_out,
              float* __restrict__ D_out, int* __restrict__ vis_out,
              int4* __restrict__ tile_rec, int Sq, int T, int KV, int G,
              int hd_arg, int rows, int window, int prefix_len,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int4 rec_s;                   // the M tile's record
  const int hd = HD ? HD : hd_arg;
  __shared__ float D_s[BM];
  const int ld = hd + 8;                   // 2 hd + 16 bytes a row
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BM x ld
  bf16* do_s = q_s + BM * ld;                       // BM x ld
  bf16* k_s = do_s + BM * ld;                       // ST x KT x ld
  bf16* v_s = k_s + ST * KT * ld;                   // ST x KT x ld
  int* kp_s = reinterpret_cast<int*>(v_s + ST * KT * ld);   // ST x KT

  const int NP = Sq * G;
  const int bk = blockIdx.x, b = bk / KV, kvh = bk - b * KV;
  const int mt = gridDim.y - 1 - blockIdx.y;          // latest rows first
  const int m0 = mt * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int* qpos_b = qpos + static_cast<size_t>(b) * Sq;
  const float sl2 = scale * LOG2E;

  int pr[2], qp[2], vis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pr[h] = m0 + warp * 16 + gq + 8 * h;
    const int r = pr[h] / G;
    qp[h] = pr[h] < NP ? qpos_b[r] : 0;
    vis[h] = pr[h] < NP ? visit_end(qpos_b, r, Sq, rows, T, prefix_len) : 0;
  }
  if (tid == 0) rec_s = make_int4(0, INT_MAX, INT_MAX, INT_MIN);
  __syncthreads();
  // integer extremes (a pair past NP: visit end 0, position 0)
  atomicMax(&rec_s.x, max(vis[0], vis[1]));
  atomicMin(&rec_s.y, min(vis[0], vis[1]));
  atomicMin(&rec_s.z, min(qp[0], qp[1]));
  atomicMax(&rec_s.w, max(qp[0], qp[1]));
  // the warp's 16 pairs: smallest visit end, smallest and largest position
  const int w_vis = __reduce_min_sync(FULL, min(vis[0], vis[1]));
  const int w_qlo = __reduce_min_sync(FULL, min(qp[0], qp[1]));
  const int w_qhi = __reduce_max_sync(FULL, max(qp[0], qp[1]));

  // the block's Q and dO rows (zero past NP), in the first tile's group
  const int cpr = hd / 8;                  // 16-byte chunks a row
  for (int i = tid; i < BM * cpr; i += MW * 32) {
    const int rr = i / cpr, c = i - rr * cpr, p = m0 + rr;
    const size_t off = p < NP ? pair_row(b, kvh, p, Sq, KV, G) * hd + c * 8
                              : 0;
    cp_async16(q_s + rr * ld + c * 8, q + off, p < NP);
    cp_async16(do_s + rr * ld + c * 8, dout + off, p < NP);
  }
  // D = rowsum(do * o) of the warp's 16 pairs: lanes 2i and 2i + 1 each
  // sum half of pair i's columns (16 bytes a load, all issued at once)
  {
    const int p = m0 + warp * 16 + (lane >> 1), half = hd / 2;
    float s = 0.0f;
    if (p < NP) {
      const size_t at = pair_row(b, kvh, p, Sq, KV, G) * hd + (lane & 1) * half;
      for (int d = 0; d < half; d += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + at + d);
        const uint4 y = *reinterpret_cast<const uint4*>(o + at + d);
        const unsigned* xs = reinterpret_cast<const unsigned*>(&x);
        const unsigned* ys = reinterpret_cast<const unsigned*>(&y);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + w));
          const float2 c = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ys + w));
          s = fmaf(a.x, c.x, s);
          s = fmaf(a.y, c.y, s);
        }
      }
    }
    s += __shfl_xor_sync(FULL, s, 1);
    if ((lane & 1) == 0) D_s[warp * 16 + (lane >> 1)] = s;
  }
  __syncthreads();
  const int blk_vis = rec_s.x;
  const float Dp[2] = {D_s[warp * 16 + gq], D_s[warp * 16 + gq + 8]};
  const int n_tiles = (blk_vis + KT - 1) / KT;
  if (tid == 0) tile_rec[static_cast<size_t>(bk) * gridDim.y + mt] = rec_s;
  const size_t stride = static_cast<size_t>(KV) * hd;
  const bf16* kb = k + (static_cast<size_t>(b) * T * KV + kvh) * hd;
  const bf16* vb = v + (static_cast<size_t>(b) * T * KV + kvh) * hd;
  const int* kvpos_b = kvpos + static_cast<size_t>(b) * T;

  // step s < n_tiles: pass 1 on tile s (K only); then pass 2 on tile
  // s - n_tiles (K and V); step s lives in slot s % ST
  auto stage = [&](int s) {
    const int slot = s % ST;
    const bool pass2 = s >= n_tiles;
    const int t0 = (pass2 ? s - n_tiles : s) * KT;
    const int n_valid = min(KT, blk_vis - t0);
    for (int i = tid; i < KT * cpr; i += MW * 32) {
      const int j = i / cpr, c = i - j * cpr;
      const bool ok = j < n_valid;
      const size_t off = ok ? (t0 + j) * stride + c * 8 : 0;
      cp_async16(k_s + (slot * KT + j) * ld + c * 8, kb + off, ok);
      if (pass2)
        cp_async16(v_s + (slot * KT + j) * ld + c * 8, vb + off, ok);
    }
    // positions of keys past n_valid are never read (past every vis)
    for (int j = tid; j < KT; j += MW * 32)
      cp_async4(kp_s + slot * KT + j, kvpos_b + t0 + j, j < n_valid);
  };

  float acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float inv_l[2] = {0.0f, 0.0f};
  const bf16* qw = q_s + warp * 16 * ld;
  const bf16* dw = do_s + warp * 16 * ld;
  const int n_steps = 2 * n_tiles;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {       // the first ST - 1 steps' tiles
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<ST - 2>();               // step s's group has landed
    __syncthreads();                       // and step s - 1's slot is free
    if (s + ST - 1 < n_steps) stage(s + ST - 1);
    cp_async_commit();
    const int slot = s % ST;
    const bool pass2 = s >= n_tiles;
    const int t0 = (pass2 ? s - n_tiles : s) * KT;
    const bf16* kt = k_s + slot * KT * ld;
    const int* kpt = kp_s + slot * KT;
    // every pair of the warp visits every key of the tile, allowed
    int k_lo = INT_MAX, k_hi = INT_MIN;
#pragma unroll
    for (int j = lane; j < KT; j += 32) {
      k_lo = min(k_lo, kpt[j]);
      k_hi = max(k_hi, kpt[j]);
    }
    k_lo = __reduce_min_sync(FULL, k_lo);
    k_hi = __reduce_max_sync(FULL, k_hi);
    const bool full = t0 + KT <= w_vis && k_hi <= w_qlo &&
                      (!window || w_qhi - k_lo < window);
    if (s == n_tiles) {                    // pass 1 done: the row stats
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(FULL, l[h], 1);
        l[h] += __shfl_xor_sync(FULL, l[h], 2);
        inv_l[h] = 1.0f / l[h];
        if (t4 == 0 && pr[h] < NP) {
          const size_t row = pair_row(b, kvh, pr[h], Sq, KV, G);
          m_out[row] = m[h];
          il_out[row] = inv_l[h];
          D_out[row] = Dp[h];
          vis_out[row] = vis[h];
        }
      }
    }

    // S = Q K^T: 16 pairs x KT keys a warp
    float sc[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
    rows_dot<KT>(sc, qw, kt, ld, hd, lane);

    if (!pass2) {
      // the online max and sum over the visited keys, as the forward's
      float tmax[2] = {-INFINITY, -INFINITY};
      if (full) {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nt][e] *= sl2;
            tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[nt][e]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt) {
          const int2 kp2 =
              *reinterpret_cast<const int2*>(kpt + nt * 8 + t4 * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, j = nt * 8 + t4 * 2 + (e & 1);
            float x = -INFINITY;
            if (t0 + j < vis[h])
              x = allowed((e & 1) ? kp2.y : kp2.x, qp[h], window,
                          prefix_len) ? sc[nt][e] * sl2 : NEG;
            sc[nt][e] = x;
            tmax[h] = fmaxf(tmax[h], x);
          }
        }
      }
      float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(FULL, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(FULL, tmax[h], 2));
        const float m_new = fmaxf(m[h], tmax[h]);
        corr[h] = m_new == -INFINITY ? 1.0f : ex2(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          rsum[h] += sc[nt][e] == -INFINITY ? 0.0f : ex2(sc[nt][e] - m[h]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rsum[h];
    } else {
      // dP = dO V^T, then dS = P (dP - D) where allowed, in registers
      float dp[KT / 8][4];
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = 0.0f;
      rows_dot<KT>(dp, dw, v_s + slot * KT * ld, ld, hd, lane);
      if (full) {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            sc[nt][e] = ex2(sc[nt][e] * sl2 - m[h]) * inv_l[h] *
                        (dp[nt][e] - Dp[h]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt) {
          const int2 kp2 =
              *reinterpret_cast<const int2*>(kpt + nt * 8 + t4 * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, j = nt * 8 + t4 * 2 + (e & 1);
            float ds = 0.0f;
            if (t0 + j < vis[h] &&
                allowed((e & 1) ? kp2.y : kp2.x, qp[h], window, prefix_len))
              ds = ex2(sc[nt][e] * sl2 - m[h]) * inv_l[h] *
                   (dp[nt][e] - Dp[h]);
            sc[nt][e] = ds;
          }
        }
      }
      // dQ += dS K (K through ldmatrix.trans)
      frag_times_rows<KT, NDT>(acc, sc, kt, ld, hd, lane);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pr[h] >= NP) continue;
    bf16* dr = dq + pair_row(b, kvh, pr[h], Sq, KV, G) * hd;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      if (dt * 8 < hd)
        *reinterpret_cast<__nv_bfloat162*>(dr + dt * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc[dt][2 * h] * scale,
                                  acc[dt][2 * h + 1] * scale);
  }
}

// A block: BM keys of one (b, kv head), 16 a warp (keys as M); QT pairs a
// query tile, ST tiles in flight.  Grid (B * KV, key tiles): the earliest
// keys (the most query tiles) of every (b, kv head) first.  The tiles of
// pairs walk all G heads in pair order, each with its pairs' m, 1 / l, D,
// positions and visit ends; a tile is skipped when the dq kernel's M tile
// holding it visits none of the block's keys (its terms would all be
// zero), and a warp whose 16 keys every pair of the tile visits and is
// allowed to see (by that M tile's record) skips the per-element masks.
template <int NDT, int QT, int ST, int HD>
__global__ void __launch_bounds__(MW * 32, 2)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kvpos, const bf16* __restrict__ dout,
                const float* __restrict__ m_in,
                const float* __restrict__ il_in,
                const float* __restrict__ D_in,
                const int* __restrict__ vis_in,
                const int4* __restrict__ tile_rec, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int Sq, int T, int KV, int G,
                int hd_arg, int window, int prefix_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = HD ? HD : hd_arg;
  const int ld = hd + 8;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // BM x ld
  bf16* v_s = k_s + BM * ld;                        // BM x ld
  bf16* q_s = v_s + BM * ld;                        // ST x QT x ld
  bf16* do_s = q_s + ST * QT * ld;                  // ST x QT x ld
  float* m_s = reinterpret_cast<float*>(do_s + ST * QT * ld);   // ST x QT
  float* il_s = m_s + ST * QT;                      // ST x QT: 1 / l
  float* d_s = il_s + ST * QT;                      // ST x QT
  int* qp_s = reinterpret_cast<int*>(d_s + ST * QT);            // ST x QT
  int* vis_s = qp_s + ST * QT;                                  // ST x QT
  int4* rec_s = reinterpret_cast<int4*>(vis_s + ST * QT);      // ST

  const int NP = Sq * G;
  const int bk = blockIdx.x, b = bk / KV, kvh = bk - b * KV;
  const int j0 = blockIdx.y * BM;          // earliest keys first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int* qpos_b = qpos + static_cast<size_t>(b) * Sq;
  const float sl2 = scale * LOG2E;
  const int n_mt = (NP + BM - 1) / BM;
  const int4* rec_b = tile_rec + static_cast<size_t>(bk) * n_mt;

  // the block's K and V rows (zero past T), in the first tile's group
  const int cpr = hd / 8;
  for (int i = tid; i < BM * cpr; i += MW * 32) {
    const int jj = i / cpr, c = i - jj * cpr, j = j0 + jj;
    const size_t off =
        j < T ? ((static_cast<size_t>(b) * T + j) * KV + kvh) * hd + c * 8
              : 0;
    cp_async16(k_s + jj * ld + c * 8, k + off, j < T);
    cp_async16(v_s + jj * ld + c * 8, v + off, j < T);
  }
  int jk[2], kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    jk[h] = j0 + warp * 16 + gq + 8 * h;
    kp[h] = jk[h] < T ? kvpos[static_cast<size_t>(b) * T + jk[h]] : 0;
  }
  // the warp's 16 keys: smallest and largest position
  const int w_klo = __reduce_min_sync(FULL, min(kp[0], kp[1]));
  const int w_khi = __reduce_max_sync(FULL, max(kp[0], kp[1]));
  const int w_end = j0 + warp * 16 + 16;

  const int n_pt = (NP + QT - 1) / QT;
  // the first tile at or after t whose M tile visits a key of the block
  // (the same value in every thread: no barrier)
  auto next_tile = [&](int t) {
    while (t < n_pt && rec_b[t * QT / BM].x <= j0) ++t;
    return t;
  };
  // tile t into slot `slot`: Q and dO rows and the pairs' stats, zero past
  // NP (visit end 0: no key)
  auto stage = [&](int t, int slot) {
    const int p0 = t * QT;
    for (int i = tid; i < QT * cpr; i += MW * 32) {
      const int pp = i / cpr, c = i - pp * cpr, p = p0 + pp;
      const size_t off = p < NP ? pair_row(b, kvh, p, Sq, KV, G) * hd + c * 8
                                : 0;
      cp_async16(q_s + (slot * QT + pp) * ld + c * 8, q + off, p < NP);
      cp_async16(do_s + (slot * QT + pp) * ld + c * 8, dout + off, p < NP);
    }
    for (int pp = tid; pp < QT; pp += MW * 32) {
      const int p = p0 + pp, at = slot * QT + pp;
      const bool ok = p < NP;
      const size_t row = ok ? pair_row(b, kvh, p, Sq, KV, G) : 0;
      cp_async4(m_s + at, m_in + row, ok);
      cp_async4(il_s + at, il_in + row, ok);
      cp_async4(d_s + at, D_in + row, ok);
      cp_async4(vis_s + at, vis_in + row, ok);
      cp_async4(qp_s + at, qpos_b + (ok ? p / G : 0), ok);
    }
    if (tid == 0) cp_async16(rec_s + slot, rec_b + t * QT / BM, true);
  };

  float acc_k[NDT][4], acc_v[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[dt][e] = 0.0f;
      acc_v[dt][e] = 0.0f;
    }
  const bf16* kw = k_s + warp * 16 * ld;
  const bf16* vw = v_s + warp * 16 * ld;

  int t_cur = next_tile(0), t_stage = t_cur;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {       // the first ST - 1 tiles
    if (t_stage < n_pt) {
      stage(t_stage, s);
      t_stage = next_tile(t_stage + 1);
    }
    cp_async_commit();
  }
  for (int i = 0; t_cur < n_pt; ++i) {
    cp_async_wait<ST - 2>();               // tile i's group has landed
    __syncthreads();                       // and tile i - 1's slot is free
    if (t_stage < n_pt) {
      stage(t_stage, (i + ST - 1) % ST);
      t_stage = next_tile(t_stage + 1);
    }
    cp_async_commit();
    const int slot = i % ST;
    const bf16* qt = q_s + slot * QT * ld;
    const bf16* dot = do_s + slot * QT * ld;
    const int at = slot * QT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QT pairs a warp
    float sc[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = 0.0f;
        dp[nt][e] = 0.0f;
      }
    rows_dot<QT>(sc, kw, qt, ld, hd, lane);
    rows_dot<QT>(dp, vw, dot, ld, hd, lane);

    // P^T and dS^T in registers: P = 2^(s - m) / l over the visited keys
    const int4 rec = rec_s[slot];
    const bool full = w_end <= rec.y && w_khi <= rec.z &&
                      (!window || rec.w - w_klo < window);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
      const int pp = at + nt * 8 + t4 * 2;
      const float2 m2 = *reinterpret_cast<const float2*>(m_s + pp);
      const float2 il2 = *reinterpret_cast<const float2*>(il_s + pp);
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + pp);
      const int2 qp2 = *reinterpret_cast<const int2*>(qp_s + pp);
      const int2 vis2 = *reinterpret_cast<const int2*>(vis_s + pp);
      if (full) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const float pr = ex2(sc[nt][e] * sl2 - (c ? m2.y : m2.x)) *
                           (c ? il2.y : il2.x);
          dp[nt][e] = pr * (dp[nt][e] - (c ? d2.y : d2.x));
          sc[nt][e] = pr;
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = e & 1;
        float pr = 0.0f, ds = 0.0f;
        if (jk[h] < (c ? vis2.y : vis2.x)) {
          const bool ok =
              allowed(kp[h], c ? qp2.y : qp2.x, window, prefix_len);
          pr = ex2((ok ? sc[nt][e] * sl2 : NEG) - (c ? m2.y : m2.x)) *
               (c ? il2.y : il2.x);
          if (ok) ds = pr * (dp[nt][e] - (c ? d2.y : d2.x));
        }
        sc[nt][e] = pr;
        dp[nt][e] = ds;
      }
    }
    // dV += P^T dO and dK += dS^T Q (dO and Q through ldmatrix.trans)
    frag_times_rows<QT, NDT>(acc_v, sc, dot, ld, hd, lane);
    frag_times_rows<QT, NDT>(acc_k, dp, qt, ld, hd, lane);
    t_cur = next_tile(t_cur + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (jk[h] >= T) continue;
    const size_t r = ((static_cast<size_t>(b) * T + jk[h]) * KV + kvh) * hd;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      if (dt * 8 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + r + dt * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc_k[dt][2 * h] * scale,
                                  acc_k[dt][2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + r + dt * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc_v[dt][2 * h], acc_v[dt][2 * h + 1]);
      }
  }
}

// NDT n8 tiles of output columns (hd <= 8 NDT); KT keys a dq tile, QT
// pairs a dk/dv tile; ST tiles in flight; HD the head dimension where it
// is fixed at compile time (loops unrolled whole), else 0
template <int NDT, int KT, int QT, int ST, int HD>
int launch_mma(void* q, void* k, void* v, void* qpos, void* kvpos, void* o,
               void* dout, void* dq, void* dk, void* dv, void* m_buf,
               void* l_buf, void* d_buf, void* vis_buf, void* tile_buf,
               int B, int Sq, int T, int KV, int G, int hd, int window,
               int prefix_len, cudaStream_t stream) {
  const int rows = max(1, min(Sq, 16 / G));
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const int ld = hd + 8;
  const size_t smem_dq = sizeof(bf16) * (2 * BM + 2 * ST * KT) * ld +
                         sizeof(int) * ST * KT;
  const size_t smem_kv = sizeof(bf16) * (2 * BM + 2 * ST * QT) * ld +
                         sizeof(float) * ST * QT * 5 + sizeof(int4) * ST;
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma_kernel<NDT, KT, ST, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_mma_kernel<NDT, QT, ST, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NP = Sq * G;
  const dim3 grid_q(B * KV, (NP + BM - 1) / BM);
  dq_mma_kernel<NDT, KT, ST, HD><<<grid_q, MW * 32, smem_dq, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(m_buf), static_cast<float*>(l_buf),
      static_cast<float*>(d_buf), static_cast<int*>(vis_buf),
      static_cast<int4*>(tile_buf), Sq, T, KV, G, hd, rows, window,
      prefix_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(B * KV, (T + BM - 1) / BM);
  dkdv_mma_kernel<NDT, QT, ST, HD><<<grid_kv, MW * 32, smem_kv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<const bf16*>(dout),
      static_cast<const float*>(m_buf), static_cast<const float*>(l_buf),
      static_cast<const float*>(d_buf), static_cast<const int*>(vis_buf),
      static_cast<const int4*>(tile_buf), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, T, KV, G, hd, window, prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
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

// mma form: bf16 q, k, v, o, do, dq, dk, dv; hd % 16 == 0, hd <= 128,
// G <= 32.  Scratch, written by the dq kernel, read by the dk/dv kernel:
// m_buf, l_buf, d_buf f32 and vis_buf int32, B * Sq * KV * G each (a
// pair's m in log2 units, 1 / l, rowsum(do * o) and visit end); tile_buf
// int4, B * KV * ceil(Sq * G / 64), 16-byte aligned (each 64-pair tile's
// largest and smallest visit end, smallest and largest position).
extern "C" int flash_attention_bwd_mma_launch(
    void* q, void* k, void* v, void* qpos, void* kvpos, void* o, void* dout,
    void* dq, void* dk, void* dv, void* m_buf, void* l_buf, void* d_buf,
    void* vis_buf, void* tile_buf, int B, int Sq, int T, int KV, int G,
    int hd, int window, int prefix_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 16 || hd > MMA_MAX_HD || hd % 16 != 0 || G < 1 ||
      G > MMA_MAX_G || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define FA_BWD_MMA(NDT, KT, QT, HD)                                         \
  launch_mma<NDT, KT, QT, 3, HD>(q, k, v, qpos, kvpos, o, dout, dq, dk, dv, \
                                 m_buf, l_buf, d_buf, vis_buf, tile_buf, B, \
                                 Sq, T, KV, G, hd, window, prefix_len, s)
  if (hd == 64) return FA_BWD_MMA(8, 64, 64, 64);       // smollm, llama
  if (hd == 128) return FA_BWD_MMA(16, 32, 32, 128);
  if (hd <= 32) return FA_BWD_MMA(4, 64, 64, 0);
  if (hd <= 64) return FA_BWD_MMA(8, 64, 64, 0);
  return FA_BWD_MMA(16, 32, 32, 0);
#undef FA_BWD_MMA
}
