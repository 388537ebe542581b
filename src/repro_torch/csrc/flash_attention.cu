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
//     with no allowed key averages V over the keys it visited;
//   * an online softmax with f32 m, l and o; p is rounded to v's type
//     before the PV product (as the oracle's p.astype(v.dtype)) while l
//     sums the unrounded p; out = o / max(l, 1e-30) in q's type.
// q and k/v are f32 or bf16, independently (the served model computes in
// bf16 while an engine may keep its cache in f32).
//
// The keys a row visits are the same in every form: slots [0, vis) with
// vis = min(n * 32, T), n = min((hi + 32) / 32 + 1, ceil(T / 32)), hi the
// largest non-sentinel query position of the row's group of
// rows = max(1, min(Sq, 16 / G)) query rows (the SIMT form's query tile;
// the TPU kernel's bound), raised to cover the prefix when prefix_len !=
// 0.  The bound assumes slot order = position order, which holds for a
// global cache and for a ring that has not wrapped; once decode passes a
// window, hi >= T and every slot is visited.  A slot past vis, or past
// T, scores -inf and contributes nothing (not even to l).
//
// What bounds it on the H100: the bytes of q, o and the visited k/v over
// 3.35 TB/s, against 4 B H Sq T_visited hd flops over 989 TFLOP/s of bf16
// tensor-core rate.  Prefill at Sq ~ 1000 is flop-bound by that measure
// (0.0023 ms at the served shape); decode (Sq = 1) is byte-bound (0.0011
// ms), and in practice bound by latency: a few dependent loads a block
// and two launches.  Three forms, one C entry each, chosen by
// ops.flash_form (kernels/flash_attention/ops.py):
//
// * split (Sq * G <= 32: every decode tick; any type pair).  The key axis
//   is cut into splits of whole 32-key tiles, about one block an SM (33
//   splits of 32 keys at B = 4, T = 1056: 132 blocks); a block reads its
//   chunk of one kv head's cache once for all G query heads and every
//   query row and writes f32 partials (m, l, o); a split past a row's
//   visited keys writes m = -inf, l = 0.  A second kernel merges the
//   splits (combine_kernel): weights exp(m_i - M), 0 for m_i = -inf, sums
//   in one fixed order, no atomics, so two calls give equal bits.  The
//   partials come from the mma kernel below with one 32-pair M tile where
//   q and k/v are bf16 and hd % 16 == 0 (the served decode), else from
//   split_kernel: 288 threads, 32-key K/V tiles double-buffered by
//   cp.async (16 B a lane; scalar loads where hd % 8 != 0) into rows
//   padded to 16 (mod 32) bytes, so 8 lanes reading 16 B of 8 rows hit
//   distinct banks; 8 lanes a key score it against every pair (each K
//   unit read once for all pairs) and sum by shuffles; a pair's warp
//   holds its m and l; the PV product by (pair, 8 columns, key class)
//   items, the key classes summed by shuffles once the split is done.
// * mma (Sq * G > 32, q and k/v bf16, hd % 16 == 0: prefill of the
//   served model).  (query row, group) pairs of one kv head are packed
//   into M, 16 a warp (64 a block), so every K/V tile feeds all G heads;
//   grid (M tiles, B * KV, key splits), the latest query rows (most keys)
//   first, the keys cut into as few splits as give about two blocks an
//   SM.  Q (M x hd) and double-buffered 32-key K and V tiles (and their
//   positions) arrive by cp.async and stay in shared memory as bf16, rows
//   of 2 hd + 16 bytes (conflict-free for ldmatrix); S = Q K^T and
//   O += P V run on mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with
//   ldmatrix fragments (V through ldmatrix.trans), the online softmax on
//   the S fragments in registers, P rounded to bf16 as the A operand, O
//   (16 x hd f32, 144 registers a thread at hd = 288) in registers.  More
//   than one split writes the partials, merged by combine_kernel.
// * simt (every other case: f32 or mixed prefill, hd % 16 != 0, and the
//   shapes past the other forms' limits: G > 32 or hd > 288, as MLA's
//   latent attention with G = 128, hd = 576).  One block per (b * KV + kv
//   head, tile of `rows` query rows, slice of the groups), one warp per
//   (query row, group) pair: all G groups in one block where rows * G
//   warps fit (32 at hd <= 288, 16 above), else slices of 16 groups, each
//   block reading the K/V tiles for its own slice; 32-key K/V tiles
//   staged as f32 in dynamic shared memory (rows padded to hd + 1
//   floats), lane j scores key j, the tile's max and sum by warp shuffles
//   (the sum broadcast from lane 0), lane c owns output columns c, c + 32,
//   ... for the PV product (9 a lane up to hd = 288, 18 up to 576).
//
// ptxas (sm_90a, CUDA 12.8), registers a thread, no spills in any form:
// mma_kernel 242 (4 warps) / 243 (2 warps); split_kernel 138 (bf16 q and
// k/v), 166 (other pairs); combine_kernel 32; flash_kernel (simt, 9
// columns a lane) 59-60.
// Shared memory above 48 KB is dynamic: each launch raises the kernel's
// limit first and reports a refused launch through cudaGetLastError.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KB = 32;               // keys a tile
constexpr int MAX_HD = 288;          // split and mma forms; simt: 9 columns a lane
constexpr int SIMT_MAX_HD = 576;     // simt: 18 columns a lane
constexpr int SIMT_MAX_G = 128;
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

// butterfly sum, then lane 0's value everywhere (the lanes' sums may
// differ in the last bits: they pair the terms in different orders)
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

// key tiles below the causal bound of query rows [r0, r1) (see the head)
__device__ __forceinline__ int visit_tiles(const int* __restrict__ qpos_b,
                                           int r0, int r1, int T,
                                           int prefix_len) {
  int hi = -1;
  for (int i = r0; i < r1; ++i) {
    const int p = qpos_b[i];
    if (p < POS_VALID) hi = max(hi, p);
  }
  if (prefix_len) hi = max(hi, prefix_len - 1);
  return min((hi + KB) / KB + 1, (T + KB - 1) / KB);
}

// slots row r visits: those of its group of `rows` query rows
__device__ __forceinline__ int visit_end(const int* __restrict__ qpos_b,
                                         int r, int Sq, int rows, int T,
                                         int prefix_len) {
  const int r0 = r / rows * rows;
  return min(visit_tiles(qpos_b, r0, min(r0 + rows, Sq), T, prefix_len) * KB,
             T);
}

// A block of keys: the k/v a call is given hold global slots [offset,
// offset + T) of a cache of T_total slots (a rank's block of a cache split
// by length); the bound above counts global slots.  The local slots a
// global visit end `e` leaves: [0, min(max(e - offset, 0), T)).
__device__ __forceinline__ int local_end(int e, int offset, int T) {
  return min(max(e - offset, 0), T);
}

// ------------------------------------------------------------ simt form --

// NC output columns a lane (hd <= 32 NC); GB groups a block (blockIdx.z
// takes groups [GB z, GB z + GB))
template <typename TQ, typename TKV, int NC>
__global__ void flash_kernel(const TQ* __restrict__ q,
                             const TKV* __restrict__ k,
                             const TKV* __restrict__ v,
                             const int* __restrict__ qpos,
                             const int* __restrict__ kvpos,
                             TQ* __restrict__ out,
                             float* __restrict__ m_part,
                             float* __restrict__ l_part,
                             float* __restrict__ o_part, int Sq, int T,
                             int KV, int G, int GB, int hd, int rows,
                             int window, int prefix_len, float scale,
                             int offset, int T_total) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int ldk = hd + 1;
  float* k_s = smem;                         // KB x (hd + 1)
  float* v_s = k_s + KB * ldk;               // KB x hd
  float* q_s = v_s + KB * hd;                // nwarps x hd
  int* kp_s = reinterpret_cast<int*>(q_s + nwarps * hd);   // KB
  __shared__ int vis_s;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int r0 = blockIdx.y * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = r0 + warp / GB, g = blockIdx.z * GB + warp % GB;
  const bool active = r < Sq && g < G;

  if (threadIdx.x == 0)
    vis_s = local_end(
        min(visit_tiles(qpos + b * Sq, r0, min(r0 + rows, Sq), T_total,
                        prefix_len) * KB, T_total),
        offset, T);
  const size_t qoff = ((static_cast<size_t>(b) * Sq + r) * KV + kvh) * G + g;
  if (active)
    for (int d = lane; d < hd; d += 32)
      q_s[warp * hd + d] = to_f(q[qoff * hd + d]);
  __syncthreads();
  const int vis = vis_s;                     // local slots visited
  const int n_tiles = (vis + KB - 1) / KB;
  const int qp = active ? qpos[b * Sq + r] : 0;

  float m = -INFINITY, l = 0.0f;
  float o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * KB;
    const int nk = min(KB, vis - t0);
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
      s = allowed(kp_s[lane], qp, window, prefix_len) ? acc * scale : NEG;
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

  if (active && m_part != nullptr) {
    // partials: one split, the split form's layout (row (b * KV + kv
    // head) * Sq * G + pair), o unnormalized
    const size_t prow =
        (static_cast<size_t>(blockIdx.x) * Sq + r) * G + g;
    if (lane == 0) {
      m_part[prow] = m;
      l_part[prow] = l;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o_part[prow * hd + d] = o[c];
    }
  } else if (active) {
    const float den = fmaxf(l, 1e-30f);
    TQ* orow = out + qoff * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = from_f<TQ>(o[c] / den);
    }
  }
}

template <typename TQ, typename TKV, int NC>
int launch_simt_nc(void* q, void* k, void* v, void* qpos, void* kvpos,
                   void* out, void* m_part, void* l_part, void* o_part,
                   int B, int Sq, int T, int KV, int G, int hd, int window,
                   int prefix_len, int offset, int T_total,
                   cudaStream_t stream) {
  // rows * G warps a block: about 16 warps, at least one query row; where
  // that passes the warps a block holds (32, or 16 at 18 columns a lane:
  // the register file), slices of 16 groups
  const int rows = max(1, min(Sq, 16 / G));
  const int max_warps = NC > MAX_HD / 32 ? 16 : 32;
  const int GB = rows * G <= max_warps ? G : 16;
  const int nwarps = rows * GB;
  const size_t smem =
      sizeof(float) * (KB * (hd + 1) + KB * hd + nwarps * hd) +
      sizeof(int) * KB;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<TQ, TKV, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * KV, (Sq + rows - 1) / rows, (G + GB - 1) / GB);
  flash_kernel<TQ, TKV, NC><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<TQ*>(out),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(o_part), Sq, T, KV, G, GB, hd, rows, window,
      prefix_len, 1.0f / sqrtf(static_cast<float>(hd)), offset, T_total);
  return static_cast<int>(cudaGetLastError());
}

// out, or (m_part != nullptr) the partials of one split
template <typename TQ, typename TKV>
int launch_simt(void* q, void* k, void* v, void* qpos, void* kvpos,
                void* out, void* m_part, void* l_part, void* o_part, int B,
                int Sq, int T, int KV, int G, int hd, int window,
                int prefix_len, int offset, int T_total,
                cudaStream_t stream) {
  if (hd > SIMT_MAX_HD || G > SIMT_MAX_G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= MAX_HD)
    return launch_simt_nc<TQ, TKV, MAX_HD / 32>(
        q, k, v, qpos, kvpos, out, m_part, l_part, o_part, B, Sq, T, KV, G,
        hd, window, prefix_len, offset, T_total, stream);
  return launch_simt_nc<TQ, TKV, SIMT_MAX_HD / 32>(
      q, k, v, qpos, kvpos, out, m_part, l_part, o_part, B, Sq, T, KV, G,
      hd, window, prefix_len, offset, T_total, stream);
}

// ------------------------------------------------ asynchronous copies --

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

// shared-memory elements a row: hd rounded up to 8, padded so that the row
// is 16 (mod 32) bytes: 8 lanes reading 16 B of 8 successive rows, or
// ldmatrix reading 8 rows, hit distinct banks
__host__ __device__ __forceinline__ int smem_ld(int hd8, int esize) {
  return hd8 + ((hd8 * esize) % 32 == 0 ? 16 : 32) / esize;
}

// KB rows of hd8 columns into dst (row stride ld) from src (row stride
// `stride`); rows >= n_valid and columns in [hd, hd8) are zero.  `vec`:
// hd % 8 == 0 and 16-byte aligned rows, so 16-byte cp.async chunks.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld,
                                           const T* __restrict__ src,
                                           size_t stride, int n_valid,
                                           int hd, int hd8, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = hd / E;
    for (int i = threadIdx.x; i < KB * cpr; i += blockDim.x) {
      const int j = i / cpr, c = i - j * cpr;
      const bool ok = j < n_valid;
      cp_async16(dst + j * ld + c * E, ok ? src + j * stride + c * E : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < KB * hd8; i += blockDim.x) {
      const int j = i / hd8, d = i - j * hd8;
      dst[j * ld + d] =
          (j < n_valid && d < hd) ? src[j * stride + d] : from_f<T>(0.0f);
    }
  }
}

// 8 values from shared memory (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// ----------------------------------------------- split form (decode) --

constexpr int SPLIT_THREADS = 288;       // 9 warps
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int SCORE_WARPS = 8;           // 4 keys a warp, 8 lanes a key
constexpr int SPLIT_MAX_PAIRS = 32;      // Sq * G a block holds
constexpr int S_SLOTS =                  // pairs a warp's softmax holds
    (SPLIT_MAX_PAIRS + SPLIT_WARPS - 1) / SPLIT_WARPS;
constexpr int O_SLOTS =                  // PV items a thread holds
    (SPLIT_MAX_PAIRS * MAX_HD / 8 + SPLIT_THREADS - 1) / SPLIT_THREADS;

// Partials: row (b * KV + kv head) * Sq * G + pair, split s at
// [row * n_split + s] of m_part and l_part, [(row * n_split + s) * hd] of
// o_part; pair = query row * G + group.
//
// A tile of 32 keys in three phases, each closed by a barrier:
//   scores — warps 0-7, lane 8 j' + c' of warp w takes key 4 w + j' and
//     16-byte column units c', c' + 8, ... for every pair (each K unit is
//     read once for all pairs), then the 8 lanes of a key sum by shuffles;
//   softmax — pair p's online state lives in warp p % 9, one key a lane;
//   PV — item (pair, unit of 8 columns, key class ks < KS) sums keys
//     ks, ks + KS, ...; KS in {1, 2, 4, 8} spreads the items over the 288
//     threads (KS = 2 at 4 pairs and hd = 288), and the KS lanes of an
//     item sum by shuffles once the split is done.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kvpos, float* __restrict__ m_part,
             float* __restrict__ l_part, float* __restrict__ o_part, int Sq,
             int T, int KV, int G, int hd, int rows, int window,
             int prefix_len, float scale, int keys_per_split, int vec,
             int offset, int T_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int vis_s[SPLIT_MAX_PAIRS], qp_s[SPLIT_MAX_PAIRS];
  __shared__ int blk_vis_s;
  const int NP = Sq * G;
  const int hd8 = (hd + 7) & ~7;
  const int ldq = smem_ld(hd8, sizeof(TQ));
  const int ldkv = smem_ld(hd8, sizeof(TKV));
  TKV* k_s = reinterpret_cast<TKV*>(smem_raw);           // 2 x KB x ldkv
  TKV* v_s = k_s + 2 * KB * ldkv;                          // 2 x KB x ldkv
  TQ* q_s = reinterpret_cast<TQ*>(v_s + 2 * KB * ldkv);   // NP x ldq
  float* s_s = reinterpret_cast<float*>(q_s + NP * ldq);  // NP x KB
  float* p_s = s_s + NP * KB;                              // NP x KB
  float* corr_s = p_s + NP * KB;                           // NP
  int* kp_s = reinterpret_cast<int*>(corr_s + NP);        // 2 x KB

  const int bk = blockIdx.x, b = bk / KV, kvh = bk - b * KV;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* qpos_b = qpos + static_cast<size_t>(b) * Sq;

  if (tid == 0) blk_vis_s = 0;
  __syncthreads();
  if (tid < NP) {
    const int e = local_end(
        visit_end(qpos_b, tid / G, Sq, rows, T_total, prefix_len), offset,
        T);
    vis_s[tid] = e;
    qp_s[tid] = qpos_b[tid / G];
    atomicMax(&blk_vis_s, e);
  }
  __syncthreads();
  const int k_lo = split * keys_per_split;
  const int k_hi = min(k_lo + keys_per_split, blk_vis_s);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + KB - 1) / KB : 0;
  const int n_units = hd8 / 8, n_items = NP * n_units;
  int KS = 8;
  while (KS > 1 && n_items * KS > SPLIT_THREADS) KS >>= 1;

  float m[S_SLOTS], l[S_SLOTS];
  float o[O_SLOTS][8];
#pragma unroll
  for (int i = 0; i < S_SLOTS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < O_SLOTS; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.0f;

  if (n_tiles > 0) {
    // q of every pair, in the first tile's copy group where rows allow
    constexpr int EQ = 16 / sizeof(TQ);
    const int cols = vec ? hd / EQ : hd8;
    for (int i = tid; i < NP * cols; i += SPLIT_THREADS) {
      const int p = i / cols, c = i - p * cols;
      const int r = p / G, g = p - r * G;
      const TQ* src =
          q + (((static_cast<size_t>(b) * Sq + r) * KV + kvh) * G + g) * hd;
      if (vec)
        cp_async16(q_s + p * ldq + c * EQ, src + c * EQ, true);
      else
        q_s[p * ldq + c] = c < hd ? src[c] : from_f<TQ>(0.0f);
    }
    const size_t stride = static_cast<size_t>(KV) * hd;
    const TKV* kb = k + (static_cast<size_t>(b) * T * KV + kvh) * hd;
    const TKV* vb = v + (static_cast<size_t>(b) * T * KV + kvh) * hd;
    auto stage = [&](int t, int buf) {
      const int t0 = k_lo + t * KB, n_valid = min(KB, k_hi - t0);
      stage_rows(k_s + buf * KB * ldkv, ldkv, kb + t0 * stride, stride,
                 n_valid, hd, hd8, vec);
      stage_rows(v_s + buf * KB * ldkv, ldkv, vb + t0 * stride, stride,
                 n_valid, hd, hd8, vec);
      // positions of keys past n_valid are never read (they score -inf)
      if (tid < KB)
        cp_async4(kp_s + buf * KB + tid,
                  kvpos + static_cast<size_t>(b) * T + t0 + tid,
                  tid < n_valid);
      cp_async_commit();
    };

    stage(0, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < n_tiles) {
        stage(t + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = k_lo + t * KB, nk = min(KB, k_hi - t0);
      const TKV* kt = k_s + buf * KB * ldkv;
      const TKV* vt = v_s + buf * KB * ldkv;

      if (warp < SCORE_WARPS) {
        const int j = warp * 4 + (lane >> 3), c0 = lane & 7;
        float acc[SPLIT_MAX_PAIRS];
#pragma unroll
        for (int p = 0; p < SPLIT_MAX_PAIRS; ++p) acc[p] = 0.0f;
        for (int c = c0; c < n_units; c += 8) {
          float kx[8];
          load8(kt + j * ldkv + c * 8, kx);
#pragma unroll
          for (int p = 0; p < SPLIT_MAX_PAIRS; ++p) {
            if (p < NP) {
              float qx[8];
              load8(q_s + p * ldq + c * 8, qx);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[p] = fmaf(qx[e], kx[e], acc[p]);
            }
          }
        }
        const int kp = kp_s[buf * KB + j];
#pragma unroll
        for (int p = 0; p < SPLIT_MAX_PAIRS; ++p) {
          if (p < NP) {
            float a = acc[p];
            a += __shfl_xor_sync(FULL, a, 1);
            a += __shfl_xor_sync(FULL, a, 2);
            a += __shfl_xor_sync(FULL, a, 4);
            if (c0 == 0) {
              float sc = -INFINITY;
              if (j < nk && t0 + j < vis_s[p])
                sc = allowed(kp, qp_s[p], window, prefix_len) ? a * scale
                                                              : NEG;
              s_s[p * KB + j] = sc;
            }
          }
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < S_SLOTS; ++i) {
        const int p = warp + SPLIT_WARPS * i;
        if (p >= NP) break;
        const float sc = s_s[p * KB + lane];
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float pe = sc == -INFINITY ? 0.0f : expf(sc - m_new);
        const float corr = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(pe);
        m[i] = m_new;
        p_s[p * KB + lane] = to_f(from_f<TKV>(pe));   // p in v's type
        if (lane == 0) corr_s[p] = corr;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < O_SLOTS; ++i) {
        const int item = tid + i * SPLIT_THREADS;
        if (item < n_items * KS) {
          const int pc = item / KS, ks = item - pc * KS;
          const int p = pc / n_units, u = (pc - p * n_units) * 8;
          const float cr = corr_s[p];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[i][e] *= cr;
          for (int j = ks; j < nk; j += KS) {
            const float pj = p_s[p * KB + j];
            float x[8];
            load8(vt + j * ldkv + u, x);
#pragma unroll
            for (int e = 0; e < 8; ++e) o[i][e] = fmaf(pj, x[e], o[i][e]);
          }
        }
      }
      __syncthreads();
    }
  }

  const size_t row0 = static_cast<size_t>(bk) * NP;
#pragma unroll
  for (int i = 0; i < S_SLOTS; ++i) {
    const int p = warp + SPLIT_WARPS * i;
    if (p < NP && lane == 0) {
      m_part[(row0 + p) * n_split + split] = m[i];
      l_part[(row0 + p) * n_split + split] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < O_SLOTS; ++i) {
    const int item = tid + i * SPLIT_THREADS;
    for (int off = 1; off < KS; off <<= 1)    // the KS lanes of an item
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[i][e] += __shfl_xor_sync(FULL, o[i][e], off);
    if (item < n_items * KS && item % KS == 0) {
      const int pc = item / KS, p = pc / n_units;
      const int u = (pc - p * n_units) * 8;
      float* op = o_part + ((row0 + p) * n_split + split) * hd;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (u + e < hd) op[u + e] = o[i][e];
    }
  }
}

// Merge the key splits of one (b * KV + kv head, pair) row: M = max m_i,
// weights exp(m_i - M) (0 for m_i = -inf, whose o is then not read),
// L = sum of w_i l_i, out = sum of w_i o_i / max(L, 1e-30) in q's type.
// Sums are taken in one fixed order (per thread in split order, then the
// warps' butterflies, then the warps in order; o over the splits with a
// weight, in split order), so calls repeat bitwise.
template <typename TQ>
__global__ void combine_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ o_part,
                               TQ* __restrict__ out, int Sq, int KV, int G,
                               int hd, int n_split) {
  extern __shared__ float w_s[];         // n_split weights, then indices
  int* idx_s = reinterpret_cast<int*>(w_s + n_split);
  __shared__ float red_s[32];
  __shared__ float max_s, den_s;
  __shared__ int n_idx_s;
  const int NP = Sq * G;
  const int row = blockIdx.x, bk = row / NP, p = row - bk * NP;
  const int b = bk / KV, kvh = bk - b * KV, r = p / G, g = p - r * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const float* mp = m_part + static_cast<size_t>(row) * n_split;
  const float* lp = l_part + static_cast<size_t>(row) * n_split;

  float x = -INFINITY;
  for (int s = tid; s < n_split; s += blockDim.x) {
    w_s[s] = mp[s];
    x = fmaxf(x, w_s[s]);
  }
  x = warp_max(x);
  if (lane == 0) red_s[warp] = x;
  __syncthreads();
  if (tid == 0) {
    float M = -INFINITY;
    for (int w = 0; w < nwarps; ++w) M = fmaxf(M, red_s[w]);
    max_s = M;
  }
  __syncthreads();
  const float M = max_s;
  x = 0.0f;
  for (int s = tid; s < n_split; s += blockDim.x) {
    const float w = w_s[s] == -INFINITY ? 0.0f : expf(w_s[s] - M);
    w_s[s] = w;
    x += w * lp[s];
  }
  x = warp_sum(x);
  __syncthreads();                       // red_s is read above
  if (lane == 0) red_s[warp] = x;
  __syncthreads();
  if (tid == 0) {
    float L = 0.0f;
    for (int w = 0; w < nwarps; ++w) L += red_s[w];
    den_s = fmaxf(L, 1e-30f);
  }
  if (warp == 0) {                       // the splits with a weight, in order
    int n = 0;
    for (int s0 = 0; s0 < n_split; s0 += 32) {
      const bool keep = s0 + lane < n_split && w_s[s0 + lane] != 0.0f;
      const unsigned mask = __ballot_sync(FULL, keep);
      if (keep) idx_s[n + __popc(mask & ((1u << lane) - 1))] = s0 + lane;
      n += __popc(mask);
    }
    if (lane == 0) n_idx_s = n;
  }
  __syncthreads();
  const float den = den_s;
  const int n_idx = n_idx_s;
  const float* op = o_part + static_cast<size_t>(row) * n_split * hd;
  TQ* orow = out + (((static_cast<size_t>(b) * Sq + r) * KV + kvh) * G + g)
                   * hd;
  for (int d = tid; d < hd; d += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n_idx; ++i) {
      const int s = idx_s[i];
      acc = fmaf(w_s[s], op[static_cast<size_t>(s) * hd + d], acc);
    }
    orow[d] = from_f<TQ>(acc / den);
  }
}

template <typename TQ>
int launch_combine(const float* m_part, const float* l_part,
                   const float* o_part, void* out, int B, int Sq, int KV,
                   int G, int hd, int n_split, cudaStream_t stream) {
  const int threads = min(1024, (hd + 31) / 32 * 32);   // a column each
  combine_kernel<TQ><<<B * KV * Sq * G, threads,
                       (sizeof(float) + sizeof(int)) * n_split, stream>>>(
      m_part, l_part, o_part, static_cast<TQ*>(out), Sq, KV, G, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_split(void* q, void* k, void* v, void* qpos, void* kvpos,
                 void* out, void* m_part, void* l_part, void* o_part, int B,
                 int Sq, int T, int KV, int G, int hd, int window,
                 int prefix_len, int keys_per_split, int n_split, int vec,
                 int offset, int T_total, bool combine,
                 cudaStream_t stream) {
  const int rows = max(1, min(Sq, 16 / G));
  const int NP = Sq * G, hd8 = (hd + 7) & ~7;
  const size_t smem =
      4 * KB * smem_ld(hd8, sizeof(TKV)) * sizeof(TKV) +
      NP * smem_ld(hd8, sizeof(TQ)) * sizeof(TQ) +
      sizeof(float) * (2 * NP * KB + NP) + sizeof(int) * 2 * KB;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* op = static_cast<float*>(o_part);
  split_kernel<TQ, TKV><<<dim3(B * KV, n_split), SPLIT_THREADS, smem,
                          stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), mp, lp, op, Sq, T, KV, G, hd, rows,
      window, prefix_len, 1.0f / sqrtf(static_cast<float>(hd)),
      keys_per_split, vec, offset, T_total);
  err = cudaGetLastError();
  if (err != cudaSuccess || !combine) return static_cast<int>(err);
  return launch_combine<TQ>(mp, lp, op, out, B, Sq, KV, G, hd, n_split,
                            stream);
}

// ------------------------------------------ mma form (bf16 prefill) --

constexpr int MAX_DT = MAX_HD / 8;       // n8 tiles of output columns

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

// NW warps, 16 (query row, group) pairs each.  A thread holds rows gq and
// gq + 8 of its warp's 16 (gq = lane / 4) and, of each n8 tile, columns
// 2 (lane % 4) and 2 (lane % 4) + 1: the mma accumulator layout.
template <int NW>
__global__ void __launch_bounds__(NW * 32)
mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ qpos,
           const int* __restrict__ kvpos, bf16* __restrict__ out,
           float* __restrict__ m_part, float* __restrict__ l_part,
           float* __restrict__ o_part, int Sq, int T, int KV, int G, int hd,
           int rows, int window, int prefix_len, float scale,
           int keys_per_split, int offset, int T_total, int partials) {
  constexpr int BM = 16 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int blk_vis_s;
  const int ld = hd + 8;                   // 2 hd + 16 bytes a row
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BM x ld
  bf16* k_s = q_s + BM * ld;                        // 2 x KB x ld
  bf16* v_s = k_s + 2 * KB * ld;                    // 2 x KB x ld
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * KB * ld);   // 2 x KB

  const int NP = Sq * G;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;   // latest rows first
  const int bk = blockIdx.y, b = bk / KV, kvh = bk - b * KV;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int* qpos_b = qpos + static_cast<size_t>(b) * Sq;

  int pr[2], qp[2], vis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pr[h] = m0 + warp * 16 + gq + 8 * h;
    const int r = pr[h] / G;
    qp[h] = pr[h] < NP ? qpos_b[r] : 0;
    vis[h] = pr[h] < NP
                 ? local_end(visit_end(qpos_b, r, Sq, rows, T_total,
                                       prefix_len), offset, T)
                 : 0;
  }
  if (tid == 0) blk_vis_s = 0;
  __syncthreads();
  atomicMax(&blk_vis_s, max(vis[0], vis[1]));
  __syncthreads();
  const int k_lo = split * keys_per_split;
  const int k_hi = min(k_lo + keys_per_split, blk_vis_s);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + KB - 1) / KB : 0;
  const int lim[2] = {min(vis[0], k_hi), min(vis[1], k_hi)};

  float o[MAX_DT][4];
#pragma unroll
  for (int dt = 0; dt < MAX_DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  if (n_tiles > 0) {
    const int cpr = hd / 8;                // 16-byte chunks a row
    for (int i = tid; i < BM * cpr; i += NW * 32) {
      const int rr = i / cpr, c = i - rr * cpr, p = m0 + rr;
      const bf16* src = q;
      if (p < NP) {
        const int r = p / G, g = p - r * G;
        src = q + (((static_cast<size_t>(b) * Sq + r) * KV + kvh) * G + g)
                  * hd + c * 8;
      }
      cp_async16(q_s + rr * ld + c * 8, src, p < NP);
    }
    const size_t stride = static_cast<size_t>(KV) * hd;
    const bf16* kb = k + (static_cast<size_t>(b) * T * KV + kvh) * hd;
    const bf16* vb = v + (static_cast<size_t>(b) * T * KV + kvh) * hd;
    auto stage = [&](int t, int buf) {
      const int t0 = k_lo + t * KB, n_valid = min(KB, k_hi - t0);
      for (int i = tid; i < KB * cpr; i += NW * 32) {
        const int j = i / cpr, c = i - j * cpr;
        const bool ok = j < n_valid;
        const size_t off = ok ? (t0 + j) * stride + c * 8 : 0;
        cp_async16(k_s + (buf * KB + j) * ld + c * 8, kb + off, ok);
        cp_async16(v_s + (buf * KB + j) * ld + c * 8, vb + off, ok);
      }
      // positions of keys past n_valid are never read (they score -inf)
      for (int j = tid; j < KB; j += NW * 32)
        cp_async4(kp_s + buf * KB + j,
                  kvpos + static_cast<size_t>(b) * T + t0 + j, j < n_valid);
      cp_async_commit();
    };

    const bf16* qw = q_s + warp * 16 * ld;
    stage(0, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < n_tiles) {
        stage(t + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = k_lo + t * KB;
      const bf16* kt = k_s + buf * KB * ld;
      const bf16* vt = v_s + buf * KB * ld;
      const int* kpt = kp_s + buf * KB;

      // S = Q K^T: 16 rows x KB keys a warp, KB / 8 n8 tiles
      float sc[KB / 8][4];
#pragma unroll
      for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
      for (int ks = 0; ks < hd; ks += 16) {
        unsigned a0, a1, a2, a3;
        ldsm_x4(a0, a1, a2, a3, qw + (lane & 15) * ld + ks + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          unsigned b0, b1, b2, b3;
          ldsm_x4(b0, b1, b2, b3,
                  kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld + ks
                      + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], a0, a1, a2, a3, b0, b1);
          mma_bf16(sc[2 * np + 1], a0, a1, a2, a3, b2, b3);
        }
      }

      // masks and the online softmax on the fragments
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = nt * 8 + t4 * 2 + (e & 1);
          float s = -INFINITY;
          if (t0 + j < lim[h])
            s = allowed(kpt[j], qp[h], window, prefix_len)
                    ? sc[nt][e] * scale : NEG;
          sc[nt][e] = s;
          tmax[h] = fmaxf(tmax[h], s);
        }
      float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(FULL, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(FULL, tmax[h], 2));
        const float m_new = fmaxf(m[h], tmax[h]);
        corr[h] = m_new == -INFINITY ? 1.0f : expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p =
              sc[nt][e] == -INFINITY ? 0.0f : expf(sc[nt][e] - m[h]);
          sc[nt][e] = p;
          rsum[h] += p;                    // l sums the unrounded p
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rsum[h];
#pragma unroll
      for (int dt = 0; dt < MAX_DT; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }

      // O += P V: P (bf16) from the S fragments as the A operand
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        const unsigned a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        const unsigned a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        const unsigned a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        const unsigned a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < MAX_DT / 2; ++dp) {
          if (dp * 16 < hd) {
            unsigned b0, b1, b2, b3;
            ldsm_x4_t(b0, b1, b2, b3,
                      vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                          + dp * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], a0, a1, a2, a3, b0, b1);
            mma_bf16(o[2 * dp + 1], a0, a1, a2, a3, b2, b3);
          }
        }
      }
      __syncthreads();                     // the buffer is consumed
    }
  }

  const int ndt = hd / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    if (pr[h] >= NP) continue;
    if (n_split == 1 && !partials) {
      const int r = pr[h] / G, g = pr[h] - r * G;
      bf16* orow =
          out + (((static_cast<size_t>(b) * Sq + r) * KV + kvh) * G + g) * hd;
      const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < MAX_DT; ++dt)
        if (dt < ndt)
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + t4 * 2) =
              __floats2bfloat162_rn(o[dt][2 * h] / den,
                                    o[dt][2 * h + 1] / den);
    } else {
      const size_t prow =
          (static_cast<size_t>(bk) * NP + pr[h]) * n_split + split;
      if (t4 == 0) {
        m_part[prow] = m[h];
        l_part[prow] = l[h];
      }
      // w = 0: the merge skips it (returned partials hold its zeros)
      if (m[h] == -INFINITY && !partials) continue;
      float* op = o_part + prow * hd;
#pragma unroll
      for (int dt = 0; dt < MAX_DT; ++dt)
        if (dt < ndt)
          *reinterpret_cast<float2*>(op + dt * 8 + t4 * 2) =
              make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
    }
  }
}

template <int NW>
int launch_mma(void* q, void* k, void* v, void* qpos, void* kvpos, void* out,
               void* m_part, void* l_part, void* o_part, int B, int Sq,
               int T, int KV, int G, int hd, int window, int prefix_len,
               int keys_per_split, int n_split, int offset, int T_total,
               bool partials, cudaStream_t stream) {
  constexpr int BM = 16 * NW;
  const int rows = max(1, min(Sq, 16 / G));
  const int NP = Sq * G;
  const size_t smem =
      sizeof(bf16) * (BM + 4 * KB) * (hd + 8) + sizeof(int) * 2 * KB;
  cudaError_t err = cudaFuncSetAttribute(
      mma_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* op = static_cast<float*>(o_part);
  const dim3 grid((NP + BM - 1) / BM, B * KV, n_split);
  mma_kernel<NW><<<grid, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<bf16*>(out), mp, lp, op,
      Sq, T, KV, G, hd, rows, window, prefix_len,
      1.0f / sqrtf(static_cast<float>(hd)), keys_per_split, offset, T_total,
      partials ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1 || partials)
    return static_cast<int>(err);
  return launch_combine<bf16>(mp, lp, op, out, B, Sq, KV, G, hd, n_split,
                              stream);
}

}  // namespace

// The wrapper (kernels/flash_attention/ops.py) checks 1 <= G <= 128,
// hd <= 576 (G <= 32 and hd <= 288 for the split and mma forms), Sq >= 1,
// T >= 1, contiguous 16-byte aligned tensors and each form's own
// conditions; q_bf16 / kv_bf16 select bf16 (1) or f32 (0).

// simt form
extern "C" int flash_attention_launch(void* q, void* k, void* v, void* qpos,
                                      void* kvpos, void* out, int B, int Sq,
                                      int T, int KV, int G, int hd,
                                      int window, int prefix_len, int q_bf16,
                                      int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_SIMT(TQ, TKV)                                                  \
  launch_simt<TQ, TKV>(q, k, v, qpos, kvpos, out, nullptr, nullptr,      \
                       nullptr, B, Sq, T, KV, G, hd, window, prefix_len, \
                       0, T, s)
  if (q_bf16 && kv_bf16) return FA_SIMT(bf16, bf16);
  if (q_bf16) return FA_SIMT(bf16, float);
  if (kv_bf16) return FA_SIMT(float, bf16);
  return FA_SIMT(float, float);
#undef FA_SIMT
}

// split form: Sq * G <= 32; partials of B * KV * Sq * G * n_split (m, l)
// and that times hd (o) floats; n_split = ceil(T / keys_per_split),
// keys_per_split a multiple of 32; vec: hd % 8 == 0.  Each split's
// partials come from the tensor-core kernel (one 32-pair M tile) where
// tensor_cores != 0, else from the FMA kernel.
extern "C" int flash_attention_split_launch(
    void* q, void* k, void* v, void* qpos, void* kvpos, void* out,
    void* m_part, void* l_part, void* o_part, int B, int Sq, int T, int KV,
    int G, int hd, int window, int prefix_len, int q_bf16, int kv_bf16,
    int keys_per_split, int n_split, int vec, int tensor_cores,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq * G > SPLIT_MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores) {   // bf16 q and k/v, hd % 16 == 0: one 32-pair M tile
    if (!(q_bf16 && kv_bf16) || hd % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma<2>(q, k, v, qpos, kvpos, out, m_part, l_part, o_part,
                         B, Sq, T, KV, G, hd, window, prefix_len,
                         keys_per_split, n_split, 0, T, false, s);
  }
#define FA_SPLIT(TQ, TKV)                                                   \
  launch_split<TQ, TKV>(q, k, v, qpos, kvpos, out, m_part, l_part, o_part, \
                        B, Sq, T, KV, G, hd, window, prefix_len,           \
                        keys_per_split, n_split, vec, 0, T, true, s)
  if (q_bf16 && kv_bf16) return FA_SPLIT(bf16, bf16);
  if (q_bf16) return FA_SPLIT(bf16, float);
  if (kv_bf16) return FA_SPLIT(float, bf16);
  return FA_SPLIT(float, float);
#undef FA_SPLIT
}

// mma form: bf16 q and k/v, hd % 16 == 0; warps 2 or 4 (32 or 64 pairs
// a block); partials as the split form's when n_split > 1
extern "C" int flash_attention_mma_launch(
    void* q, void* k, void* v, void* qpos, void* kvpos, void* out,
    void* m_part, void* l_part, void* o_part, int B, int Sq, int T, int KV,
    int G, int hd, int window, int prefix_len, int keys_per_split,
    int n_split, int warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (warps == 2)
    return launch_mma<2>(q, k, v, qpos, kvpos, out, m_part, l_part, o_part,
                         B, Sq, T, KV, G, hd, window, prefix_len,
                         keys_per_split, n_split, 0, T, false, s);
  if (warps == 4)
    return launch_mma<4>(q, k, v, qpos, kvpos, out, m_part, l_part, o_part,
                         B, Sq, T, KV, G, hd, window, prefix_len,
                         keys_per_split, n_split, 0, T, false, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Partials of a block of keys: k, v (B, T, KV, hd) and kv_pos (B, T) hold
// global slots [offset, offset + T) of a cache of T_total slots, and the
// visit bound counts global slots.  Writes, without merging, the f32
// partials m, l (B * KV * Sq * G * n_split) and o (that times hd) in the
// split form's layout: row (b * KV + kv head) * Sq * G + pair, split s at
// [row * n_split + s].  A split (or block) holding none of a row's visited
// keys writes m = -inf, l = 0, o = 0.  form 0: the simt form (one split,
// n_split = 1; any Sq, G <= 128, hd <= 576: MLA's decode); form 1: the
// split form (Sq * G <= 32, G <= 32, hd <= 288; n_split = ceil(T /
// keys_per_split); tensor_cores as flash_attention_split_launch's).
extern "C" int flash_attention_partials_launch(
    void* q, void* k, void* v, void* qpos, void* kvpos, void* m_part,
    void* l_part, void* o_part, int B, int Sq, int T, int KV, int G, int hd,
    int window, int prefix_len, int q_bf16, int kv_bf16, int offset,
    int T_total, int form, int keys_per_split, int n_split, int vec,
    int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offset < 0 || offset + T > T_total)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0) {
    if (n_split != 1) return static_cast<int>(cudaErrorInvalidValue);
#define FA_SIMT(TQ, TKV)                                                  \
  launch_simt<TQ, TKV>(q, k, v, qpos, kvpos, nullptr, m_part, l_part,    \
                       o_part, B, Sq, T, KV, G, hd, window, prefix_len,  \
                       offset, T_total, s)
    if (q_bf16 && kv_bf16) return FA_SIMT(bf16, bf16);
    if (q_bf16) return FA_SIMT(bf16, float);
    if (kv_bf16) return FA_SIMT(float, bf16);
    return FA_SIMT(float, float);
#undef FA_SIMT
  }
  if (Sq * G > SPLIT_MAX_PAIRS || hd > MAX_HD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores) {
    if (!(q_bf16 && kv_bf16) || hd % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma<2>(q, k, v, qpos, kvpos, nullptr, m_part, l_part,
                         o_part, B, Sq, T, KV, G, hd, window, prefix_len,
                         keys_per_split, n_split, offset, T_total, true, s);
  }
#define FA_SPLIT(TQ, TKV)                                                   \
  launch_split<TQ, TKV>(q, k, v, qpos, kvpos, nullptr, m_part, l_part,     \
                        o_part, B, Sq, T, KV, G, hd, window, prefix_len,   \
                        keys_per_split, n_split, vec, offset, T_total,     \
                        false, s)
  if (q_bf16 && kv_bf16) return FA_SPLIT(bf16, bf16);
  if (q_bf16) return FA_SPLIT(bf16, float);
  if (kv_bf16) return FA_SPLIT(float, bf16);
  return FA_SPLIT(float, float);
#undef FA_SPLIT
}

// The merge of partials in the layout above (n_split of them a row, in
// order: across ranks, gathered rank-major and split-minor):
// combine_kernel, out (B, Sq, KV, G, hd) in q's type (out_bf16).
extern "C" int flash_attention_combine_launch(void* m_part, void* l_part,
                                              void* o_part, void* out, int B,
                                              int Sq, int KV, int G, int hd,
                                              int n_split, int out_bf16,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* mp = static_cast<const float*>(m_part);
  const float* lp = static_cast<const float*>(l_part);
  const float* op = static_cast<const float*>(o_part);
  if (out_bf16)
    return launch_combine<bf16>(mp, lp, op, out, B, Sq, KV, G, hd, n_split,
                                s);
  return launch_combine<float>(mp, lp, op, out, B, Sq, KV, G, hd, n_split,
                               s);
}
