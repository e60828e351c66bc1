// Flash-attention backward for Hopper (sm_90a): the gradient of the forward
// in flash_attention.cu and flash_attention_wgmma.cu.
//
// Replaces no Pallas kernel.  repro/kernels/flash_attention.py::
// flash_attention_pallas (line 101) has no custom_vjp: the reference's
// training differentiates the plain route of ops.flash_attention
// (ref.attention / ref.attention_blocked) by autodiff, and the port's training
// path needs the same gradient on the card without a plain version on it.
//
// q, o, dout, dq are (B, Hq, Sq, D); k, v, dk, dv are (B, Hkv, Sk, D); query
// head h reads kv head h / (Hq / Hkv).  The mask is the forward's: key kpos
// is visible to query qpos when kpos < Sk, (causal) kpos <= qpos and (window)
// kpos > qpos - window.  With P = softmax(scale * Q K^T) over the visible keys
// and dO the output's gradient, the gradient is
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// summed over the GQA group's query heads for dK and dV.  A row that sees no
// key has P = 0 and gets a zero gradient (ref.attention's row_visible guard).
// Every output element is written once, by one thread, after a fixed-order
// sum, and no kernel uses atomics: the gradient is the same bits launch after
// launch.
//
// What bounds it on this card: operations.  The gradient needs five products
// of 2 * (visible pairs) * D flops (the forward's Q K^T recomputed, dO V^T,
// P^T dO, dS K, dS^T Q); on the tensor cores in bf16 that is the bound.  Two
// variants, chosen per call (kernels/flash_attention_bwd.py::bwd_variant):
//
// * bf16 at head dims 64 and 128 (qwen3-4b, olmoe, whisper), on wgmma and
//   TMA (fa_bwd_wgmma_launch), FlashAttention-3's design.  It reads the
//   logsumexp that the wgmma forward saved (natural log, +inf for a row that
//   sees no key), so no kernel recomputes the softmax's statistics, and
//   makes seven products: Q K^T and dO V^T in each of the two main kernels,
//   and the three gradients.  Operands are described to TMA with the
//   caller's strides, as the forward's are, and dq, dk and dv are written
//   with their own strides: the (B, S, H, D) views attend_full passes are
//   read and written where they lie.  Three kernels:
//     (a) bwd_prep_wgmma: Delta a row, and lse in base 2 (lse * log2 e),
//         into float32 scratch (B, Hq, SqP), SqP = Sq rounded up to 128,
//         rows past Sq at Delta 0 and lse +inf (their P is then exactly 0);
//     (b) bwd_dkdv_wgmma: one CTA per (batch * kv head, 128 keys), the
//         tiles with the most causal work first; two consumer warpgroups own
//         64 keys each and a producer warpgroup, one thread of which starts
//         every load, hands them its registers (setmaxnreg 240 / 24).  K and
//         V arrive once; then, for each query head of the GQA group and each
//         64-row query tile that sees the keys, Q, dO, lse and Delta arrive
//         by TMA into a ring of two stages with full and empty mbarriers.
//         S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 from shared
//         memory into float32 registers; P^T = exp2(S^T scale log2 e - lse)
//         and dS^T = P^T o (dP^T - Delta) are formed in those registers and
//         packed as bf16 into the A fragments of dV += P^T dO and
//         dK += dS^T Q, which read Q and dO from shared memory as MN-major
//         B operands (m64nDk16).  P and dS never leave the registers; both
//         are formed in one pass after both score products, which keeps a
//         consumer thread within its 240 registers.  The group sum stays
//         in the block's accumulators;
//     (c) bwd_dq_wgmma: one CTA per (batch * q head, 128 query rows), the
//         tiles with the most causal work first; Q and dO arrive once, K and
//         V tiles of 128 keys through the ring; S = Q K^T and dP = dO V^T
//         (m64n128k16) and dQ += dS K (K as an MN-major B operand).  128
//         keys a tile rather than 64: half the tiles, and S and dP as
//         m64n128 products, which read less shared memory a flop
//         (tools/flash_bwd_candidates.py times the two; PERF.md).
//   In both, the loop runs only over the tiles the mask leaves, a
//   warpgroup skips a tile whose keys are all masked for it, and masking is
//   per element only in tiles that cross a causal or window limit (or the
//   end of the keys, in (c)); TMA fills rows past Sq and Sk with zeros.
//   P and dS are rounded to bf16 for their products, as FlashAttention does.
//
// * float32, and bf16 at other head dims (gemma3's 256), or any call with
//   variant "cuda_core" (flash_attention_bwd_launch): float32 FMAs on the
//   CUDA cores, on contiguous operands, each kernel recomputing what it
//   needs (eight products in all):
//     (a) bwd_prep_kernel: per query row, the logsumexp of its visible scores
//         (an online max and sum over the kv tiles, as the forward runs it)
//         and Delta, into float32 scratch (B, Hq, Sq);
//     (b) bwd_dkdv_kernel: one block per (batch, kv head, tile of keys).  It
//         loops over the group's query heads and the query tiles that see the
//         tile, recomputes P^T = exp(scale * K Q^T - lse) and dP^T = V dO^T,
//         and accumulates dV += P^T dO and dK += dS^T Q in registers;
//     (c) bwd_dq_kernel: one block per (batch, query head, tile of query
//         rows), looping over the kv tiles that the mask leaves, dQ += dS K.
//   The forward CUDA-core kernel's layout: 128 threads as 16 row groups x 8
//   lanes, each holding R rows x 4 columns of a score tile and R rows x D/8
//   columns of its accumulators, tiles of 32 on the inner loop,
//   shared-memory rows padded by 4 floats.  Head dims up to 256 (a multiple
//   of 8) run in three compiled widths (64, 128, 256), a narrower D
//   zero-padded in shared memory.  R is 256 / width in (a) and (b), so a
//   thread's dK and dV accumulators are 64 floats; in (c) R is 2 (1 at width
//   256).  expf, not __expf.

#include "hopper_wgmma.cuh"

#define FAB_MAX_HEAD_DIM 256
#define FAB_NEG_INF -1e30f

// dtype codes (kernels/flash_attention.py::_DTYPE_CODE)
#define FAB_F32 0
#define FAB_BF16 1

// the CUDA-core variant: contiguous (B, H, S, D) operands
struct FaBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, Hq, Sq) scratch
  float* delta;  // (B, Hq, Sq) scratch
  int32_t b, hq, hkv, sq, sk, d;
  int32_t causal;
  int32_t has_window;
  int32_t window;
  int32_t dtype;
  float scale;
};

// the wgmma variant: bf16 operands with (batch, head, seq) strides in
// elements, the head dim contiguous
struct FaBwdWgArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int64_t q_stride[3];
  int64_t k_stride[3];
  int64_t v_stride[3];
  int64_t o_stride[3];
  int64_t dout_stride[3];
  int64_t dq_stride[3];
  int64_t dk_stride[3];
  int64_t dv_stride[3];
  const float* lse;  // (B, Hq, Sq): the forward's, natural log
  float* lse2;       // (B, Hq, sq_pad) scratch
  float* delta;      // (B, Hq, sq_pad) scratch
  int32_t b, hq, hkv, sq, sk, d;
  int32_t sq_pad;  // Sq rounded up to 128
  int32_t causal;
  int32_t has_window;
  int32_t window;
  float scale;
};

namespace {

constexpr int NT = 128;     // threads per block: 16 row groups x 8 lanes
constexpr int BT = 32;      // the inner tile: keys in (a) and (c), queries in (b)
constexpr int PS = BT + 4;  // shared row stride of P and dS

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// Stage rows [row0, row0 + nrows) of one head (rows of d contiguous elements)
// into shared memory as float32 with row stride `ld`; rows past `nvalid` and
// columns past `d` are zero.
template <typename T, int DMAX>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int row0, int nrows,
                                      int nvalid, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DMAX / VEC;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += NT) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    float vals[VEC];
    if (row0 + r < nvalid && c < d) {
      load_vec(src + (int64_t)(row0 + r) * d + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      store4(dst + r * ld + c + i, vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// s[i][j] = sum_d A[rg * R + i][d] * B[cg + 8 j][d]: R rows of A against 4 rows
// of B, both staged with row stride DMAX + 4.  The order over d is fixed, so
// (a), (b) and (c) recompute the same score bits.
template <int DMAX, int R>
__device__ __forceinline__ void tile_dot(const float* sA, const float* sB, int rg, int cg,
                                         float (&s)[R][4]) {
  constexpr int DP = DMAX + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < DMAX; dd += 4) {
    float4 av[R], bv[4];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(sA + (rg * R + i) * DP + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(sB + (cg + 8 * j) * DP + dd);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][g][e] += sum_t P[rg * R + i][t] * B[t][cg * 4 + 32 g + e] over the
// BT inner elements: P with row stride PS, B with row stride DMAX + 4.
template <int DMAX, int R>
__device__ __forceinline__ void tile_acc(const float* sP, const float* sB, int rg, int cg,
                                         float (&acc)[R][DMAX / 32][4]) {
  constexpr int DP = DMAX + 4;
  constexpr int NG = DMAX / 32;
#pragma unroll 2
  for (int t = 0; t < BT; t += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pv[i] = *reinterpret_cast<const float4*>(sP + (rg * R + i) * PS + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 bv = *reinterpret_cast<const float4*>(sB + (t + u) * DP + cg * 4 + 32 * g);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          acc[i][g][0] = fmaf(p, bv.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p, bv.y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p, bv.z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p, bv.w, acc[i][g][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ bool visible(const FaBwdArgs& a, int qpos, int kpos) {
  return qpos < a.sq && kpos < a.sk && (!a.causal || kpos <= qpos) &&
         (!a.has_window || kpos > qpos - a.window);
}

// kv tiles of TILE keys that can hold a visible key for query rows [q0, q_hi]
template <int TILE = BT>
__device__ __forceinline__ void kv_tiles(const FaBwdArgs& a, int q0, int q_hi, int& kt_begin,
                                         int& kt_end) {
  int kv_end = a.sk;
  if (a.causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (a.has_window) kv_begin = max(0, q0 - a.window + 1);
  kt_begin = kv_begin / TILE;
  kt_end = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;
}

// query tiles of TILE rows that can see a key of kv rows [k0, k_hi]
template <int TILE = BT>
__device__ __forceinline__ void q_tiles(const FaBwdArgs& a, int k0, int k_hi, int& qt_begin,
                                        int& qt_end) {
  const int q_begin = a.causal ? k0 : 0;
  int q_end = a.sq;
  if (a.has_window) q_end = (int)min((int64_t)q_end, (int64_t)k_hi + a.window);
  qt_begin = q_begin / TILE;
  qt_end = q_end > q_begin ? (q_end + TILE - 1) / TILE : qt_begin;
}

template <int DMAX, typename T, int R>
__device__ __forceinline__ void store_rows(T* base, int row0, int nvalid, int d, int rg, int cg,
                                           const float (&acc)[R][DMAX / 32][4], float mul) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + rg * R + i;
    if (row >= nvalid) continue;
    T* out = base + (int64_t)row * d;
#pragma unroll
    for (int g = 0; g < DMAX / 32; ++g) {
      const int c = cg * 4 + 32 * g;
      if (c < d)
        store4(out + c, acc[i][g][0] * mul, acc[i][g][1] * mul, acc[i][g][2] * mul,
               acc[i][g][3] * mul);
    }
  }
}

// Delta = rowsum(dO o O) of query rows q0 + rg * R + i of head bh: the 8
// lanes of a row group split the row, in a fixed order.
template <typename T, int R>
__device__ __forceinline__ void row_delta(const FaBwdArgs& a, int bh, int q0) {
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int64_t qoff = (int64_t)bh * a.sq * a.d;
  const T* op = static_cast<const T*>(a.o) + qoff;
  const T* gp = static_cast<const T*>(a.dout) + qoff;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + rg * R + i;
    float sum = 0.f;
    if (row < a.sq) {
      for (int c = cg * 8; c < a.d; c += 64) {
        float ov[8], gv[8];
        load_vec(op + (int64_t)row * a.d + c, ov);
        load_vec(gp + (int64_t)row * a.d + c, gv);
        if constexpr (sizeof(T) == 4) {
          load_vec(op + (int64_t)row * a.d + c + 4, ov + 4);
          load_vec(gp + (int64_t)row * a.d + c + 4, gv + 4);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(ov[e], gv[e], sum);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (cg == 0 && row < a.sq) a.delta[(int64_t)bh * a.sq + row] = sum;
  }
}

// ---------------------------------------------------------------- (a) prep
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) bwd_prep_kernel(const FaBwdArgs a) {
  constexpr int R = 256 / DMAX;
  constexpr int BQ = 16 * R;
  constexpr int DP = DMAX + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * DP;

  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int bh = blockIdx.y;
  const int hk = (bh % a.hq) / (a.hq / a.hkv);
  const int bk = (bh / a.hq) * a.hkv + hk;
  const int q0 = blockIdx.x * BQ;
  const int64_t qoff = (int64_t)bh * a.sq * a.d;
  const T* qp = static_cast<const T*>(a.q) + qoff;
  const T* kp = static_cast<const T*>(a.k) + (int64_t)bk * a.sk * a.d;

  row_delta<T, R>(a, bh, q0);

  stage<T, DMAX>(sQ, DP, qp, q0, BQ, a.sq, a.d);
  int kt_begin, kt_end;
  kv_tiles(a, q0, min(q0 + BQ, a.sq) - 1, kt_begin, kt_end);

  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = FAB_NEG_INF;
    l[i] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K is no longer read
    stage<T, DMAX>(sK, DP, kp, k0, BT, a.sk, a.d);
    __syncthreads();
    float s[R][4];
    tile_dot<DMAX, R>(sQ, sK, rg, cg, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + rg * R + i;
      bool vis[4];
      float rmax = FAB_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(a, qpos, k0 + cg + 8 * j);
        s[i][j] = vis[j] ? s[i][j] * a.scale : FAB_NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rsum += vis[j] ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * expf(m[i] - m_new) + rsum;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + rg * R + i;
    // a row that sees no key keeps l = 0: its P is masked to 0 everywhere
    if (cg == 0 && row < a.sq)
      a.lse[(int64_t)bh * a.sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

// ---------------------------------------------------------------- (b) dK, dV
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(const FaBwdArgs a) {
  constexpr int R = 256 / DMAX;  // kv rows per thread
  constexpr int BKV = 16 * R;
  constexpr int DP = DMAX + 4;
  constexpr int NG = DMAX / 32;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BKV * DP;
  float* sQ = sV + BKV * DP;
  float* sG = sQ + BT * DP;  // dO
  float* sP = sG + BT * DP;  // P^T (BKV x BT)
  float* sS = sP + BKV * PS;  // dS^T
  float* sL = sS + BKV * PS;  // lse of the query tile
  float* sD = sL + BT;        // Delta of the query tile

  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int bk = blockIdx.y;  // batch * hkv + kv head
  const int bi = bk / a.hkv, hk = bk % a.hkv;
  const int group = a.hq / a.hkv;
  const int k0 = blockIdx.x * BKV;
  const int64_t koff = (int64_t)bk * a.sk * a.d;

  stage<T, DMAX>(sK, DP, static_cast<const T*>(a.k) + koff, k0, BKV, a.sk, a.d);
  stage<T, DMAX>(sV, DP, static_cast<const T*>(a.v) + koff, k0, BKV, a.sk, a.d);

  int qt_begin, qt_end;  // query tiles that can see a key of this tile
  q_tiles(a, k0, min(k0 + BKV, a.sk) - 1, qt_begin, qt_end);

  float acc_k[R][NG][4], acc_v[R][NG][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[i][g][e] = acc_v[i][g][e] = 0.f;

  for (int hg = 0; hg < group; ++hg) {
    const int bh = bi * a.hq + hk * group + hg;
    const int64_t qoff = (int64_t)bh * a.sq * a.d;
    const T* qp = static_cast<const T*>(a.q) + qoff;
    const T* gp = static_cast<const T*>(a.dout) + qoff;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      stage<T, DMAX>(sQ, DP, qp, q0, BT, a.sq, a.d);
      stage<T, DMAX>(sG, DP, gp, q0, BT, a.sq, a.d);
      for (int t = threadIdx.x; t < BT; t += NT) {
        const bool in = q0 + t < a.sq;
        sL[t] = in ? a.lse[(int64_t)bh * a.sq + q0 + t] : 0.f;
        sD[t] = in ? a.delta[(int64_t)bh * a.sq + q0 + t] : 0.f;
      }
      __syncthreads();

      float s[R][4], dp[R][4];
      tile_dot<DMAX, R>(sK, sQ, rg, cg, s);   // (K Q^T)[kv row][query]
      tile_dot<DMAX, R>(sV, sG, rg, cg, dp);  // (V dO^T)[kv row][query]
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kr = rg * R + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = cg + 8 * j;
          const float p =
              visible(a, q0 + qc, k0 + kr) ? expf(s[i][j] * a.scale - sL[qc]) : 0.f;
          sP[kr * PS + qc] = p;
          sS[kr * PS + qc] = p * (dp[i][j] - sD[qc]);
        }
      }
      __syncthreads();  // P^T and dS^T complete
      tile_acc<DMAX, R>(sP, sG, rg, cg, acc_v);  // dV += P^T dO
      tile_acc<DMAX, R>(sS, sQ, rg, cg, acc_k);  // dK += dS^T Q
    }
  }
  store_rows<DMAX>(static_cast<T*>(a.dv) + koff, k0, a.sk, a.d, rg, cg, acc_v, 1.f);
  store_rows<DMAX>(static_cast<T*>(a.dk) + koff, k0, a.sk, a.d, rg, cg, acc_k, a.scale);
}

// ---------------------------------------------------------------- (c) dQ
// query rows per thread of the dQ kernel: 2 at widths 64 and 128, 1 at 256
// (4 at width 64 spilled 8 bytes in float32, ptxas)
template <int DMAX>
__host__ __device__ constexpr int dq_rows() {
  return DMAX >= 256 ? 1 : 2;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(const FaBwdArgs a) {
  constexpr int R = dq_rows<DMAX>();
  constexpr int BQ = 16 * R;
  constexpr int DP = DMAX + 4;
  constexpr int NG = DMAX / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sG = sQ + BQ * DP;  // dO
  float* sK = sG + BQ * DP;
  float* sV = sK + BT * DP;
  float* sS = sV + BT * DP;  // dS (BQ x BT)

  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most causal work first
  const int bh = blockIdx.y;
  const int hk = (bh % a.hq) / (a.hq / a.hkv);
  const int bk = (bh / a.hq) * a.hkv + hk;
  const int q0 = qt * BQ;
  const int64_t qoff = (int64_t)bh * a.sq * a.d;
  const int64_t koff = (int64_t)bk * a.sk * a.d;

  stage<T, DMAX>(sQ, DP, static_cast<const T*>(a.q) + qoff, q0, BQ, a.sq, a.d);
  stage<T, DMAX>(sG, DP, static_cast<const T*>(a.dout) + qoff, q0, BQ, a.sq, a.d);
  float lse[R], dlt[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + rg * R + i;
    lse[i] = row < a.sq ? a.lse[(int64_t)bh * a.sq + row] : 0.f;
    dlt[i] = row < a.sq ? a.delta[(int64_t)bh * a.sq + row] : 0.f;
  }
  int kt_begin, kt_end;
  kv_tiles(a, q0, min(q0 + BQ, a.sq) - 1, kt_begin, kt_end);

  float acc[R][NG][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    stage<T, DMAX>(sK, DP, static_cast<const T*>(a.k) + koff, k0, BT, a.sk, a.d);
    stage<T, DMAX>(sV, DP, static_cast<const T*>(a.v) + koff, k0, BT, a.sk, a.d);
    __syncthreads();
    float s[R][4], dp[R][4];
    tile_dot<DMAX, R>(sQ, sK, rg, cg, s);   // Q K^T
    tile_dot<DMAX, R>(sG, sV, rg, cg, dp);  // dO V^T
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = rg * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = cg + 8 * j;
        const float p = visible(a, q0 + qr, k0 + kc) ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        sS[qr * PS + kc] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();  // dS complete
    tile_acc<DMAX, R>(sS, sK, rg, cg, acc);  // dQ += dS K
  }
  store_rows<DMAX>(static_cast<T*>(a.dq) + qoff, q0, a.sq, a.d, rg, cg, acc, a.scale);
}

template <int DMAX>
constexpr size_t prep_smem() {
  return ((size_t)16 * (256 / DMAX) + BT) * (DMAX + 4) * sizeof(float);
}

template <int DMAX>
constexpr size_t dkdv_smem() {
  constexpr size_t bkv = 16 * (256 / DMAX);
  return (2 * (bkv + BT) * (DMAX + 4) + 2 * bkv * PS + 2 * BT) * sizeof(float);
}

template <int DMAX>
constexpr size_t dq_smem() {
  constexpr size_t bq = 16 * dq_rows<DMAX>();
  return (2 * (bq + BT) * (DMAX + 4) + bq * PS) * sizeof(float);
}

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, size_t smem, const FaBwdArgs& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch(const FaBwdArgs& a, cudaStream_t stream) {
  constexpr int rows = 16 * (256 / DMAX);     // (a)'s query and (b)'s kv tile
  constexpr int dq_tile = 16 * dq_rows<DMAX>();  // (c)'s query tile
  cudaError_t err = run(bwd_prep_kernel<T, DMAX>, dim3((a.sq + rows - 1) / rows, a.b * a.hq),
                        prep_smem<DMAX>(), a, stream);
  if (err != cudaSuccess) return err;
  if (a.sk > 0) {
    err = run(bwd_dkdv_kernel<T, DMAX>, dim3((a.sk + rows - 1) / rows, a.b * a.hkv),
              dkdv_smem<DMAX>(), a, stream);
    if (err != cudaSuccess) return err;
  }
  return run(bwd_dq_kernel<T, DMAX>, dim3((a.sq + dq_tile - 1) / dq_tile, a.b * a.hq),
             dq_smem<DMAX>(), a, stream);
}

template <typename T>
cudaError_t launch_width(const FaBwdArgs& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

// ============================================================ tensor cores
// The wgmma variant (the header's first): (a) bwd_prep_wgmma, (b)
// bwd_dkdv_wgmma, (c) bwd_dq_wgmma, bf16 at head dims 64 and 128.

typedef __nv_bfloat16 bf16;

constexpr int WG_CONSUMERS = 256;                  // two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;     // and the producer warpgroup
constexpr int WG_STAGES = 2;                       // depth of the streamed tiles' ring
// registers a thread after setmaxnreg (at launch 384 threads get 168)
constexpr int WG_PRODUCER_REGS = 24, WG_CONSUMER_REGS = 240;
static_assert(WG_PRODUCER_REGS * 128 + WG_CONSUMER_REGS * WG_CONSUMERS <= 65536, "registers");
constexpr int KV_ROWS = 128;   // (b): keys a CTA, 64 a consumer warpgroup
constexpr int QT_ROWS = 64;    // (b): query rows a streamed tile
constexpr int Q_ROWS = 128;    // (c): query rows a CTA, 64 a consumer warpgroup
constexpr int KT_ROWS = 128;   // (c): keys a streamed tile
constexpr int SQ_ALIGN = 128;  // rows of lse2 and Delta a (batch, head)
constexpr float LOG2E = 1.4426950408889634f;

struct WgParams {
  const float* lse2;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t dq_stride[3], dk_stride[3], dv_stride[3];
  int32_t hq, hkv, sq, sk, sq_pad;
  int32_t causal, has_window, window;
  float scale, scale_log2;
};

__device__ __forceinline__ bool visible(int key, int q, const WgParams& p) {
  return key < p.sk && (!p.causal || key <= q) &&
         (!p.has_window || (long long)key > (long long)q - p.window);
}

// rows (key or query) row0 + 16 w + g and + 8 of a 64 x D accumulator, times
// mul, as bf16 at base + row * row_stride; rows past nvalid are not written
template <int D>
__device__ __forceinline__ void store_rows_wg(bf16* base, int64_t row_stride, int row_a,
                                              int nvalid, const float (&acc)[D / 2], float mul,
                                              int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= nvalid) continue;
    bf16* out = base + (int64_t)row * row_stride;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + 8 * i + 2 * t) =
          pack_bf16(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
  }
}

// ------------------------------------------------------------- (a) prep
// 8 threads a row, 16 rows a block: Delta = rowsum(dO o O) and lse in base 2
template <int D>
__global__ void __launch_bounds__(128) bwd_prep_wgmma(const FaBwdWgArgs a) {
  const int row = blockIdx.x * 16 + threadIdx.x / 8, c8 = threadIdx.x % 8;
  const int bh = blockIdx.y, bi = bh / a.hq, h = bh % a.hq;
  float sum = 0.f;
  if (row < a.sq) {
    const bf16* op = static_cast<const bf16*>(a.o) + bi * a.o_stride[0] + h * a.o_stride[1] +
                     (int64_t)row * a.o_stride[2];
    const bf16* gp = static_cast<const bf16*>(a.dout) + bi * a.dout_stride[0] +
                     h * a.dout_stride[1] + (int64_t)row * a.dout_stride[2];
#pragma unroll
    for (int c = c8 * 8; c < D; c += 64) {
      float ov[8], gv[8];
      load_vec(op + c, ov);
      load_vec(gp + c, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = fmaf(ov[e], gv[e], sum);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c8 == 0 && row < a.sq_pad) {
    const int64_t at = (int64_t)bh * a.sq_pad + row;
    a.delta[at] = sum;
    a.lse2[at] = row < a.sq ? a.lse[(int64_t)bh * a.sq + row] * LOG2E : pos_inf();
  }
}

// ------------------------------------------------------------- (b) dK, dV
template <int D>
struct DkdvTile {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr uint32_t KV_PANEL = KV_ROWS * 128;  // bytes of a 64-column panel of K or V
  static constexpr uint32_t KV_BYTES = KV_PANEL * PANELS;
  static constexpr uint32_t QT_PANEL = QT_ROWS * 128;  // and of a Q or dO tile
  static constexpr uint32_t QT_BYTES = QT_PANEL * PANELS;
  static constexpr uint32_t ROW_BYTES = QT_ROWS * 4;   // a tile's lse2 or Delta
  // a stage: Q, dO, lse2, Delta, 1024-byte aligned
  static constexpr uint32_t STAGE_BYTES = (2 * QT_BYTES + 2 * ROW_BYTES + 1023) / 1024 * 1024;
  // K, V, then the stages; 1024 more to align the base
  static constexpr size_t SMEM = 2 * KV_BYTES + (size_t)WG_STAGES * STAGE_BYTES + 1024;
  static_assert(SMEM <= 232448 - 64, "a block's shared memory, the barriers beside it");
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do, const WgParams p) {
  using T = DkdvTile<D>;
  extern __shared__ uint8_t smem_raw[];
  // bars[0]: K and V full; then per stage: full, empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * WG_STAGES];

  const uint32_t sK = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + T::KV_BYTES;
  auto stage = [&](int s) { return sV + T::KV_BYTES + (uint32_t)s * T::STAGE_BYTES; };
  auto bar = [&](int i) { return smem_addr(&bars[i]); };
  auto full = [&](int s) { return bar(1 + s); };
  auto empty = [&](int s) { return bar(1 + WG_STAGES + s); };

  const int bk = blockIdx.x;
  const int bi = bk / p.hkv, hk = bk % p.hkv;
  const int group = p.hq / p.hkv;
  const int k0 = blockIdx.y * KV_ROWS;  // causal: the first key tile sees every query
  const int k_hi = min(k0 + KV_ROWS, p.sk) - 1;
  // the query tiles that can see a key of this tile, for each head of the group
  const int q_begin = p.causal ? k0 : 0;
  long long q_end = p.sq;
  if (p.has_window) q_end = min(q_end, (long long)k_hi + p.window);
  const int qt_begin = q_begin / QT_ROWS;
  const int n_qt = q_end > q_begin ? (int)((q_end + QT_ROWS - 1) / QT_ROWS) - qt_begin : 0;
  const int n_it = group * n_qt;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    // the producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (tid == WG_CONSUMERS && n_it > 0) {
      mbar_expect_tx(bar(0), 2 * T::KV_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        tma_load(sK + pn * T::KV_PANEL, &tm_k, pn * PANEL_COLS, k0, hk, bi, bar(0));
        tma_load(sV + pn * T::KV_PANEL, &tm_v, pn * PANEL_COLS, k0, hk, bi, bar(0));
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES) mbar_wait(empty(s), ((it / WG_STAGES) - 1) & 1);
        const int h = hk * group + it / n_qt;
        const int q0 = (qt_begin + it % n_qt) * QT_ROWS;
        const uint32_t sQ = stage(s), sG = sQ + T::QT_BYTES, sL = sG + T::QT_BYTES;
        mbar_expect_tx(full(s), 2 * T::QT_BYTES + 2 * T::ROW_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load(sQ + pn * T::QT_PANEL, &tm_q, pn * PANEL_COLS, q0, h, bi, full(s));
          tma_load(sG + pn * T::QT_PANEL, &tm_do, pn * PANEL_COLS, q0, h, bi, full(s));
        }
        const int64_t rows = ((int64_t)bi * p.hq + h) * p.sq_pad + q0;
        bulk_load(sL, p.lse2 + rows, T::ROW_BYTES, full(s));
        bulk_load(sL + T::ROW_BYTES, p.delta + rows, T::ROW_BYTES, full(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  // a consumer thread: warpgroup wg holds keys kw0 .. kw0 + 63 of the tile;
  // this thread holds keys key_a and key_a + 8 (the accumulator layout)
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + wg * 64;
  const int key_a = kw0 + ((tid % 128) / 32) * 16 + g;
  uint8_t* const base = smem_raw + (sK - smem_addr(smem_raw));  // generic address of sK

  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

  if (n_it > 0) mbar_wait(bar(0), 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % WG_STAGES;
    const uint32_t ph = (it / WG_STAGES) & 1;
    const int q0 = (qt_begin + it % n_qt) * QT_ROWS;
    const uint32_t sQ = stage(s), sG = sQ + T::QT_BYTES;
    const float* sL = reinterpret_cast<const float*>(base + (sG + T::QT_BYTES - sK));
    const float* sD = sL + QT_ROWS;
    // every key of this warpgroup masked for every query of the tile
    const bool none = kw0 >= p.sk || (p.causal && kw0 > q0 + QT_ROWS - 1) ||
                      (p.has_window && (long long)kw0 + 63 <= (long long)q0 - p.window);
    mbar_wait(full(s), ph);
    if (!none) {
      const bool edge = (p.causal && kw0 + 63 > q0) ||
                        (p.has_window && (long long)kw0 <= (long long)q0 + QT_ROWS - 1 - p.window);
      // S^T = K Q^T and dP^T = V dO^T, 64 keys x QT_ROWS queries
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, smem_desc(sK + (kk / 4) * T::KV_PANEL + wg * 64 * 128 + (kk % 4) * 32, 16, 1024),
                     smem_desc(sQ + (kk / 4) * T::QT_PANEL + (kk % 4) * 32, 16, 1024), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, smem_desc(sV + (kk / 4) * T::KV_PANEL + wg * 64 * 128 + (kk % 4) * 32, 16, 1024),
                     smem_desc(sG + (kk / 4) * T::QT_PANEL + (kk % 4) * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T scale log2 e - lse2) and dS^T = P^T o (dP^T - Delta),
      // as bf16 A fragments over the queries: pa[kk] and sa[kk] cover
      // queries 16 kk .. +15
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = (j >> 1) & 1, c = 8 * (j / 4) + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
        float p0 = exp2f(fmaf(st[j], p.scale_log2, -l2.x));
        float p1 = exp2f(fmaf(st[j + 1], p.scale_log2, -l2.y));
        if (edge) {
          if (!visible(key_a + 8 * r, q0 + c, p)) p0 = 0.f;
          if (!visible(key_a + 8 * r, q0 + c + 1, p)) p1 = 0.f;
        }
        pa[j / 8][(j / 2) % 4] = pack_bf16(p0, p1);
        sa[j / 8][(j / 2) % 4] = pack_bf16(p0 * (dpt[j] - d2.x), p1 * (dpt[j + 1] - d2.y));
      }
      // dV += P^T dO and dK += dS^T Q
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(sa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT_ROWS / 16; ++kk) {
        wgmma_rs<D>(dv, pa[kk], smem_desc(sG + kk * 16 * 128, T::QT_PANEL, 1024));
        wgmma_rs<D>(dk, sa[kk], smem_desc(sQ + kk * 16 * 128, T::QT_PANEL, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      // the fragments stay live until the products that read them are done
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(sa[kk]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
  }

  store_rows_wg<D>(p.dv + bi * p.dv_stride[0] + hk * p.dv_stride[1], p.dv_stride[2], key_a, p.sk,
                   dv, 1.f, t);
  store_rows_wg<D>(p.dk + bi * p.dk_stride[0] + hk * p.dk_stride[1], p.dk_stride[2], key_a, p.sk,
                   dk, p.scale, t);
}

// ------------------------------------------------------------------- (c) dQ
template <int D>
struct DqTile {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr uint32_t Q_PANEL = Q_ROWS * 128;   // bytes of a 64-column panel of Q or dO
  static constexpr uint32_t Q_BYTES = Q_PANEL * PANELS;
  static constexpr uint32_t KT_PANEL = KT_ROWS * 128;  // and of a K or V tile
  static constexpr uint32_t KT_BYTES = KT_PANEL * PANELS;
  // Q, dO, then STAGES x (K, V), each 1024-byte aligned; 1024 more to align the base
  static constexpr size_t SMEM = 2 * Q_BYTES + (size_t)WG_STAGES * 2 * KT_BYTES + 1024;
  static_assert(SMEM <= 232448 - 64, "a block's shared memory, the barriers beside it");
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const WgParams p) {
  using T = DqTile<D>;
  constexpr int NS = KT_ROWS / 2;  // S values a consumer thread holds (two rows)
  extern __shared__ uint8_t smem_raw[];
  // bars[0]: Q and dO full; then per stage: full, empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * WG_STAGES];

  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + T::Q_BYTES;
  auto k_tile = [&](int s) { return sG + T::Q_BYTES + (uint32_t)s * 2 * T::KT_BYTES; };
  auto bar = [&](int i) { return smem_addr(&bars[i]); };
  auto full = [&](int s) { return bar(1 + s); };
  auto empty = [&](int s) { return bar(1 + WG_STAGES + s); };

  const int bh = blockIdx.x;
  const int bi = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int n_qt = (p.sq + Q_ROWS - 1) / Q_ROWS;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * Q_ROWS;  // most causal work first

  // kv tiles that can hold a visible key for some row of this q tile
  const int q_hi = min(q0 + Q_ROWS, p.sq) - 1;
  long long kv_end = p.sk;
  if (p.causal) kv_end = min(kv_end, (long long)q_hi + 1);
  long long kv_begin = 0;
  if (p.has_window) kv_begin = max(0LL, (long long)q0 - p.window + 1);
  int kt_begin = 0, n_kt = 0;
  if (kv_end > kv_begin) {
    kt_begin = (int)(kv_begin / KT_ROWS);
    n_kt = (int)((kv_end + KT_ROWS - 1) / KT_ROWS) - kt_begin;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (tid == WG_CONSUMERS && n_kt > 0) {
      mbar_expect_tx(bar(0), 2 * T::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        tma_load(sQ + pn * T::Q_PANEL, &tm_q, pn * PANEL_COLS, q0, h, bi, bar(0));
        tma_load(sG + pn * T::Q_PANEL, &tm_do, pn * PANEL_COLS, q0, h, bi, bar(0));
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES) mbar_wait(empty(s), ((it / WG_STAGES) - 1) & 1);
        const int k0 = (kt_begin + it) * KT_ROWS;
        const uint32_t sK = k_tile(s), sV = sK + T::KT_BYTES;
        mbar_expect_tx(full(s), 2 * T::KT_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load(sK + pn * T::KT_PANEL, &tm_k, pn * PANEL_COLS, k0, hk, bi, full(s));
          tma_load(sV + pn * T::KT_PANEL, &tm_v, pn * PANEL_COLS, k0, hk, bi, full(s));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  // warpgroup wg holds query rows wg_lo .. wg_lo + 63; this thread rows
  // row_a and row_a + 8
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg_lo = q0 + wg * 64;
  const int row_a = wg_lo + ((tid % 128) / 32) * 16 + g;
  float l2[2], dl[2];  // rows past Sq: lse2 +inf, Delta 0 (the prep's padding)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = (int64_t)bh * p.sq_pad + row_a + 8 * r;
    l2[r] = p.lse2[at];
    dl[r] = p.delta[at];
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n_kt > 0) mbar_wait(bar(0), 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % WG_STAGES;
    const uint32_t ph = (it / WG_STAGES) & 1;
    const int k0 = (kt_begin + it) * KT_ROWS;
    const uint32_t sK = k_tile(s), sV = sK + T::KT_BYTES;
    // every key of the tile masked for every row of this warpgroup
    const bool none = wg_lo >= p.sq || (p.causal && k0 > wg_lo + 63) ||
                      (p.has_window && (long long)k0 + KT_ROWS - 1 <= (long long)wg_lo - p.window);
    mbar_wait(full(s), ph);
    if (!none) {
      const bool edge = (k0 + KT_ROWS > p.sk) || (p.causal && k0 + KT_ROWS - 1 > wg_lo) ||
                        (p.has_window && (long long)k0 <= (long long)wg_lo + 63 - p.window);
      // S = Q K^T and dP = dO V^T, 64 rows x KT_ROWS keys
      float sc[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT_ROWS>(sc, smem_desc(sQ + (kk / 4) * T::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32, 16, 1024),
                          smem_desc(sK + (kk / 4) * T::KT_PANEL + (kk % 4) * 32, 16, 1024));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT_ROWS>(dp, smem_desc(sG + (kk / 4) * T::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32, 16, 1024),
                          smem_desc(sV + (kk / 4) * T::KT_PANEL + (kk % 4) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      // P = exp2(S scale log2 e - lse2) and dS = P o (dP - Delta), as bf16
      // A fragments over the keys
      uint32_t sa[KT_ROWS / 16][4];
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int r = (j >> 1) & 1, key = k0 + 8 * (j / 4) + 2 * t;
        float p0 = exp2f(fmaf(sc[j], p.scale_log2, -l2[r]));
        float p1 = exp2f(fmaf(sc[j + 1], p.scale_log2, -l2[r]));
        if (edge) {
          if (!visible(key, row_a + 8 * r, p)) p0 = 0.f;
          if (!visible(key + 1, row_a + 8 * r, p)) p1 = 0.f;
        }
        sa[j / 8][(j / 2) % 4] = pack_bf16(p0 * (dp[j] - dl[r]), p1 * (dp[j + 1] - dl[r]));
      }
      // dQ += dS K
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < KT_ROWS / 16; ++kk) fence_regs(sa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT_ROWS / 16; ++kk)
        wgmma_rs<D>(dq, sa[kk], smem_desc(sK + kk * 16 * 128, T::KT_PANEL, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < KT_ROWS / 16; ++kk) fence_regs(sa[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  store_rows_wg<D>(p.dq + bi * p.dq_stride[0] + h * p.dq_stride[1], p.dq_stride[2], row_a, p.sq,
                   dq, p.scale, t);
}

template <typename Kernel>
int run_wg(Kernel kernel, dim3 grid, size_t smem, const CUtensorMap (&m)[4], const WgParams& p,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, WG_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const FaBwdWgArgs& a, cudaStream_t stream) {
  WgParams p;
  p.lse2 = a.lse2;
  p.delta = a.delta;
  p.dq = static_cast<bf16*>(a.dq);
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  for (int i = 0; i < 3; ++i) {
    p.dq_stride[i] = a.dq_stride[i];
    p.dk_stride[i] = a.dk_stride[i];
    p.dv_stride[i] = a.dv_stride[i];
  }
  p.hq = a.hq;
  p.hkv = a.hkv;
  p.sq = a.sq;
  p.sk = a.sk;
  p.sq_pad = a.sq_pad;
  p.causal = a.causal;
  p.has_window = a.has_window;
  p.window = a.window;
  p.scale = a.scale;
  p.scale_log2 = a.scale * LOG2E;

  bwd_prep_wgmma<D><<<dim3(a.sq_pad / 16, a.b * a.hq), 128, 0, stream>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  CUtensorMap m[4];
  if (a.sk > 0) {
    err = make_map(&m[0], a.k, a.b, a.hkv, a.sk, D, a.k_stride, KV_ROWS);
    if (err == 0) err = make_map(&m[1], a.v, a.b, a.hkv, a.sk, D, a.v_stride, KV_ROWS);
    if (err == 0) err = make_map(&m[2], a.q, a.b, a.hq, a.sq, D, a.q_stride, QT_ROWS);
    if (err == 0) err = make_map(&m[3], a.dout, a.b, a.hq, a.sq, D, a.dout_stride, QT_ROWS);
    if (err == 0)
      err = run_wg(bwd_dkdv_wgmma<D>, dim3(a.b * a.hkv, (a.sk + KV_ROWS - 1) / KV_ROWS),
                   DkdvTile<D>::SMEM, m, p, stream);
    if (err != 0) return err;
  }
  err = make_map(&m[0], a.q, a.b, a.hq, a.sq, D, a.q_stride, Q_ROWS);
  if (err == 0) err = make_map(&m[1], a.dout, a.b, a.hq, a.sq, D, a.dout_stride, Q_ROWS);
  if (err == 0) err = make_map(&m[2], a.k, a.b, a.hkv, a.sk, D, a.k_stride, KT_ROWS);
  if (err == 0) err = make_map(&m[3], a.v, a.b, a.hkv, a.sk, D, a.v_stride, KT_ROWS);
  if (err != 0) return err;
  return run_wg(bwd_dq_wgmma<D>, dim3(a.b * a.hq, a.sq_pad / Q_ROWS), DqTile<D>::SMEM, m, p,
                stream);
}

}  // namespace

extern "C" int fa_bwd_args_size() { return (int)sizeof(FaBwdArgs); }

extern "C" int fa_bwd_wgmma_args_size() { return (int)sizeof(FaBwdWgArgs); }

extern "C" int fa_bwd_max_head_dim() { return FAB_MAX_HEAD_DIM; }

// The CUDA-core variant on `stream`; returns 0 or cudaGetLastError() of a launch.
extern "C" int flash_attention_bwd_launch(const FaBwdArgs* a, void* stream) {
  if (a->d <= 0 || a->d > FAB_MAX_HEAD_DIM || a->d % 8 || a->hkv <= 0 || a->hq % a->hkv ||
      a->sq <= 0 || a->sk < 0 || a->b * a->hq <= 0 || a->b * a->hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = a->dtype == FAB_BF16 ? launch_width<__nv_bfloat16>(*a, s)
                    : a->dtype == FAB_F32 ? launch_width<float>(*a, s)
                                          : cudaErrorInvalidValue;
  return (int)err;
}

// The wgmma variant on `stream`; returns 0, cudaGetLastError() of a launch,
// or one of hopper_wgmma.cuh's codes.
extern "C" int fa_bwd_wgmma_launch(const FaBwdWgArgs* a, void* stream) {
  if ((a->d != 64 && a->d != 128) || a->hkv <= 0 || a->hq % a->hkv || a->sq <= 0 || a->sk < 0 ||
      a->b * a->hq <= 0 || a->b * a->hq > 65535 || a->lse == nullptr ||
      a->sq_pad != (a->sq + SQ_ALIGN - 1) / SQ_ALIGN * SQ_ALIGN || a->sq_pad / Q_ROWS > 65535 ||
      (a->sk + KV_ROWS - 1) / KV_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->d == 64 ? launch_wgmma<64>(*a, s) : launch_wgmma<128>(*a, s);
}
