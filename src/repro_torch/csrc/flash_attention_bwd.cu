// Flash-attention backward for Hopper (sm_90a): the gradient of the forward
// in flash_attention.cu and flash_attention_wgmma.cu.
//
// Replaces no Pallas kernel.  repro/kernels/flash_attention.py::
// flash_attention_pallas (line 101) has no custom_vjp: the reference's
// training differentiates the plain route of ops.flash_attention
// (ref.attention / ref.attention_blocked) by autodiff, and the port's training
// path needs the same gradient on the card without a plain version on it.
//
// Operands are contiguous (B, H, S, D): q, o, dout, dq are (B, Hq, Sq, D);
// k, v, dk, dv are (B, Hkv, Sk, D); query head h reads kv head h / (Hq / Hkv).
// The mask is the forward's: key kpos is visible to query qpos when kpos < Sk,
// (causal) kpos <= qpos and (window) kpos > qpos - window.  With
// P = softmax(scale * Q K^T) over the visible keys and dO the output's
// gradient, the gradient is
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// summed over the GQA group's query heads for dK and dV.  A row that sees no
// key has P = 0 and gets a zero gradient (ref.attention's row_visible guard).
//
// Three kernels, each recomputing what it needs from the operands, with
// float32 sums:
//   (a) bwd_prep_*: per query row, the logsumexp of its visible scores
//       (an online max and sum over the kv tiles, as the forward runs it) and
//       Delta, into float32 scratch (B, Hq, Sq);
//   (b) bwd_dkdv_*: one block per (batch, kv head, tile of keys).  It
//       loops over the group's query heads and the query tiles that see the
//       tile, recomputes P^T = exp(scale * K Q^T - lse) and dP^T = V dO^T, and
//       accumulates dV += P^T dO and dK += dS^T Q in registers.  The group sum
//       happens inside the block, so no atomics are needed;
//   (c) bwd_dq_*: one block per (batch, query head, tile of query rows),
//       looping over the kv tiles that the mask leaves, dQ += dS K.
// Every output element is written once, by one thread, after a fixed-order
// sum: the gradient is the same bits launch after launch.
//
// What bounds it on this card: operations.  The gradient needs five products
// of 2 * (visible pairs) * D flops (the forward's Q K^T recomputed, dO V^T,
// P^T dO, dS K, dS^T Q); on the tensor cores in bf16 that is the bound.  The
// design recomputes more than that (eight products in all: Q K^T in each of
// the three kernels, dO V^T in two) so that no score matrix is written to
// device memory, and comes in two variants, chosen per call
// (kernels/flash_attention_bwd.py::bwd_variant):
//   * bf16 at head dims 64 and 128 (qwen3-4b, olmoe, whisper): every product
//     on the tensor cores with mma.sync m16n8k16 (bf16 in, float32 sums).
//     A block is 4 warps, each owning 16 rows of the block's 64-row tile and
//     looping over 32-row tiles of the other operand; operands stay bf16 in
//     shared memory (rows padded by 8 elements against ldmatrix bank
//     conflicts), and P^T, dS^T and dS pass from the score accumulators to
//     the next product as A fragments in registers, rounded to bf16 (as
//     FlashAttention-2 does).  dK/dV's two 16 x D accumulators take 128
//     registers a thread at D 128 (240 in all, no spill);
//   * float32, and bf16 at other head dims (gemma3's 256): float32 FMAs on
//     the CUDA cores, in the forward CUDA-core kernel's layout: 128 threads
//     as 16 row groups x 8 lanes, each holding R rows x 4 columns of a score
//     tile and R rows x D/8 columns of its accumulators, tiles of 32 on the
//     inner loop, shared-memory rows padded by 4 floats.  Head dims up to
//     256 (a multiple of 8) run in three compiled widths (64, 128, 256), a
//     narrower D zero-padded in shared memory.  R is 256 / width in (a) and
//     (b), so a thread's dK and dV accumulators are 64 floats; in (c) R is 2
//     (1 at width 256).
// FAB_CUDA_CORE forces the second variant (for timing the two on one
// input).  expf, not __expf, in both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FAB_MAX_HEAD_DIM 256
#define FAB_NEG_INF -1e30f

// dtype codes (kernels/flash_attention.py::_DTYPE_CODE)
#define FAB_F32 0
#define FAB_BF16 1

// variant codes (kernels/flash_attention_bwd.py::VARIANT_CODE)
#define FAB_AUTO 0
#define FAB_CUDA_CORE 1

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
  int32_t variant;  // FAB_AUTO: tensor cores where they apply; FAB_CUDA_CORE
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


// ============================================================ tensor cores
// (a), (b) and (c) for bf16 at head dims 64 and 128 on mma.sync (the header's
// first variant).  Fragments come by ldmatrix, .trans where a product reads
// a tile along its rows; a staged row is D + 8 elements, so the 8 row
// addresses of an ldmatrix fall in 8 different bank groups.

typedef __nv_bfloat16 bf16;

constexpr int MT = 64;  // rows of a block's own tile: 4 warps x 16
constexpr int IT = 32;  // rows of the tile a block loops over

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + nrows) of one head ((D) bf16 a row in device
// memory) into shared memory with row stride D + 8; rows past nvalid are zero.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int row0, int nrows,
                                           int nvalid) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < nrows * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nvalid) v = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

template <int N8>
__device__ __forceinline__ void zero(float (&c)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// c[16 x 8 N8] += A[a_row0 .. + 16][0 .. D) * B[b_row0 .. + 8 N8][0 .. D)^T, both
// tiles row-major in shared memory with row stride D + 8
template <int D, int N8>
__device__ __forceinline__ void mm_abt(float (&c)[N8][4], const bf16* sA, int a_row0,
                                       const bf16* sB, int b_row0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, sA + (a_row0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, sB + (b_row0 + n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
      mma16816(c[n], a, b[0], b[1]);
      mma16816(c[n + 1], a, b[2], b[3]);
    }
  }
}

// c[16 x D] += P[16 x 16 K16] * B[b_row0 .. + 16 K16][0 .. D): P as A fragments
// in registers, B row-major in shared memory (row stride D + 8)
template <int D, int K16>
__device__ __forceinline__ void mm_pb(float (&c)[D / 8][4], const uint32_t (&p)[K16][4],
                                      const bf16* sB, int b_row0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, sB + (b_row0 + kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8);
      mma16816(c[n], p[kk], b[0], b[1]);
      mma16816(c[n + 1], p[kk], b[2], b[3]);
    }
  }
}

// accumulators of a 16 x 16 K16 tile -> A fragments, rounded to bf16
template <int K16>
__device__ __forceinline__ void to_a(uint32_t (&a)[K16][4], const float (&c)[2 * K16][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// rows row0 + g and row0 + g + 8 of a 16 x D accumulator, times mul, as bf16
template <int D>
__device__ __forceinline__ void store_acc(bf16* base, int row0, int nvalid,
                                          const float (&c)[D / 8][4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= nvalid) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(base + (int64_t)row * D + n * 8 + 2 * t) =
          pack_bf16(c[n][2 * half] * mul, c[n][2 * half + 1] * mul);
  }
}

// (a) on the tensor cores: each warp's 16 query rows, kv tiles of MT keys
template <int D>
__global__ void __launch_bounds__(NT) bwd_prep_mma(const FaBwdArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sK = sQ + MT * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int bk = (bh / a.hq) * a.hkv + (bh % a.hq) / (a.hq / a.hkv);
  const int q0 = blockIdx.x * MT;
  const bf16* kp = static_cast<const bf16*>(a.k) + (int64_t)bk * a.sk * D;

  row_delta<bf16, MT / 16>(a, bh, q0);
  stage_bf16<D>(sQ, static_cast<const bf16*>(a.q) + (int64_t)bh * a.sq * D, q0, MT, a.sq);
  int kt_begin, kt_end;
  kv_tiles<MT>(a, q0, min(q0 + MT, a.sq) - 1, kt_begin, kt_end);

  float m[2] = {FAB_NEG_INF, FAB_NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * MT;
    __syncthreads();  // the previous tile's K is no longer read
    stage_bf16<D>(sK, kp, k0, MT, a.sk);
    __syncthreads();
    float s[MT / 8][4];
    zero(s);
    mm_abt<D, MT / 8>(s, sQ, warp * 16, sK, 0, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = q0 + warp * 16 + g + 8 * half;
      float rmax = FAB_NEG_INF;
#pragma unroll
      for (int n = 0; n < MT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = visible(a, qpos, k0 + n * 8 + 2 * t + e) ? x * a.scale : FAB_NEG_INF;
          rmax = fmaxf(rmax, x);
        }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[half], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < MT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * half + e];
          rsum += x > 0.5f * FAB_NEG_INF ? expf(x - m_new) : 0.f;
        }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[half] = l[half] * expf(m[half] - m_new) + rsum;
      m[half] = m_new;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + 8 * half;
    if (t == 0 && row < a.sq)
      a.lse[(int64_t)bh * a.sq + row] = l[half] > 0.f ? m[half] + logf(l[half]) : 0.f;
  }
}

// (b) on the tensor cores: each warp's 16 keys of the block's MT, query
// tiles of IT rows; dV += P^T dO and dK += dS^T Q
template <int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_mma(const FaBwdArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* sK = reinterpret_cast<bf16*>(smem_u4);
  bf16* sV = sK + MT * LD;
  bf16* sQ = sV + MT * LD;
  bf16* sG = sQ + IT * LD;  // dO
  float* sL = reinterpret_cast<float*>(sG + IT * LD);
  float* sD = sL + IT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.y;
  const int bi = bk / a.hkv, hk = bk % a.hkv;
  const int group = a.hq / a.hkv;
  const int k0 = blockIdx.x * MT;
  const int64_t koff = (int64_t)bk * a.sk * D;

  stage_bf16<D>(sK, static_cast<const bf16*>(a.k) + koff, k0, MT, a.sk);
  stage_bf16<D>(sV, static_cast<const bf16*>(a.v) + koff, k0, MT, a.sk);
  int qt_begin, qt_end;
  q_tiles<IT>(a, k0, min(k0 + MT, a.sk) - 1, qt_begin, qt_end);

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  for (int hg = 0; hg < group; ++hg) {
    const int bh = bi * a.hq + hk * group + hg;
    const int64_t qoff = (int64_t)bh * a.sq * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * IT;
      __syncthreads();  // the previous tile's Q, dO, lse and Delta are no longer read
      stage_bf16<D>(sQ, static_cast<const bf16*>(a.q) + qoff, q0, IT, a.sq);
      stage_bf16<D>(sG, static_cast<const bf16*>(a.dout) + qoff, q0, IT, a.sq);
      for (int i = threadIdx.x; i < IT; i += NT) {
        const bool in = q0 + i < a.sq;
        sL[i] = in ? a.lse[(int64_t)bh * a.sq + q0 + i] : 0.f;
        sD[i] = in ? a.delta[(int64_t)bh * a.sq + q0 + i] : 0.f;
      }
      __syncthreads();
      float s[IT / 8][4], dp[IT / 8][4];
      zero(s);
      zero(dp);
      mm_abt<D, IT / 8>(s, sK, warp * 16, sQ, 0, lane);   // (K Q^T)[key][query]
      mm_abt<D, IT / 8>(dp, sV, warp * 16, sG, 0, lane);  // (V dO^T)[key][query]
#pragma unroll
      for (int n = 0; n < IT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          const int kpos = k0 + warp * 16 + g + 8 * (e >> 1);
          const float p = visible(a, q0 + qc, kpos) ? expf(s[n][e] * a.scale - sL[qc]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sD[qc]);
        }
      uint32_t pa[IT / 16][4], sa[IT / 16][4];
      to_a<IT / 16>(pa, s);
      to_a<IT / 16>(sa, dp);
      mm_pb<D, IT / 16>(dv, pa, sG, 0, lane);  // dV += P^T dO
      mm_pb<D, IT / 16>(dk, sa, sQ, 0, lane);  // dK += dS^T Q
    }
  }
  store_acc<D>(static_cast<bf16*>(a.dv) + koff, k0 + warp * 16, a.sk, dv, 1.f, lane);
  store_acc<D>(static_cast<bf16*>(a.dk) + koff, k0 + warp * 16, a.sk, dk, a.scale, lane);
}

// (c) on the tensor cores: each warp's 16 query rows of the block's MT, kv
// tiles of IT keys; dQ += dS K
template <int D>
__global__ void __launch_bounds__(NT) bwd_dq_mma(const FaBwdArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sG = sQ + MT * LD;  // dO
  bf16* sK = sG + MT * LD;
  bf16* sV = sK + IT * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (a.sq + MT - 1) / MT;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * MT;  // most causal work first
  const int bh = blockIdx.y;
  const int bk = (bh / a.hq) * a.hkv + (bh % a.hq) / (a.hq / a.hkv);
  const int64_t qoff = (int64_t)bh * a.sq * D;
  const int64_t koff = (int64_t)bk * a.sk * D;

  stage_bf16<D>(sQ, static_cast<const bf16*>(a.q) + qoff, q0, MT, a.sq);
  stage_bf16<D>(sG, static_cast<const bf16*>(a.dout) + qoff, q0, MT, a.sq);
  float lse[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + 8 * half;
    lse[half] = row < a.sq ? a.lse[(int64_t)bh * a.sq + row] : 0.f;
    dlt[half] = row < a.sq ? a.delta[(int64_t)bh * a.sq + row] : 0.f;
  }
  int kt_begin, kt_end;
  kv_tiles<IT>(a, q0, min(q0 + MT, a.sq) - 1, kt_begin, kt_end);

  float dq[D / 8][4];
  zero(dq);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * IT;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_bf16<D>(sK, static_cast<const bf16*>(a.k) + koff, k0, IT, a.sk);
    stage_bf16<D>(sV, static_cast<const bf16*>(a.v) + koff, k0, IT, a.sk);
    __syncthreads();
    float s[IT / 8][4], dp[IT / 8][4];
    zero(s);
    zero(dp);
    mm_abt<D, IT / 8>(s, sQ, warp * 16, sK, 0, lane);   // Q K^T
    mm_abt<D, IT / 8>(dp, sG, warp * 16, sV, 0, lane);  // dO V^T
#pragma unroll
    for (int n = 0; n < IT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qpos = q0 + warp * 16 + g + 8 * half;
        const float p = visible(a, qpos, k0 + n * 8 + 2 * t + (e & 1))
                            ? expf(s[n][e] * a.scale - lse[half]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dlt[half]);
      }
    uint32_t sa[IT / 16][4];
    to_a<IT / 16>(sa, dp);
    mm_pb<D, IT / 16>(dq, sa, sK, 0, lane);  // dQ += dS K
  }
  store_acc<D>(static_cast<bf16*>(a.dq) + qoff, q0 + warp * 16, a.sq, dq, a.scale, lane);
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

template <int D>
cudaError_t launch_mma(const FaBwdArgs& a, cudaStream_t stream) {
  constexpr size_t tile = (size_t)(D + 8) * sizeof(bf16);  // bytes a staged row
  const dim3 q_grid((a.sq + MT - 1) / MT, a.b * a.hq);
  cudaError_t err = run(bwd_prep_mma<D>, q_grid, 2 * MT * tile, a, stream);
  if (err != cudaSuccess) return err;
  if (a.sk > 0) {
    err = run(bwd_dkdv_mma<D>, dim3((a.sk + MT - 1) / MT, a.b * a.hkv),
              2 * (MT + IT) * tile + 2 * IT * sizeof(float), a, stream);
    if (err != cudaSuccess) return err;
  }
  return run(bwd_dq_mma<D>, q_grid, 2 * (MT + IT) * tile, a, stream);
}

template <typename T>
cudaError_t launch_width(const FaBwdArgs& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (a.variant == FAB_AUTO && a.d == 64) return launch_mma<64>(a, stream);
    if (a.variant == FAB_AUTO && a.d == 128) return launch_mma<128>(a, stream);
  }
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

extern "C" int fa_bwd_args_size() { return (int)sizeof(FaBwdArgs); }

extern "C" int fa_bwd_max_head_dim() { return FAB_MAX_HEAD_DIM; }

extern "C" int flash_attention_bwd_launch(const FaBwdArgs* a, void* stream) {
  if (a->d <= 0 || a->d > FAB_MAX_HEAD_DIM || a->d % 8 || a->hkv <= 0 || a->hq % a->hkv ||
      a->sq <= 0 || a->sk < 0 || a->b * a->hq <= 0 || a->b * a->hq > 65535 ||
      (a->variant != FAB_AUTO && a->variant != FAB_CUDA_CORE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = a->dtype == FAB_BF16 ? launch_width<__nv_bfloat16>(*a, s)
                    : a->dtype == FAB_F32 ? launch_width<float>(*a, s)
                                          : cudaErrorInvalidValue;
  return (int)err;
}
