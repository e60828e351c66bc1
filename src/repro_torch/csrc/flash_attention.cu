// Flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel) for float32 operands and for head dims other than 64, 128 and
// 256; bf16 at those widths takes the tensor-core kernel in
// flash_attention_wgmma.cu (kernels/flash_attention.py::kernel_variant).
// q is (B, Hq, Sq, D), k and v are (B, Hkv, Sk, D), each given by its base
// pointer and its batch, head and sequence strides in elements (the head
// dim is contiguous), so the caller's (B, S, H, D) projections are read
// and written where they lie, with no transposed copy.  Query head h reads kv
// head h / (Hq / Hkv) (GQA, no repeat in memory).  What it computes is the TPU
// kernel's: operands upcast to float32; scores scaled; masked scores set to
// -1e30 (causal: key <= query; window: key > query - window; keys past Sk);
// an online softmax with the running max m, normaliser l and accumulator acc
// in float32, p zeroed where masked; out = acc / (l > 0 ? l : 1) in the
// input's dtype.
//
// What bounds it on this card: at prefill shapes, operations.  Attention does
// 4 * Sq * Sk * D flops (halved by the causal mask) per head on 2 * (Sq + Sk)
// * D values, hundreds of flops a byte, so its bound is the tensor cores'
// bf16 rate.  This design is the simple one: every product is a scalar
// float32 FMA on the CUDA cores, so it sits far above that bound (for bf16
// at widths 64, 128 and 256 the wgmma kernel does the products on the
// tensor cores).  What the design does:
//   * one thread block of 128 threads per (batch * q head, tile of BQ query
//     rows), the tiles with the most causal work launched first;
//   * the kv loop runs only over the tiles the causal and window limits leave
//     (the Pallas kernel skipped the others with @pl.when); masking inside a
//     tile is per element, so ragged Sq and Sk need no padding;
//   * q, k and v tiles are staged in shared memory as float32 with 16-byte
//     loads from device memory; each thread owns RQ query rows and holds
//     their m, l and acc (RQ x D/8 values) in registers, so every output
//     element is written once, by one thread, with no atomics;
//   * S = Q K^T: each thread computes RQ rows x 4 keys as float4 dot
//     products; the rows' max and sum are reduced over the 8 threads that
//     share them with warp shuffles; P goes through shared memory to the
//     P V product, where each thread accumulates RQ rows x D/8 columns.
// Shared-memory rows of Q and K are padded by 4 floats so that the 8 threads
// of a quarter warp read 8 different rows from 8 different bank groups.
// Head dims up to 256 (a multiple of 8) are taken, in three compiled widths
// (64, 128, 256); a narrower D is zero-padded in shared memory.  A block
// takes 64 query rows at widths 64 and 128 (32 for float32 at 128) and 32
// at 256.  expf, not
// __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_MAX_HEAD_DIM 256
#define FA_NEG_INF -1e30f

// dtype codes (kernels/flash_attention.py::_DTYPE_CODE)
#define FA_F32 0
#define FA_BF16 1

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_stride[3];  // (batch, head, seq) strides in elements
  int64_t k_stride[3];
  int64_t v_stride[3];
  int64_t o_stride[3];
  int32_t b, hq, hkv, sq, sk, d;
  int32_t causal;
  int32_t has_window;
  int32_t window;
  int32_t dtype;
  float scale;
};

namespace {

constexpr int NT = 128;  // threads per block: 16 row groups x 8 column lanes
constexpr int BK = 32;   // keys per kv tile
constexpr int PS = BK + 4;  // shared row stride of P (float4-aligned)

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

// Stage rows [row0, row0 + nrows) of one head (row stride `rs` elements) into
// shared memory as float32 with row stride `ld`; rows past `nvalid` and
// columns past `d` are zero.
template <typename T, int DMAX>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int64_t rs,
                                      int row0, int nrows, int nvalid, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DMAX / VEC;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += NT) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    float vals[VEC];
    if (row0 + r < nvalid && c < d) {
      load_vec(src + (int64_t)(row0 + r) * rs + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      store4(dst + r * ld + c + i, vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

template <int DMAX, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DMAX + 4) + (size_t)BK * (DMAX + 4) + (size_t)BK * DMAX +
         (size_t)BQ * PS;
}

template <typename T, int DMAX, int BQ>
__global__ void __launch_bounds__(NT) fa_kernel(const FaArgs a) {
  constexpr int RQ = BQ / 16;     // query rows per thread
  constexpr int DP = DMAX + 4;    // shared row stride of Q and K
  constexpr int NG = DMAX / 32;   // float4 column groups of acc per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * DMAX;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg * RQ .. rg * RQ + RQ - 1
  const int cg = tid & 7;   // lane in the row group
  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most causal work first
  const int bh = blockIdx.y;
  const int bi = bh / a.hq;
  const int h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = qt * BQ;

  const T* qp = static_cast<const T*>(a.q) + bi * a.q_stride[0] + h * a.q_stride[1];
  const T* kp = static_cast<const T*>(a.k) + bi * a.k_stride[0] + hk * a.k_stride[1];
  const T* vp = static_cast<const T*>(a.v) + bi * a.v_stride[0] + hk * a.v_stride[1];

  stage<T, DMAX>(sQ, DP, qp, a.q_stride[2], q0, BQ, a.sq, a.d);

  // kv tiles that can hold a visible key for some row of this q tile
  const int q_hi = min(q0 + BQ, a.sq) - 1;
  int kv_end = a.sk;
  if (a.causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (a.has_window) kv_begin = max(0, q0 - a.window + 1);
  const int kt_begin = kv_begin / BK;
  const int kt_end = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  float m[RQ], l[RQ], acc[RQ][NG][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage<T, DMAX>(sK, DP, kp, a.k_stride[2], k0, BK, a.sk, a.d);
    stage<T, DMAX>(sV, DMAX, vp, a.v_stride[2], k0, BK, a.sk, a.d);
    __syncthreads();

    // S = Q K^T for rows rg * RQ + i and keys cg + 8 j
    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DMAX; dd += 4) {
      float4 qv[RQ], kv[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg * RQ + i) * DP + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (cg + 8 * j) * DP + dd);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax per row; the 8 lanes of a row group hold one row's keys
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + rg * RQ + i;
      bool vis[4];
      float rmax = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 8 * j;
        vis[j] = kpos < a.sk && (!a.causal || kpos <= qpos) &&
                 (!a.has_window || kpos > qpos - a.window);
        s[i][j] = vis[j] ? s[i][j] * a.scale : FA_NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        sP[(rg * RQ + i) * PS + cg + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    __syncthreads();  // P complete

    // acc += P V for rows rg * RQ + i and columns cg * 4 + 32 g .. + 3
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg * RQ + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sV + (kk + u) * DMAX + cg * 4 + 32 * g);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  // the output's address is formed here, not held across the kv loop (held,
  // it spilled at float32 width 128)
  T* op = static_cast<T*>(a.o) + (int64_t)(blockIdx.y / a.hq) * a.o_stride[0] +
          (int64_t)(blockIdx.y % a.hq) * a.o_stride[1];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + rg * RQ + i;
    if (row >= a.sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    T* orow = op + (int64_t)row * a.o_stride[2];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = cg * 4 + 32 * g;
      if (c < a.d)
        store4(orow + c, acc[i][g][0] / safe_l, acc[i][g][1] / safe_l,
               acc[i][g][2] / safe_l, acc[i][g][3] / safe_l);
    }
  }
}

template <typename T, int DMAX, int BQ>
cudaError_t launch(const FaArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DMAX, BQ>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DMAX, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.hq);
  fa_kernel<T, DMAX, BQ><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const FaArgs& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64, 64>(a, stream);
  if (a.d <= 128) {
    // float32 at width 128 takes 32 rows a block, half the rows and acc
    // registers a thread holds: with 64 it compiled to 168 registers and
    // spilled 20 bytes (ptxas)
    if constexpr (sizeof(T) == 4) {
      return launch<T, 128, 32>(a, stream);
    } else {
      return launch<T, 128, 64>(a, stream);
    }
  }
  return launch<T, 256, 32>(a, stream);
}

}  // namespace

extern "C" int fa_args_size() { return (int)sizeof(FaArgs); }

extern "C" int fa_max_head_dim() { return FA_MAX_HEAD_DIM; }

extern "C" int flash_attention_launch(const FaArgs* a, void* stream) {
  if (a->d <= 0 || a->d > FA_MAX_HEAD_DIM || a->d % 8 || a->hkv <= 0 ||
      a->hq % a->hkv || a->sq <= 0 || a->b * a->hq <= 0 || a->b * a->hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = a->dtype == FA_BF16 ? launch_width<__nv_bfloat16>(*a, s)
                    : a->dtype == FA_F32 ? launch_width<float>(*a, s)
                                         : cudaErrorInvalidValue;
  return (int)err;
}
