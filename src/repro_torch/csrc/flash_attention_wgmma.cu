// Flash-attention forward on the tensor cores for Hopper (sm_90a): bf16 in,
// wgmma for both products, TMA loads into a shared-memory ring.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel) for bf16 operands with head dim 64, 128 or 256; float32 operands
// and other head dims take the CUDA-core kernel (csrc/flash_attention.cu), and
// kernels/flash_attention.py::kernel_variant chooses between the two.  q is
// (B, Hq, Sq, D), k and v are (B, Hkv, Sk, D), each described to the TMA
// unit as a 4-D tensor (D, S, H, B) with the caller's strides, so the
// (B, S, H, D) projections that attend_full passes are read where they lie,
// with no transposed copy; query head h reads kv head h / (Hq / Hkv) (GQA).
// What it computes is the TPU kernel's: scores scaled; masked scores at
// -1e30 (causal: key <= query; window: key > query - window; keys past Sk)
// and p zeroed where masked; an online softmax with float32 m, l and acc;
// out = acc / (l > 0 ? l : 1), written once in bf16.  The tensor cores
// multiply bf16, so at D 64 and 128 the float32 p is fed to the P V product
// as two bf16 parts, p_hi = bf16(p) and p_lo = bf16(p - p_hi), and
// O += p_hi V + p_lo V keeps p to about 2^-16 of itself (the TPU kernel
// multiplies float32 p); l sums the float32 p.  With p_hi alone (2^-9) the
// output moved by one bf16 step at |out| >= 4 on qwen3-4b's live
// activations, past the reference tests' bf16 tolerance (atol 3e-2) that
// the result is held to; the second part makes the tensor work 1.5 times
// the nominal 4 D flops a visible pair.  At D 256 P V takes p_hi alone:
// on one gemma3-12b unit's live calls it held that tolerance with the same
// worst error as both parts (1.212e-2), and the second part cost 16% of
// the calls' time (tools/flash_candidates.py, on an H100 at 700 W).
//
// What bounds it on this card: operations.  At qwen3-4b's prefill (B 2,
// Hq 32, S 2048, D 128, causal) attention does 6.9e10 flops on 84 MB, some
// 800 flops a byte, so its floor is the tensor cores' bf16 rate.  The
// design keeps the tensor cores fed:
//   * one CTA per (batch * q head, 128-row q tile), the tiles with the most
//     causal work launched first; two consumer warpgroups own 64 q rows
//     each, and a producer warpgroup, one thread of which starts every
//     load, hands its registers to them (setmaxnreg: 232 a consumer thread
//     at D 64 and 128, 240 at D 256, where 384 threads get 168 at launch;
//     at 168 the m64n128 products of S and O spilled);
//   * the kv tile: BK 128 keys at D 64 and 128; BK 64 at D 256, where 128
//     keys would need 256 KB for the two stages of K and V (a block gets
//     227 KB) and 256 registers of S, P and O a thread.  At BK 64 a
//     consumer thread holds 32 S values, 16 registers of P and 128 of O,
//     within the 192 the D-128 instance holds at BK 128; shared memory is
//     Q 64 KB + 2 stages x (K + V) 128 KB, 193 KB aligned;
//   * Q arrives once by TMA; K and V tiles of BK keys arrive by TMA into a
//     ring of STAGES stages with full and empty mbarriers, so the loads of
//     the next tiles overlap the products on this one; 128-byte swizzled
//     64-column panels, the layout wgmma reads without bank conflicts;
//   * the kv loop runs only over the tiles the causal and window limits
//     leave; masking is per element and only in tiles that cross a limit,
//     so ragged Sq and Sk need no padding (TMA fills rows past the end
//     with zeros);
//   * S = Q K^T is wgmma m64nBKk16 from shared memory into float32
//     registers; the online softmax runs in those registers (a row's max
//     is reduced over the four threads that hold it, its sum only once, at
//     the end); P is packed, as its bf16 parts, in the registers that
//     wgmma reads as its A operand, so O += P V is one wgmma m64nDk16 a
//     part and k step with V read from shared memory as a transposed
//     (MN-major) operand.  At D 256 it is one m64n256k16 across V's four
//     panels (the descriptor's leading offset steps a panel), not two
//     m64n128k16 on the halves of O: P's fragments are read once, and it
//     is half the instructions;
//   * each output element is written once, by the thread whose
//     accumulator holds it.
// Where FaWgArgs::lse is set, the kernel also writes each row's logsumexp,
// for the backward (csrc/flash_attention_bwd.cu) to recompute P from: in
// natural log, of the scaled scores over the row's visible keys,
// lse = (m + log2(l)) ln 2 from the base-2 max m and sum l it already holds;
// a row that sees no key (l == 0) gets +inf, so that exp(s - lse) is exactly
// 0 there.  Where it is null the kernel writes nothing more (serving never
// asks for it).
// The host encodes the three tensor maps with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no libcuda
// (hopper_wgmma.cuh, with the PTX helpers).

#include "hopper_wgmma.cuh"

#define FAW_NEG_INF -1e30f

struct FaWgArgs {
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
  float scale;
  float* lse;  // null, or (B, Hq, Sq) float32: each row's logsumexp (see the top)
};

namespace {

constexpr int BQ = 128;            // q rows a CTA: two consumer warpgroups of 64
constexpr int STAGES = 2;          // K/V ring depth
constexpr int CONSUMERS = 256;     // threads of the two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 128;  // and the producer warpgroup

struct KParams {
  __nv_bfloat16* o;
  int64_t o_stride[3];
  int32_t hq, hkv, sq, sk;
  int32_t causal, has_window, window;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  float* lse;
};

__device__ __forceinline__ bool visible(int key, int row, const KParams& kp) {
  return key < kp.sk && (!kp.causal || key <= row) &&
         (!kp.has_window || (long long)key > (long long)row - kp.window);
}

template <int D, int BK>
struct Tile {
  static_assert(((D == 64 || D == 128) && BK == 128) || (D == 256 && BK == 64), "instances");
  // registers a thread after setmaxnreg hands the producer's to the
  // consumers (at launch 384 threads get 168): 40 x 128 + 232 x 256, and
  // at D 256 24 x 128 + 240 x 256, within 65,536
  static constexpr int PRODUCER_REGS = D == 256 ? 24 : 40;
  static constexpr int CONSUMER_REGS = D == 256 ? 240 : 232;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 65536, "registers");
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr uint32_t Q_PANEL = BQ * 128;   // bytes of a 64-column panel of Q
  static constexpr uint32_t KV_PANEL = BK * 128;  // and of K or V
  static constexpr uint32_t Q_BYTES = Q_PANEL * PANELS;
  static constexpr uint32_t KV_BYTES = KV_PANEL * PANELS;
  // Q, then STAGES x (K, V), each 1024-byte aligned; 1024 more to align the base
  static constexpr size_t SMEM = Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + 1024;
  static_assert(SMEM <= 232448 - 64, "a block's shared memory, the barriers beside it");
};

template <int D, int BK>
__global__ void __launch_bounds__(NTHREADS, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const KParams kp) {
  using T = Tile<D, BK>;
  constexpr int NS = BK / 2;  // S values a consumer thread holds (two rows)
  constexpr int NO = D / 2;   // O values a consumer thread holds
  constexpr bool kPLo = D != 256;  // P V adds p's low bf16 part (see the top)
  extern __shared__ uint8_t smem_raw[];
  // bars[0]: Q full; then per stage: K full, V full, slot empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];

  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  auto k_tile = [&](int s) { return sQ + T::Q_BYTES + (uint32_t)s * 2 * T::KV_BYTES; };
  auto bar = [&](int i) { return smem_addr(&bars[i]); };
  auto full_k = [&](int s) { return bar(1 + s); };
  auto full_v = [&](int s) { return bar(1 + STAGES + s); };
  auto empty = [&](int s) { return bar(1 + 2 * STAGES + s); };

  const int n_qt = (kp.sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most causal work first
  const int bh = blockIdx.y;
  const int bi = bh / kp.hq;
  const int h = bh % kp.hq;
  const int hk = h / (kp.hq / kp.hkv);
  const int q0 = qt * BQ;

  // kv tiles that can hold a visible key for some row of this q tile
  const int q_hi = min(q0 + BQ, kp.sq) - 1;
  long long kv_end = kp.sk;
  if (kp.causal) kv_end = min(kv_end, (long long)q_hi + 1);
  long long kv_begin = 0;
  if (kp.has_window) kv_begin = max(0LL, (long long)q0 - kp.window + 1);
  int kt_begin = 0, n_kt = 0;
  if (kv_end > kv_begin) {
    kt_begin = (int)(kv_begin / BK);
    n_kt = (int)((kv_end + BK - 1) / BK) - kt_begin;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (tid == CONSUMERS && n_kt > 0) {
      mbar_expect_tx(bar(0), T::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn)
        tma_load(sQ + pn * T::Q_PANEL, &tm_q, pn * PANEL_COLS, q0, h, bi, bar(0));
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        const int k0 = (kt_begin + it) * BK;
        const uint32_t sK = k_tile(s), sV = sK + T::KV_BYTES;
        mbar_expect_tx(full_k(s), T::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn)
          tma_load(sK + pn * T::KV_PANEL, &tm_k, pn * PANEL_COLS, k0, hk, bi, full_k(s));
        mbar_expect_tx(full_v(s), T::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn)
          tma_load(sV + pn * T::KV_PANEL, &tm_v, pn * PANEL_COLS, k0, hk, bi, full_v(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
  // a consumer thread: warpgroup wg holds q rows wg*64 .. +63 of the tile;
  // this thread holds rows row_a and row_a + 8 (the wgmma accumulator layout)
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg_lo = q0 + wg * 64;
  const int row_a = wg_lo + ((tid % 128) / 32) * 16 + g;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {FAW_NEG_INF, FAW_NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  if (n_kt > 0) mbar_wait(bar(0), 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = (kt_begin + it) * BK;
    const uint32_t sK = k_tile(s), sV = sK + T::KV_BYTES;

    // S = Q K^T
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    mbar_wait(full_k(s), ph);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          smem_desc(sQ + (kk / 4) * T::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = smem_desc(sK + (kk / 4) * T::KV_PANEL + (kk % 4) * 32, 16, 1024);
      if constexpr (BK == 128)
        wgmma_ss_n128(sc, da, db, 1);
      else
        wgmma_ss_n64(sc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in base 2; masks only in tiles that cross a limit
    const bool edge = (k0 + BK > kp.sk) || (kp.causal && k0 + BK - 1 > wg_lo) ||
                      (kp.has_window && (long long)k0 <= (long long)wg_lo + 63 - kp.window);
    float mx[2] = {FAW_NEG_INF, FAW_NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int r = (j >> 1) & 1;
      float x = sc[j] * kp.scale_log2;
      if (edge && !visible(k0 + 8 * (j / 4) + 2 * t + (j & 1), row_a + 8 * r, kp)) x = FAW_NEG_INF;
      sc[j] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P as bf16 hi and (where kPLo) lo parts, laid out as wgmma's A
    // fragments: pa[kk] and pb[kk] cover keys 16 kk .. +15
    uint32_t pa[BK / 16][4], pb[kPLo ? BK / 16 : 1][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const int r = (j >> 1) & 1;
      float p0 = exp2f(sc[j] - m_run[r]);
      float p1 = exp2f(sc[j + 1] - m_run[r]);
      if (edge) {
        const int key = k0 + 8 * (j / 4) + 2 * t;
        if (!visible(key, row_a + 8 * r, kp)) p0 = 0.f;
        if (!visible(key + 1, row_a + 8 * r, kp)) p1 = 0.f;
      }
      psum[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      pa[j / 8][(j / 2) % 4] = *reinterpret_cast<const uint32_t*>(&hi);
      if constexpr (kPLo) pb[j / 8][(j / 2) % 4] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V
    mbar_wait(full_v(s), ph);
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      fence_regs(pa[kk]);
      if constexpr (kPLo) fence_regs(pb[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = smem_desc(sV + kk * 16 * 128, T::KV_PANEL, 1024);
      if constexpr (D == 256) {
        wgmma_rs_n256(o, pa[kk], db);
        if constexpr (kPLo) wgmma_rs_n256(o, pb[kk], db);
      } else if constexpr (D == 128) {
        wgmma_rs_n128(o, pa[kk], db);
        wgmma_rs_n128(o, pb[kk], db);
      } else {
        wgmma_rs_n64(o, pa[kk], db);
        wgmma_rs_n64(o, pb[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
  }

  // out = acc / (l > 0 ? l : 1), each element written once
  __nv_bfloat16* obase = kp.o + bi * kp.o_stride[0] + h * kp.o_stride[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l > 0.f ? l : 1.f;
    const int row = row_a + 8 * r;
    if (row >= kp.sq) continue;
    if (kp.lse != nullptr && t == 0)  // m_run is the same in the row's four threads
      kp.lse[((int64_t)bi * kp.hq + h) * kp.sq + row] =
          l > 0.f ? (m_run[r] + log2f(l)) * 0.6931471805599453f : pos_inf();
    __nv_bfloat16* orow = obase + (int64_t)row * kp.o_stride[2];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * t) =
          pack_bf16(o[4 * i + 2 * r] / safe_l, o[4 * i + 2 * r + 1] / safe_l);
    }
  }
}

template <int D, int BK>
int launch(const FaWgArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, a.q, a.b, a.hq, a.sq, D, a.q_stride, BQ);
  if (err == 0) err = make_map(&mk, a.k, a.b, a.hkv, a.sk, D, a.k_stride, BK);
  if (err == 0) err = make_map(&mv, a.v, a.b, a.hkv, a.sk, D, a.v_stride, BK);
  if (err != 0) return err;
  KParams kp;
  kp.o = static_cast<__nv_bfloat16*>(a.o);
  for (int i = 0; i < 3; ++i) kp.o_stride[i] = a.o_stride[i];
  kp.hq = a.hq;
  kp.hkv = a.hkv;
  kp.sq = a.sq;
  kp.sk = a.sk;
  kp.causal = a.causal;
  kp.has_window = a.has_window;
  kp.window = a.window;
  kp.scale_log2 = a.scale * 1.4426950408889634f;
  kp.lse = a.lse;
  const size_t smem = Tile<D, BK>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(fa_wgmma_kernel<D, BK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.hq);
  fa_wgmma_kernel<D, BK><<<grid, NTHREADS, smem, stream>>>(mq, mk, mv, kp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fa_wgmma_args_size() { return (int)sizeof(FaWgArgs); }

// Launch on `stream`; returns 0, cudaGetLastError() of the launch, or one
// of hopper_wgmma.cuh's codes.
extern "C" int fa_wgmma_launch(const FaWgArgs* a, void* stream) {
  if ((a->d != 64 && a->d != 128 && a->d != 256) || a->hkv <= 0 || a->hq % a->hkv || a->sq <= 0 || a->sk < 0 ||
      a->b * a->hq <= 0 || a->b * a->hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->d == 256) return launch<256, 64>(*a, s);
  return a->d == 64 ? launch<64, 128>(*a, s) : launch<128, 128>(*a, s);
}
