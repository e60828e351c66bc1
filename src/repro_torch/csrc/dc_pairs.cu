// DC theta-join scan for Hopper (sm_90a): the fused both-role pair scan and,
// by a compile-time role switch, the single-role scan.
//
// Replaces repro/kernels/dc_pairs.py::dc_pair_scan_pallas (body _pair_kernel)
// and dc_role_scan_pallas (body _role_kernel).  For every row i of the
// worklist's row blocks and every in-scope partner j of its col blocks (j != i
// by global id), role t1 tests the atoms as written, role t2 the flipped atoms
// with the column sides swapped.  Per row and role it counts the partners for
// which every atom holds and keeps, per atom, the min or max of the partner's
// value.  The role scan (kBoth = false) is role t1 alone.
//
// What bounds it on this card: operations.  Every worklist pair costs a few
// 32-bit instructions per role and atom, and the inputs are a few bytes per
// ROW, so the scan does O(n^2) work over O(n) bytes.  The design spends as few
// instructions per pair and role as it can:
//   * every atom is one range test on int32 keys that the wrapper
//     (kernels/dc_pairs.py) prepares on the device: for a row value x the
//     partners y with `x op y` form one interval, possibly wrapping, of an
//     order-preserving key, so the test is `(uint32)(key_y - lo_x) <= span_x`
//     whatever the op and dtype (no op switch, no int-or-float branch; NaN,
//     -0.0 and int-to-float rounding are settled in the keys).  A row whose
//     atom can hold for no partner is flagged dead and writes nothing;
//   * the reduce is always a min: a max-reduced key is stored bit-inverted,
//     and a NaN partner is stored as INT32_MIN so that it wins, as in XLA.
//     The wrapper decodes the keys to the column's dtype after the launch;
//   * the kernel is a template on the atom count (1-4, and 8 as the generic
//     path, whose unused atoms always hold) and on the role switch; per
//     (row, partner) the hold test and its updates are predicated PTX: N
//     range compares, one predicated add and N predicated mins (in C++
//     the compiler makes each predicated min a compare and a select);
//   * each thread holds R rows in registers, and partner keys come from
//     shared memory as 16-byte vectors, so one load feeds 4 partners x R
//     rows; the col tiles stream through a two-stage cp.async ring, and a
//     tile whose partners all lie in the col scope skips the scope test;
//   * the CTA's rows are one worklist row block (or a piece of it), and its
//     col blocks one chunk of the worklist's col list: a grid of (row item,
//     col chunk, shard) sized to about DC_WAVES waves of resident CTAs.  A
//     sharded launch (the logical shards of sharded detection, DESIGN.md
//     §8) lays the shards out one after another, shard_blocks blocks each,
//     and runs the worklist inside every shard: shard s pairs its blocks
//     rid[i] + s * shard_blocks with cid[j] + s * shard_blocks only, so
//     one launch scans the block diagonal of all shards.
//     Chunks merge with integer atomics (add for counts, min for the keys),
//     which commute, so the result is the same bits in any order;
//   * the per-block bound pruning (the paper's partition pruning) is
//     evaluated once per (row block, col block) item into a shared list of
//     the surviving col blocks; the diagonal test j != i runs only in tiles
//     whose col block is the row block.
// wgmma and TMA do not apply to comparisons.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define DC_MAX_ATOMS 8
#define DC_MAX_DISTINCT 16
#define DC_MAX_ARRAYS 32  // partner key arrays: compare and stat, per role and atom
#define DC_TILE 256       // partners per shared-memory tile
#define DC_MAX_LIST 1024  // col blocks per chunk (the shared list's length)
#define DC_MAX_THREADS 256
// rows a thread holds for one or two atoms, and for three or four (the
// generic path holds 2); CTA waves over every SM that the chunking aims for
#define DC_ROWS_FEW 4
#define DC_ROWS_MANY 2
#define DC_WAVES 16

// atom op codes (kernels/dc_pairs.py::_OP_CODE), used by the tile pruning only
#define OP_EQ 0
#define OP_NE 1
#define OP_LT 2
#define OP_LE 3
#define OP_GT 4
#define OP_GE 5

struct ScanArgs {
  const int32_t* keys[DC_MAX_ARRAYS];  // (npad,) stored partner keys, one per array
  const int32_t* valid;                // (npad,) col scope, 0 or 1
  const uint8_t* full;                 // [nb][tiles a block]: every partner in scope
  const int32_t* lo;                   // [roles][kernel_atoms][npad] interval starts
  const int32_t* span;                 // [roles][kernel_atoms][npad] interval lengths - 1
  const uint8_t* alive;                // [roles][npad] row in scope, no atom dead
  const int32_t* bounds;               // [4][n_distinct][nb] raw 32-bit widened bounds
  const int32_t* rid;                  // (nrows,) worklist row block ids
  const int32_t* cid;                  // (ncols,) worklist col block ids
  int32_t* count;                      // [roles][npad], zeroed
  int32_t* stat;                       // [roles][kernel_atoms][npad], INT32_MAX
  int32_t cmp_arr[2][DC_MAX_ATOMS];    // key array each role's atom compares
  int32_t stat_arr[2][DC_MAX_ATOMS];   // key array each role's atom reduces
  int32_t op[2][DC_MAX_ATOMS];         // each role's atom op, for the pruning
  int32_t row_col[2][DC_MAX_ATOMS];    // distinct column on the row side
  int32_t par_col[2][DC_MAX_ATOMS];    // distinct column on the partner side
  int32_t col_float[DC_MAX_DISTINCT];  // distinct column is bf16 or float32
  int32_t n_arrays;
  int32_t nrows;
  int32_t ncols;
  int32_t nb;
  int32_t block;
  int32_t n_distinct;
  int32_t n_atoms;
  int32_t kernel_atoms;  // 1-4, or 8: the generic path
  int32_t chunks;        // col chunks (0: fill the card)
  int32_t pieces;        // CTAs a row block, set by the launch
  int32_t n_shards;      // shards of a sharded launch (1: one grid)
  int32_t shard_blocks;  // blocks a shard: shard s's block b is s * shard_blocks + b
};

__device__ __forceinline__ float as_f(int32_t bits, bool fl) {
  return fl ? __int_as_float(bits) : (float)bits;
}

// Can `l op r` hold for some l in [lmin, lmax], r in [rmin, rmax]?  A NaN
// bound (a NaN in scope) proves nothing, so the tile stays possible.
__device__ __forceinline__ bool tile_possible(int op, int32_t lmin, int32_t lmax, bool lf,
                                              int32_t rmin, int32_t rmax, bool rf) {
  if (lf || rf) {
    float a = as_f(lmin, lf), b = as_f(lmax, lf), c = as_f(rmin, rf), d = as_f(rmax, rf);
    if (isnan(a) || isnan(b) || isnan(c) || isnan(d)) return true;
    switch (op) {
      case OP_LT: return a < d;
      case OP_LE: return a <= d;
      case OP_GT: return b > c;
      case OP_GE: return b >= c;
      case OP_EQ: return a <= d && c <= b;
      default: return !(a == b && c == d && a == c);
    }
  }
  int32_t a = lmin, b = lmax, c = rmin, d = rmax;
  switch (op) {
    case OP_LT: return a < d;
    case OP_LE: return a <= d;
    case OP_GT: return b > c;
    case OP_GE: return b >= c;
    case OP_EQ: return a <= d && c <= b;
    default: return !(a == b && c == d && a == c);
  }
}

// Role `role`'s pruning predicate for the tile (row block rb, col block cb).
__device__ __forceinline__ bool role_possible(const ScanArgs& a, int role, int rb, int cb) {
  const int nb = a.nb, nd = a.n_distinct;
  const int32_t* row_min = a.bounds;
  const int32_t* row_max = a.bounds + nd * nb;
  const int32_t* col_min = a.bounds + 2 * nd * nb;
  const int32_t* col_max = a.bounds + 3 * nd * nb;
  bool ok = true;
  for (int i = 0; i < a.n_atoms; ++i) {
    const int rc = a.row_col[role][i], pc = a.par_col[role][i];
    ok = ok && tile_possible(a.op[role][i], row_min[rc * nb + rb], row_max[rc * nb + rb],
                             a.col_float[rc] != 0, col_min[pc * nb + cb],
                             col_max[pc * nb + cb], a.col_float[pc] != 0);
  }
  return ok;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// One role's state for the R rows a thread holds.
template <int N, int R>
struct RoleState {
  uint32_t nlo[R][N];  // -lo: the test is key + nlo <= span
  uint32_t span[R][N];
  int32_t s[R][N];  // running min of the stored stat keys
  int32_t c[R];
  bool alive[R];
  int off[N];   // shared-memory offset of each atom's compare keys
  int soff[N];  // and of its stat keys
};

template <int N, int R>
__device__ __forceinline__ void init_role(RoleState<N, R>& st, const ScanArgs& a, int role,
                                          int rb, const int (&loc)[R], size_t np) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.off[i] = a.cmp_arr[role][i] * DC_TILE;
    st.soff[i] = a.stat_arr[role][i] * DC_TILE;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool active = loc[r] < a.block;
    const size_t row = (size_t)rb * a.block + loc[r];
    st.alive[r] = active && a.alive[role * np + row] != 0;
    st.c[r] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const size_t at = ((size_t)role * N + i) * np + row;
      st.nlo[r][i] = active ? 0u - (uint32_t)a.lo[at] : 0u;
      st.span[r][i] = active ? (uint32_t)a.span[at] : 0u;
      st.s[r][i] = INT32_MAX;
    }
  }
}

// One (row, partner) pair of one role as predicated PTX: the hold predicate
// is the AND of the atoms' range tests `d <= sp` (d = key - lo) and, unless
// kAll, of the partner's scope; the count and each stat's min are
// predicated on it.  Left to itself the compiler makes each predicated
// update a compare and a select.
template <int N, bool kAll>
__device__ __forceinline__ void pair_ptx(int32_t& c, int32_t (&s)[N], const int32_t (&v)[N],
                                         const uint32_t (&d)[N], const uint32_t (&sp)[N],
                                         int32_t valid) {
  if constexpr (N == 1 && kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.u32 p, %3, %4;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %2;\n\t"
        "}"
        : "+r"(c), "+r"(s[0])
        : "r"(v[0]), "r"(d[0]), "r"(sp[0]));
  } else if constexpr (N == 1 && !kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.ne.s32 p, %5, 0;\n\t"
        "setp.le.and.u32 p, %3, %4, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %2;\n\t"
        "}"
        : "+r"(c), "+r"(s[0])
        : "r"(v[0]), "r"(d[0]), "r"(sp[0]), "r"(valid));
  } else if constexpr (N == 2 && kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.u32 p, %5, %7;\n\t"
        "setp.le.and.u32 p, %6, %8, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %3;\n\t"
        "@p min.s32 %2, %2, %4;\n\t"
        "}"
        : "+r"(c), "+r"(s[0]), "+r"(s[1])
        : "r"(v[0]), "r"(v[1]), "r"(d[0]), "r"(d[1]), "r"(sp[0]), "r"(sp[1]));
  } else if constexpr (N == 2 && !kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.ne.s32 p, %9, 0;\n\t"
        "setp.le.and.u32 p, %5, %7, p;\n\t"
        "setp.le.and.u32 p, %6, %8, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %3;\n\t"
        "@p min.s32 %2, %2, %4;\n\t"
        "}"
        : "+r"(c), "+r"(s[0]), "+r"(s[1])
        : "r"(v[0]), "r"(v[1]), "r"(d[0]), "r"(d[1]), "r"(sp[0]), "r"(sp[1]), "r"(valid));
  } else if constexpr (N == 3 && kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.u32 p, %7, %10;\n\t"
        "setp.le.and.u32 p, %8, %11, p;\n\t"
        "setp.le.and.u32 p, %9, %12, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %4;\n\t"
        "@p min.s32 %2, %2, %5;\n\t"
        "@p min.s32 %3, %3, %6;\n\t"
        "}"
        : "+r"(c), "+r"(s[0]), "+r"(s[1]), "+r"(s[2])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(sp[0]), "r"(sp[1]),
          "r"(sp[2]));
  } else if constexpr (N == 3 && !kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.ne.s32 p, %13, 0;\n\t"
        "setp.le.and.u32 p, %7, %10, p;\n\t"
        "setp.le.and.u32 p, %8, %11, p;\n\t"
        "setp.le.and.u32 p, %9, %12, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %4;\n\t"
        "@p min.s32 %2, %2, %5;\n\t"
        "@p min.s32 %3, %3, %6;\n\t"
        "}"
        : "+r"(c), "+r"(s[0]), "+r"(s[1]), "+r"(s[2])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(sp[0]), "r"(sp[1]),
          "r"(sp[2]), "r"(valid));
  } else if constexpr (N == 4 && kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.u32 p, %9, %13;\n\t"
        "setp.le.and.u32 p, %10, %14, p;\n\t"
        "setp.le.and.u32 p, %11, %15, p;\n\t"
        "setp.le.and.u32 p, %12, %16, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %5;\n\t"
        "@p min.s32 %2, %2, %6;\n\t"
        "@p min.s32 %3, %3, %7;\n\t"
        "@p min.s32 %4, %4, %8;\n\t"
        "}"
        : "+r"(c), "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]),
          "r"(sp[0]), "r"(sp[1]), "r"(sp[2]), "r"(sp[3]));
  } else if constexpr (N == 4 && !kAll) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.ne.s32 p, %17, 0;\n\t"
        "setp.le.and.u32 p, %9, %13, p;\n\t"
        "setp.le.and.u32 p, %10, %14, p;\n\t"
        "setp.le.and.u32 p, %11, %15, p;\n\t"
        "setp.le.and.u32 p, %12, %16, p;\n\t"
        "@p add.s32 %0, %0, 1;\n\t"
        "@p min.s32 %1, %1, %5;\n\t"
        "@p min.s32 %2, %2, %6;\n\t"
        "@p min.s32 %3, %3, %7;\n\t"
        "@p min.s32 %4, %4, %8;\n\t"
        "}"
        : "+r"(c), "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]),
          "r"(sp[0]), "r"(sp[1]), "r"(sp[2]), "r"(sp[3]), "r"(valid));
  }

}

// Compare one shared-memory tile of `len4` partners (a multiple of V) against
// the thread's R rows for one role.  `pbase` is the tile's first partner
// within its col block; kDiag excludes the partner whose index equals the
// row's (the tile's col block is the row block); kAll: every partner of the
// tile is in scope, so the scope test is skipped.
template <int N, int R, int V, bool kSplit, bool kDiag, bool kAll>
__device__ __forceinline__ void role_tile(RoleState<N, R>& st, const int32_t* buf,
                                          const int32_t* vbuf, int len4, int pbase,
                                          const int (&loc)[R]) {
  for (int j = 0; j < len4; j += V) {
    int32_t vv[V], kk[N][V], ks[N][V];
    if constexpr (V == 4) {
      const int4 t = *reinterpret_cast<const int4*>(vbuf + j);
      vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int4 k = *reinterpret_cast<const int4*>(buf + st.off[i] + j);
        kk[i][0] = k.x; kk[i][1] = k.y; kk[i][2] = k.z; kk[i][3] = k.w;
        if (kSplit) {
          const int4 s = *reinterpret_cast<const int4*>(buf + st.soff[i] + j);
          ks[i][0] = s.x; ks[i][1] = s.y; ks[i][2] = s.z; ks[i][3] = s.w;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        vv[q] = vbuf[j + q];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          kk[i][q] = buf[st.off[i] + j + q];
          if (kSplit) ks[i][q] = buf[st.soff[i] + j + q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (N <= 4 && !kSplit && !kDiag) {
          int32_t v[N];
          uint32_t d[N];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            v[i] = kk[i][q];
            d[i] = (uint32_t)kk[i][q] + st.nlo[r][i];
          }
          pair_ptx<N, kAll>(st.c[r], st.s[r], v, d, st.span[r], vv[q]);
        } else {
          bool h = kAll || vv[q] != 0;
          if (kDiag) h = h & (pbase + j + q != loc[r]);
#pragma unroll
          for (int i = 0; i < N; ++i)
            h = h & ((uint32_t)kk[i][q] + st.nlo[r][i] <= st.span[r][i]);
          st.c[r] += h;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const int32_t v = kSplit ? ks[i][q] : kk[i][q];
            st.s[r][i] = h ? min(st.s[r][i], v) : st.s[r][i];
          }
        }
      }
    }
  }
}

template <int N, int R>
__device__ __forceinline__ void flush_role(const RoleState<N, R>& st, const ScanArgs& a,
                                           int role, int rb, const int (&loc)[R], size_t np) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!st.alive[r] || st.c[r] == 0) continue;
    const size_t row = (size_t)rb * a.block + loc[r];
    atomicAdd(a.count + role * np + row, st.c[r]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < a.n_atoms) atomicMin(a.stat + ((size_t)role * N + i) * np + row, st.s[r][i]);
  }
}

template <int N, int R, int V, bool kSplit>
__device__ __forceinline__ void scan_tile(RoleState<N, R>& st, const int32_t* buf,
                                          const int32_t* vbuf, int len4, int pbase,
                                          const int (&loc)[R], bool diag, bool all) {
  if (diag) role_tile<N, R, V, kSplit, true, false>(st, buf, vbuf, len4, pbase, loc);
  else if (all) role_tile<N, R, V, kSplit, false, true>(st, buf, vbuf, len4, pbase, loc);
  else role_tile<N, R, V, kSplit, false, false>(st, buf, vbuf, len4, pbase, loc);
}

// grid: x = (worklist row block, piece of it), y = col chunk, z = shard.
template <int N, int R, int V, bool kBoth, bool kSplit>
__global__ void __launch_bounds__(DC_MAX_THREADS, 1) dc_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int s_items;
  const int T = blockDim.x, t = threadIdx.x;
  const int stage_words = (a.n_arrays + 1) * DC_TILE;
  uint32_t* list = reinterpret_cast<uint32_t*>(smem + 2 * stage_words);
  const int shard0 = (int)blockIdx.z * a.shard_blocks;
  const int rb = a.rid[blockIdx.x / a.pieces] + shard0;
  const int piece = blockIdx.x % a.pieces;
  const int c0 = (int)((long long)blockIdx.y * a.ncols / gridDim.y);
  const int c1 = (int)((long long)(blockIdx.y + 1) * a.ncols / gridDim.y);
  const size_t np = (size_t)a.nb * a.block;

  // the chunk's col blocks that some role cannot prune, in any order
  if (t == 0) s_items = 0;
  __syncthreads();
  for (int ci = c0 + t; ci < c1; ci += T) {
    const int cb = a.cid[ci] + shard0;
    const bool p1 = role_possible(a, 0, rb, cb);
    const bool p2 = kBoth && role_possible(a, 1, rb, cb);
    if (p1 || p2)
      list[atomicAdd(&s_items, 1)] = (uint32_t)ci | (p1 ? 1u << 30 : 0u) | (p2 ? 1u << 31 : 0u);
  }

  int loc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) loc[r] = (piece * R + r) * T + t;
  RoleState<N, R> st1, st2;
  init_role(st1, a, 0, rb, loc, np);
  if (kBoth) init_role(st2, a, 1, rb, loc, np);
  __syncthreads();

  const int nsub = (a.block + DC_TILE - 1) / DC_TILE;
  const int total = s_items * nsub;
  // stage a tile: every key array and the col scope of partners
  // [sub * DC_TILE, + len) of the item's col block; slots up to len4 are
  // out of scope
  auto load_tile = [&](int it, int stage) {
    const uint32_t e = list[it / nsub];
    const int sub = it % nsub;
    const int cb = a.cid[e & 0x3fffffffu] + shard0;
    const int first = sub * DC_TILE;
    const int len = min(DC_TILE, a.block - first);
    const int len4 = (len + V - 1) / V * V;
    const size_t base = (size_t)cb * a.block + first;
    int32_t* dst = smem + stage * stage_words;
    for (int arr = 0; arr <= a.n_arrays; ++arr) {
      const int32_t* src = (arr < a.n_arrays ? a.keys[arr] : a.valid) + base;
      int32_t* d = dst + arr * DC_TILE;
      for (int j = t; j < len4; j += T) {
        if (j < len) cp_async4(d + j, src + j);
        else d[j] = 0;
      }
    }
    cp_async_commit();
  };

  if (total > 0) load_tile(0, 0);
  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    if (it + 1 < total) {
      load_tile(it + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t e = list[it / nsub];
    const int sub = it % nsub;
    const int cb = a.cid[e & 0x3fffffffu] + shard0;
    const int first = sub * DC_TILE;
    const int len4 = (min(DC_TILE, a.block - first) + V - 1) / V * V;
    const int32_t* buf = smem + stage * stage_words;
    const int32_t* vbuf = buf + a.n_arrays * DC_TILE;
    const bool diag = cb == rb;
    const bool all = len4 == min(DC_TILE, a.block - first) && a.full[cb * nsub + sub] != 0;
    if ((e >> 30) & 1u) scan_tile<N, R, V, kSplit>(st1, buf, vbuf, len4, first, loc, diag, all);
    if (kBoth && (e >> 31)) scan_tile<N, R, V, kSplit>(st2, buf, vbuf, len4, first, loc, diag, all);
    __syncthreads();  // the stage is rewritten two items on
  }

  flush_role(st1, a, 0, rb, loc, np);
  if (kBoth) flush_role(st2, a, 1, rb, loc, np);
}

template <int N, int R, int V, bool kBoth, bool kSplit>
static int launch(ScanArgs* a, cudaStream_t stream) {
  auto kern = dc_scan_kernel<N, R, V, kBoth, kSplit>;
  const int threads = std::min(DC_MAX_THREADS, ((a->block + R - 1) / R + 31) / 32 * 32);
  const int pieces = (a->block + threads * R - 1) / (threads * R);
  const long long row_items = (long long)a->nrows * pieces;
  if (row_items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (a->n_shards < 1 || a->n_shards > 65535 || a->shard_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const size_t stage_bytes = (size_t)(a->n_arrays + 1) * DC_TILE * sizeof(int32_t);
  const size_t smem_max = 2 * stage_bytes + DC_MAX_LIST * sizeof(uint32_t);
  cudaError_t err = cudaSuccess;
  if (smem_max > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err != cudaSuccess) return (int)err;
  }
  long long chunks = a->chunks;
  if (chunks <= 0) {  // about DC_WAVES waves of CTAs over every SM
    int dev = 0, sms = 1, per_sm = 1;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem_max);
    if (err != cudaSuccess) return (int)err;
    const long long target = (long long)DC_WAVES * (per_sm > 0 ? per_sm : 1) * sms;
    const long long items = row_items * a->n_shards;
    chunks = (target + items - 1) / items;
  }
  chunks = std::max(chunks, (long long)(a->ncols + DC_MAX_LIST - 1) / DC_MAX_LIST);
  chunks = std::min(chunks, (long long)a->ncols);
  chunks = std::min(chunks, 65535LL);
  if (chunks < 1) chunks = 1;
  const int list_len = (int)((a->ncols + chunks - 1) / chunks);
  if (list_len > DC_MAX_LIST) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = 2 * stage_bytes + (size_t)list_len * sizeof(uint32_t);
  a->pieces = pieces;
  kern<<<dim3((unsigned)row_items, (unsigned)chunks, (unsigned)a->n_shards), threads, smem,
         stream>>>(*a);
  return (int)cudaGetLastError();
}

template <bool kBoth>
static int dispatch(ScanArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->n_arrays < 1 || a->n_arrays > DC_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  switch (a->kernel_atoms) {
    case 1: return launch<1, DC_ROWS_FEW, 4, kBoth, false>(a, s);
    case 2: return launch<2, DC_ROWS_FEW, 4, kBoth, false>(a, s);
    case 3: return launch<3, DC_ROWS_MANY, 4, kBoth, false>(a, s);
    case 4: return launch<4, DC_ROWS_MANY, 4, kBoth, false>(a, s);
    case DC_MAX_ATOMS: return launch<DC_MAX_ATOMS, 2, 1, kBoth, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int dc_max_atoms() { return DC_MAX_ATOMS; }
int dc_max_distinct() { return DC_MAX_DISTINCT; }
int dc_max_arrays() { return DC_MAX_ARRAYS; }
int dc_tile() { return DC_TILE; }
int dc_args_size() { return (int)sizeof(ScanArgs); }

// Launch the fused both-role scan on `stream`; returns cudaGetLastError().
int dc_pair_scan_launch(ScanArgs* args, void* stream) { return dispatch<true>(args, stream); }

// Launch the role-t1 scan (role t2's arrays unread).
int dc_role_scan_launch(ScanArgs* args, void* stream) { return dispatch<false>(args, stream); }

}  // extern "C"
