// DC theta-join scan for Hopper (sm_90a): the fused both-role pair scan and,
// by a compile-time role switch, the single-role scan.
//
// Replaces repro/kernels/dc_pairs.py::dc_pair_scan_pallas (body _pair_kernel)
// and dc_role_scan_pallas (body _role_kernel).  For every row i of the
// worklist's row blocks and every in-scope partner j of its col blocks (j != i
// by global id), role t1 tests the atoms as written, role t2 the flipped atoms
// with the column sides swapped.  Per row and role it counts the partners for
// which every atom holds and keeps, per atom, the min or max of the partner's
// value (the identity of the column's own dtype when the count is 0).  The
// role scan (kBoth = false) is role t1 alone: role t2's tile pruning,
// compares and writes are compiled out, so it does half the pair scan's work.
//
// What bounds it on this card: operations.  Every worklist pair costs a few
// 32-bit comparisons per role and the inputs are a few bytes per ROW, so the
// scan does O(n^2) comparisons over O(n) bytes.  The design keeps the bytes
// out of the way and spends nothing on synchronisation:
//   * one thread block per worklist row block, one thread per row, so each
//     row's atom operands, count and running min/max live in registers;
//   * the block walks the col-block id list; per col block it reads the
//     per-block min/max bounds and skips the tile when some atom cannot hold
//     anywhere in it (the paper's partition pruning, per role), otherwise it
//     stages the distinct atom columns and the col scope of the tile in shared
//     memory once for both roles;
//   * every output element is written once, by its row's thread: no atomics,
//     and the result does not depend on the order blocks run in.
// Comparisons run in an exact widened type: int8/int16/int32 as int32, bf16 and
// float32 as float32 (an atom over an integer and a float column compares in
// float32, like the reference's type promotion).  Min/max follow XLA: NaN
// propagates and -0.0 orders below +0.0.  wgmma and TMA do not apply to
// comparisons; making the scan fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define DC_MAX_ATOMS 8
#define DC_MAX_DISTINCT 16

// column dtype codes (kernels/dc_pairs.py::_DTYPE_CODE)
#define DT_INT32 0
#define DT_FLOAT32 1
#define DT_INT8 2
#define DT_INT16 3
#define DT_BF16 4

// atom op codes (kernels/dc_pairs.py::_OP_CODE)
#define OP_EQ 0
#define OP_NE 1
#define OP_LT 2
#define OP_LE 3
#define OP_GT 4
#define OP_GE 5

#define RED_MIN 0
#define RED_MAX 1

#define CANON_NAN_BITS 0x7fc00000u

struct DcArgs {
  const void* cols[DC_MAX_DISTINCT];  // distinct atom columns, padded to nb*block
  void* stat1[DC_MAX_ATOMS];          // role t1 stats, dtype of the atom's right column
  void* stat2[DC_MAX_ATOMS];          // role t2 stats, dtype of the atom's left column
  const int32_t* bounds;              // [4][n_distinct][nb] raw 32-bit widened bounds
  const uint8_t* row_scope;           // (nb*block,)
  const uint8_t* col_scope;           // (nb*block,)
  const int32_t* rid;                 // (nrows,) worklist row block ids
  const int32_t* cid;                 // (ncols,) worklist col block ids
  int32_t* count1;                    // (nb*block,)
  int32_t* count2;                    // (nb*block,); unused by the role scan
  int32_t col_dtype[DC_MAX_DISTINCT];
  int32_t op1[DC_MAX_ATOMS];
  int32_t op2[DC_MAX_ATOMS];
  int32_t red1[DC_MAX_ATOMS];
  int32_t red2[DC_MAX_ATOMS];
  int32_t l_idx[DC_MAX_ATOMS];
  int32_t r_idx[DC_MAX_ATOMS];
  int32_t nrows;
  int32_t ncols;
  int32_t nb;
  int32_t block;
  int32_t n_distinct;
  int32_t n_atoms;
};

__device__ __forceinline__ bool is_float(int dt) {
  return dt == DT_FLOAT32 || dt == DT_BF16;
}

// Widen element idx of a column to 32 bits: int32 for integer dtypes, float32
// bits for float dtypes.  Both widenings are exact.
__device__ __forceinline__ uint32_t load_wide(const void* p, int dt, int idx) {
  switch (dt) {
    case DT_INT8:
      return (uint32_t)(int32_t)((const int8_t*)p)[idx];
    case DT_INT16:
      return (uint32_t)(int32_t)((const int16_t*)p)[idx];
    case DT_BF16:
      return ((uint32_t)((const uint16_t*)p)[idx]) << 16;
    default:  // int32 and float32 are 32-bit already
      return ((const uint32_t*)p)[idx];
  }
}

__device__ __forceinline__ float as_f(uint32_t bits, bool fl) {
  return fl ? __uint_as_float(bits) : (float)(int32_t)bits;
}

template <typename T>
__device__ __forceinline__ bool apply_op(int op, T x, T y) {
  switch (op) {
    case OP_EQ: return x == y;
    case OP_NE: return x != y;
    case OP_LT: return x < y;
    case OP_LE: return x <= y;
    case OP_GT: return x > y;
    default: return x >= y;
  }
}

// x op y, in int32 when both sides are integers, else in float32.
__device__ __forceinline__ bool compare(int op, uint32_t x, bool xf, uint32_t y, bool yf) {
  if (!xf && !yf) return apply_op<int32_t>(op, (int32_t)x, (int32_t)y);
  return apply_op<float>(op, as_f(x, xf), as_f(y, yf));
}

// Can `l op r` hold for some l in [lmin, lmax], r in [rmin, rmax]?  A NaN
// bound (a NaN in scope) proves nothing, so the tile stays possible.
__device__ __forceinline__ bool tile_possible(int op, uint32_t lmin, uint32_t lmax, bool lf,
                                              uint32_t rmin, uint32_t rmax, bool rf) {
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
  int32_t a = (int32_t)lmin, b = (int32_t)lmax, c = (int32_t)rmin, d = (int32_t)rmax;
  switch (op) {
    case OP_LT: return a < d;
    case OP_LE: return a <= d;
    case OP_GT: return b > c;
    case OP_GE: return b >= c;
    case OP_EQ: return a <= d && c <= b;
    default: return !(a == b && c == d && a == c);
  }
}

// Reduce identity of an output dtype, widened.
__device__ __forceinline__ uint32_t identity(int dt, int red) {
  bool mn = red == RED_MIN;
  switch (dt) {
    case DT_INT8: return (uint32_t)(mn ? 127 : -128);
    case DT_INT16: return (uint32_t)(mn ? 32767 : -32768);
    case DT_INT32: return mn ? 0x7fffffffu : 0x80000000u;
    default: return mn ? 0x7f800000u : 0xff800000u;  // +inf / -inf
  }
}

// XLA's min/max: NaN wins, and -0.0 < +0.0.
__device__ __forceinline__ uint32_t reduce(uint32_t acc, uint32_t v, bool fl, int red) {
  if (!fl) {
    int32_t a = (int32_t)acc, b = (int32_t)v;
    return (uint32_t)(red == RED_MIN ? min(a, b) : max(a, b));
  }
  float a = __uint_as_float(acc), b = __uint_as_float(v);
  if (isnan(a) || isnan(b)) return CANON_NAN_BITS;
  if (a < b) return red == RED_MIN ? acc : v;
  if (b < a) return red == RED_MIN ? v : acc;
  // equal: only the zeros can differ, by sign
  bool neg_acc = acc >> 31;
  if (red == RED_MIN) return neg_acc ? acc : v;
  return neg_acc ? v : acc;
}

__device__ __forceinline__ void store_narrow(void* p, int dt, int idx, uint32_t v) {
  switch (dt) {
    case DT_INT8: ((int8_t*)p)[idx] = (int8_t)(int32_t)v; break;
    case DT_INT16: ((int16_t*)p)[idx] = (int16_t)(int32_t)v; break;
    case DT_BF16: ((uint16_t*)p)[idx] = (uint16_t)(v >> 16); break;
    default: ((uint32_t*)p)[idx] = v; break;
  }
}

template <bool kBoth>
__global__ void dc_scan_kernel(const DcArgs a) {
  extern __shared__ uint32_t tile[];  // [n_distinct][block] col values, then col scope
  uint8_t* tile_scope = (uint8_t*)(tile + a.n_distinct * a.block);
  const int t = threadIdx.x;
  const int rb = a.rid[blockIdx.x];
  const int row = rb * a.block + t;
  const bool in_scope = a.row_scope[row] != 0;
  const int nd = a.n_distinct, nb = a.nb;
  const int32_t* row_min = a.bounds;
  const int32_t* row_max = a.bounds + nd * nb;
  const int32_t* col_min = a.bounds + 2 * nd * nb;
  const int32_t* col_max = a.bounds + 3 * nd * nb;

  uint32_t lv[DC_MAX_ATOMS], rv[DC_MAX_ATOMS], s1[DC_MAX_ATOMS], s2[DC_MAX_ATOMS];
  bool lf[DC_MAX_ATOMS], rf[DC_MAX_ATOMS];
#pragma unroll
  for (int i = 0; i < DC_MAX_ATOMS; ++i) {
    if (i < a.n_atoms) {
      int li = a.l_idx[i], ri = a.r_idx[i];
      lf[i] = is_float(a.col_dtype[li]);
      rf[i] = is_float(a.col_dtype[ri]);
      lv[i] = load_wide(a.cols[li], a.col_dtype[li], row);
      s1[i] = identity(a.col_dtype[ri], a.red1[i]);
      if (kBoth) {
        rv[i] = load_wide(a.cols[ri], a.col_dtype[ri], row);
        s2[i] = identity(a.col_dtype[li], a.red2[i]);
      }
    }
  }
  int c1 = 0, c2 = 0;

  for (int ci = 0; ci < a.ncols; ++ci) {
    const int cb = a.cid[ci];
    // per-role tile pruning from the block bounds; uniform across the block
    bool p1 = true, p2 = kBoth;
#pragma unroll
    for (int i = 0; i < DC_MAX_ATOMS; ++i) {
      if (i < a.n_atoms) {
        int li = a.l_idx[i], ri = a.r_idx[i];
        p1 = p1 && tile_possible(a.op1[i], row_min[li * nb + rb], row_max[li * nb + rb], lf[i],
                                 col_min[ri * nb + cb], col_max[ri * nb + cb], rf[i]);
        if (kBoth)
          p2 = p2 && tile_possible(a.op2[i], row_min[ri * nb + rb], row_max[ri * nb + rb], rf[i],
                                   col_min[li * nb + cb], col_max[li * nb + cb], lf[i]);
      }
    }
    if (!p1 && !p2) continue;
    __syncthreads();  // the previous tile is no longer read
    const int base = cb * a.block;
    for (int d = 0; d < nd; ++d)
      tile[d * a.block + t] = load_wide(a.cols[d], a.col_dtype[d], base + t);
    tile_scope[t] = a.col_scope[base + t];
    __syncthreads();
    if (!in_scope) continue;
    for (int j = 0; j < a.block; ++j) {
      if (!tile_scope[j] || base + j == row) continue;
      if (p1) {
        bool hold = true;
#pragma unroll
        for (int i = 0; i < DC_MAX_ATOMS; ++i)
          if (i < a.n_atoms)
            hold = hold && compare(a.op1[i], lv[i], lf[i], tile[a.r_idx[i] * a.block + j], rf[i]);
        if (hold) {
          ++c1;
#pragma unroll
          for (int i = 0; i < DC_MAX_ATOMS; ++i)
            if (i < a.n_atoms)
              s1[i] = reduce(s1[i], tile[a.r_idx[i] * a.block + j], rf[i], a.red1[i]);
        }
      }
      if (kBoth && p2) {
        bool hold = true;
#pragma unroll
        for (int i = 0; i < DC_MAX_ATOMS; ++i)
          if (i < a.n_atoms)
            hold = hold && compare(a.op2[i], rv[i], rf[i], tile[a.l_idx[i] * a.block + j], lf[i]);
        if (hold) {
          ++c2;
#pragma unroll
          for (int i = 0; i < DC_MAX_ATOMS; ++i)
            if (i < a.n_atoms)
              s2[i] = reduce(s2[i], tile[a.l_idx[i] * a.block + j], lf[i], a.red2[i]);
        }
      }
    }
  }

  a.count1[row] = c1;
  if (kBoth) a.count2[row] = c2;
#pragma unroll
  for (int i = 0; i < DC_MAX_ATOMS; ++i) {
    if (i < a.n_atoms) {
      store_narrow(a.stat1[i], a.col_dtype[a.r_idx[i]], row, s1[i]);
      if (kBoth) store_narrow(a.stat2[i], a.col_dtype[a.l_idx[i]], row, s2[i]);
    }
  }
}

template <bool kBoth>
static int dc_scan_launch(const DcArgs* args, void* stream) {
  size_t smem = (size_t)args->n_distinct * args->block * sizeof(uint32_t) + args->block;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dc_scan_kernel<kBoth>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dc_scan_kernel<kBoth><<<args->nrows, args->block, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" {

int dc_max_atoms() { return DC_MAX_ATOMS; }
int dc_max_distinct() { return DC_MAX_DISTINCT; }
int dc_args_size() { return (int)sizeof(DcArgs); }

// Launch the fused both-role scan on `stream`; returns cudaGetLastError().
int dc_pair_scan_launch(const DcArgs* args, void* stream) {
  return dc_scan_launch<true>(args, stream);
}

// Launch the role-t1 scan (count2, stat2 and op2/red2 unread).
int dc_role_scan_launch(const DcArgs* args, void* stream) {
  return dc_scan_launch<false>(args, stream);
}

}  // extern "C"
