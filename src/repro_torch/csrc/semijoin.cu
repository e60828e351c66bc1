// Blocked semijoin membership for Hopper (sm_90a).
//
// Replaces repro/kernels/semijoin.py::semijoin_pallas (body _kernel).  For
// each query key i: out[i] = query_mask[i] && (some j with keys_mask[j] has
// keys[j] == query[i]).  One dictionary-coded int32 column on both sides.
//
// What bounds it on this card: operations.  The brute-force scan compares
// every query with every masked-in key until it finds a hit, O(n m) int32
// compares over O(n + m) bytes.  The design:
//   * one thread per query key, one thread block per `block` queries; the
//     query, its running hit flag and its mask live in registers;
//   * the keys are walked in tiles of `block`: each tile and its mask are
//     staged in shared memory once per thread block and read by every thread
//     as a broadcast (all threads read the same word at once);
//   * a thread stops comparing once it has a hit, and the whole block leaves
//     the key loop as soon as every thread in it has one (__syncthreads_and);
//   * each output is written once, by its thread: no atomics.
// Equality is C's ==, as jnp's == on int32.  Making it fast (a hash table or
// a sort-merge in place of the scan) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void semijoin_kernel(const int32_t* __restrict__ query,
                                const uint8_t* __restrict__ query_mask,
                                const int32_t* __restrict__ keys,
                                const uint8_t* __restrict__ keys_mask,
                                uint8_t* __restrict__ out, int n, int m) {
  extern __shared__ int32_t tile_keys[];  // [blockDim.x] keys, then the mask
  uint8_t* tile_mask = (uint8_t*)(tile_keys + blockDim.x);
  const int t = threadIdx.x;
  const int bs = blockDim.x;
  const int i = blockIdx.x * bs + t;
  const bool live = i < n && query_mask[i] != 0;
  const int32_t q = i < n ? query[i] : 0;
  bool found = !live;  // a masked-out query needs no hit to be decided

  for (int base = 0; base < m; base += bs) {
    if (__syncthreads_and(found)) break;  // every query of the block decided
    const int j = base + t;
    tile_keys[t] = j < m ? keys[j] : 0;
    tile_mask[t] = j < m ? keys_mask[j] : 0;
    __syncthreads();
    if (!found) {
      const int len = min(bs, m - base);
      for (int k = 0; k < len; ++k) {
        if (tile_mask[k] && tile_keys[k] == q) {
          found = true;
          break;
        }
      }
    }
  }
  if (i < n) out[i] = (uint8_t)(live && found);
}

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.
int semijoin_launch(const void* query, const void* query_mask, const void* keys,
                    const void* keys_mask, void* out, int n, int m, int block, void* stream) {
  if (n == 0) return 0;
  const int grid = (n + block - 1) / block;
  const size_t smem = (size_t)block * (sizeof(int32_t) + sizeof(uint8_t));
  semijoin_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)query, (const uint8_t*)query_mask, (const int32_t*)keys,
      (const uint8_t*)keys_mask, (uint8_t*)out, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
