// Semijoin membership for Hopper (sm_90a): a hash build and probe.
//
// Replaces repro/kernels/semijoin.py::semijoin_pallas (body _kernel).  For
// each query key i: out[i] = query_mask[i] && (some j with keys_mask[j] has
// keys[j] == query[i]).  One dictionary-coded int32 column on both sides;
// equality is C's == on int32, as jnp's == (the TPU kernel's
// q[:, None] == k[None, :]).
//
// What bounds it on this card: bytes.  The function needs one insert for
// each live key and one probe for each live query, O(n + m) work over
// O(n + m) bytes, so the least time is the bytes over HBM bandwidth.  The
// TPU kernel compares every query with every key block (O(n m)); the design
// here does the function's own work instead:
//   * the table is open addressing in device memory, `slots` 64-bit slots
//     (a power of two at least twice the keys: kernels/semijoin.py::
//     table_slots), so at most half full; at SF1 (75,000 keys) it is 262,144
//     slots, 2 MB, and stays in the 50 MB L2 for the probe;
//   * a slot holds (1 << 32) | uint32(key) and an empty slot is 0, so the
//     slot alone marks occupancy and every int32 value (INT32_MIN, -1, 0) is
//     an ordinary key with no sentinel;
//   * the wrapper allocates the table with torch.empty; the launch clears it
//     with cudaMemsetAsync on the same stream, then runs the build and the
//     probe there: the kernels allocate nothing;
//   * build: one thread per key inserts each masked-in key with a 64-bit
//     atomicCAS and linear probing; a duplicate stops at its equal slot;
//   * the hash is Murmur3's 32-bit finalizer: SF1's keys are a permutation
//     of 0..74,999 and codes can be multiples of the table size, so an
//     identity or multiply-and-mask hash would pile keys into runs;
//   * probe: one thread per query; a live query probes until it meets its
//     key or an empty slot (the table is at most half full, so runs are
//     short); each output is written once, by its thread, with no atomics;
//   * the TPU kernel's key block size plays no part here: the wrapper keeps
//     `block` in its signature for the plain version, which blocks by it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned long long slot_of(int32_t key) {
  return (1ull << 32) | (unsigned long long)(uint32_t)key;
}

__global__ void __launch_bounds__(THREADS) semijoin_build(
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ keys_mask,
    unsigned long long* __restrict__ table, int m, uint32_t slot_mask) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= m || !keys_mask[j]) return;
  const int32_t key = keys[j];
  const unsigned long long want = slot_of(key);
  uint32_t h = mix32((uint32_t)key) & slot_mask;
  while (true) {
    const unsigned long long prev = atomicCAS(&table[h], 0ull, want);
    if (prev == 0ull || prev == want) return;
    h = (h + 1) & slot_mask;
  }
}

__global__ void __launch_bounds__(THREADS) semijoin_probe(
    const int32_t* __restrict__ query, const uint8_t* __restrict__ query_mask,
    const unsigned long long* __restrict__ table, uint8_t* __restrict__ out, int n,
    uint32_t slot_mask) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  bool found = false;
  if (query_mask[i]) {
    const int32_t q = query[i];
    const unsigned long long want = slot_of(q);
    uint32_t h = mix32((uint32_t)q) & slot_mask;
    while (true) {
      const unsigned long long v = __ldg(&table[h]);
      if (v == want) {
        found = true;
        break;
      }
      if (v == 0ull) break;
      h = (h + 1) & slot_mask;
    }
  }
  out[i] = (uint8_t)found;
}

}  // namespace

extern "C" {

// Clear the table, build it from the live keys and probe it with the
// queries, all on `stream`; `slots` is a power of two.  Returns the first
// CUDA error of the three steps.
int semijoin_launch(const void* query, const void* query_mask, const void* keys,
                    const void* keys_mask, void* out, void* table, int n, int m, int slots,
                    void* stream) {
  if (n < 0 || m < 0 || slots <= 0 || (slots & (slots - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t slot_mask = (uint32_t)slots - 1;
  cudaError_t err = cudaMemsetAsync(table, 0, (size_t)slots * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    semijoin_build<<<(m + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        (const int32_t*)keys, (const uint8_t*)keys_mask, (unsigned long long*)table, m,
        slot_mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  semijoin_probe<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const int32_t*)query, (const uint8_t*)query_mask, (const unsigned long long*)table,
      (uint8_t*)out, n, slot_mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
