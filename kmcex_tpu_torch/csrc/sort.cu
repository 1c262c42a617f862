// Ascending sort of 64-bit keys (+ optional 32-bit payload) on Hopper.
//
// Replaces the TPU bitonic network of kmcex_tpu/count/sort_pallas.py:
//   K1 _block_sort_kernel (sort_pallas.py:177-215, pallas_call :203) — the
//      in-VMEM sort of each 2^18-element block;
//   K2 _hbm_step_kernel (sort_pallas.py:218-296, pallas_call :266) — one
//      cross-block compare-exchange per bitonic step, run level by level
//      by _merge_tree.
// It keeps their contract, not their layout: unsigned ascending order,
// SENTINEL (all ones) last, each payload following its key.  The (hi, lo)
// u32 planes, the column-major tile order and the even-block flush rule
// were TPU-only and are gone; keys are read as unsigned long long.
//
// Design (a plain bitonic sort over a power-of-two array, N >= 2048):
//   * tile_sort    — one block of 1024 threads sorts each 2048-key tile in
//                    shared memory (24 KB with payloads), all stages k <= 2048;
//   * global_step  — for every stage k > 2048 and stride j >= 2048, one
//                    compare-exchange pass over device memory;
//   * tile_merge   — the strides j < 2048 of stage k, finished in shared
//                    memory, one tile per block.
// With a payload, equal keys are ordered by payload (lexicographic compare),
// so the wrapper's padding (SENTINEL, 0xFFFFFFFF) always sorts behind any
// input entry and the first n outputs are exactly the input multiset.
//
// What bounds it on an H100: device-memory traffic.  Every global_step reads
// and writes the whole array once (12 bytes per key with a payload), and a
// sort of N = 2^m keys runs (m-11)(m-10)/2 of them (120 passes at 2^26),
// so it moves ~120 * 2 * 12 * N bytes — far more than an LSD radix sort's
// ~8 passes.  The design keeps every stride below 2048 in shared memory to
// cut the pass count; a radix sort is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

namespace {

constexpr int TILE = 2048;
constexpr int TILE_THREADS = TILE / 2;

template <bool PAY>
__device__ __forceinline__ bool greater(u64 ka, u32 pa, u64 kb, u32 pb) {
  if (PAY) return ka > kb || (ka == kb && pa > pb);
  return ka > kb;
}

// Compare-exchange of slots i < l so that (asc ? ascending : descending).
template <bool PAY>
__device__ __forceinline__ void cas(u64* k, u32* p, long long i, long long l,
                                    bool asc) {
  u64 a = k[i], b = k[l];
  u32 pa = PAY ? p[i] : 0u, pb = PAY ? p[l] : 0u;
  if (greater<PAY>(a, pa, b, pb) == asc) {
    k[i] = b;
    k[l] = a;
    if (PAY) {
      p[i] = pb;
      p[l] = pa;
    }
  }
}

// Strides j = jmax .. 1 inside one shared-memory tile; stage k's direction
// comes from the GLOBAL index (base + i).
template <bool PAY>
__device__ __forceinline__ void tile_strides(u64* sk, u32* sp, long long base,
                                             u64 k, int jmax) {
  const int t = threadIdx.x;
  for (int j = jmax; j > 0; j >>= 1) {
    int i = 2 * t - (t & (j - 1));
    bool asc = (((u64)(base + i)) & k) == 0;
    cas<PAY>(sk, sp, i, i + j, asc);
    __syncthreads();
  }
}

template <bool PAY>
__device__ __forceinline__ void tile_load(const u64* keys, const u32* pay,
                                          long long base, u64* sk, u32* sp) {
  const int t = threadIdx.x;
  sk[t] = keys[base + t];
  sk[t + TILE_THREADS] = keys[base + t + TILE_THREADS];
  if (PAY) {
    sp[t] = pay[base + t];
    sp[t + TILE_THREADS] = pay[base + t + TILE_THREADS];
  }
  __syncthreads();
}

template <bool PAY>
__device__ __forceinline__ void tile_store(u64* keys, u32* pay, long long base,
                                           const u64* sk, const u32* sp) {
  const int t = threadIdx.x;
  keys[base + t] = sk[t];
  keys[base + t + TILE_THREADS] = sk[t + TILE_THREADS];
  if (PAY) {
    pay[base + t] = sp[t];
    pay[base + t + TILE_THREADS] = sp[t + TILE_THREADS];
  }
}

template <bool PAY>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_sort(u64* keys, u32* pay) {
  __shared__ u64 sk[TILE];
  __shared__ u32 sp[PAY ? TILE : 1];
  const long long base = (long long)blockIdx.x * TILE;
  tile_load<PAY>(keys, pay, base, sk, sp);
  for (int k = 2; k <= TILE; k <<= 1) tile_strides<PAY>(sk, sp, base, k, k >> 1);
  tile_store<PAY>(keys, pay, base, sk, sp);
}

template <bool PAY>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_merge(u64* keys, u32* pay, u64 k) {
  __shared__ u64 sk[TILE];
  __shared__ u32 sp[PAY ? TILE : 1];
  const long long base = (long long)blockIdx.x * TILE;
  tile_load<PAY>(keys, pay, base, sk, sp);
  tile_strides<PAY>(sk, sp, base, k, TILE / 2);
  tile_store<PAY>(keys, pay, base, sk, sp);
}

template <bool PAY>
__global__ void global_step(u64* keys, u32* pay, long long half, u64 k,
                            long long j) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  long long i = 2 * t - (t & (j - 1));
  bool asc = (((u64)i) & k) == 0;
  cas<PAY>(keys, pay, i, i + j, asc);
}

template <bool PAY>
cudaError_t run_sort(u64* keys, u32* pay, long long n, cudaStream_t s) {
  const long long tiles = n / TILE;
  const long long half = n / 2;
  const int gthreads = 256;
  const long long gblocks = (half + gthreads - 1) / gthreads;
  tile_sort<PAY><<<(unsigned)tiles, TILE_THREADS, 0, s>>>(keys, pay);
  for (u64 k = 2 * TILE; k <= (u64)n; k <<= 1) {
    for (long long j = (long long)(k >> 1); j >= TILE; j >>= 1)
      global_step<PAY><<<(unsigned)gblocks, gthreads, 0, s>>>(keys, pay, half,
                                                              k, j);
    tile_merge<PAY><<<(unsigned)tiles, TILE_THREADS, 0, s>>>(keys, pay, k);
  }
  return cudaGetLastError();
}

}  // namespace

// Sorts keys[0:n) (and payload, when not null) in place, ascending.
// n must be a power of two >= 2048 (the wrapper pads with SENTINEL).
extern "C" int kx_sort_u64(void* keys, void* payload, long long n,
                           void* stream) {
  if (n < TILE || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = payload
                      ? run_sort<true>((u64*)keys, (u32*)payload, n, s)
                      : run_sort<false>((u64*)keys, nullptr, n, s);
  return (int)e;
}
