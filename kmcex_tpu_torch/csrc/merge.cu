// Merge of two ascending (64-bit key, 32-bit payload) runs on Hopper.
//
// Replaces the TPU sorted-run merge of kmcex_tpu/count/sort_pallas.py
// merge_sorted_u64 (:387-412): the final bitonic stage over a ++ reversed b,
// run by
//   K2 _hbm_step_kernel with asc_override (sort_pallas.py:218-296,
//      pallas_call :266) when the runs span several blocks, and
//   K3 _bitonic_finish_kernel (sort_pallas.py:415-445, pallas_call :434)
//      when both fit in one block.
// Contract kept: the output is the ascending UNSIGNED merge of both runs, of
// length la + lb, each payload with its key, for any run lengths —
// SENTINEL-padded runs included (SENTINEL is the largest unsigned key, so
// padding merges to the tail).  On equal keys a's entries come first
// (stable).  No power-of-two padding; the inputs are never written.
//
// Design: a two-level merge path through shared memory.  A block owns one
// tile of TILE = THREADS * ITEMS consecutive outputs.
//   1. Tile split.  Warp 0 searches the diagonal tile * TILE and warp 1 the
//      diagonal (tile + 1) * TILE in device memory: how many of a's entries
//      lie among the first `diag` outputs.  The 32 lanes probe 32 points of
//      the range at once, so 2^25 candidates take 5-6 dependent round trips
//      (a binary search takes 25), once per tile, not once per thread.
//   2. Window load.  a[a0:a1] and b[b0:b1], together exactly the tile's
//      outputs, and their payloads go to shared memory (a's window first)
//      with consecutive lanes on consecutive elements; a thread issues all
//      its loads before it stores any.  The windows start at any 8-byte
//      offset, so the loads are plain 8- and 4-byte ones.
//   3. Thread split and serial merge.  Thread t binary-searches diagonal
//      t * ITEMS inside the tile (<= 12 steps in shared memory) and merges
//      ITEMS outputs into registers, keys and payloads.
//   4. Store.  After a barrier the registers go back to the same shared
//      memory in output order (thread t writes [t * ITEMS, (t+1) * ITEMS);
//      ITEMS is odd, so the lanes of a warp fall into distinct banks), and
//      the block writes keys and payloads with consecutive lanes on
//      consecutive elements.
// Every level uses ONE predicate, a[i] <= b[j] takes a: the tile split, the
// thread split and the serial merge agree on where a stretch of equal keys
// (two padded runs end in one) is cut.
//
// What bounds it on an H100: device-memory traffic, one read of each run and
// one write of the output (24 bytes per output with payloads).  A tile holds
// 12 bytes per output in shared memory (46,080 bytes at 256 x 15), so four
// blocks share an SM and one block's search, merge and barriers overlap the
// others' loads and stores.  Global offsets are 64-bit, in-tile indices 32.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

// kmcex_tpu_torch/tools/tune_merge.py builds variants of these with -D
#ifndef KX_MERGE_THREADS
#define KX_MERGE_THREADS 256
#endif
#ifndef KX_MERGE_ITEMS
#define KX_MERGE_ITEMS 15
#endif
#ifndef KX_MERGE_BLOCKS_PER_SM
#define KX_MERGE_BLOCKS_PER_SM 4
#endif

namespace {

constexpr int THREADS = KX_MERGE_THREADS;
constexpr int ITEMS = KX_MERGE_ITEMS;
constexpr int TILE = THREADS * ITEMS;
constexpr int SMEM_BYTES = TILE * (int)(sizeof(u64) + sizeof(u32));
static_assert(THREADS % 32 == 0 && THREADS >= 64, "two whole warps split");
static_assert(ITEMS % 2 == 1, "odd ITEMS: a conflict-free write-back");
static_assert(SMEM_BYTES <= 227 * 1024, "a tile must fit in shared memory");

// The number of a's entries among the first `diag` outputs of the stable
// merge: the smallest i in [max(0, diag - lb), min(diag, la)] with
// a[i] > b[diag - i - 1].  The predicate a[p] <= b[diag - p - 1] is true
// below that i and false from it on, so the 32 lanes of the calling warp
// probe 32 evenly spaced points and the count of true lanes picks the next
// range, 1/32 as long.  Every lane returns the same value.
__device__ long long warp_split(const u64* __restrict__ a, long long la,
                                const u64* __restrict__ b, long long lb,
                                long long diag, int lane) {
  long long lo = diag > lb ? diag - lb : 0;
  long long hi = diag < la ? diag : la;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool a_first = p < hi && a[p] <= b[diag - p - 1];
    const int c = __popc(__ballot_sync(0xffffffffu, a_first));
    if (c == 0) {
      hi = lo;
    } else {
      const long long next_hi = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = next_hi < hi ? next_hi : hi;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS, KX_MERGE_BLOCKS_PER_SM)
    merge_tiles(const u64* __restrict__ a, const u32* __restrict__ ca,
                long long la, const u64* __restrict__ b,
                const u32* __restrict__ cb, long long lb, u64* __restrict__ ok,
                u32* __restrict__ oc) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sk = reinterpret_cast<u64*>(smem);                      // [TILE]
  u32* sc = reinterpret_cast<u32*>(smem + TILE * sizeof(u64));  // [TILE]
  __shared__ long long split[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long total = la + lb;
  const long long out0 = (long long)blockIdx.x * TILE;
  const long long out1 = out0 + TILE < total ? out0 + TILE : total;

  // 1. the tile's two splits, one warp each
  if (warp < 2) {
    const long long s = warp_split(a, la, b, lb, warp ? out1 : out0, lane);
    if (lane == 0) split[warp] = s;
  }
  __syncthreads();
  const long long a0 = split[0], b0 = out0 - a0;
  const int n = (int)(out1 - out0);
  const int na = (int)(split[1] - a0), nb = n - na;

  // 2. both windows to shared memory: a's at [0, na), b's at [na, n)
  if (n == TILE) {
    u64 tk[ITEMS];
    u32 tc[ITEMS];
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      const int i = tid + s * THREADS;
      const bool in_a = i < na;
      const long long g = in_a ? a0 + i : b0 + (i - na);
      tk[s] = (in_a ? a : b)[g];
      tc[s] = (in_a ? ca : cb)[g];
    }
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      sk[tid + s * THREADS] = tk[s];
      sc[tid + s * THREADS] = tc[s];
    }
  } else {
    for (int i = tid; i < n; i += THREADS) {
      const bool in_a = i < na;
      const long long g = in_a ? a0 + i : b0 + (i - na);
      sk[i] = (in_a ? a : b)[g];
      sc[i] = (in_a ? ca : cb)[g];
    }
  }
  __syncthreads();

  // 3. the thread's split inside the tile, then ITEMS outputs into registers
  const u64* sb = sk + na;
  const int diag = tid * ITEMS < n ? tid * ITEMS : n;
  int lo = diag > nb ? diag - nb : 0;
  int hi = diag < na ? diag : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] <= sb[diag - mid - 1])
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo, j = diag - lo;
  u64 ka = i < na ? sk[i] : 0, kb = j < nb ? sb[j] : 0;
  u64 rk[ITEMS];
  u32 rc[ITEMS];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    rk[s] = 0;
    rc[s] = 0;
    if (diag + s < n) {  // false only past the end of a partial last tile
      const bool take_a = j >= nb || (i < na && ka <= kb);
      rk[s] = take_a ? ka : kb;
      rc[s] = sc[take_a ? i : na + j];
      if (take_a) {
        if (++i < na) ka = sk[i];
      } else {
        if (++j < nb) kb = sb[j];
      }
    }
  }
  __syncthreads();  // every read of the windows is done

  // 4. registers to shared memory in output order, then coalesced stores
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    sk[tid * ITEMS + s] = rk[s];
    sc[tid * ITEMS + s] = rc[s];
  }
  __syncthreads();
  if (n == TILE) {
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      ok[out0 + tid + s * THREADS] = sk[tid + s * THREADS];
      oc[out0 + tid + s * THREADS] = sc[tid + s * THREADS];
    }
  } else {
    for (int o = tid; o < n; o += THREADS) {
      ok[out0 + o] = sk[o];
      oc[out0 + o] = sc[o];
    }
  }
}

}  // namespace

// Outputs per block; the tests size their boundary cases from it.
extern "C" int kx_merge_tile(void) { return TILE; }

extern "C" int kx_merge_u64(const void* a, const void* ca, long long la,
                            const void* b, const void* cb, long long lb,
                            void* out_k, void* out_c, void* stream) {
  if (la < 0 || lb < 0) return (int)cudaErrorInvalidValue;
  const long long total = la + lb;
  if (total == 0) return 0;
  const long long tiles = (total + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (SMEM_BYTES > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  merge_tiles<<<(unsigned)tiles, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const u64*)a, (const u32*)ca, la, (const u64*)b, (const u32*)cb, lb,
      (u64*)out_k, (u32*)out_c);
  return (int)cudaGetLastError();
}
