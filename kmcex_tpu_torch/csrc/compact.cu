// Stable stream compaction of (64-bit key, 32-bit count) pairs on Hopper.
//
// Replaces K4 of the TPU package: _shift_compact_kernel
// (kmcex_tpu/count/compact_pallas.py:59-144, pallas_call :157) plus the
// dynamic_update_slice stitch of compact_pairs (:179-244).  Contract kept:
// every pair whose key is not SENTINEL (all ones) moves to the front in its
// input order; the tail is filled with (SENTINEL, 0).  The TPU version also
// required the surviving keys to be ascending and distinct (it compacted per
// block and relied on global order to stitch); this one does not.
//
// Design, two kernels over tiles of 1024 elements (one per thread):
//   * compact_count   — survivors per tile (__syncthreads_count);
//   * (host side: an inclusive scan of the per-tile totals, torch.cumsum —
//      the TPU code also computed these offsets outside its kernel,
//      compact_pallas.py:198-203);
//   * compact_scatter — the rank of each survivor inside its tile from warp
//      ballots and a shuffle scan of the 32 warp totals, then a scatter to
//      tile offset + rank; slots at or past the survivor total get
//      (SENTINEL, 0).
//
// What bounds it on an H100: device-memory traffic — the keys are read
// twice (count, scatter), keys and counts written once: 28 bytes per
// element.  The per-tile totals are 1/1024 of that.  Fusing the two passes
// (a decoupled look-back scan) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

namespace {

constexpr int TILE = 1024;
constexpr u64 SENT = ~0ull;

__global__ void __launch_bounds__(TILE)
    compact_count(const u64* keys, long long n, int* tile_counts) {
  const long long i = (long long)blockIdx.x * TILE + threadIdx.x;
  const int live = i < n && keys[i] != SENT;
  const int c = __syncthreads_count(live);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(TILE)
    compact_scatter(const u64* keys, const u32* counts, long long n,
                    const long long* incl, u64* out_k, u32* out_c) {
  __shared__ int warp_excl[TILE / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * TILE + threadIdx.x;
  u64 key = SENT;
  u32 cnt = 0;
  if (i < n) {
    key = keys[i];
    cnt = counts[i];
  }
  const bool live = i < n && key != SENT;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_excl[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_excl[lane];  // TILE / 32 == 32 warp totals
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    warp_excl[lane] = x - v;
  }
  __syncthreads();
  const long long tile_off = blockIdx.x ? incl[blockIdx.x - 1] : 0;
  const long long total = incl[gridDim.x - 1];
  if (live) {
    const long long dst = tile_off + warp_excl[warp] + lane_rank;
    out_k[dst] = key;
    out_c[dst] = cnt;
  }
  if (i < n && i >= total) {
    out_k[i] = SENT;
    out_c[i] = 0;
  }
}

}  // namespace

extern "C" int kx_compact_tile(void) { return TILE; }

// tile_counts: int32 [ceil(n / TILE)] survivors per tile.
extern "C" int kx_compact_count(const void* keys, long long n,
                                void* tile_counts, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + TILE - 1) / TILE;
  compact_count<<<(unsigned)tiles, TILE, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, n, (int*)tile_counts);
  return (int)cudaGetLastError();
}

// incl: int64 [tiles] inclusive scan of tile_counts.  out_* must not alias
// the inputs.
extern "C" int kx_compact_scatter(const void* keys, const void* counts,
                                  long long n, const void* incl, void* out_k,
                                  void* out_c, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + TILE - 1) / TILE;
  compact_scatter<<<(unsigned)tiles, TILE, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, (const u32*)counts, n, (const long long*)incl,
      (u64*)out_k, (u32*)out_c);
  return (int)cudaGetLastError();
}
