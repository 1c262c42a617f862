// Stable stream compaction of (64-bit key, 32-bit count) pairs on Hopper,
// in one pass over the input with decoupled look-back.
//
// Replaces K4 of the TPU package: _shift_compact_kernel
// (kmcex_tpu/count/compact_pallas.py:59-144, pallas_call :157) plus the
// dynamic_update_slice stitch of compact_pairs (:179-244).  Contract kept:
// every pair whose key is not SENTINEL (all ones) moves to the front in its
// input order; the tail is filled with (SENTINEL, 0); the output is as long
// as the input and never aliases it.  The TPU version also required the
// surviving keys to be ascending and distinct (it compacted per block and
// relied on global order to stitch); this one does not.
//
// What bounds it on an H100: device-memory bytes.  Each pair is read once
// (12 bytes) and each output slot written once (12 bytes, survivor or
// tail): 24 bytes a pair, 1.61 GB at 64M pairs, 0.48 ms at 3.35 TB/s.  One
// compare a pair is nothing beside that.
//
// Design (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016): two launches on the caller's stream, no host
// sync and no other operation between them.
//   * compact_pass reads each input byte once.  A block claims its tile
//     (TILE pairs) from an atomic counter, so every tile it waits on belongs
//     to a block already running.  Warp w owns WARP_PAIRS consecutive pairs
//     of the tile; lane l holds RUNS runs of VEC consecutive pairs (run g:
//     pairs 32 VEC g + VEC l .. + VEC-1 of the warp's), loaded with 16-byte
//     streaming loads (__ldcs; two loads of keys and one of counts a run),
//     so each load instruction of a warp reads 512 consecutive bytes.
//     Ranks within the warp: one ballot a pair slot and popc; the warp
//     totals are scanned through shared memory.  Thread 0 publishes the
//     tile's AGGREGATE status word as soon as the total is known; the
//     block stages its survivors in shared memory in compacted order (12
//     bytes a pair); warp 0 looks back over earlier tiles, 32 at a time,
//     for the exclusive prefix and publishes INCLUSIVE; then the block
//     writes the survivors to [prefix, prefix + aggregate), consecutive
//     threads on consecutive addresses.  The tile that ends the input
//     writes the survivor total to a device scalar.
//   * fill_tail — a fixed grid strides over [total, n) and writes
//     (SENTINEL, 0) with 16-byte stores.  The tail is not written inside
//     the pass: no tile knows the total until the last one has published.
//     (A tile could write its own holes at the tail, from n - (base -
//     prefix) down; on an H100 that lengthened each block's life, which
//     the pass cannot afford, and ran slower than this separate stream of
//     stores.)
// What holds it below the bound: the pass, not the fill.  Each block's
// loads are in flight only between its claim and its ballot; about half of
// a block's life is the look-back, waiting for the tiles just before it to
// publish their aggregates (clock64 reads of the phases, PERF.md), so the
// pass reads well below a plain copy's rate.  A persistent
// grid that copies its next tile (cp.async.bulk) while it works on the
// current one ran slower still: a tile claimed ahead publishes its
// aggregate only when its block gets to it, and every later tile's
// look-back waits on that (PERF.md).
// A status word is 64 bits: a 2-bit flag over a 62-bit count, so the count
// never limits n; the grid's 2^31 - 1 tiles do.  The word carries its own
// value, so relaxed (volatile) loads and stores suffice: no other memory is
// read through it.  The scratch (tile counter, survivor total, one status
// word a tile: kx_compact_scratch_words) comes zeroed from the caller; the
// kernels allocate nothing.
// Inputs that do not start on a 16-byte boundary, and the ragged last tile,
// are read with scalar loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

typedef unsigned long long u64;
typedef unsigned int u32;

namespace {

// Runs a thread and blocks an SM: 8 x 2 (32 pairs a thread, 96 KB of
// staging, two blocks an SM) measured faster than 4 x 4 and 3 x 5 on an
// H100 (PERF.md); other values build with -D.
#ifndef KX_COMPACT_RUNS
#define KX_COMPACT_RUNS 8
#endif
#ifndef KX_COMPACT_MIN_BLOCKS
#define KX_COMPACT_MIN_BLOCKS 2
#endif

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                   // pairs a run: one 16-byte count load
constexpr int RUNS = KX_COMPACT_RUNS;    // runs a thread
constexpr int ITEMS = VEC * RUNS;        // pairs a thread
constexpr int WARP_PAIRS = 32 * ITEMS;   // consecutive pairs a warp
constexpr int TILE = THREADS * ITEMS;    // pairs a tile: 8192 by default
constexpr u64 SENT = ~0ull;
constexpr u64 FLAG_AGG = 1ull << 62;     // the tile's own survivors
constexpr u64 FLAG_INC = 2ull << 62;     // survivors of this and all earlier tiles
constexpr u64 VALUE = FLAG_AGG - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FILL_THREADS = 256;
constexpr int FILL_BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;

// Scratch (u64 words): [0] tile counter, [1] survivor total, [2..] one
// status word a tile.
constexpr int SC_COUNTER = 0;
constexpr int SC_TOTAL = 1;
constexpr int SC_STATUS = 2;

// Dynamic shared memory of one compact_pass block: the staged survivors
// (12 bytes a pair), the warp totals, the claimed tile and the prefix.
constexpr int SMEM = TILE * 8 + TILE * 4 + WARPS * 4 + 2 * 8;

__global__ void __launch_bounds__(THREADS, KX_COMPACT_MIN_BLOCKS)
    compact_pass(const u64* __restrict__ keys, const u32* __restrict__ counts,
                 long long n, bool aligned, u64* __restrict__ out_k,
                 u32* __restrict__ out_c, u64* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_keys = (u64*)smem;
  u32* s_cnt = (u32*)(s_keys + TILE);
  u32* s_warp = s_cnt + TILE;
  u64* s_misc = (u64*)(s_warp + WARPS);  // [0] tile, [1] prefix

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_misc[0] = atomicAdd(scratch + SC_COUNTER, 1ull);
  __syncthreads();
  const long long tile = (long long)s_misc[0];
  const long long base = tile * TILE;
  const int tile_n = n - base < TILE ? (int)(n - base) : TILE;

  // Pair (g, j) of this lane is pair wbase + 32 VEC g + VEC lane + j of the
  // tile: (g, lane, j) order is input order within the warp.
  const int wbase = warp * WARP_PAIRS;
  u64 k[ITEMS];
  u32 c[ITEMS];
  if (tile_n == TILE && aligned) {
#pragma unroll
    for (int g = 0; g < RUNS; ++g) {
      const long long i = base + wbase + 32 * VEC * g + VEC * lane;
      const ulonglong2 a = __ldcs((const ulonglong2*)(keys + i));
      const ulonglong2 b = __ldcs((const ulonglong2*)(keys + i + 2));
      const uint4 q = __ldcs((const uint4*)(counts + i));
      k[VEC * g] = a.x;
      k[VEC * g + 1] = a.y;
      k[VEC * g + 2] = b.x;
      k[VEC * g + 3] = b.y;
      c[VEC * g] = q.x;
      c[VEC * g + 1] = q.y;
      c[VEC * g + 2] = q.z;
      c[VEC * g + 3] = q.w;
    }
  } else {  // ragged or unaligned: scalar loads, SENTINEL past the end
#pragma unroll
    for (int g = 0; g < RUNS; ++g) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int p = wbase + 32 * VEC * g + VEC * lane + j;
        k[VEC * g + j] = p < tile_n ? __ldcs(keys + base + p) : SENT;
        c[VEC * g + j] = p < tile_n ? __ldcs(counts + base + p) : 0u;
      }
    }
  }

  // Survivors of the warp before each of this lane's runs: the warp's
  // earlier runs, then the lower lanes of the same run.
  const u32 lower = (1u << lane) - 1u;
  u32 before[RUNS];
  u32 live = 0;  // bit VEC g + j: pair (g, j) survives
  u32 warp_total = 0;
#pragma unroll
  for (int g = 0; g < RUNS; ++g) {
    u32 b_lower = 0, b_all = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const bool s = k[VEC * g + j] != SENT;
      const u32 b = __ballot_sync(FULL, s);
      b_lower += __popc(b & lower);
      b_all += __popc(b);
      live |= (u32)s << (VEC * g + j);
    }
    before[g] = warp_total + b_lower;
    warp_total += b_all;
  }
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();
  u32 warp_excl = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const u32 t = s_warp[w];
    warp_excl += w < warp ? t : 0u;
    agg += t;
  }
  volatile u64* status = (volatile u64*)(scratch + SC_STATUS);
  if (tid == 0) status[tile] = (tile == 0 ? FLAG_INC : FLAG_AGG) | agg;

  // Stage the survivors in compacted order.
#pragma unroll
  for (int g = 0; g < RUNS; ++g) {
    u32 r = warp_excl + before[g];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if ((live >> (VEC * g + j)) & 1u) {
        s_keys[r] = k[VEC * g + j];
        s_cnt[r] = c[VEC * g + j];
        ++r;
      }
    }
  }

  // Decoupled look-back: lane l reads the status of tile top - l; the
  // window's lanes up to the nearest INCLUSIVE word hold the prefix.
  if (warp == 0) {
    u64 prefix = 0;
    if (tile > 0) {
      long long top = tile - 1;
      for (;;) {
        const long long t = top - lane;
        u64 v = FLAG_INC;  // before tile 0: an inclusive 0
        if (t >= 0) {
          do {
            v = status[t];
          } while ((v & ~VALUE) == 0);
        }
        const u32 inc = __ballot_sync(FULL, (v & FLAG_INC) != 0);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        u64 x = lane <= stop ? (v & VALUE) : 0ull;
#pragma unroll
        for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
        prefix += x;
        if (inc) break;
        top -= 32;
      }
      if (lane == 0) status[tile] = FLAG_INC | (prefix + agg);
    }
    if (lane == 0) {
      s_misc[1] = prefix;
      if (tile == (long long)gridDim.x - 1) scratch[SC_TOTAL] = prefix + agg;
    }
  }
  __syncthreads();

  const long long dst = (long long)s_misc[1];
  for (int i = tid; i < (int)agg; i += THREADS) {
    out_k[dst + i] = s_keys[i];
    out_c[dst + i] = s_cnt[i];
  }
}

// (SENTINEL, 0) into [total, n): keys two slots a store, counts four, each
// store instruction of a warp on consecutive addresses.
__global__ void __launch_bounds__(FILL_THREADS)
    fill_tail(u64* __restrict__ out_k, u32* __restrict__ out_c, long long n,
              const u64* __restrict__ scratch) {
  const long long total = (long long)scratch[SC_TOTAL];
  const long long gid = (long long)blockIdx.x * FILL_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * FILL_THREADS;
  for (long long p = total / 2 + gid; p < (n + 1) / 2; p += stride) {
    const long long i = 2 * p;
    if (i >= total && i + 2 <= n) {
      *(ulonglong2*)(out_k + i) = make_ulonglong2(SENT, SENT);
    } else {
      for (long long s = i; s < i + 2; ++s)
        if (s >= total && s < n) out_k[s] = SENT;
    }
  }
  for (long long q = total / 4 + gid; q < (n + 3) / 4; q += stride) {
    const long long i = 4 * q;
    if (i >= total && i + 4 <= n) {
      *(uint4*)(out_c + i) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (long long s = i; s < i + 4; ++s)
        if (s >= total && s < n) out_c[s] = 0u;
    }
  }
}

}  // namespace

extern "C" int kx_compact_tile(void) { return TILE; }

// The int64 words of scratch that kx_compact_pairs needs for n pairs.
extern "C" long long kx_compact_scratch_words(long long n) {
  return SC_STATUS + (n + TILE - 1) / TILE;
}

// scratch: int64 [kx_compact_scratch_words(n)], zeroed.  out_* (fresh allocations)
// and scratch 16-byte aligned, and never aliasing the inputs.
extern "C" int kx_compact_pairs(const void* keys, const void* counts,
                                long long n, void* out_k, void* out_c,
                                void* scratch, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (((uintptr_t)out_k | (uintptr_t)out_c | (uintptr_t)scratch) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bool aligned = (((uintptr_t)keys | (uintptr_t)counts) & 15) == 0;
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  // Once a device: the shared-memory opt-in, and its SM count.
  static std::atomic<int> sm_count[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sm_count[dev].load();
  if (sms == 0) {
    e = cudaFuncSetAttribute(compact_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sm_count[dev].store(sms);
  }
  const cudaStream_t s = (cudaStream_t)stream;
  compact_pass<<<(unsigned)tiles, THREADS, SMEM, s>>>(
      (const u64*)keys, (const u32*)counts, n, aligned, (u64*)out_k,
      (u32*)out_c, (u64*)scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fill_tail<<<(unsigned)(sms * FILL_BLOCKS_PER_SM), FILL_THREADS, 0, s>>>(
      (u64*)out_k, (u32*)out_c, n, (const u64*)scratch);
  return (int)cudaGetLastError();
}
