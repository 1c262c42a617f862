// One-sweep LSD radix sort of 64-bit keys (+ optional 32-bit payload) on
// Hopper.
//
// Replaces the TPU bitonic network of kmcex_tpu/count/sort_pallas.py:
//   K1 _block_sort_kernel (sort_pallas.py:177-215, pallas_call :203) — the
//      in-VMEM sort of each 2^18-element block;
//   K2 _hbm_step_kernel (sort_pallas.py:218-296, pallas_call :266) — one
//      cross-block compare-exchange per bitonic step, run level by level
//      by _merge_tree.
// Contract: unsigned ascending order (SENTINEL, all ones, last), each
// payload with its key, and STABLE: equal keys keep their input order.  Any
// n < 2^30; no padding; the input is never written.  The (hi, lo) u32
// planes, column-major tiles and power-of-two blocks were TPU-only.
//
// What bounds it: device-memory bytes, kept to ~9 passes over the keys.
// With 8-bit digits a 64-bit key takes 8 passes of one read and one write
// each (16 bytes a key, 24 with a payload), and one more read builds all
// eight histograms: ~8.5 GB at 64M keys (~13 GB with payloads).  The
// passes run at about half the copy rate (64M keys on an H100: 5.1 ms,
// against 3.2 ms for the same bytes as plain copies); with the scatter's
// stores removed a pass still takes 80% of its time, so the rest is the
// in-tile load and rank at three blocks an SM.
//
// Design (Adinets & Merrill, "Onesweep", 2022):
//   * digit_histograms — one read of the keys builds all eight 256-bin
//     digit histograms in shared memory, then adds them to a global [8][256]
//     array.  Plain shared atomics: warp-aggregating them with
//     __match_any_sync (for SENTINEL's hot bin 255) took 3.8 ms at 64M keys
//     on an H100, against 0.22 ms without;
//   * bin_starts       — exclusive scan of each digit's histogram;
//   * onesweep_pass(d) — once per digit, ping-ponging between two scratch
//     buffers.  A block claims its tile (TILE keys) from an atomic counter
//     (so every tile it waits on belongs to a block already running), loads
//     it warp-striped, ranks the keys stably (per-warp ballot match of the
//     digit + popc of the lower peers, then an exclusive scan of the warp
//     bin counts in warp order), publishes its bin counts as AGGREGATE
//     status words, looks back over earlier tiles for its bins' exclusive
//     prefixes (decoupled look-back), publishes INCLUSIVE, stages the tile
//     in shared memory in digit order and scatters it, consecutive threads
//     on consecutive addresses within a bin.  The payload follows the same
//     permutation.  Eight passes (even) leave the result in the second
//     scratch buffer; the histograms cost one extra read, and the per-tile
//     status words (1 KB a tile) stay in L2.
// A status word is a 2-bit flag over a 30-bit count, hence n < 2^30.  It
// carries its own value, so relaxed (volatile) loads and stores suffice: no
// other memory is read through it.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;   // bins per digit
constexpr int PASSES = 64 / RADIX_BITS;  // digits per key
constexpr int THREADS = RADIX;           // one thread per bin in the scans
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                // keys per thread
constexpr int TILE = THREADS * ITEMS;    // keys per tile
constexpr int WARP_KEYS = 32 * ITEMS;    // contiguous keys per warp
constexpr u32 FLAG_AGG = 1u << 30;       // tile's own count
constexpr u32 FLAG_INC = 2u << 30;       // count of this and all earlier tiles
constexpr u32 VALUE = FLAG_AGG - 1;
constexpr long long MAX_N = 1ll << 30;
constexpr unsigned FULL = 0xffffffffu;

constexpr int HIST_THREADS = 512;
constexpr int HIST_ITEMS = 4;  // keys in flight per thread

// Workspace (u32 words): histograms [PASSES][RADIX], bin starts
// [PASSES][RADIX], tile counters [PASSES], status [tiles][RADIX].
constexpr long long WS_HIST = 0;
constexpr long long WS_START = WS_HIST + PASSES * RADIX;
constexpr long long WS_COUNTER = WS_START + PASSES * RADIX;
constexpr long long WS_STATUS = WS_COUNTER + PASSES;

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

__global__ void __launch_bounds__(HIST_THREADS)
    digit_histograms(const u64* __restrict__ keys, long long n,
                     u32* __restrict__ hist) {
  __shared__ u32 s[PASSES * RADIX];
  const int tid = threadIdx.x;
  for (int i = tid; i < PASSES * RADIX; i += HIST_THREADS) s[i] = 0;
  __syncthreads();
  const long long chunk = (long long)HIST_THREADS * HIST_ITEMS;
  for (long long base = blockIdx.x * chunk; base < n;
       base += (long long)gridDim.x * chunk) {
    u64 k[HIST_ITEMS];
#pragma unroll
    for (int u = 0; u < HIST_ITEMS; ++u) {
      const long long i = base + u * HIST_THREADS + tid;
      k[u] = i < n ? keys[i] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < HIST_ITEMS; ++u) {
      if (base + u * HIST_THREADS + tid < n) {
#pragma unroll
        for (int d = 0; d < PASSES; ++d)
          atomicAdd(&s[d * RADIX + ((u32)(k[u] >> (d * RADIX_BITS)) &
                                    (RADIX - 1))], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < PASSES * RADIX; i += HIST_THREADS)
    if (s[i]) atomicAdd(&hist[i], s[i]);
}

// One block per digit: exclusive scan of its RADIX bin counts.
__global__ void __launch_bounds__(RADIX)
    bin_starts(const u32* __restrict__ hist, u32* __restrict__ start) {
  __shared__ u32 warp_sum[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u32 v = hist[blockIdx.x * RADIX + tid];
  u32 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u32 y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  u32 before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  start[blockIdx.x * RADIX + tid] = before + x - v;
}

// Dynamic shared memory of one onesweep_pass block.
template <bool PAY>
constexpr int pass_smem_bytes() {
  return TILE * 8                 // staged keys
         + (PAY ? TILE * 4 : 0)   // staged payloads
         + WARPS * RADIX * 4      // per-warp bin counts, then offsets
         + RADIX * 4              // the tile's exclusive bin starts
         + RADIX * 8              // global base of each bin
         + (WARPS + 1) * 4;       // scan partials, claimed tile index
}

// Three blocks an SM: caps registers at 80 (127 uncapped, which fits two),
// 5.1 ms against 5.7 ms at 64M keys on an H100.
template <bool PAY>
__global__ void __launch_bounds__(THREADS, 3)
    onesweep_pass(const u64* __restrict__ kin, const u32* __restrict__ pin,
                  u64* __restrict__ kout, u32* __restrict__ pout, long long n,
                  int shift, const u32* __restrict__ bin_start, u32* status,
                  u32* tile_counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_keys = (u64*)smem;
  u32* s_pay = (u32*)(s_keys + TILE);
  u32* s_wcnt = s_pay + (PAY ? TILE : 0);
  u32* s_bin_excl = s_wcnt + WARPS * RADIX;
  long long* s_gbase = (long long*)(s_bin_excl + RADIX);
  u32* s_misc = (u32*)(s_gbase + RADIX);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < WARPS * RADIX; i += THREADS) s_wcnt[i] = 0;
  if (tid == 0) s_misc[WARPS] = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const u32 tile = s_misc[WARPS];
  const long long tile_base = (long long)tile * TILE;
  const int tile_n = (int)(n - tile_base < TILE ? n - tile_base : TILE);

  // Warp w owns keys [w * WARP_KEYS, (w + 1) * WARP_KEYS) of the tile; lane
  // l holds key w * WARP_KEYS + 32 i + l, so (i, lane) order is input order.
  const int wbase = warp * WARP_KEYS;
  u64 k[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = wbase + 32 * i + lane;
    k[i] = j < tile_n ? kin[tile_base + j] : 0ull;
  }

  // Stable rank within the warp: earlier items through the warp's running
  // bin counts, lower lanes of the same item through the peer mask.
  u32* wcnt = s_wcnt + warp * RADIX;
  const u32 lower = (1u << lane) - 1u;
  u32 rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = wbase + 32 * i + lane < tile_n;
    const u32 dig = (u32)(k[i] >> shift) & (RADIX - 1);
    u32 peers = __ballot_sync(FULL, valid);
#pragma unroll
    for (int b = 0; b < RADIX_BITS; ++b) {
      const bool bit = (dig >> b) & 1u;
      const u32 m = __ballot_sync(FULL, bit);
      peers &= bit ? m : ~m;
    }
    const u32 before = wcnt[dig];
    __syncwarp();
    if (valid && (peers >> lane) == 1u)  // highest lane of its group
      wcnt[dig] = before + __popc(peers);
    __syncwarp();
    rank[i] = before + __popc(peers & lower);
  }
  __syncthreads();

  // Thread tid is bin tid: exclusive scan of the warp counts in warp order.
  u32 cnt = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const u32 c = s_wcnt[w * RADIX + tid];
    s_wcnt[w * RADIX + tid] = cnt;
    cnt += c;
  }
  volatile u32* my_status = status + (long long)tile * RADIX;
  my_status[tid] = (tile == 0 ? FLAG_INC : FLAG_AGG) | cnt;

  // The tile's exclusive bin starts: a block scan of cnt over the bins.
  u32 incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u32 y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_misc[warp] = incl;
  __syncthreads();
  u32 warp_before = 0;
  for (int w = 0; w < warp; ++w) warp_before += s_misc[w];
  const u32 bin_excl = warp_before + incl - cnt;
  s_bin_excl[tid] = bin_excl;
  __syncthreads();

  // Stage the tile in shared memory in digit order.
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = wbase + 32 * i + lane;
    if (j < tile_n) {
      const u32 dig = (u32)(k[i] >> shift) & (RADIX - 1);
      const u32 pos = s_bin_excl[dig] + s_wcnt[warp * RADIX + dig] + rank[i];
      s_keys[pos] = k[i];
      if (PAY) s_pay[pos] = pin[tile_base + j];
    }
  }

  // Decoupled look-back for bin tid over the earlier tiles.
  u32 prefix = 0;
  if (tile > 0) {
    const volatile u32* st = status;
    long long t = (long long)tile - 1;
    for (;;) {
      u32 v;
      do {
        v = st[t * RADIX + tid];
      } while ((v & ~VALUE) == 0);
      prefix += v & VALUE;
      if (v & FLAG_INC) break;
      --t;
    }
    my_status[tid] = FLAG_INC | (prefix + cnt);
  }
  s_gbase[tid] = (long long)bin_start[tid] + prefix - bin_excl;
  __syncthreads();

  // Scatter: staged key j of bin b goes to bin_start[b] + prefix[b] +
  // (j - bin_excl[b]).
  for (int j = tid; j < tile_n; j += THREADS) {
    const u64 key = s_keys[j];
    const long long dst = s_gbase[(u32)(key >> shift) & (RADIX - 1)] + j;
    kout[dst] = key;
    if (PAY) pout[dst] = s_pay[j];
  }
}

template <bool PAY>
cudaError_t run_sort(const u64* keys, const u32* pay, long long n, u64* ka,
                     u64* kb, u32* pa, u32* pb, u32* ws, cudaStream_t s) {
  const long long tiles = tiles_of(n);
  u32* hist = ws + WS_HIST;
  u32* start = ws + WS_START;
  u32* counter = ws + WS_COUNTER;
  u32* status = ws + WS_STATUS;
  cudaError_t e = cudaMemsetAsync(hist, 0, PASSES * RADIX * 4, s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(counter, 0, PASSES * 4, s);
  if (e != cudaSuccess) return e;

  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long hchunk = (long long)HIST_THREADS * HIST_ITEMS;
  long long hblocks = (n + hchunk - 1) / hchunk;
  if (hblocks > 4ll * sms) hblocks = 4ll * sms;
  digit_histograms<<<(unsigned)hblocks, HIST_THREADS, 0, s>>>(keys, n, hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bin_starts<<<PASSES, RADIX, 0, s>>>(hist, start);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int smem = pass_smem_bytes<PAY>();
  if ((e = cudaFuncSetAttribute(onesweep_pass<PAY>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess)
    return e;
  const u64* kin = keys;
  const u32* pin = pay;
  for (int p = 0; p < PASSES; ++p) {
    u64* kout = (p & 1) ? kb : ka;
    u32* pout = (p & 1) ? pb : pa;
    e = cudaMemsetAsync(status, 0, tiles * RADIX * 4, s);
    if (e != cudaSuccess) return e;
    onesweep_pass<PAY><<<(unsigned)tiles, THREADS, smem, s>>>(
        kin, pin, kout, pout, n, p * RADIX_BITS, start + p * RADIX, status,
        counter + p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    kin = kout;
    pin = pout;
  }
  return cudaSuccess;
}

}  // namespace

// Bytes of the workspace kx_sort_u64 needs for n keys.
extern "C" long long kx_sort_workspace_bytes(long long n) {
  return (WS_STATUS + tiles_of(n) * RADIX) * 4;
}

// Sorts keys[0:n) (and payload, when not null), stable and ascending, into
// keys_b (and pay_b).  keys_a / pay_a are scratch of n elements;
// workspace holds kx_sort_workspace_bytes(n).  The inputs are not written.
// 0 < n < 2^30.
extern "C" int kx_sort_u64(const void* keys, const void* payload, long long n,
                           void* keys_a, void* keys_b, void* pay_a,
                           void* pay_b, void* workspace, void* stream) {
  if (n <= 0 || n >= MAX_N) return (int)cudaErrorInvalidValue;
  if (payload && (!pay_a || !pay_b)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      payload ? run_sort<true>((const u64*)keys, (const u32*)payload, n,
                               (u64*)keys_a, (u64*)keys_b, (u32*)pay_a,
                               (u32*)pay_b, (u32*)workspace, s)
              : run_sort<false>((const u64*)keys, nullptr, n, (u64*)keys_a,
                                (u64*)keys_b, nullptr, nullptr,
                                (u32*)workspace, s);
  return (int)e;
}
