// The coupled-bit-array encode of the KModel on Hopper, straight from the
// counted table on the card.
//
// Replaces no TPU kernel: the JAX package encodes the arrays on the host,
// with the native Encoder (native/src/kmcex_native.cpp, Encoder), which
// stays the host route's encoder and the specification this kernel is
// tested against.  It was added because that encoder set the pace of the
// model builds while the card sat idle: its inserts into one array are a
// chain that must run in order, and the host runs five such chains on a
// few threads.
//
// The schedule, kept exactly (the reference's kmodel.hpp:508-573): the
// array-bound pairs fill n_bits buckets of bucket_size in stream order;
// when all are full (or at the end, for the partial ones) n_bits rounds
// run, and in round t bucket i drains IN ORDER into array (i+t) % n_bits,
// with seeds kHashSeeds[(a*n_hash+j) % 128] and positions murmur64 of the
// k-mer's ASCII string modulo km_bit_size.  An insert succeeds when no
// already-tagged probe position disagrees with the bin bit; it then sets
// the bin bits and the tags, and ORs the middle (k-2)-mer into km_back.
// Between rounds a bucket is compacted as reorder_buffer does (the k-th
// hole from the left in [0, s) takes the k-th survivor from the right in
// [s, n)); after the last round the survivors go to the rest store in
// (bucket, slot) order.  Bucket contents persist across flushes: an empty
// bucket of the tail flush whose slot 0 still holds a survivor of the last
// full flush is retried and handed off again, as the reference does.
//
// Batches, exactly: one chain's inserts depend on each other only through
// shared probe positions.  A block walks its bucket in batches of W
// k-mers.  Each k-mer's positions go into a hash table in shared memory
// that keeps, for each position, the smallest batch index probing it.  A
// k-mer none of whose positions was probed by an earlier k-mer of the batch
// decides against the state before the batch: no earlier k-mer of the batch
// touches its bits, and no later one that does can have decided yet (that
// one is itself conflicted).  Such k-mers have pairwise disjoint positions,
// so they all decide and write at once.  Warp 0 then decides the others one
// by one, in order, against that state plus the writes made so far.  The
// bits are those of the sequential loop.
//
// What bounds it on an H100: the order.  Only the n_bits chains of a round
// run at once, one block each on one SM, so the chain itself is kept to
// what must be in order: a round-0 chain is 2^18 k-mers a flush, each with
// n_hash probes into an array of tens of MB and n_hash tag and bin updates,
// L2 and device-memory round trips behind a few barriers a batch.
// Everything order-free leaves the chains for kernels across the whole
// card: the probe positions of a round (encode_positions: murmur64, one
// exact reciprocal modulo a position), and km_back, which is the OR of the
// middle (k-2)-mers of every k-mer that was inserted anywhere, once, at the
// end (encode_back over an inserted flag a pair).  The card's memory
// bandwidth is far away: a k-mer moves a few dozen bytes.
//
// Layout: bit1 and bit2 are interleaved, one 64-bit word holding 32 bits of
// each (bit1 low, bit2 high), so one load reads a probe's bin bit and tag
// and one atomicOr sets both; the arrays follow each other at byte offsets
// a * km_byte_size, so the word holding a bit may straddle two arrays, and
// every write is an atomicOr.  Bytes are the reference's (bit j of a byte
// is MSB-first, little-endian words).  The caller splits the two halves
// apart on the card.  Reads of bits go around L1 (__ldcg): other threads'
// atomics land in L2.
//
// One C entry point runs the whole encode on the caller's stream: per flush
// and round, encode_positions, encode_conflicts (a block per batch),
// encode_round (a cluster of blocks per chain) and encode_compact (a block
// per bucket); per flush encode_handoff; at the end encode_back.  No host
// sync; the caller allocates every buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

typedef unsigned long long u64;
typedef unsigned int u32;

namespace {

constexpr int THREADS = 1024;            // conflict-test and compaction blocks
constexpr int NWARPS = THREADS / 32;
constexpr int CLUSTER = 8;               // blocks of a chain
constexpr int CT = 128;                  // threads of a chain's block
constexpr int WIDE = 256;                // the order-free kernels' blocks
constexpr int MAX_POS = 8192;            // W * n_hash a batch may hold
constexpr int MAX_W = 8192;              // W, at n_hash = 1
constexpr int LOG_TABLE = 14;
constexpr int TABLE = 1 << LOG_TABLE;    // hash-table slots, load <= 1/2
constexpr int MAX_BITS = 64;             // n_bits
constexpr int GROUP = 8;                 // loads a thread issues before use
constexpr int ITEMS = 8;                 // slots a thread takes a pass when
constexpr int CHUNK = THREADS * ITEMS;   // a bucket is compacted
constexpr int SMEM = TABLE * 8 + MAX_POS * 4;
constexpr u64 EMPTY = ~0ull;
constexpr u64 M = 0xc6a4a7935bd1e995ull;
constexpr unsigned FULL = 0xffffffffu;

__constant__ u32 kSeeds[128] = {
    46757, 46769, 46771, 46807, 46811, 46817, 46819, 46829, 46831, 46853,
    46861, 46867, 46877, 46889, 46901, 46919, 46933, 46957, 46993, 46997,
    47017, 47041, 47051, 47057, 47059, 47087, 47093, 47111, 47119, 47123,
    47129, 47137, 47143, 47147, 47149, 47161, 47189, 47207, 47221, 47237,
    47251, 47269, 47279, 47287, 47293, 47297, 47303, 47309, 47317, 47339,
    47351, 47353, 47363, 47381, 47387, 47389, 47407, 47417, 47419, 47431,
    47441, 47459, 47491, 47497, 47501, 47507, 47513, 47521, 47527, 47533,
    47543, 47563, 47569, 47581, 47591, 47599, 47609, 47623, 47629, 47639,
    47653, 47657, 47659, 47681, 47699, 47701, 47711, 47713, 47717, 47737,
    47741, 47743, 47777, 47779, 47791, 47797, 47807, 47809, 47819, 47837,
    47843, 47857, 47869, 47881, 47903, 47911, 47917, 47933, 47939, 47947,
    47951, 47963, 47969, 47977, 47981, 48017, 48023, 48029, 48049, 48073,
    48079, 48091, 48109, 48119, 48121, 48131, 48157, 48163};

// h % d with r = (2^64 - 1) / d: the high half of h * r is the quotient or
// at most two short of it, never above.
struct Mod {
  u64 d, r;
};

__device__ __forceinline__ u64 mod(u64 h, Mod m) {
  u64 x = h - __umul64hi(h, m.r) * m.d;
  while (x >= m.d) x -= m.d;
  return x;
}

struct Params {
  const u64* keys;      // the array-bound pairs, in listing order
  const u32* occs;
  u64* bkeys;           // [n_bits][bucket_size] bucket contents
  u32* bocc;            // 0 marks an inserted k-mer
  u64* bidx;            // stream index of each bucket slot
  int* bcount;          // [n_bits] k-mers of each bucket in play
  u64* tkeys;           // [n_bits][bucket_size] compaction scratch
  u32* tocc;
  u64* tidx;
  u32* pos;             // [n_bits][n_hash][bucket_size] a round's positions
  u32* conf;            // [n_bits][max_batches][W / 32] conflict bits
  unsigned char* inserted;  // [n] flags: the pair went into an array
  u64* bits;            // interleaved bit1 / bit2 words
  u32* km_back;
  const u32* occ2bin;
  long long occ2bin_len;
  u64* stats;           // [rest_n, attempts, serial attempts]
  u64* rest_keys;
  u32* rest_occs;
  Mod bits_mod, back_mod;
  u64 km_byte_size, mid_mask;
  long long n, bucket_size, max_batches;
  int k, n_bits, n_hash, back_num_hash, batch;
};

// MurmurHash64A over the ASCII string of a 2-bit packed k-mer (MSB-first,
// A=0 C=1 G=2 T=3), split as the native encoder splits it: the seed-free
// block mixes once, then one fold per seed.  Eight bases become eight bytes
// at a time: each 2-bit code goes to its byte, then code c turns into
// 65 + 2c + (c >> 1) * (2 + 11 * (c & 1)), "ACGT", byte by byte.
struct Pre {
  u64 f[4];
  u64 tail;
  int nfull, len;
};

__device__ __forceinline__ u64 mix(u64 k) {
  k *= M;
  k ^= k >> 47;
  return k * M;
}

__device__ __forceinline__ void murmur_pre(u64 v, int len, Pre& p) {
  const u64 top = v << (64 - 2 * len);   // base c at bits 63-2c, 62-2c
  const u64 ones = 0x0101010101010101ull;
  u64 w[4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const u32 codes = (u32)(top >> (48 - 16 * i)) & 0xffffu;  // bases 8i..
    u64 b = 0;
#pragma unroll
    for (int j = 0; j < 8; j++)
      b |= (u64)((codes >> (14 - 2 * j)) & 3u) << (8 * j);
    const u64 hi = (b >> 1) & ones, lo = b & ones;
    u64 a = 0x4141414141414141ull + 2 * b + hi * 2 + (hi & lo) * 11;
    const int left = len - 8 * i;      // bases of this word
    if (left < 8) a = left > 0 ? a & ((1ull << (8 * left)) - 1) : 0;
    w[i] = a;
  }
  p.len = len;
  p.nfull = len >> 3;
#pragma unroll
  for (int i = 0; i < 4; i++) p.f[i] = mix(w[i]);
  p.tail = p.nfull == 0 ? w[0] : p.nfull == 1 ? w[1] : p.nfull == 2 ? w[2]
         : p.nfull == 3 ? w[3] : 0;
}

__device__ __forceinline__ u64 murmur_eval(const Pre& p, u32 seed) {
  u64 h = (u64)seed ^ ((u64)p.len * M);
#pragma unroll
  for (int i = 0; i < 4; i++) {
    if (i < p.nfull) {
      h ^= p.f[i];
      h *= M;
    }
  }
  if (p.len & 7) {
    h ^= p.tail;
    h *= M;
  }
  h ^= h >> 47;
  h *= M;
  return h ^ (h >> 47);
}

// The word of ``bits`` (or of km_back, base 0) holding bit ``pos`` of the
// array that starts at byte ``base``, and the bit's place in the word.
__device__ __forceinline__ u64 word_of(u64 base, u64 pos, int& bit) {
  u64 gb = base + (pos >> 3);
  bit = 8 * (int)(gb & 3) + 7 - (int)(pos & 7);
  return gb >> 2;
}

__device__ __forceinline__ u32 bin_of(const Params& P, u32 occ) {
  return (long long)occ < P.occ2bin_len ? P.occ2bin[occ] : 0u;
}

__device__ __forceinline__ long long bucket_fill(long long fill, int i,
                                                 long long bs) {
  long long n = fill - (long long)i * bs;
  return n < 0 ? 0 : (n > bs ? bs : n);
}

// The probe positions of round t for every k-mer in play, across the card:
// slot s of bucket i into array (i + t) % n_bits.  Round 0 first fills the
// buckets from the stream: ``fill`` k-mers of the flush from stream index
// ``base`` on, bucket i taking its share.
__global__ void __launch_bounds__(WIDE)
encode_positions(Params P, long long base, long long fill, int t) {
  const long long bs = P.bucket_size;
  const long long g = (long long)blockIdx.x * WIDE + threadIdx.x;
  const int i = (int)(g / bs);
  const long long s = g - (long long)i * bs;
  if (i >= P.n_bits) return;
  const long long n = t == 0 ? bucket_fill(fill, i, bs) : P.bcount[i];
  if (s >= n) return;
  const long long slot = (long long)i * bs + s;
  u64 key;
  if (t == 0) {
    const long long src = base + (long long)i * bs + s;
    key = P.keys[src];
    P.bkeys[slot] = key;
    P.bocc[slot] = P.occs[src];
    P.bidx[slot] = (u64)src;
  } else {
    key = P.bkeys[slot];
  }
  const int a = (i + t) % P.n_bits, nh = P.n_hash;
  Pre pre;
  murmur_pre(key, P.k, pre);
  u32* out = P.pos + (long long)i * nh * bs + s;
  for (int j = 0; j < nh; j++)
    out[j * bs] = (u32)mod(murmur_eval(pre, kSeeds[(a * nh + j) % 128]),
                           P.bits_mod);
}

__device__ __forceinline__ u32 slot_of(u32 pos) {
  return (pos * 2654435761u) >> (32 - LOG_TABLE);
}

// Keep (pos, idx) in the table: a slot holds pos in its high half and the
// smallest index that probes it in its low half.
__device__ __forceinline__ void table_put(u64* tab, u32 pos, u32 idx) {
  const u64 mine = ((u64)pos << 32) | idx;
  for (u32 s = slot_of(pos);; s = (s + 1) & (TABLE - 1)) {
    u64 old = atomicCAS(&tab[s], EMPTY, mine);
    if (old == EMPTY) return;
    if ((u32)(old >> 32) == pos) {
      atomicMin(&tab[s], mine);
      return;
    }
  }
}

__device__ __forceinline__ u32 table_min(const u64* tab, u32 pos) {
  for (u32 s = slot_of(pos);; s = (s + 1) & (TABLE - 1)) {
    u64 e = tab[s];
    if (e != EMPTY && (u32)(e >> 32) == pos) return (u32)e;
  }
}

// Exclusive prefix sum of ``x`` over the block's threads, and the total.
// Two barriers; ``wsum`` is shared scratch of NWARPS words.
__device__ __forceinline__ int block_scan(int x, int& total, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; w++) {
    const int v = wsum[w];
    off += w < warp ? v : 0;
    tot += v;
  }
  __syncthreads();
  total = tot;
  return off + incl - x;
}

// Of the ITEMS slots from ``j``, up to ``end``, those whose occ is (``live``)
// or is not (!``live``) 0, as a bit mask.
__device__ __forceinline__ unsigned slots(const u32* bo, long long j,
                                          long long end, bool live) {
  unsigned f = 0;
#pragma unroll
  for (int u = 0; u < ITEMS; u++)
    if (j + u < end && (bo[j + u] != 0) == live) f |= 1u << u;
  return f;
}

// The word holding position ``p`` of the array at ``abase`` and the mask
// that sets its bin bit ``binbit`` and its tag.
__device__ __forceinline__ u64 target(u64 abase, u32 p, u32 binbit, u64& set) {
  int bit;
  const u64 w = word_of(abase, p, bit);
  set = ((u64)binbit << bit) | (1ull << (32 + bit));
  return w;
}

// Whether word ``v`` has the tag of ``set`` and disagrees on its bin bit.
__device__ __forceinline__ bool clash(u64 v, u64 set) {
  const u64 tag = set >> 32;   // 1 << bit
  return ((v >> 32) & tag) && (v & tag) != (set & tag);
}

// Whether every probe of a k-mer agrees with ``bin``: its positions are
// pp[0], pp[stride], ..., the first GROUP of them already in ``first``; a
// group of words is loaded before any is read, so their round trips
// overlap.
__device__ __forceinline__ bool fits(const Params& P, const u32* first,
                                     const u32* pp, long long stride,
                                     u64 abase, u32 bin) {
  bool ok = true;
  for (int j0 = 0; j0 < P.n_hash; j0 += GROUP) {
    u32 p[GROUP];
    u64 v[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; u++)
      if (j0 + u < P.n_hash) p[u] = j0 ? pp[(j0 + u) * stride] : first[u];
#pragma unroll
    for (int u = 0; u < GROUP; u++) {
      u64 set;
      if (j0 + u < P.n_hash) v[u] = __ldcg(&P.bits[target(abase, p[u], 0, set)]);
    }
#pragma unroll
    for (int u = 0; u < GROUP; u++) {
      u64 set;
      if (j0 + u < P.n_hash) {
        target(abase, p[u], (bin >> (j0 + u)) & 1, set);
        ok &= !clash(v[u], set);
      }
    }
  }
  return ok;
}

// Sets the bin bits and tags of a k-mer that fits.
__device__ __forceinline__ void insert(const Params& P, const u32* pp,
                                       long long stride, u64 abase, u32 bin) {
  for (int j = 0; j < P.n_hash; j++) {
    u64 set;
    const u64 w = target(abase, pp[j * stride], (bin >> j) & 1, set);
    atomicOr(&P.bits[w], set);
  }
}

__device__ __forceinline__ long long in_play(const Params& P, long long fill,
                                             int t, int i) {
  return t == 0 ? bucket_fill(fill, i, P.bucket_size) : P.bcount[i];
}

// The conflict test of round t, for every batch of every bucket at once:
// block (b, i) marks the k-mers of batch b of bucket i that share a probe
// position with an earlier k-mer of the batch, one bit each, in
// conf[(i * max_batches + b) * W / 32 ...].  It depends on the positions
// alone, not on the arrays.
__global__ void __launch_bounds__(THREADS, 1)
encode_conflicts(Params P, long long fill, int t) {
  extern __shared__ u64 smem[];
  u64* tab = smem;
  u32* pos = (u32*)(smem + TABLE);   // [n_hash][W]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.y, nh = P.n_hash, W = P.batch;
  const long long bs = P.bucket_size, b0 = (long long)blockIdx.x * W;
  const long long n = in_play(P, fill, t, i);
  if (b0 >= n) return;
  const int m = (int)(n - b0 < W ? n - b0 : W);
  const u32* gpos = P.pos + (long long)i * nh * bs + b0;
  for (int s = tid; s < TABLE; s += THREADS) tab[s] = EMPTY;
  __syncthreads();
  for (int c = tid; c < m; c += THREADS) {
    for (int j0 = 0; j0 < nh; j0 += GROUP) {
      u32 p[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; u++)
        if (j0 + u < nh) p[u] = gpos[(j0 + u) * bs + c];
#pragma unroll
      for (int u = 0; u < GROUP; u++) {
        if (j0 + u < nh) {
          pos[(j0 + u) * W + c] = p[u];
          table_put(tab, p[u], (u32)c);
        }
      }
    }
  }
  __syncthreads();
  u32* conf = P.conf + ((long long)i * P.max_batches + blockIdx.x)
                          * ((W + 31) >> 5);
  for (int c0 = 0; c0 < m; c0 += THREADS) {
    const int c = c0 + tid;
    bool conflicted = false;
    if (c < m)
      for (int j = 0; j < nh; j++)
        conflicted |= table_min(tab, pos[j * W + c]) != (u32)c;
    const unsigned mask = __ballot_sync(FULL, conflicted);
    if (lane == 0 && c0 + 32 * warp < m) conf[(c0 >> 5) + warp] = mask;
  }
}

// Round t of a flush: the cluster of chain i drains bucket i, in order, into
// array (i + t) % n_bits, batch by batch.  Its CLUSTER blocks decide the
// batch's unconflicted k-mers at once, each a share, against the state
// before the batch; then warp 0 of the first block decides the conflicted
// ones one by one, in order.  A cluster barrier (release / acquire at
// cluster scope) separates the two and the batches.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(CT)
encode_round(Params P, long long fill, int t) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x / CLUSTER, a = (i + t) % P.n_bits;
  const long long bs = P.bucket_size;
  u32* bo = P.bocc + (long long)i * bs;
  const u64* bx = P.bidx + (long long)i * bs;
  const int nh = P.n_hash, W = P.batch, words = (W + 31) >> 5;
  const u32* gpos = P.pos + (long long)i * nh * bs;
  const u64 abase = (u64)a * P.km_byte_size;
  const long long n = in_play(P, fill, t, i);

  unsigned serial = 0;   // a lane's count of its words' bits
  long long b = 0;
  for (long long b0 = 0; b0 < n; b0 += W, b++) {
    const int m = (int)(n - b0 < W ? n - b0 : W);
    const u32* conf = P.conf + ((long long)i * P.max_batches + b) * words;
    // 1. the unconflicted, a share a block, against the state before; a
    // k-mer's conflict word, count, stream index and first positions are
    // loaded together
    for (int c = rank * CT + tid; c < m; c += CLUSTER * CT) {
      const u32 cw = conf[c >> 5], occ = bo[b0 + c];
      const u64 idx = bx[b0 + c];
      const u32* pp = gpos + b0 + c;
      u32 first[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; u++)
        if (u < nh) first[u] = pp[u * bs];
      if ((cw >> (c & 31)) & 1) continue;
      const u32 bin = bin_of(P, occ);
      if (fits(P, first, pp, bs, abase, bin)) {
        insert(P, pp, bs, abase, bin);
        P.inserted[idx] = 1;
        bo[b0 + c] = 0;
      }
    }
    cl.sync();
    // 2. the conflicted, one by one in batch order: lane l holds word
    // w0 + l of this batch's conflict bits
    if (rank == 0 && warp == 0) {
      const int nw = (m + 31) >> 5;
      for (int w0 = 0; w0 < nw; w0 += 32) {
        const unsigned word = w0 + lane < nw ? conf[w0 + lane] : 0u;
        serial += __popc(word);
        for (unsigned any = __ballot_sync(FULL, word != 0); any;
             any &= any - 1) {
          const int l = __ffs(any) - 1;
          unsigned mask = __shfl_sync(FULL, word, l);
          while (mask) {
            const int c = ((w0 + l) << 5) + __ffs(mask) - 1;
            mask &= mask - 1;
            const u32 occ = bo[b0 + c];
            const u64 idx = bx[b0 + c];
            const u32 p = lane < nh ? gpos[lane * bs + b0 + c] : 0u;
            const u32 bin = bin_of(P, occ);
            bool bad = false;
            u64 w = 0, set = 0;
            if (lane < nh) {
              w = target(abase, p, (bin >> lane) & 1, set);
              bad = clash(__ldcg(&P.bits[w]), set);
            }
            if (!__ballot_sync(FULL, bad)) {
              if (lane < nh) atomicOr(&P.bits[w], set);
              if (lane == 0) {
                P.inserted[idx] = 1;
                bo[b0 + c] = 0;
              }
            }
            __threadfence_block();
            __syncwarp();
          }
        }
      }
    }
    cl.sync();
  }
  if (rank == 0 && warp == 0) serial = __reduce_add_sync(FULL, serial);
  if (rank == 0 && tid == 0) {
    atomicAdd(&P.stats[1], (u64)n);
    atomicAdd(&P.stats[2], (u64)serial);
  }
}

// After round t: bucket i compacted as reorder_buffer does: s survivors
// stay in [0, s); the k-th hole from the left there takes the k-th survivor
// from the right in [s, n).  A thread takes ITEMS consecutive slots a pass,
// so ranks in thread order are ranks in slot order.
__global__ void __launch_bounds__(THREADS)
encode_compact(Params P, long long fill, int t) {
  __shared__ int wsum[NWARPS];
  __shared__ int s_count;
  const int tid = threadIdx.x, i = blockIdx.x;
  const long long bs = P.bucket_size;
  u64* bk = P.bkeys + (long long)i * bs;
  u32* bo = P.bocc + (long long)i * bs;
  u64* bx = P.bidx + (long long)i * bs;
  const long long n = in_play(P, fill, t, i);
  if (tid == 0) s_count = 0;
  __syncthreads();
  int mine = 0;
  for (long long j = (long long)tid * ITEMS; j < n; j += CHUNK)
    mine += __popc(slots(bo, j, n, true));
  atomicAdd(&s_count, mine);
  __syncthreads();
  const long long s = s_count;
  u64* tk = P.tkeys + (long long)i * bs;
  u32* to = P.tocc + (long long)i * bs;
  u64* tx = P.tidx + (long long)i * bs;
  long long run = 0;
  for (long long j0 = s; j0 < n; j0 += CHUNK) {
    const long long j = j0 + (long long)tid * ITEMS;
    unsigned f = slots(bo, j, n, true);
    int tot;
    long long r = run + block_scan(__popc(f), tot, wsum);
    for (; f; f &= f - 1, r++) {
      const long long src = j + __ffs(f) - 1;
      tk[r] = bk[src];
      to[r] = bo[src];
      tx[r] = bx[src];
    }
    run += tot;
  }
  const long long h = run;
  run = 0;
  for (long long j0 = 0; h && j0 < s; j0 += CHUNK) {
    const long long j = j0 + (long long)tid * ITEMS;
    unsigned f = slots(bo, j, s, false);
    int tot;
    long long r = run + block_scan(__popc(f), tot, wsum);
    for (; f; f &= f - 1, r++) {
      const long long dst = j + __ffs(f) - 1, src = h - 1 - r;
      bk[dst] = tk[src];
      bo[dst] = to[src];
      bx[dst] = tx[src];
    }
    run += tot;
  }
  // an empty bucket reads slot 0, as reorder_buffer does
  if (tid == 0) P.bcount[i] = (int)(n == 0 ? (bo[0] != 0) : s);
}

// After a flush's last round: every bucket's survivors to the rest store,
// in (bucket, slot) order, behind what earlier flushes handed off.
__global__ void __launch_bounds__(THREADS)
encode_handoff(Params P) {
  __shared__ long long off[MAX_BITS + 1];
  if (threadIdx.x == 0) {
    off[0] = (long long)P.stats[0];
    for (int i = 0; i < P.n_bits; i++) off[i + 1] = off[i] + P.bcount[i];
  }
  __syncthreads();
  for (int i = 0; i < P.n_bits; i++) {
    const u64* bk = P.bkeys + (long long)i * P.bucket_size;
    const u32* bo = P.bocc + (long long)i * P.bucket_size;
    const long long cnt = off[i + 1] - off[i];
    for (long long j = threadIdx.x; j < cnt; j += THREADS) {
      P.rest_keys[off[i] + j] = bk[j];
      P.rest_occs[off[i] + j] = bo[j];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) P.stats[0] = (u64)off[P.n_bits];
}

// km_back, order-free, across the card: the middle (k-2)-mer of every pair
// that went into an array.
__global__ void __launch_bounds__(WIDE)
encode_back(Params P) {
  const long long g = (long long)blockIdx.x * WIDE + threadIdx.x;
  if (g >= P.n || !P.inserted[g]) return;
  Pre mp;
  murmur_pre((P.keys[g] >> 2) & P.mid_mask, P.k - 2, mp);
  for (int j = 0; j < P.back_num_hash; j++) {
    int bit;
    const u64 w = word_of(0, mod(murmur_eval(mp, kSeeds[j]), P.back_mod),
                          bit);
    atomicOr(&P.km_back[w], 1u << bit);
  }
}

Mod make_mod(long long d) {
  Mod m;
  m.d = (u64)d;
  m.r = d > 0 ? ~0ull / (u64)d : 0;
  return m;
}

// The batch the kernel takes at most for n_hash probes a k-mer.
int max_batch(int n_hash) {
  return MAX_POS / n_hash < MAX_W ? MAX_POS / n_hash : MAX_W;
}

}  // namespace

// The whole encode of ``n`` array-bound pairs on ``stream``.  Buffers, all
// on the card and 8-byte aligned: bkeys / bidx / tkeys / tidx int64 and
// bocc / tocc int32 [n_bits * bucket_size], bkeys / bocc / bidx zeroed; pos
// int32 [n_bits * n_hash * bucket_size]; bcount int32 [n_bits]; inserted
// uint8 [n], zeroed; bits int64 [ceil(n_bits * km_byte_size / 4)] and
// km_back int32 [ceil(back_bit_len / 32)], zeroed; stats int64 [3], zeroed;
// rest_keys int64 / rest_occs int32 [n + n_bits].  occ2bin: uint32
// [occ2bin_len].
extern "C" int kx_encode_arrays(
    const void* keys, const void* occs, long long n, int k, int n_bits,
    int n_hash, int back_num_hash, long long km_byte_size,
    long long back_bit_len, const void* occ2bin, long long occ2bin_len,
    long long bucket_size, int batch, void* bkeys, void* bocc, void* bidx,
    void* bcount, void* tkeys, void* tocc, void* tidx, void* pos, void* conf,
    void* inserted, void* bits, void* km_back, void* stats, void* rest_keys,
    void* rest_occs, void* stream) {
  const long long km_bit_size = km_byte_size * 8;
  if (n < 0 || k < 3 || k > 32 || n_bits < 1 || n_bits > MAX_BITS
      || n_hash < 1 || n_hash > 32 || back_num_hash < 0
      || back_num_hash > 32 || km_byte_size < 1
      || km_bit_size > (1ll << 32) || (back_num_hash && back_bit_len < 1)
      || bucket_size < 1 || bucket_size > 0x7fffffffll || batch < 1
      || batch > max_batch(n_hash))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      encode_conflicts, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.keys = (const u64*)keys;
  P.occs = (const u32*)occs;
  P.bkeys = (u64*)bkeys;
  P.bocc = (u32*)bocc;
  P.bidx = (u64*)bidx;
  P.bcount = (int*)bcount;
  P.tkeys = (u64*)tkeys;
  P.tocc = (u32*)tocc;
  P.tidx = (u64*)tidx;
  P.pos = (u32*)pos;
  P.conf = (u32*)conf;
  P.inserted = (unsigned char*)inserted;
  P.bits = (u64*)bits;
  P.km_back = (u32*)km_back;
  P.occ2bin = (const u32*)occ2bin;
  P.occ2bin_len = occ2bin_len;
  P.stats = (u64*)stats;
  P.rest_keys = (u64*)rest_keys;
  P.rest_occs = (u32*)rest_occs;
  P.bits_mod = make_mod(km_bit_size);
  P.back_mod = make_mod(back_bit_len);
  P.km_byte_size = (u64)km_byte_size;
  P.mid_mask = (~0ull) >> (64 - 2 * (k - 2));
  P.n = n;
  P.bucket_size = bucket_size;
  P.max_batches = (bucket_size + batch - 1) / batch;
  P.k = k;
  P.n_bits = n_bits;
  P.n_hash = n_hash;
  P.back_num_hash = back_num_hash;
  P.batch = batch;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long cap = (long long)n_bits * bucket_size;
  const long long full = n / cap;
  const unsigned wide = (unsigned)((cap + WIDE - 1) / WIDE);
  // the full flushes, then the tail flush (partial and empty buckets)
  for (long long f = 0; f <= full; f++) {
    const long long fill = f < full ? cap : n - full * cap;
    for (int t = 0; t < n_bits; t++) {
      encode_positions<<<wide, WIDE, 0, s>>>(P, f * cap, fill, t);
      encode_conflicts<<<dim3((unsigned)P.max_batches, n_bits), THREADS, SMEM,
                         s>>>(P, fill, t);
      encode_round<<<n_bits * CLUSTER, CT, 0, s>>>(P, fill, t);
      encode_compact<<<n_bits, THREADS, 0, s>>>(P, fill, t);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    encode_handoff<<<1, THREADS, 0, s>>>(P);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (n && back_num_hash) {
    encode_back<<<(unsigned)((n + WIDE - 1) / WIDE), WIDE, 0, s>>>(P);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
