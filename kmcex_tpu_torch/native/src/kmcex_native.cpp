// kmcex_tpu native runtime — the host-side sequential pieces of the KModel
// encode that are order-dependent and therefore cannot be expressed as
// commutative device scatters (SURVEY.md §7 "Hard parts").
//
// Semantics replicate the reference encode pipeline exactly
// (the reference's kmodel.hpp:473-622): the buffered bucket fill, the
// rotating (bucket, round) -> array schedule, the in-bucket compaction
// between rounds, and the per-insert conflict rule on the coupled bit
// arrays.  All hashing is MurmurHash64A over the ASCII k-mer string with the
// reference's fixed seed table (tools.hpp:9,16-50).  This file is new code:
// the algorithms were reimplemented from observed behavior, not copied.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

const uint32_t kHashSeeds[128] = {
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

// MurmurHash64A over a byte string (public-domain algorithm; parity with
// tools.hpp:16-50 is golden-tested from Python).
inline uint64_t murmur64(const void* key, int len, uint32_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (uint64_t)((uint64_t)len * m);
  const uint8_t* p = (const uint8_t*)key;
  int nfull = len / 8;
  for (int i = 0; i < nfull; i++) {
    uint64_t k;
    memcpy(&k, p + 8 * i, 8);  // little-endian load
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  const uint8_t* tail = p + 8 * nfull;
  switch (len & 7) {
    case 7: h ^= (uint64_t)tail[6] << 48; // fallthrough
    case 6: h ^= (uint64_t)tail[5] << 40; // fallthrough
    case 5: h ^= (uint64_t)tail[4] << 32; // fallthrough
    case 4: h ^= (uint64_t)tail[3] << 24; // fallthrough
    case 3: h ^= (uint64_t)tail[2] << 16; // fallthrough
    case 2: h ^= (uint64_t)tail[1] << 8;  // fallthrough
    case 1: h ^= (uint64_t)tail[0]; h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// Render the ASCII string of a 2-bit packed k-mer (MSB-first, A=0 C=1 G=2
// T=3) — the hashes run over ASCII, not packed bits (kmodel.hpp:600).
// A 256-entry byte->4-chars table emits four bases per lookup.
struct Ascii4Lut {
  uint32_t t[256];
  Ascii4Lut() {
    static const char ACGT[4] = {'A', 'C', 'G', 'T'};
    for (int b = 0; b < 256; b++) {
      // MSB-first within the byte -> first char from the top 2 bits
      uint32_t v = 0;
      for (int i = 0; i < 4; i++) {
        v |= (uint32_t)(uint8_t)ACGT[(b >> (6 - 2 * i)) & 3] << (8 * i);
      }
      t[b] = v;  // little-endian u32 = chars in memory order
    }
  }
};
static const Ascii4Lut kAscii4;

inline void to_ascii(uint64_t v, int k, char* out) {
  // left-align to 32 bases so byte j (MSB-first) yields chars 4j..4j+3
  uint64_t a = v << (2 * (32 - k));
  for (int j = 0; j < 8; j++) {
    uint32_t c4 = kAscii4.t[(uint8_t)(a >> (56 - 8 * j))];
    memcpy(out + 4 * j, &c4, 4);  // writes up to 32 chars; callers' bufs are 64B
  }
}

// Seed-independent murmur precomputation: the per-8-byte-block mix
// k*=m; k^=k>>r; k*=m does not involve the seed, so for the many
// (seed_j) evaluations of the SAME string (nh probes x n_bits arrays) the
// blocks are mixed once and each evaluation is just xor-mul folds.
struct MurmurPre {
  uint64_t f[8];
  uint64_t tail;
  int nfull;
  int len;
};

inline void murmur_pre(const void* key, int len, MurmurPre& p) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  const uint8_t* d = (const uint8_t*)key;
  p.nfull = len / 8;
  p.len = len;
  for (int i = 0; i < p.nfull; i++) {
    uint64_t k;
    memcpy(&k, d + 8 * i, 8);
    k *= m;
    k ^= k >> r;
    k *= m;
    p.f[i] = k;
  }
  p.tail = 0;
  const uint8_t* t = d + 8 * p.nfull;
  switch (len & 7) {
    case 7: p.tail ^= (uint64_t)t[6] << 48; // fallthrough
    case 6: p.tail ^= (uint64_t)t[5] << 40; // fallthrough
    case 5: p.tail ^= (uint64_t)t[4] << 32; // fallthrough
    case 4: p.tail ^= (uint64_t)t[3] << 24; // fallthrough
    case 3: p.tail ^= (uint64_t)t[2] << 16; // fallthrough
    case 2: p.tail ^= (uint64_t)t[1] << 8;  // fallthrough
    case 1: p.tail ^= (uint64_t)t[0];
  }
}

inline uint64_t murmur_eval(const MurmurPre& p, uint32_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ ((uint64_t)p.len * m);
  for (int i = 0; i < p.nfull; i++) {
    h ^= p.f[i];
    h *= m;
  }
  if (p.len & 7) {
    h ^= p.tail;
    h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// Atomic bit set, MSB-first within byte (kmodel.hpp:576-581).
inline void set_bit(uint8_t* bits, uint64_t pos) {
  uint64_t row = pos >> 3;
  uint8_t x = (uint8_t)(1u << (7 - (pos & 7)));
  __sync_fetch_and_or(bits + row, x);
}

inline bool check_bit(const uint8_t* bits, uint64_t pos) {
  uint64_t row = pos >> 3;
  return (bits[row] >> (7 - (pos & 7))) & 1;
}

struct KmerBuf {
  uint64_t kmer;
  uint32_t occ;      // raw counter; 0 marks "inserted, drop from buffer"
  int64_t orig_idx;  // position in the caller's input stream
};

}  // namespace

extern "C" {

uint64_t kx_murmur64(const uint8_t* data, int len, uint32_t seed) {
  return murmur64(data, len, seed);
}

// Batched Bloom-filter insert over packed k-mers.
// substr_mode: 0 = hash the full k-mer string; 1 = hash the middle (k-2)-mer
// kmer[1:k-1] (the "back" filters; kmodel.hpp:386-390,475).
// Seeds are always kHashSeeds[0..num_hash).
// The Bloom/bit-array loops are memory-latency bound, not hash bound: each
// probe is a random byte in a multi-MB table (DRAM-latency class), while the
// murmur folds run at >200M evals/s.  All batched entry points therefore
// run a two-phase block pipeline: phase 1 computes every probe position for
// a small block and issues prefetches; phase 2 touches the (now in-flight)
// lines.  Positions depend only on the k-mer, never on table contents, so
// the split is semantics-free.
constexpr int64_t kBlk = 16;

void kx_insert_bloom(const uint64_t* kmers, int64_t n, int k, uint8_t* bf,
                     uint64_t bf_bitlen, int num_hash, int substr_mode,
                     int n_threads) {
  if (bf_bitlen == 0 || n == 0) return;
  const int klen = substr_mode ? k - 2 : k;
  if (num_hash > 32) {  // beyond the block buffers: direct path
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) {
      char buf[64];
      uint64_t v = kmers[i];
      if (substr_mode) v = (v >> 2) & ((~0ULL) >> (64 - 2 * (k - 2)));
      to_ascii(v, klen, buf);
      MurmurPre pre;
      murmur_pre(buf, klen, pre);
      for (int j = 0; j < num_hash; j++) {
        set_bit(bf, murmur_eval(pre, kHashSeeds[j % 128]) % bf_bitlen);
      }
    }
    return;
  }
  const int64_t nblk = (n + kBlk - 1) / kBlk;
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
  for (int64_t b = 0; b < nblk; b++) {
    const int64_t i0 = b * kBlk, i1 = i0 + kBlk < n ? i0 + kBlk : n;
    uint64_t pos[kBlk][32];
    for (int64_t i = i0; i < i1; i++) {
      char buf[64];
      uint64_t v = kmers[i];
      if (substr_mode) v = (v >> 2) & ((~0ULL) >> (64 - 2 * (k - 2)));
      to_ascii(v, klen, buf);
      MurmurPre pre;
      murmur_pre(buf, klen, pre);
      for (int j = 0; j < num_hash; j++) {
        uint64_t p = murmur_eval(pre, kHashSeeds[j]) % bf_bitlen;
        pos[i - i0][j] = p;
        __builtin_prefetch(bf + (p >> 3), 1, 1);
      }
    }
    for (int64_t i = i0; i < i1; i++) {
      for (int j = 0; j < num_hash; j++) set_bit(bf, pos[i - i0][j]);
    }
  }
}

// Batched Bloom-filter membership probe; out[i] = 1 if all bits set.
void kx_check_bloom(const uint64_t* kmers, int64_t n, int k,
                    const uint8_t* bf, uint64_t bf_bitlen, int num_hash,
                    int substr_mode, uint8_t* out, int n_threads) {
  if (bf_bitlen == 0) { memset(out, 0, n); return; }
  const int klen = substr_mode ? k - 2 : k;
  if (num_hash > 32) {  // beyond the block buffers: direct path
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) {
      char buf[64];
      uint64_t v = kmers[i];
      if (substr_mode) v = (v >> 2) & ((~0ULL) >> (64 - 2 * (k - 2)));
      to_ascii(v, klen, buf);
      MurmurPre pre;
      murmur_pre(buf, klen, pre);
      uint8_t ok = 1;
      for (int j = 0; j < num_hash && ok; j++) {
        ok = check_bit(bf, murmur_eval(pre, kHashSeeds[j % 128]) % bf_bitlen);
      }
      out[i] = ok;
    }
    return;
  }
  const int64_t nblk = (n + kBlk - 1) / kBlk;
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
  for (int64_t b = 0; b < nblk; b++) {
    const int64_t i0 = b * kBlk, i1 = i0 + kBlk < n ? i0 + kBlk : n;
    uint64_t pos[kBlk][32];
    for (int64_t i = i0; i < i1; i++) {
      char buf[64];
      uint64_t v = kmers[i];
      if (substr_mode) v = (v >> 2) & ((~0ULL) >> (64 - 2 * (k - 2)));
      to_ascii(v, klen, buf);
      MurmurPre pre;
      murmur_pre(buf, klen, pre);
      for (int j = 0; j < num_hash; j++) {
        uint64_t p = murmur_eval(pre, kHashSeeds[j]) % bf_bitlen;
        pos[i - i0][j] = p;
        __builtin_prefetch(bf + (p >> 3), 0, 1);
      }
    }
    for (int64_t i = i0; i < i1; i++) {
      uint8_t ok = 1;
      for (int j = 0; j < num_hash && ok; j++) {
        ok = check_bit(bf, pos[i - i0][j]);
      }
      out[i] = ok;
    }
  }
}

namespace {

// One attempted insert into coupled array `index` (kmodel.hpp:590-622):
// bit j of `bin` goes to position murmur(ascii, seed[index][j]) % len in
// bit_array_1, with the tag set in bit_array_2 — allowed only if no already-
// tagged probe position disagrees with the bin bit.
inline bool insert_to_array_pos(const uint64_t* pos, uint32_t bin,
                                uint8_t* bit1, uint8_t* bit2, int n_hash) {
  for (int j = 0; j < n_hash; j++) {
    bool v1 = check_bit(bit1, pos[j]);
    bool v2 = check_bit(bit2, pos[j]);
    if (v2 && v1 != (bool)((bin >> j) & 1)) return false;
  }
  for (int j = 0; j < n_hash; j++) {
    if ((bin >> j) & 1) set_bit(bit1, pos[j]);
    set_bit(bit2, pos[j]);
  }
  return true;
}

// In-bucket compaction between rounds (kmodel.hpp:529-540): move survivors
// from the tail into freed slots; NOT order-preserving, and later rounds (and
// the rest-store hand-off) see this order, so it must match exactly.
//
// Reference quirk that parity requires: with n == 0 the loop body never runs
// and the return still reads a[0].occ — so an EMPTY bucket in the tail flush
// (buff_num zeroed by push_last_to_array, kmodel.hpp:520-527) RESURRECTS its
// slot-0 survivor left over from the previous full flush (survivors stay in
// place with occ != 0 after the hand-off), retries it every round, and —
// since a k-mer that failed all arrays keeps failing (bits are never
// cleared) — pushes it to the rest store a SECOND time.  Buckets that were
// never written read occ == 0 (the reference's fresh heap pages are zeroed;
// our slots are value-initialized) and stay empty.
inline int64_t reorder_buffer(KmerBuf* a, int64_t n) {
  int64_t il = 0, ir = n - 1;
  while (il < ir) {
    while (il < ir && !a[ir].occ) ir--;
    while (il < ir && a[il].occ) il++;
    if (il < ir) {
      a[il] = a[ir];
      a[ir].occ = 0;
    }
  }
  return a[il].occ ? il + 1 : 0;
}

}  // namespace

namespace {

// Incremental coupled-bit-array encoder, replicating the reference's
// buffered rotating schedule (kmodel.hpp:508-573):
//   * k-mers fill n_bits buckets of bucket_size each, in arrival order;
//   * when all buckets are full, run n_bits rounds; in round t bucket i
//     drains into array (i+t)%n_bits (arrays disjoint per round, so the
//     reference's thread-per-bucket parallelism is order-deterministic);
//   * every successful insert also ORs the middle (k-2)-mer into the global
//     km_back Bloom filter (commutative, order-free);
//   * survivors after all rounds go to the rest store in (bucket, slot)
//     order — collected here as (kmer, occ) pairs.
//
// The incremental (feed/finish) form lets the caller stream chunks as they
// arrive from the device while earlier chunks are being encoded; the
// schedule depends only on overall stream order, so chunked feeding is
// bit-identical to the one-shot pass.
//
// occs are raw counters; bins are looked up through occ2bin at insert time
// (kmodel.hpp:545) via the caller-provided LUT.
// bit1/bit2: n_bits contiguous arrays of (km_bit_size/8) bytes each.
struct Encoder {
  int k, n_bits, n_hash, back_num_hash, n_threads;
  const uint32_t* occ2bin;
  int64_t occ2bin_len;
  uint8_t *bit1, *bit2, *km_back;
  uint64_t km_bit_size, km_byte_size, back_bit_len, mid_mask;
  int64_t bucket_size, cap, idx;
  std::vector<std::vector<uint32_t>> seeds;
  std::vector<std::vector<KmerBuf>> buf;
  std::vector<int64_t> buf_n;
  std::vector<uint64_t> rest_kmers;
  std::vector<uint32_t> rest_occs;

  Encoder(int k_, int n_bits_, int n_hash_, const uint32_t* occ2bin_,
          int64_t occ2bin_len_, uint8_t* bit1_, uint8_t* bit2_,
          uint64_t km_bit_size_, uint8_t* km_back_, uint64_t back_bit_len_,
          int back_num_hash_, int64_t bucket_size_, int n_threads_)
      : k(k_), n_bits(n_bits_), n_hash(n_hash_),
        back_num_hash(back_num_hash_), n_threads(n_threads_),
        occ2bin(occ2bin_), occ2bin_len(occ2bin_len_), bit1(bit1_),
        bit2(bit2_), km_back(km_back_), km_bit_size(km_bit_size_),
        km_byte_size(km_bit_size_ >> 3), back_bit_len(back_bit_len_),
        mid_mask((~0ULL) >> (64 - 2 * (k_ - 2))), bucket_size(bucket_size_),
        cap(bucket_size_ * n_bits_), idx(0) {
    // Per-array seed tables: seeds[i][j] = kHashSeeds[(i*n_hash + j) % 128]
    // (kmodel.hpp:450-453).
    seeds.resize(n_bits);
    buf.resize(n_bits);
    buf_n.assign(n_bits, bucket_size);
    for (int i = 0; i < n_bits; i++) {
      seeds[i].resize(n_hash);
      for (int j = 0; j < n_hash; j++)
        seeds[i][j] = kHashSeeds[(i * n_hash + j) % 128];
      buf[i].resize(bucket_size);
    }
  }

  // Drain one bucket into one array, sequentially (kmodel.hpp:543-555).
  // Probe positions depend only on the k-mer, so a block of them is
  // computed and prefetched ahead of the (strictly in-order) insert pass —
  // the inserts themselves stay sequential, preserving the reference's
  // conflict semantics bit-exactly.
  void insert_array(int bucket, int array, int64_t& real_n) {
    KmerBuf* a = buf[bucket].data();
    uint8_t* b1 = bit1 + (uint64_t)array * km_byte_size;
    uint8_t* b2 = bit2 + (uint64_t)array * km_byte_size;
    const uint32_t* sd = seeds[array].data();
    char ascii[64];
    constexpr int64_t B = 16;
    uint64_t pos[B][32];
    uint64_t bpos[B][32];
    uint32_t bins[B];
    for (int64_t c0 = 0; c0 < real_n; c0 += B) {
      const int64_t c1 = c0 + B < real_n ? c0 + B : real_n;
      for (int64_t c = c0; c < c1; c++) {
        to_ascii(a[c].kmer, k, ascii);
        MurmurPre pre;
        murmur_pre(ascii, k, pre);
        uint32_t occ = a[c].occ;
        bins[c - c0] = (occ < (uint64_t)occ2bin_len) ? occ2bin[occ] : 0;
        for (int j = 0; j < n_hash; j++) {
          uint64_t p = murmur_eval(pre, sd[j]) % km_bit_size;
          pos[c - c0][j] = p;
          __builtin_prefetch(b1 + (p >> 3), 1, 1);
          __builtin_prefetch(b2 + (p >> 3), 1, 1);
        }
        // km_back positions speculatively (inserts succeed ~95% of the
        // time, and the eval is far cheaper than a DRAM stall)
        uint64_t mid = (a[c].kmer >> 2) & mid_mask;
        char mascii[64];
        to_ascii(mid, k - 2, mascii);
        MurmurPre mpre;
        murmur_pre(mascii, k - 2, mpre);
        for (int j = 0; j < back_num_hash; j++) {
          uint64_t p = murmur_eval(mpre, kHashSeeds[j]) % back_bit_len;
          bpos[c - c0][j] = p;
          __builtin_prefetch(km_back + (p >> 3), 1, 1);
        }
      }
      for (int64_t c = c0; c < c1; c++) {
        if (insert_to_array_pos(pos[c - c0], bins[c - c0], b1, b2, n_hash)) {
          // middle (k-2)-mer into km_back (kmodel.hpp:546-551)
          for (int j = 0; j < back_num_hash; j++) {
            set_bit(km_back, bpos[c - c0][j]);
          }
          a[c].occ = 0;
        }
      }
    }
    real_n = reorder_buffer(a, real_n);
  }

  // Flush: n_bits rounds of the rotation, then survivors to rest
  // (kmodel.hpp:557-573).
  void flush() {
    for (int t = 0; t < n_bits; t++) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 1)
#endif
      for (int i = 0; i < n_bits; i++) {
        insert_array(i, (i + t) % n_bits, buf_n[i]);
      }
    }
    for (int i = 0; i < n_bits; i++) {
      for (int64_t j = 0; j < buf_n[i]; j++) {
        rest_kmers.push_back(buf[i][j].kmer);
        rest_occs.push_back(buf[i][j].occ);
      }
      buf_n[i] = bucket_size;
    }
  }

  void feed(const uint64_t* kmers, const uint32_t* occs, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
      int64_t row = idx / bucket_size, col = idx % bucket_size;
      buf[row][col].kmer = kmers[i];
      buf[row][col].occ = occs[i];
      buf[row][col].orig_idx = 0;
      idx++;
      if (idx >= cap) {
        flush();
        idx = 0;
      }
    }
  }

  // Tail flush (kmodel.hpp:520-527): partial bucket lengths, then one flush.
  void finish() {
    int64_t row = (idx - 1) / bucket_size;
    int64_t col = (idx - 1) % bucket_size;
    if (idx == 0) { row = 0; col = -1; }
    buf_n[row] = col + 1;
    for (int i = (int)row + 1; i < n_bits; i++) buf_n[i] = 0;
    flush();
  }
};

}  // namespace

void* kx_encoder_new(int k, int n_bits, int n_hash, const uint32_t* occ2bin,
                     int64_t occ2bin_len, uint8_t* bit1, uint8_t* bit2,
                     uint64_t km_bit_size, uint8_t* km_back,
                     uint64_t back_bit_len, int back_num_hash,
                     int64_t bucket_size, int n_threads) {
  return new Encoder(k, n_bits, n_hash, occ2bin, occ2bin_len, bit1, bit2,
                     km_bit_size, km_back, back_bit_len, back_num_hash,
                     bucket_size, n_threads);
}

void kx_encoder_feed(void* h, const uint64_t* kmers, const uint32_t* occs,
                     int64_t n) {
  ((Encoder*)h)->feed(kmers, occs, n);
}

int64_t kx_encoder_finish(void* h) {
  Encoder* e = (Encoder*)h;
  e->finish();
  return (int64_t)e->rest_kmers.size();
}

void kx_encoder_take_rest(void* h, uint64_t* kmers_out, uint32_t* occs_out) {
  Encoder* e = (Encoder*)h;
  memcpy(kmers_out, e->rest_kmers.data(), e->rest_kmers.size() * 8);
  memcpy(occs_out, e->rest_occs.data(), e->rest_occs.size() * 4);
}

void kx_encoder_free(void* h) { delete (Encoder*)h; }

// Batched coupled-array probe (query side, kmodel.hpp:625-646): for each
// k-mer and each array, if all n_hash tag bits are set, decode the value
// bits little-endian into a bin.  out_bins[i*n_bits + a] = bin if the array
// "hit" (all tags set), else -1.  Bin 0 hits are reported as 0 (caller
// applies the reference's >0 / !=0 filters).
void kx_find_bitarray(const uint64_t* kmers, int64_t n, int k, int n_bits,
                      int n_hash, const uint8_t* bit1, const uint8_t* bit2,
                      uint64_t km_bit_size, int32_t* out_bins, int n_threads) {
  const uint64_t km_byte_size = km_bit_size >> 3;
  std::vector<std::vector<uint32_t>> seeds(n_bits);
  for (int i = 0; i < n_bits; i++) {
    seeds[i].resize(n_hash);
    for (int j = 0; j < n_hash; j++) seeds[i][j] = kHashSeeds[(i * n_hash + j) % 128];
  }
  if (n_bits > 8 || n_hash > 32) {  // beyond the block buffers: direct path
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) {
      char ascii[64];
      to_ascii(kmers[i], k, ascii);
      MurmurPre pre;
      murmur_pre(ascii, k, pre);
      for (int a = 0; a < n_bits; a++) {
        const uint8_t* b1 = bit1 + (uint64_t)a * km_byte_size;
        const uint8_t* b2 = bit2 + (uint64_t)a * km_byte_size;
        bool ok = true;
        int32_t bin = 0;
        for (int j = 0; j < n_hash; j++) {
          uint64_t p = murmur_eval(pre, seeds[a][j]) % km_bit_size;
          bin |= ((int32_t)check_bit(b1, p)) << j;
          if (!check_bit(b2, p)) ok = false;
        }
        out_bins[i * n_bits + a] = ok ? bin : -1;
      }
    }
    return;
  }
  const int64_t nblk = (n + kBlk - 1) / kBlk;
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
  for (int64_t b = 0; b < nblk; b++) {
    const int64_t i0 = b * kBlk, i1 = i0 + kBlk < n ? i0 + kBlk : n;
    // positions for the whole block (all arrays) computed + prefetched first
    uint64_t pos[kBlk][8][32];
    for (int64_t i = i0; i < i1; i++) {
      char ascii[64];
      to_ascii(kmers[i], k, ascii);
      MurmurPre pre;
      murmur_pre(ascii, k, pre);
      for (int a = 0; a < n_bits; a++) {
        const uint8_t* b1 = bit1 + (uint64_t)a * km_byte_size;
        const uint8_t* b2 = bit2 + (uint64_t)a * km_byte_size;
        for (int j = 0; j < n_hash; j++) {
          uint64_t p = murmur_eval(pre, seeds[a][j]) % km_bit_size;
          pos[i - i0][a][j] = p;
          __builtin_prefetch(b1 + (p >> 3), 0, 1);
          __builtin_prefetch(b2 + (p >> 3), 0, 1);
        }
      }
    }
    for (int64_t i = i0; i < i1; i++) {
      for (int a = 0; a < n_bits; a++) {
        const uint8_t* b1 = bit1 + (uint64_t)a * km_byte_size;
        const uint8_t* b2 = bit2 + (uint64_t)a * km_byte_size;
        bool ok = true;
        int32_t bin = 0;
        for (int j = 0; j < n_hash; j++) {
          uint64_t p = pos[i - i0][a][j];
          bin |= ((int32_t)check_bit(b1, p)) << j;
          if (!check_bit(b2, p)) ok = false;  // no early break: matches ref
        }
        out_bins[i * n_bits + a] = ok ? bin : -1;
      }
    }
  }
}

// Two-pointer merge of sorted (kmer, count) runs, summing duplicates with
// uint32 saturation (counts are cs-clamped far below 2^32 downstream).
// Returns the merged length; out arrays need capacity na+nb.  Memory-speed
// replacement for argsort-based host merges when device runs spill to host
// (genome-scale tables exceed HBM).
int64_t kx_merge_runs(const uint64_t* ka, const uint32_t* ca, int64_t na,
                      const uint64_t* kb, const uint32_t* cb, int64_t nb,
                      uint64_t* ko, uint32_t* co) {
  int64_t i = 0, j = 0, o = 0;
  while (i < na && j < nb) {
    uint64_t x = ka[i], y = kb[j];
    if (x < y) {
      ko[o] = x; co[o++] = ca[i++];
    } else if (y < x) {
      ko[o] = y; co[o++] = cb[j++];
    } else {
      uint64_t s = (uint64_t)ca[i] + cb[j];
      ko[o] = x; co[o++] = s > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)s;
      i++; j++;
    }
  }
  for (; i < na; i++) { ko[o] = ka[i]; co[o++] = ca[i]; }
  for (; j < nb; j++) { ko[o] = kb[j]; co[o++] = cb[j]; }
  return o;
}

// Read the wbits-wide little-endian bit field starting at stream bit
// i*wbits (device _pack_bits layout: value a of each 8-group occupies bits
// [a*wbits, (a+1)*wbits) of the group's wbits-byte block).
static inline uint64_t read_bits(const uint8_t* bytes, int64_t nbytes,
                                 int64_t i, int wbits, uint64_t mask) {
  int64_t bit = i * (int64_t)wbits;
  int64_t byte = bit >> 3;
  int shift = (int)(bit & 7);
  uint64_t v;
  if (byte + 9 <= nbytes) {
    uint64_t lo;
    memcpy(&lo, bytes + byte, 8);
    v = lo >> shift;
    if (shift && shift + wbits > 64) v |= (uint64_t)bytes[byte + 8] << (64 - shift);
  } else {  // tail-safe slow path (last few entries only)
    v = 0;
    int need = (shift + wbits + 7) >> 3;
    for (int b = 0; b < need && byte + b < nbytes; b++)
      v |= (uint64_t)bytes[byte + b] << (8 * b);
    v >>= shift;
  }
  return v & mask;
}

// Decode a bit-packed delta stream (device _pack_row): out[i] = base + sum
// of the first i+1 deltas, where delta 0 is 0 (the first absolute k-mer
// travels separately in the stats pull).
void kx_unpack_deltas(const uint8_t* bytes, int64_t nbytes, int64_t n,
                      int wbits, uint64_t base, uint64_t* out) {
  const uint64_t mask = wbits >= 64 ? ~0ULL : ((1ULL << wbits) - 1);
  uint64_t acc = base;
  for (int64_t i = 0; i < n; i++) {
    acc += read_bits(bytes, nbytes, i, wbits, mask);
    out[i] = acc;
  }
}

// Decode a bit-packed count stream (device _pack_row; cbits <= 32).
void kx_unpack_counts(const uint8_t* bytes, int64_t nbytes, int64_t n,
                      int cbits, uint32_t* out) {
  const uint64_t mask = cbits >= 64 ? ~0ULL : ((1ULL << cbits) - 1);
  for (int64_t i = 0; i < n; i++)
    out[i] = (uint32_t)read_bits(bytes, nbytes, i, cbits, mask);
}

extern "C++" {  // the templated segmenter core has C++ linkage
namespace {

inline const uint8_t* base_lut() {
  static uint8_t lut[256];
  static bool lut_init = false;
  if (!lut_init) {
    memset(lut, 255, 256);
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
    lut_init = true;
  }
  return lut;
}

// Shared segmenter core.  Packed=false writes [rows, seg_len] byte codes
// (255 = invalid); packed=true writes [rows, seg_len/4] 2-bit codes
// (little-endian within byte) + [rows, seg_len/8] validity bits — the
// device-transfer format (count/extract.extract_canonical_packed), emitted
// directly from ASCII in one pass.
template <bool kPacked>
int64_t segment_core(const uint8_t* buf, int64_t len, int is_fasta,
                     int* fastq_phase, int k, int seg_len, uint8_t* out,
                     uint8_t* out_mask, int64_t out_cap_rows,
                     int64_t* consumed, int64_t* n_reads, int64_t* n_bases) {
  const uint8_t* lut = base_lut();
  const int64_t stride = seg_len - (k - 1);
  const int64_t pbytes = seg_len >> 2, mbytes = seg_len >> 3;
  int64_t rows = 0, reads = 0, bases = 0;
  int64_t pos = 0;
  int phase = *fastq_phase;
  while (pos < len) {
    const uint8_t* nl = (const uint8_t*)memchr(buf + pos, '\n', len - pos);
    if (!nl) break;  // incomplete line -> caller carries it over
    int64_t start = pos, end = nl - buf;
    pos = end + 1;
    if (end > start && buf[end - 1] == '\r') end--;  // CRLF
    bool is_seq = is_fasta ? (end == start || buf[start] != '>')
                           : (phase == 1);
    phase = (phase + 1) & 3;
    if (!is_seq) continue;
    int64_t L = end - start;
    int64_t nseg = L >= k ? (L - k) / stride + 1 : 0;
    if (rows + nseg > out_cap_rows) {  // rewind this line; resume later
      pos = start;
      phase = (phase + 3) & 3;
      break;
    }
    reads++;
    bases += L;
    if (L < k) continue;
    for (int64_t s = 0; s < nseg; s++) {
      const uint8_t* src = buf + start + s * stride;
      int64_t avail = L - s * stride;
      int64_t m = avail < seg_len ? avail : seg_len;
      if (kPacked) {
        uint8_t* dp = out + (rows + s) * pbytes;
        uint8_t* dm = out_mask + (rows + s) * mbytes;
        memset(dp, 0, pbytes);
        memset(dm, 0, mbytes);
        for (int64_t j = 0; j < m; j++) {
          uint8_t c = lut[src[j]];
          if (c < 4) {
            dp[j >> 2] |= (uint8_t)(c << (2 * (j & 3)));
            dm[j >> 3] |= (uint8_t)(1u << (j & 7));
          }
        }
      } else {
        uint8_t* dst = out + (rows + s) * seg_len;
        for (int64_t j = 0; j < m; j++) dst[j] = lut[src[j]];
        if (m < seg_len) memset(dst + m, 255, seg_len - m);
      }
    }
    rows += nseg;
  }
  *fastq_phase = phase;
  *consumed = pos;
  *n_reads = reads;
  *n_bases = bases;
  return rows;
}

}  // namespace
}  // extern "C++"

// FASTQ/FASTA chunk segmenter: scan complete lines in buf, pick sequence
// lines (FASTQ: every 4th starting at phase offset; FASTA: non-'>' lines),
// translate ASCII -> 2-bit codes (255 for non-ACGT) and cut into segments of
// seg_len overlapping by k-1 into `out` [out_cap_rows, seg_len] (rows padded
// with 255).  Resumable: stops at line granularity when out is full.
//   fastq_phase: in/out, line index mod 4 across chunks.
//   consumed: out, bytes of buf processed (always ends on a line boundary).
// Returns rows written.
int64_t kx_segment_buffer(const uint8_t* buf, int64_t len, int is_fasta,
                          int* fastq_phase, int k, int seg_len, uint8_t* out,
                          int64_t out_cap_rows, int64_t* consumed,
                          int64_t* n_reads, int64_t* n_bases) {
  return segment_core<false>(buf, len, is_fasta, fastq_phase, k, seg_len,
                             out, nullptr, out_cap_rows, consumed, n_reads,
                             n_bases);
}

// Packed variant: seg_len must be a multiple of 8.
int64_t kx_segment_buffer_packed(const uint8_t* buf, int64_t len,
                                 int is_fasta, int* fastq_phase, int k,
                                 int seg_len, uint8_t* out_packed,
                                 uint8_t* out_mask, int64_t out_cap_rows,
                                 int64_t* consumed, int64_t* n_reads,
                                 int64_t* n_bases) {
  return segment_core<true>(buf, len, is_fasta, fastq_phase, k, seg_len,
                            out_packed, out_mask, out_cap_rows, consumed,
                            n_reads, n_bases);
}

}  // extern "C"
