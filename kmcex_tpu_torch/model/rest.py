"""KRestData — the exact overflow store for bit-array rejects.

Copy of the JAX package's ``model/rest.py``: a byte-compatible rebuild of
the reference rest store (rest.hpp:46-260), a CSR over 4^pre_len prefix buckets, suffixes packed 4 bases/byte, counts as
int32, with the reference's ``rest.bin`` on-disk layout reproduced field for
field.  Because k <= 32 the per-bucket sort by suffix bytes is a sort by the
packed k-mer value, and the lookup is a searchsorted over the full k-mers.

Reference quirk preserved: the binary search runs over the INCLUSIVE index
range [bucket_start, next_bucket_start] (rest.hpp:236-247), so a key greater
than every suffix in its bucket that equals the next bucket's first suffix
"hits" and returns that (wrong-prefix) count.  For the last bucket the
reference reads past its arrays (undefined); here nothing matches there,
which is the only divergence.
"""

from __future__ import annotations

import pathlib

import numpy as np


def prefix_len_for_k(k: int) -> int:
    """Largest p in [3,7] with (k-p)%4 == 0 (rest.hpp:78-83)."""
    for p in range(7, 2, -1):
        if (k - p) % 4 == 0:
            return p
    raise ValueError(f"no valid prefix length for k={k}")


class KRestData:
    """Exact (k-mer -> count) map over CSR prefix buckets."""

    def __init__(self, k: int | None = None):
        self.k = k
        if k is not None:
            self.pre_len = prefix_len_for_k(k)
            self.map_size = 1 << (2 * self.pre_len)
            self.suf_len = k - self.pre_len
            self.suff_group = self.suf_len // 4
        self._pending_kmers: list[np.ndarray] = []
        self._pending_counts: list[np.ndarray] = []
        # built state
        self.hash2index: np.ndarray | None = None
        self.pre_buffer: np.ndarray | None = None
        self.suffix_bin: np.ndarray | None = None
        self.count_bin: np.ndarray | None = None
        self.suffix_bin_count = 0
        self.pre_buffer_size = 0
        # query acceleration (derived, not serialized)
        self._suffix_int: np.ndarray | None = None
        self._full_sorted: np.ndarray | None = None

    # -- build --------------------------------------------------------------
    def push_back(self, kmers_u64: np.ndarray, counts: np.ndarray) -> None:
        """Queue (k-mer, count) pairs; order doesn't matter (build sorts)."""
        self._pending_kmers.append(np.asarray(kmers_u64, dtype=np.uint64))
        self._pending_counts.append(np.asarray(counts, dtype=np.int32))

    def build(self) -> None:
        if self._pending_kmers:
            kmers = np.concatenate(self._pending_kmers)
            counts = np.concatenate(self._pending_counts)
        else:
            kmers = np.zeros(0, dtype=np.uint64)
            counts = np.zeros(0, dtype=np.int32)
        self._pending_kmers = []
        self._pending_counts = []

        # Global sort by packed value == per-bucket sort by suffix bytes
        # (distinct k-mers, so ordering is unique; rest.hpp:106-113).
        order = np.argsort(kmers, kind="stable")
        kmers = kmers[order]
        counts = counts[order]

        suf_bits = np.uint64(2 * self.suf_len)
        prefixes = (kmers >> suf_bits).astype(np.int64)
        suffix_int = kmers & ((np.uint64(1) << suf_bits) - np.uint64(1))

        bucket_counts = np.bincount(prefixes, minlength=self.map_size).astype(np.int64)
        nonempty = bucket_counts > 0
        # hash2index: -1 empty, else running index over nonempty buckets
        # (rest.hpp:95-104).
        h2i = np.full(self.map_size, -1, dtype=np.int32)
        h2i[nonempty] = np.arange(int(nonempty.sum()), dtype=np.int32)
        self.hash2index = h2i
        self.pre_buffer_size = int(nonempty.sum()) + 1
        pre = np.zeros(self.pre_buffer_size, dtype=np.int32)
        pre[1:] = np.cumsum(bucket_counts[nonempty]).astype(np.int32)
        self.pre_buffer = pre
        self.suffix_bin_count = int(len(kmers))
        self.count_bin = counts.astype(np.int32)
        # Pack suffixes 4 bases/byte, big-endian byte order (rest.hpp:21-34).
        self.suffix_bin = self._pack_suffix_bytes(suffix_int)
        self._suffix_int = suffix_int
        self._full_sorted = None

    def _pack_suffix_bytes(self, suffix_int: np.ndarray) -> np.ndarray:
        g = self.suff_group
        out = np.empty((len(suffix_int), g), dtype=np.uint8)
        for j in range(g):
            shift = np.uint64(8 * (g - 1 - j))
            out[:, j] = ((suffix_int >> shift) & np.uint64(0xFF)).astype(np.uint8)
        return out.reshape(-1)

    def _ensure_suffix_int(self) -> np.ndarray:
        if self._suffix_int is None:
            g = self.suff_group
            b = self.suffix_bin.reshape(-1, g).astype(np.uint64)
            v = np.zeros(len(b), dtype=np.uint64)
            for j in range(g):
                v = (v << np.uint64(8)) | b[:, j]
            self._suffix_int = v
        return self._suffix_int

    # -- query --------------------------------------------------------------
    def check_kmer(self, kmers_u64: np.ndarray) -> np.ndarray:
        """Vectorized exact lookup; 0 where absent (rest.hpp:223-251
        semantics, including the inclusive-high quirk)."""
        kmers = np.asarray(kmers_u64, dtype=np.uint64)
        scalar = kmers.ndim == 0
        kmers = np.atleast_1d(kmers)
        out = np.zeros(len(kmers), dtype=np.int32)
        if self.suffix_bin_count == 0:
            return int(out[0]) if scalar else out

        S = self._ensure_suffix_int()
        suf_bits = np.uint64(2 * self.suf_len)
        prefixes = (kmers >> suf_bits).astype(np.int64)
        suffixes = kmers & ((np.uint64(1) << suf_bits) - np.uint64(1))

        pre_idx = self.hash2index[prefixes]
        valid = pre_idx >= 0
        lo = np.where(valid, self.pre_buffer[np.maximum(pre_idx, 0)], 0).astype(np.int64)
        hi = np.where(valid, self.pre_buffer[np.maximum(pre_idx, 0) + 1], 0).astype(np.int64)

        # The composite key (prefix, suffix) is the full k-mer, and the
        # suffixes of one bucket are sorted, so one search of the sorted
        # full k-mers stands for the search inside every bucket.
        full_sorted = self._full_kmer_sorted()
        pos = np.searchsorted(full_sorted, kmers)
        in_range = valid & (pos < hi) & (pos >= lo)
        hit = in_range & (np.take(full_sorted, np.minimum(pos, len(full_sorted) - 1)) == kmers)
        out[hit] = self.count_bin[pos[hit]]

        # Reference quirk: key beyond bucket end matching next bucket's first
        # suffix (index hi) "hits" with that count (rest.hpp:236-250).
        miss = valid & ~hit
        nb = miss & (hi < self.suffix_bin_count)
        nb_idx = np.where(nb, hi, 0)
        nb_hit = nb & (S[nb_idx] == suffixes)
        # only reachable when the key is greater than every bucket element:
        gt_all = pos >= hi
        nb_hit &= gt_all
        out[nb_hit] = self.count_bin[nb_idx[nb_hit]]
        return int(out[0]) if scalar else out

    def _full_kmer_sorted(self) -> np.ndarray:
        if self._full_sorted is None:
            # Reconstruct sorted full k-mers from CSR (prefix per bucket +
            # suffix ints); sorted by construction.
            S = self._ensure_suffix_int()
            counts = np.diff(self.pre_buffer).astype(np.int64)
            nonempty_prefixes = np.flatnonzero(self.hash2index >= 0).astype(np.uint64)
            pref = np.repeat(nonempty_prefixes, counts)
            self._full_sorted = (pref << np.uint64(2 * self.suf_len)) | S
        return self._full_sorted

    # -- serialization (rest.bin byte layout, rest.hpp:163-221) -------------
    def save_file(self, path: str | pathlib.Path) -> None:
        with open(path, "wb") as f:
            np.array([self.k, self.pre_len, self.map_size, self.pre_buffer_size],
                     dtype=np.int32).tofile(f)
            np.array([self.suffix_bin_count * self.suff_group,
                      self.suffix_bin_count], dtype=np.uint64).tofile(f)
            self.hash2index.astype(np.int32).tofile(f)
            self.pre_buffer.astype(np.int32).tofile(f)
            self.suffix_bin.astype(np.uint8).tofile(f)
            self.count_bin.astype(np.int32).tofile(f)

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "KRestData":
        self = cls()
        with open(path, "rb") as f:
            k, pre_len, map_size, pre_buffer_size = np.fromfile(f, dtype=np.int32, count=4)
            suff_bin_size, suffix_bin_count = np.fromfile(f, dtype=np.uint64, count=2)
            self.k = int(k)
            self.pre_len = int(pre_len)
            self.map_size = int(map_size)
            self.pre_buffer_size = int(pre_buffer_size)
            self.suf_len = self.k - self.pre_len
            self.suff_group = self.suf_len // 4
            self.suffix_bin_count = int(suffix_bin_count)
            self.hash2index = np.fromfile(f, dtype=np.int32, count=self.map_size)
            self.pre_buffer = np.fromfile(f, dtype=np.int32, count=self.pre_buffer_size)
            self.suffix_bin = np.fromfile(f, dtype=np.uint8, count=int(suff_bin_size))
            self.count_bin = np.fromfile(f, dtype=np.int32, count=self.suffix_bin_count)
        return self

    # -- stats --------------------------------------------------------------
    def get_rest_count(self) -> int:
        return self.suffix_bin_count

    def get_all_byte_size(self) -> int:
        # rest.hpp:257-259
        return (
            self.suffix_bin_count * self.suff_group
            + 4 * self.suffix_bin_count
            + 4 * self.pre_buffer_size
            + 4 * self.map_size
        )
