"""Bloom-filter bank for low-count k-mers.

Copy of the JAX package's ``model/bloom.py``, itself a rebuild of the
reference BF bank (kmodel.hpp:248-258,361-506): ``bf_num`` filter
*pairs* (1 when ci==1, else 3); pair i holds exactly the k-mers with counter
ci+i.  Each pair couples a main filter over the full k-mer ASCII string
(nh-1 hashes, ``count/5.5*(nh-1)`` bytes) with a "back" filter over the
middle (k-2)-mer (nh-2 hashes, ``(count>>3)*(nh-2)`` bytes).  Membership
requires both.  When ci>1 the probe order is pairs {1,0,2}, i.e. counts
ci+1, ci, ci+2 (kmodel.hpp:246,361-371).

Insertion is a commutative scatter-OR — order-free.  Two builds give
bit-identical filters: the native C++ host insert (this module), and the
device build (``model/device_bloom.py``), the default of the counting
pipeline, which scatters the probe bits into a device bitmap so that only
the finished filter bytes cross to the host.
"""

from __future__ import annotations

import numpy as np

from kmcex_tpu_torch import native


def bf_sizes(kmer_counts: np.ndarray, n_hash: int) -> tuple[np.ndarray, np.ndarray]:
    """Byte sizes of (main, back) filters per pair (kmodel.hpp:409-418).

    Reference computes ``count / 5.5 * (nh-1)`` in double then truncates to
    uint64, and ``(count >> 3) * (nh-2)`` in integers.

    Sizes are clamped to >=1 byte: the reference formulas yield 0 bytes for
    pairs holding <8 k-mers, and hashing modulo a 0-bit filter is undefined
    (the reference SIGFPEs on such inputs, kmodel.hpp:576-581).  The clamp
    only changes behavior on inputs where the reference cannot run at all;
    save/load recompute sizes with the same clamp, so files stay
    self-consistent.
    """
    counts = np.asarray(kmer_counts, dtype=np.uint64)
    byte_bf = np.array(
        [max(int(float(c) / 5.5 * (n_hash - 1)), 1) for c in counts], dtype=np.uint64
    )
    byte_back = np.maximum((counts >> np.uint64(3)) * np.uint64(n_hash - 2), 1)
    return byte_bf, byte_back


class BloomBank:
    def __init__(self, kmer_counts: np.ndarray, n_hash: int, ci: int):
        self.ci = int(ci)
        self.bf_num = 1 if ci == 1 else 3
        self.n_hash = int(n_hash)
        self.bf_num_hash = n_hash - 1
        self.bf_back_num_hash = n_hash - 2
        self.kmer_counts = np.asarray(kmer_counts[: self.bf_num], dtype=np.uint64)
        self.byte_bf, self.byte_bf_back = bf_sizes(self.kmer_counts, n_hash)
        self.length_bf = self.byte_bf << np.uint64(3)
        self.length_bf_back = self.byte_bf_back << np.uint64(3)
        self.bit_bf = [np.zeros(int(b), dtype=np.uint8) for b in self.byte_bf]
        self.bit_bf_back = [np.zeros(int(b), dtype=np.uint8) for b in self.byte_bf_back]
        # Probe order: identity when ci==1, else {1,0,2} (kmodel.hpp:246,363).
        self.probe_order = [0] if ci == 1 else [1, 0, 2]

    @property
    def bf_kmercount(self) -> int:
        return int(self.kmer_counts.sum())

    def insert(self, pair_idx: int, kmers_u64: np.ndarray, k: int,
               n_threads: int = 0) -> None:
        """Insert canonical k-mers into pair ``pair_idx`` (kmodel.hpp:473-506).

        ``n_threads`` passes through to the native OMP insert; the streaming
        encode calls this from a dedicated worker thread concurrently with
        the array feed and the chunk producer, where spawning the default
        all-cores OMP team oversubscribes the host (KMCEX_BLOOM_THREADS
        tunes it; kmodel.init_from_chunks passes 1)."""
        if len(kmers_u64) == 0:
            return
        native.insert_bloom(
            kmers_u64, k, self.bit_bf[pair_idx], int(self.length_bf[pair_idx]),
            self.bf_num_hash, substr_mode=0, n_threads=n_threads,
        )
        native.insert_bloom(
            kmers_u64, k, self.bit_bf_back[pair_idx], int(self.length_bf_back[pair_idx]),
            self.bf_back_num_hash, substr_mode=1, n_threads=n_threads,
        )

    def check_all(self, kmers_u64: np.ndarray, k: int) -> np.ndarray:
        """Batched check_all_bf (kmodel.hpp:361-371): returns the count
        (pair+ci) of the first pair (in probe order) where both filters hit,
        else 0."""
        kmers_u64 = np.asarray(kmers_u64, dtype=np.uint64)
        out = np.zeros(len(kmers_u64), dtype=np.int32)
        undecided = np.ones(len(kmers_u64), dtype=bool)
        for i in self.probe_order:
            if not undecided.any():
                break
            main = native.check_bloom(
                kmers_u64, k, self.bit_bf[i], int(self.length_bf[i]),
                self.bf_num_hash, substr_mode=0,
            )
            back = native.check_bloom(
                kmers_u64, k, self.bit_bf_back[i], int(self.length_bf_back[i]),
                self.bf_back_num_hash, substr_mode=1,
            )
            hit = undecided & main & back
            out[hit] = i + self.ci
            undecided &= ~hit
        return out
