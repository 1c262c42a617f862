"""KMC2 minimizer signatures (CMmer equivalent).

Rebuild of the reference signature machinery
(kmc_api/mmer.h:34-98, kmer_api.h:653-673): an m-mer is
"allowed" unless it starts with AAA/ACA/*AA, contains AA anywhere after the
front, or ends with TTT/TGT/TG*; the normalized value of an m-mer is the
minimum of itself and its reverse complement, with disallowed m-mers mapped
to the sentinel 4^m; a k-mer's signature is the minimum normalized value over
all its m-length windows.

KMC2 databases group k-mers into bins by signature, so both the KMC2
random-access path and byte-parity with KMC2 listing order need this.
Everything is precomputed into a 4^m LUT (cached per m) and applied
vectorized.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def norm_table(m: int) -> np.ndarray:
    """norm[x] = min(x if allowed, rc(x) if allowed, sentinel) (mmer.h:77-87)."""
    size = 1 << (2 * m)
    vals = np.arange(size, dtype=np.uint32)

    # reverse complement of 2-bit packed m-mers, vectorized
    rc = np.zeros_like(vals)
    v = vals.copy()
    for _ in range(m):
        rc = (rc << 2) | ((~v) & 3)
        v >>= 2

    def allowed(x: np.ndarray) -> np.ndarray:
        ok = np.ones(len(x), dtype=bool)
        ok &= (x & 0x3F) != 0x3F  # TTT suffix
        ok &= (x & 0x3F) != 0x3B  # TGT suffix
        ok &= (x & 0x3C) != 0x3C  # TG* suffix
        y = x.copy()
        for _ in range(m - 3):  # AA inside (scanning from the suffix end)
            ok &= (y & 0xF) != 0
            y >>= 2
        ok &= y != 0  # AAA prefix
        ok &= y != 0x04  # ACA prefix
        ok &= (y & 0xF) != 0  # *AA prefix
        return ok

    sentinel = np.uint32(size)
    sv = np.where(allowed(vals), vals, sentinel)
    rv = np.where(allowed(rc), rc, sentinel)
    return np.minimum(sv, rv)


def signatures(kmers_u64: np.ndarray, k: int, sig_len: int) -> np.ndarray:
    """Batched CKmerAPI::get_signature (kmer_api.h:653-673): min normalized
    m-mer over the k-mer's sliding windows."""
    kmers = np.asarray(kmers_u64, dtype=np.uint64)
    norm = norm_table(sig_len)
    mask = np.uint64((1 << (2 * sig_len)) - 1)
    n_win = k - sig_len + 1
    best = np.full(kmers.shape, np.uint32(1 << (2 * sig_len)), dtype=np.uint32)
    for w in range(n_win):
        # window starting at base w: bases w..w+m-1
        shift = np.uint64(2 * (k - sig_len - w))
        mm = ((kmers >> shift) & mask).astype(np.int64)
        best = np.minimum(best, norm[mm])
    return best
