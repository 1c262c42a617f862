"""KMC1 database writer (.kmc_pre / .kmc_suf).

Copy of the writer half of the JAX package's ``io/kmc_db.py`` — itself a
rebuild of the vendored KMC 3.1.0 API's KMC1 format (kmc_file.cpp:236-289)
— for k <= 32 single-word k-mers.  ``KMC1StreamWriter`` spools suffix
records chunk by chunk and writes ``.kmc_pre`` on close, so the table never
has to sit whole in host RAM.  The reader, KMC2 and multi-word k-mers stay
in the JAX package for now.
"""

from __future__ import annotations

import os

import numpy as np

_U64 = np.uint64

_MARKER = b"KMCP"
_MARKER_SUF = b"KMCS"


def counter_size_for(cs: int) -> int:
    """Counter byte width for a max counter value (matches KMC's choice)."""
    for nbytes in (1, 2, 3, 4):
        if cs < (1 << (8 * nbytes)):
            return nbytes
    return 4


def lut_prefix_len_for(k: int) -> int:
    """A prefix length with (k-p)%4==0 so suffixes are whole bytes.  We use
    the same rule as the rest store (largest p in [3,7], rest.hpp:78-83)."""
    for p in range(7, 2, -1):
        if (k - p) % 4 == 0:
            return p
    raise ValueError(f"no valid lut prefix length for k={k}")


def _write_pre_file(path: str, lut_counts: np.ndarray, k: int, cbytes: int,
                    p: int, min_count: int, max_count: int,
                    total: int) -> None:
    """Write the .kmc_pre file from accumulated per-prefix record counts
    (layout per kmc_file.cpp:236-289): integer counters (mode 0) of
    canonical k-mers (both strands)."""
    n_lut = 1 << (2 * p)
    lut_full = np.zeros(n_lut, dtype=np.uint64)
    lut_full[1:] = np.cumsum(lut_counts.astype(np.uint64))[:-1]
    header = np.zeros(5, dtype=np.uint64)
    header[0] = _U64(k)  # mode 0 in the high half
    header[1] = _U64(cbytes) | (_U64(p) << _U64(32))
    header[2] = _U64(min_count) | (_U64(min(max_count, 0xFFFFFFFF)) << _U64(32))
    header[3] = _U64(total)
    # header[4] low nibble 0 => canonical (both strands), kmc_file.cpp:262-274
    with open(path + ".kmc_pre", "wb") as f:
        f.write(_MARKER)
        lut_full.astype("<u8").tofile(f)
        header.astype("<u8").tofile(f)
        f.write(b"\x00" * 4)  # pad: header area (44B) stays u64-aligned
        # Trailer order per kmc_file.cpp:180-193: version at EOF-12,
        # header_offset's first byte at EOF-8, closing marker at EOF-4.
        np.array([0], dtype="<u4").tofile(f)  # kmc_version = 0 (KMC1)
        np.array([48], dtype="<u4").tofile(f)  # header_offset: 44B header + 4
        f.write(_MARKER)


class KMC1StreamWriter:
    """Streaming KMC1 writer: accepts ascending (kmers, counts) chunks and
    spools suffix records to .kmc_suf as they arrive while accumulating
    the 4^p prefix LUT in RAM (<= 4^7 u64s); .kmc_pre is written on close.
    ONE pass, bounded memory (the reference leaves this to the external
    kmc binary, main.cpp:137-140).  Writes integer counters (mode 0) of
    canonical k-mers; the counter width derives from ``max_count``
    (counters are cs-clamped upstream).

    Usage:
        w = KMC1StreamWriter(path, k, min_count=ci, max_count=cs)
        for ku, kc in chunks: w.write_chunk(ku, kc)
        w.close()
    """

    def __init__(self, path: str, k: int, min_count: int = 1,
                 max_count: int = 0xFFFFFFFF):
        self.path = path
        self.k = k
        self.min_count = min_count
        self.max_count = max_count
        self.p = lut_prefix_len_for(k)
        self.cbytes = counter_size_for(max_count)
        self.suf_bases = k - self.p
        self.sufix_size = self.suf_bases // 4
        self.lut_counts = np.zeros(1 << (2 * self.p), dtype=np.int64)
        self.total = 0
        self._last_key = None
        self._suf = open(path + ".kmc_suf", "wb")
        self._suf.write(_MARKER_SUF)
        self._closed = False

    def write_chunk(self, kmers_u64: np.ndarray, counts: np.ndarray) -> None:
        kmers = np.ascontiguousarray(kmers_u64, dtype=_U64)
        if not len(kmers):
            return
        if kmers.ndim != 1:
            raise ValueError("k-mers must be a flat uint64 array (k <= 32)")
        if ((self._last_key is not None and kmers[0] <= self._last_key)
                or (len(kmers) > 1 and not (kmers[1:] > kmers[:-1]).all())):
            raise ValueError("chunks must be globally strictly ascending")
        self._last_key = kmers[-1]
        counts = np.ascontiguousarray(counts, dtype=np.uint64)
        prefixes = (kmers >> _U64(2 * self.suf_bases)).astype(np.int64)
        self.lut_counts += np.bincount(prefixes,
                                       minlength=len(self.lut_counts))
        self.total += len(kmers)
        rec = _build_records(kmers, counts, self.sufix_size,
                             self.suf_bases, self.cbytes)
        rec.tofile(self._suf)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._suf.write(_MARKER_SUF)
        self._suf.close()
        _write_pre_file(self.path, self.lut_counts, self.k, self.cbytes,
                        self.p, self.min_count, self.max_count, self.total)

    def abort(self) -> None:
        """Discard the partial database: delete the spooled .kmc_suf and
        never write .kmc_pre.  Call on a failed build so a truncated spool
        cannot be mistaken for a complete database (a reader would parse a
        finalized-but-short file as valid)."""
        if self._closed:
            return
        self._closed = True
        self._suf.close()
        for ext in (".kmc_suf", ".kmc_pre"):
            try:
                os.unlink(self.path + ext)
            except OSError:
                pass


def _build_records(kmers, counts, sufix_size: int, suf_bases: int,
                   cbytes: int) -> np.ndarray:
    """Suffix+counter record bytes in storage order (kmc_file.cpp:457-494:
    suffix bytes MSB-first base pairs, counter little-endian)."""
    total = len(kmers)
    rec = np.zeros((total, sufix_size + cbytes), dtype=np.uint8)
    suffix = kmers & ((_U64(1) << _U64(2 * suf_bases)) - _U64(1))
    for j in range(sufix_size):
        shift = _U64(8 * (sufix_size - 1 - j))
        rec[:, j] = ((suffix >> shift) & _U64(0xFF)).astype(np.uint8)
    for b in range(cbytes):
        rec[:, sufix_size + b] = ((counts >> _U64(8 * b)) & _U64(0xFF)).astype(np.uint8)
    return rec
