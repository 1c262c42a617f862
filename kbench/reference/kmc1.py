"""A plain reader of a KMC1 database (``<name>.kmc_pre`` and
``<name>.kmc_suf``, the format of KMC 1 and 2, kmc_file.cpp:180-515).

``.kmc_pre``: the marker ``KMCP``, one uint64 a prefix of ``lut_prefix_length``
bases (the index of its first record), the header (k and mode, counter size
and prefix length, min and max count, total k-mers, strand flag), the
version at 12 bytes from the end, the header's offset at 8, ``KMCP``.
``.kmc_suf``: ``KMCS``, then one record a k-mer in ascending order (its
suffix bases 4 a byte, the first base highest, then the counter, least
significant byte first), then ``KMCS``.  k up to 32.
"""

from __future__ import annotations

import numpy as np


def read(path: str) -> dict:
    """{"kmers": uint64, "counts": uint64, "k", "min_count", "max_count",
    "total"} of the database ``path``."""
    pre = np.fromfile(path + ".kmc_pre", dtype=np.uint8)
    if pre[:4].tobytes() != b"KMCP" or pre[-4:].tobytes() != b"KMCP":
        raise ValueError(f"{path}.kmc_pre: no KMCP markers")
    if int(pre[-12:-8].view("<u4")[0]) != 0:
        raise ValueError(f"{path}.kmc_pre: not a KMC1 database")
    start = 4 + (len(pre) - 12 - int(pre[-8]))
    hdr = pre[start : start + 40].view("<u8")
    k, mode = int(hdr[0] & 0xFFFFFFFF), int(hdr[0] >> 32)
    csize, p = int(hdr[1] & 0xFFFFFFFF), int(hdr[1] >> 32)
    min_count, max_count = int(hdr[2] & 0xFFFFFFFF), int(hdr[2] >> 32)
    total = int(hdr[3])
    if mode != 0 or k > 32:
        raise ValueError(f"{path}: mode {mode}, k {k} not read here")
    lut = pre[4 : 4 + 8 * (1 << (2 * p))].view("<u8")
    suf = np.fromfile(path + ".kmc_suf", dtype=np.uint8)
    if suf[:4].tobytes() != b"KMCS" or suf[-4:].tobytes() != b"KMCS":
        raise ValueError(f"{path}.kmc_suf: no KMCS markers")
    sbytes = (k - p) // 4
    rec = suf[4:-4].reshape(-1, sbytes + csize)
    if len(rec) != total:
        raise ValueError(f"{path}: {len(rec)} records, header says {total}")
    suffix = np.zeros(total, dtype=np.uint64)
    for j in range(sbytes):
        suffix = (suffix << np.uint64(8)) | rec[:, j].astype(np.uint64)
    counts = np.zeros(total, dtype=np.uint64)
    for b in range(csize):
        counts |= rec[:, sbytes + b].astype(np.uint64) << np.uint64(8 * b)
    bounds = np.append(lut, np.uint64(total))
    prefix = np.searchsorted(bounds, np.arange(total, dtype=np.uint64),
                             side="right") - 1
    kmers = (prefix.astype(np.uint64) << np.uint64(2 * (k - p))) | suffix
    return {"kmers": kmers, "counts": counts, "k": k, "min_count": min_count,
            "max_count": max_count, "total": total}
