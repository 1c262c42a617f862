"""The benchmark's read generator: a frozen copy of the repository's seeded
generator (``kmcex_tpu_torch/tools/workload.py``: ``make_reads`` and
``write_fastq``), with the read length and the N rate as parameters.

At ``read_len=150`` and ``n_rate=0.0005`` the same seed gives the same bytes
as that generator (a test holds the two together).  ``stream`` > 0 draws a
fresh read set of the SAME genome: the genome is the first draw of the
seed's stream, and the reads then come from the stream ``[seed, stream]``.

numpy only; nothing here imports the program.
"""

from __future__ import annotations

import os

import numpy as np

_ROWS = 1 << 16  # rows per step of the generator and of the file writer


def _row_blocks(n: int):
    for a in range(0, n, _ROWS):
        yield slice(a, min(n, a + _ROWS))


def rng_seed(seed: int) -> int:
    """Any whole number as a non-negative seed for numpy's generator."""
    return int(seed) % (1 << 64)


def make_reads(genome_len: int, n_reads: int, seed: int, err_rate: float,
               read_len: int = 150, n_rate: float = 0.0005,
               stream: int = 0) -> np.ndarray:
    """Reads as ASCII, [n_reads, read_len] uint8: uniform random genome,
    uniform read starts, substitutions at ``err_rate`` and N at
    ``n_rate``."""
    rng = np.random.default_rng(rng_seed(seed))
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    if stream:
        rng = np.random.default_rng([rng_seed(seed), int(stream)])
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    shape = (n_reads, read_len)
    reads = np.empty(shape, dtype=np.uint8)
    for rows in _row_blocks(n_reads):
        reads[rows] = genome[starts[rows, None] + np.arange(read_len)[None, :]]
    err = np.empty(shape, dtype=bool)
    for rows in _row_blocks(n_reads):
        err[rows] = rng.random(reads[rows].shape) < err_rate
    for rows in _row_blocks(n_reads):
        blk, e = reads[rows], err[rows]
        sub = rng.integers(1, 4, size=blk.shape)
        blk[e] = (blk[e] + sub[e].astype(np.uint8)) % 4
    del err
    acgt = np.frombuffer(b"ACGTN", dtype=np.uint8)
    ascii_reads = acgt[reads]
    for rows in _row_blocks(n_reads):
        blk = ascii_reads[rows]
        blk[rng.random(blk.shape) < n_rate] = ord("N")
    return ascii_reads


def write_fastq(path: str | os.PathLike, ascii_reads: np.ndarray) -> None:
    """Four-line records ``@r<i>`` / read / ``+`` / quality ``I``, written
    as byte matrices, one per count of digits of the record number."""
    n, length = ascii_reads.shape
    with open(path, "wb") as f:
        lo = 0
        while lo < n:
            digits = len(str(lo))
            hi = min(n, 10 ** digits)
            seq0 = 2 + digits + 1            # "@r", the number, "\n"
            qual0 = seq0 + length + 3        # the read, "\n+\n"
            for a in range(lo, hi, _ROWS):
                b = min(hi, a + _ROWS)
                rec = np.empty((b - a, qual0 + length + 1), dtype=np.uint8)
                rec[:, 0] = ord("@")
                rec[:, 1] = ord("r")
                ids = np.arange(a, b)
                for j in range(digits):
                    rec[:, 2 + j] = ord("0") + ids // 10 ** (digits - 1 - j) % 10
                rec[:, seq0 - 1] = ord("\n")
                rec[:, seq0 : seq0 + length] = ascii_reads[a:b]
                rec[:, seq0 + length : qual0] = np.frombuffer(b"\n+\n", np.uint8)
                rec[:, qual0 : qual0 + length] = ord("I")
                rec[:, -1] = ord("\n")
                f.write(rec.tobytes())
            lo = hi


_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def forward_kmers(ascii_reads: np.ndarray, k: int) -> np.ndarray:
    """The forward k-mers (uint64, 2 bits a base, first base highest) of
    every fully-ACGT window of the reads, read by read, window by window:
    what an annotation client sends."""
    if not 1 <= k <= 32:
        raise ValueError(f"k must be 1..32, got {k}")
    n, length = ascii_reads.shape
    w = length - k + 1
    if n == 0 or w <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = []
    for rows in _row_blocks(n):
        codes = _CODE[ascii_reads[rows]]
        bad = codes > 3
        c = np.where(bad, 0, codes).astype(np.uint64)
        v = np.zeros((len(c), w), dtype=np.uint64)
        for t in range(k):
            v = (v << np.uint64(2)) | c[:, t : t + w]
        n_bad = np.concatenate([np.zeros((len(c), 1), np.int32),
                                np.cumsum(bad, axis=1, dtype=np.int32)], axis=1)
        out.append(v[(n_bad[:, k:] - n_bad[:, :-k]) == 0])
    return np.concatenate(out)
