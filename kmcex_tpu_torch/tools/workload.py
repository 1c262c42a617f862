"""Seeded workloads and the numpy oracle they are checked against.

Everything here needs numpy only and calls nothing else of the package, so
the oracle stays independent of the code it judges:

  * ``make_reads`` / ``write_fastq`` / ``make_fastq`` — the synthetic read
    generator of the repository's benchmark (150 bp reads drawn from a random
    genome, substitution errors, 0.05% N; records ``@r<i>``).  The same seed
    gives the same bytes as that generator: the random draws are made in its
    order, block of rows by block of rows, the arithmetic around them is
    done in place, and the file is written from byte matrices, not line by
    line.
  * ``oracle_counts`` — the canonical k-mer of every fully-ACGT window of
    every read, counted with ``np.unique`` partition by partition of the key
    range, so that no sort ever holds more than one partition.
  * ``serving_queries`` — the benchmark's query mix.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

READ_LEN = 150
_ROWS = 1 << 16  # rows per step of the generator and of the file writer


def _row_blocks(n: int):
    for a in range(0, n, _ROWS):
        yield slice(a, min(n, a + _ROWS))


def make_reads(genome_len: int, n_reads: int, seed: int,
               err_rate: float) -> np.ndarray:
    """The generator's reads as ASCII, [n_reads, 150] uint8.  Each of the
    generator's three full-size draws is made in blocks of rows, one after
    the other, which leaves the random stream as it is and keeps the
    temporaries small."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - READ_LEN, size=n_reads)
    shape = (n_reads, READ_LEN)
    reads = np.empty(shape, dtype=np.uint8)
    for rows in _row_blocks(n_reads):
        reads[rows] = genome[starts[rows, None] + np.arange(READ_LEN)[None, :]]
    # sequencing errors + rare Ns (0.05%)
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
        blk[rng.random(blk.shape) < 0.0005] = ord("N")
    return ascii_reads


def write_fastq(path: str | os.PathLike, ascii_reads: np.ndarray) -> None:
    """Four-line records ``@r<i>`` / read / ``+`` / quality ``I``.  Records
    whose number has the same count of digits are equally long, so each such
    group is written as one byte matrix."""
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


def make_fastq(path: str | os.PathLike, genome_len: int, n_reads: int,
               seed: int, err_rate: float = 0.002) -> np.ndarray:
    """Write the generator's FASTQ; returns the reads it wrote."""
    ascii_reads = make_reads(genome_len, n_reads, seed, err_rate)
    write_fastq(path, ascii_reads)
    return ascii_reads


_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def canonical_windows(ascii_block: np.ndarray, k: int) -> np.ndarray:
    """The canonical k-mers (uint64, 2 bits a base, first base highest) of
    the fully-ACGT k-windows of a block of equally long reads, flat, in no
    particular order.  Forward and reverse-complement words of 1, 2, 4, ...
    bases are built by doubling and joined along the binary digits of k."""
    if not 1 <= k <= 32:
        raise ValueError(f"k must be 1..32, got {k}")
    n, length = ascii_block.shape
    n_win = length - k + 1
    if n == 0 or n_win <= 0:
        return np.zeros(0, dtype=np.uint64)
    codes = _CODE[ascii_block]
    bad = codes > 3
    c = np.where(bad, 0, codes).astype(np.uint64)
    fwd = rc = None
    have = 0                      # bases joined so far
    f_m, r_m, m = c, np.uint64(3) - c, 1
    while m <= k:
        if k & m:
            if fwd is None:
                fwd, rc = f_m, r_m
            else:
                w = length - (have + m) + 1
                fwd = (fwd[:, :w] << np.uint64(2 * m)) | f_m[:, have : have + w]
                rc = rc[:, :w] | (r_m[:, have : have + w] << np.uint64(2 * have))
            have += m
        if 2 * m <= k:
            w = length - 2 * m + 1
            f_m = (f_m[:, :w] << np.uint64(2 * m)) | f_m[:, m : m + w]
            r_m = r_m[:, :w] | (r_m[:, m : m + w] << np.uint64(2 * m))
        m *= 2
    n_bad = np.concatenate([np.zeros((n, 1), np.int32),
                            np.cumsum(bad, axis=1, dtype=np.int32)], axis=1)
    ok = (n_bad[:, k:] - n_bad[:, :-k]) == 0
    return np.minimum(fwd, rc)[ok]


def oracle_counts(ascii_reads: np.ndarray, k: int, part_bits: int = 6,
                  block_reads: int = 20000, workers: int = 4):
    """Independent numpy count of a read matrix ([n, L] uint8 ASCII; a base
    outside ACGT voids its windows, a read shorter than k has none): (uint64
    canonical k-mers ascending, int64 counts).

    The windows are computed once, block by block, and dealt into
    ``2**part_bits`` partitions by the top bits of the k-mer; each partition
    is then counted with ``np.unique`` on its own and the results are joined
    in partition order, which is key order.  Memory: 8 bytes a window, held
    once, plus the sort of ``workers`` partitions at a time."""
    part_bits = min(part_bits, 8, 2 * k)
    n_parts = 1 << part_bits
    shift = np.uint64(2 * k - part_bits)
    parts: list[list[np.ndarray]] = [[] for _ in range(n_parts)]

    def deal_block(a: int):
        v = canonical_windows(ascii_reads[a : a + block_reads], k)
        pid = (v >> shift).astype(np.uint8)
        v = v[np.argsort(pid, kind="stable")]
        ends = np.cumsum(np.bincount(pid, minlength=n_parts))
        return np.split(v, ends[:-1])

    def count_part(p: int):
        pieces, parts[p] = parts[p], []
        if not pieces:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        return np.unique(np.concatenate(pieces), return_counts=True)

    # numpy releases the interpreter lock in these loops, so threads help
    with concurrent.futures.ThreadPoolExecutor(max(1, workers)) as pool:
        for dealt in pool.map(deal_block,
                              range(0, len(ascii_reads), block_reads)):
            for p, piece in enumerate(dealt):
                if len(piece):
                    parts[p].append(piece)
        done = list(pool.map(count_part, range(n_parts)))
    return (np.concatenate([u for u, _ in done]),
            np.concatenate([c for _, c in done]))


def serving_queries(kmers: np.ndarray, nq: int = 1_000_000) -> np.ndarray:
    """The benchmark's query mix: half drawn from the counted k-mers, half
    random 62-bit values, shuffled (seed 0)."""
    rng = np.random.default_rng(0)
    q = np.concatenate([rng.choice(kmers, nq // 2),
                        rng.integers(0, 1 << 62, nq // 2, dtype=np.uint64)])
    rng.shuffle(q)
    return q
