"""Byte-range record-boundary splitting in the port (io.fastq
split_byte_ranges + SegmentStream(byte_range=...), the multi-process input
split): the six cases of tests/test_byte_ranges.py against the port, and the
port's ranges and batches against the JAX module's on the same files.
Host code on bytes and integers: every comparison is exact."""

import gzip
import inspect
from collections import Counter

import numpy as np
import pytest

from kmcex_tpu.io import fastq as jfastq
from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.io import fastq
from tests.test_byte_ranges import _write_fastq


def _count_stream(path, k, byte_range=None, seg_len=64):
    """reads + canonical k-mer Counter via the port's numpy segment path."""
    st = fastq.SegmentStream(path, k, seg_len, 64, use_native=False,
                             byte_range=byte_range)
    cnt: Counter = Counter()
    for codes in st:
        for row in codes:
            for s in range(len(row) - k + 1):
                win = row[s : s + k]
                if (win < 4).all():
                    v = 0
                    for b in win:
                        v = (v << 2) | int(b)
                    cnt[int(codec.canonical_np(np.array([v], np.uint64), k)[0])] += 1
    return st.reads, cnt


def _assert_same_batches(bg, bw):
    """Batches are arrays, or (packed, maskbits) tuples."""
    assert len(bg) == len(bw)
    for a, b in zip(bg, bw):
        if isinstance(a, tuple):
            assert isinstance(b, tuple) and len(a) == len(b) == 2
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def _write_fasta(path, seed=11, n=60, wrap=None):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            L = int(rng.integers(30, 200))
            seq = acgt[rng.integers(0, 4, L)].tobytes()
            f.write(b">seq%d\n" % i)
            if wrap:
                for a in range(0, L, wrap):
                    f.write(seq[a : a + wrap] + b"\n")
            else:
                f.write(seq + b"\n")


def test_split_ranges_cover_and_align(tmp_path):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq)
    data = fq.read_bytes()
    for n_parts in (1, 2, 3, 5, 8):
        ranges = fastq.split_byte_ranges(str(fq), n_parts)
        assert ranges == jfastq.split_byte_ranges(str(fq), n_parts)
        assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c
        for a, b in ranges[1:]:
            if a < len(data):  # every non-degenerate start is a record header
                assert data[a - 1 : a] == b"\n"
                assert data[a : a + 1] == b"@"
                # and scans as a real header: two lines later is '+'
                j1 = data.find(b"\n", a)
                j2 = data.find(b"\n", j1 + 1)
                assert data[j2 + 1 : j2 + 2] == b"+"


def test_range_streams_equal_whole_file(tmp_path):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=300, seed=7)
    k = 9
    want_reads, want = _count_stream(str(fq), k)
    for n_parts in (2, 3, 4):
        ranges = fastq.split_byte_ranges(str(fq), n_parts)
        reads = 0
        got: Counter = Counter()
        for r in ranges:
            nr, c = _count_stream(str(fq), k, byte_range=r)
            reads += nr
            got.update(c)
        assert reads == want_reads
        assert got == want


def test_range_stream_native_matches_numpy(tmp_path):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=200, seed=3)
    k = 9
    for r in fastq.split_byte_ranges(str(fq), 3):
        st_n = fastq.SegmentStream(str(fq), k, 64, 1 << 12, use_native=True,
                                   byte_range=r)
        st_p = fastq.SegmentStream(str(fq), k, 64, 1 << 12, use_native=False,
                                   byte_range=r)
        bn = list(st_n)
        bp = list(st_p)
        assert st_n.reads == st_p.reads
        assert len(bn) == len(bp)
        for a, b in zip(bn, bp):
            np.testing.assert_array_equal(a, b)


def test_fasta_ranges(tmp_path):
    fa = tmp_path / "r.fasta"
    _write_fasta(fa)
    data = fa.read_bytes()
    k = 11
    want_reads, want = _count_stream(str(fa), k)
    ranges = fastq.split_byte_ranges(str(fa), 4)
    assert ranges == jfastq.split_byte_ranges(str(fa), 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
    reads = 0
    got: Counter = Counter()
    for a, b in ranges:
        if 0 < a < len(data):
            assert data[a : a + 1] == b">"
        nr, c = _count_stream(str(fa), k, byte_range=(a, b))
        reads += nr
        got.update(c)
    assert reads == want_reads
    assert got == want


def test_gzip_rejected(tmp_path):
    gz = tmp_path / "r.fastq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b"@r0\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
    with pytest.raises(ValueError):
        fastq.split_byte_ranges(str(gz), 2)
    with pytest.raises(ValueError):
        list(fastq.SegmentStream(str(gz), 9, 64, 64, byte_range=(0, 10)))


def test_more_parts_than_records(tmp_path):
    fq = tmp_path / "tiny.fastq"
    _write_fastq(fq, n_reads=2, tricky_quals=False)
    ranges = fastq.split_byte_ranges(str(fq), 8)
    assert ranges == jfastq.split_byte_ranges(str(fq), 8)
    size = fq.stat().st_size
    assert ranges[0][0] == 0 and ranges[-1][1] == size
    k = 9
    want_reads, want = _count_stream(str(fq), k)
    reads = 0
    got: Counter = Counter()
    for r in ranges:
        nr, c = _count_stream(str(fq), k, byte_range=r)
        reads += nr
        got.update(c)
    assert reads == want_reads == 2
    assert got == want


def test_segment_stream_signature_is_the_reference(tmp_path):
    """Same positional order and defaults in both packages, shown by calling
    both the same way, all seven arguments by position."""
    assert (list(inspect.signature(fastq.SegmentStream).parameters)
            == list(inspect.signature(jfastq.SegmentStream).parameters))
    assert (fastq.SegmentStream.__init__.__defaults__
            == jfastq.SegmentStream.__init__.__defaults__)
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=120, seed=5)
    r = fastq.split_byte_ranges(str(fq), 2)[1]
    for args in ((str(fq), 9), (str(fq), 9, 64, 32, True, True, r),
                 (str(fq), 9, 64, 32, False, False, r)):
        got, want = fastq.SegmentStream(*args), jfastq.SegmentStream(*args)
        bg, bw = list(got), list(want)
        assert (got.reads, got.bases) == (want.reads, want.bases)
        assert len(bg) > 0
        _assert_same_batches(bg, bw)


@pytest.mark.parametrize("kind,packed,use_native", [
    ("fastq", False, True), ("fastq", True, True), ("fastq", True, False),
    ("fasta", False, True), ("fasta_wrapped", True, True),
    ("fasta_wrapped", False, False)])
def test_range_batches_equal_jax(tmp_path, kind, packed, use_native):
    """Every range's batches, reads and bases equal the JAX module's, in
    both transfer formats and through both segmenters."""
    path = tmp_path / f"r.{kind}"
    if kind == "fastq":
        _write_fastq(path, n_reads=250, seed=21)
    else:
        _write_fasta(path, seed=4, wrap=60 if kind == "fasta_wrapped" else None)
    k = 11
    ranges = fastq.split_byte_ranges(str(path), 3)
    assert ranges == jfastq.split_byte_ranges(str(path), 3)
    for r in ranges:
        got = fastq.SegmentStream(str(path), k, 64, 48, use_native, packed, r)
        want = jfastq.SegmentStream(str(path), k, 64, 48, use_native, packed, r)
        bg, bw = list(got), list(want)
        assert (got.reads, got.bases) == (want.reads, want.bases)
        _assert_same_batches(bg, bw)


def test_record_start_survives_at_sign_quality_lines(tmp_path):
    """A quality line that begins with '@' is not a header: from every byte
    offset of a small file the scanner returns what the JAX one returns,
    and that is always a true record start (or the file's size)."""
    fq = tmp_path / "q.fastq"
    _write_fastq(fq, n_reads=12, seed=2)
    data = fq.read_bytes()
    starts, pos = set(), 0
    while pos < len(data):  # true record starts, by walking four lines
        starts.add(pos)
        for _ in range(4):
            pos = data.find(b"\n", pos) + 1
    with open(fq, "rb") as f, open(fq, "rb") as g:
        for off in range(len(data) + 1):
            got = fastq._record_start_at_or_after(f, off, len(data), False)
            assert got == jfastq._record_start_at_or_after(
                g, off, len(data), False)
            assert got == len(data) or got in starts
            assert got >= off
