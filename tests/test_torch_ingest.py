"""The port's FASTQ ingest on any thread count: the native segmenter's two
passes (line index, then row fill, over slices of the window) against the
serial loop it replaces (the JAX package's ``SegmentStream``, batch for
batch), against one thread, and against the NumPy segmenter, through
``SegmentStream`` from a mapped file, a gzip stream and an ``@list``; one
segmenter call against the JAX package's serial loop (rows, bytes consumed,
reads, bases, phase); the ``ingest.parallel_bases`` counter.  Host code on
bytes and integers: every comparison is exact."""

import gzip

import numpy as np
import pytest

from kmcex_tpu import native as jnative
from kmcex_tpu.io import fastq as jfastq
from kmcex_tpu_torch import native
from kmcex_tpu_torch.count.pipeline import count_encode
from kmcex_tpu_torch.io import fastq

THREADS = (1, 2, 3, 8)


@pytest.fixture()
def threads():
    """``native.set_num_threads`` for the test; the previous count after."""
    prev = native._n_threads_override
    yield native.set_num_threads
    native.set_num_threads(prev)


def _fastq_bytes(seed, n, lens=(40, 120), crlf=False, n_rate=0.0,
                 lower=0.0, at_quals=False):
    """``n`` four-line records with read lengths uniform in ``lens``."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    nl = b"\r\n" if crlf else b"\n"
    out = []
    for i, L in enumerate(rng.integers(lens[0], lens[1] + 1, n)):
        seq = acgt[rng.integers(0, 4, L)]
        if n_rate:
            seq[rng.random(L) < n_rate] = ord("N")
        if lower:
            seq[rng.random(L) < lower] |= 0x20
        q0 = b"@" if at_quals and i % 3 == 0 else b"I"
        qual = (q0 + b"I" * L)[:L]
        out.append(b"@r%d desc%s%s%s+%s%s%s" % (
            i, nl, seq.tobytes(), nl, nl, qual, nl))
    return b"".join(out)


# name -> (records, k, seg_len, batch_segs); every input spans several
# batches, and most windows are wide enough to split over the threads
CASES = {
    "crlf": (dict(seed=1, n=9000, crlf=True), 21, 64, 1500),
    "n_and_lowercase": (dict(seed=2, n=9000, n_rate=0.03, lower=0.3), 21, 64,
                        1500),
    "long_and_short_reads": (dict(seed=3, n=5000, lens=(0, 400)), 31, 64,
                             2000),
    "no_final_newline": (dict(seed=4, n=9000), 25, 64, 1500),
    "at_sign_qualities": (dict(seed=5, n=9000, at_quals=True), 21, 64, 1500),
    "batch_cut_mid_window": (dict(seed=6, n=9000), 21, 64, 701),
    "two_file_list": (dict(seed=7, n=5000), 21, 64, 1500),
    "byte_range_windows": (dict(seed=8, n=12000, at_quals=True), 21, 64,
                           1500),
    "gzip": (dict(seed=9, n=9000, crlf=True), 21, 64, 1500),
}


def _drain(stream):
    batches = [tuple(b.copy() for b in x) if isinstance(x, tuple)
               else x.copy() for x in stream]
    return batches, stream.reads, stream.bases


def _assert_same(got, want):
    bg, rg, sg = got
    bw, rw, sw = want
    assert (rg, sg) == (rw, sw)
    assert len(bg) == len(bw)
    for a, b in zip(bg, bw):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def _rows(batches):
    """The rows of a stream in order, those without a base dropped: the
    NumPy segmenter cuts a batch inside a read of several rows, where the
    native one ends the batch before the read (padding rows)."""
    if isinstance(batches[0], tuple):
        p = np.concatenate([b[0] for b in batches])
        m = np.concatenate([b[1] for b in batches])
        keep = (p != 0).any(1) | (m != 0).any(1)
        return p[keep], m[keep]
    c = np.concatenate(batches)
    return (c[(c != 255).any(1)],)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """The case's input files, windows and the NumPy segmenter's batches
    (packed and not) of each window."""
    name = request.param
    recs, k, seg_len, batch = CASES[name]
    d = tmp_path_factory.mktemp(name)
    data = _fastq_bytes(**recs)
    spec, windows = str(d / "r.fastq"), [None]
    if name == "no_final_newline":
        data = data.rstrip(b"\n")
    if name == "gzip":
        spec = str(d / "r.fastq.gz")
        with gzip.open(spec, "wb") as f:
            f.write(data)
    elif name == "two_file_list":
        (d / "a.fastq").write_bytes(data)
        (d / "b.fastq").write_bytes(_fastq_bytes(seed=70, n=4000, lens=(20,
                                                                       90)))
        spec = str(d / "inputs.txt")
        (d / "inputs.txt").write_text(f"{d / 'a.fastq'}\n{d / 'b.fastq'}\n")
        spec = "@" + spec
    else:
        (d / "r.fastq").write_bytes(data)
    if name == "byte_range_windows":
        windows = fastq.split_byte_ranges(spec, 3)
        assert len(set(windows)) == 3
    serial, numpy_ = {}, {}
    for w in windows:
        for packed in (True, False):
            serial[w, packed] = _drain(jfastq.SegmentStream(
                spec, k, seg_len, batch, True, packed, w))
            numpy_[w, packed] = _drain(fastq.SegmentStream(
                spec, k, seg_len, batch, False, packed, w))
    return dict(name=name, spec=spec, k=k, seg_len=seg_len, batch=batch,
                windows=windows, serial=serial, numpy=numpy_)


@pytest.mark.parametrize("n_threads", THREADS)
def test_batches_equal_numpy_and_one_thread(case, n_threads, threads,
                                            monkeypatch):
    """Packed and unpacked batches, reads and bases of every window equal
    the serial loop's and those at one thread; the rows, reads and bases
    equal the NumPy segmenter's.  A gzip stream is read in small pieces, so
    lines and batches straddle the reads."""
    if case["name"] == "gzip":
        monkeypatch.setattr(fastq, "_READ_BYTES", 1 << 18)
    args = (case["spec"], case["k"], case["seg_len"], case["batch"], True)
    parallel = 0
    for w in case["windows"]:
        for packed in (True, False):
            threads(n_threads)
            st = fastq.SegmentStream(*args, packed, w)
            got = _drain(st)
            parallel += st.parallel_bases
            _assert_same(got, case["serial"][w, packed])
            bn, rn, sn = case["numpy"][w, packed]
            assert (got[1], got[2]) == (rn, sn)
            for x, y in zip(_rows(got[0]), _rows(bn)):
                np.testing.assert_array_equal(x, y)
            threads(1)
            _assert_same(got, _drain(fastq.SegmentStream(*args, packed, w)))
    assert parallel > 0 if n_threads > 1 else parallel == 0


def _window(rng):
    """Random FASTQ-ish bytes: records of any length, CRLF or not, cut at a
    random byte (an incomplete last line)."""
    recs = []
    for i in range(int(rng.integers(0, 1500))):
        L = max(0, int(rng.choice([3, 10, 30, 64, 100, 300])
                       + rng.integers(-3, 4)))
        seq = rng.choice(list(b"ACGTacgtNnX"), size=L).astype(np.uint8)
        nl = b"\r\n" if rng.random() < 0.2 else b"\n"
        recs.append(b"@r%d%s%s%s+%s%s%s" % (i, nl, seq.tobytes(), nl, nl,
                                            b"@" * L, nl))
    data = b"".join(recs)
    return np.frombuffer(data[: int(rng.integers(0, len(data) + 1))],
                         dtype=np.uint8)


@pytest.mark.parametrize("n_threads", THREADS)
def test_segment_call_equals_serial_loop(n_threads):
    """One call: the JAX package's serial segmenter gives the same rows,
    bytes consumed, reads, bases and phase, at any row capacity and phase,
    FASTQ or FASTA lines; the rows past the last written stay untouched."""
    rng = np.random.default_rng(40 + n_threads)
    for _ in range(40):
        data = _window(rng)
        k = int(rng.choice([5, 21, 31]))
        seg_len = int(rng.choice([40, 64, 104]))
        cap = int(rng.integers(0, 400))
        phase, fasta = int(rng.integers(0, 4)), bool(rng.random() < 0.2)
        for packed in (True, False):
            if packed:
                want = [np.zeros((cap, seg_len // 4), np.uint8),
                        np.zeros((cap, seg_len // 8), np.uint8)]
                res = jnative.segment_buffer_packed(data, fasta, phase, k,
                                                    seg_len, *want)
            else:
                want = [np.full((cap, seg_len), 255, np.uint8)]
                res = jnative.segment_buffer(data, fasta, phase, k, seg_len,
                                             *want)
            got = [np.full_like(w, 0xA5) for w in want]
            r = native.segment(data, fasta, phase, k, seg_len, *got,
                               n_threads=n_threads)
            assert tuple(r[:5]) == tuple(res)
            assert r.parallel_bases in (0, r.bases)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[: r.rows], w[: r.rows])
                assert (g[r.rows:] == 0xA5).all()


@pytest.mark.parametrize("n_threads,share", [(4, 1), (1, 0)])
def test_parallel_bases_counter(tmp_path, threads, n_threads, share):
    """On an input wide enough to split, every base is segmented by a
    multi-threaded pass at -t 4, none at -t 1."""
    fq = tmp_path / "r.fastq"
    fq.write_bytes(_fastq_bytes(seed=12, n=2500, lens=(60, 60)))
    threads(n_threads)
    _, _, _, stats = count_encode(str(fq), 21, keep_pairs=False,
                                  device="cpu")
    c = stats.counters
    assert c["ingest.bases"] == 2500 * 60
    assert c["ingest.parallel_bases"] == share * c["ingest.bases"]


@pytest.mark.parametrize("seg_len,shapes", [
    (64, [(8, 16), (8, 4)]),      # mask rows of another width
    (64, [(8, 16), (7, 8)]),      # fewer mask rows than packed rows
    (60, [(8, 15), (8, 7)]),      # packed rows need seg_len % 8 == 0
    (16, [(8, 4), (8, 2)]),       # seg_len under k
    (64, [(8, 63)]),              # unpacked rows of another width
])
def test_segment_refuses_buffers_that_do_not_fit(seg_len, shapes):
    data = np.frombuffer(_fastq_bytes(seed=1, n=4), dtype=np.uint8)
    bufs = [np.zeros(s, np.uint8) for s in shapes]
    with pytest.raises(ValueError, match="do not hold rows"):
        native.segment(data, False, 0, 21, seg_len, *bufs)
