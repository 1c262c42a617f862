"""The port's read annotation (query/annotate.py) on the CPU against the JAX
package's: the cases of tests/test_annotate.py and the k > 32 annotation of
tests/test_multiword.py, and count_fastq against brute force as in
tests/test_count.py, on the same numpy-seeded inputs.  Integer counters:
every comparison is exact (tolerance 0)."""

import gzip
from collections import Counter

import numpy as np
import pytest

from kmcex_tpu.core import codec as jcodec
from kmcex_tpu.core import codec_mw as jmw
from kmcex_tpu.count.pipeline import count_fastq as jcount_fastq
from kmcex_tpu.io import kmc_db as jdb
from kmcex_tpu.model.kmodel import get_model as jget_model
from kmcex_tpu.query import annotate as jann
from kmcex_tpu_torch.count.pipeline import count_fastq as tcount_fastq
from kmcex_tpu_torch.io import kmc_db as tdb
from kmcex_tpu_torch.model.kmodel import get_model as tget_model
from kmcex_tpu_torch.query import annotate as tann
from kmcex_tpu_torch.query.device_model import DeviceKModel

COMP = str.maketrans("ACGT", "TGCA")


def rc_str(s: str) -> str:
    return s.translate(COMP)[::-1]


def _canon_int(w, k):
    return int(jcodec.canonical_np(np.uint64(jcodec.string_to_u64(w)), k))


def _reads(seed, n, L, genome_len=3000):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    return [genome[s : s + L]
            for s in rng.integers(0, genome_len - L, n).tolist()]


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [15, 31, 32])
@pytest.mark.parametrize("canonical", [True, False])
def test_extract_windows_np_equals_jax(k, canonical):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (20, 70)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 255
    gk, gv = tann.extract_windows_np(codes, k, canonical)
    wk, wv = jann.extract_windows_np(codes, k, canonical)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gk, wk)
    assert tann.extract_windows_np(codes[:, : k - 1], k)[0].shape == (20, 0)


@pytest.mark.parametrize("k", [33, 41, 64, 70])
def test_extract_windows_mw_equals_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (10, 110)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 255
    gk, gv = tann.extract_windows_mw(codes, k)
    wk, wv = jann.extract_windows_mw(codes, k)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gk, wk)


@pytest.mark.parametrize("db_from", ["jax", "torch"])
def test_annotate_with_db(tmp_path, db_from):
    """tests/test_annotate.py::test_annotate_with_db; the database comes
    from either package, the annotation from both."""
    k = 15
    reads = _reads(0, 30, 80)
    reads[5] = reads[5][:20] + "N" + reads[5][21:]  # invalid base in one read
    reads[7] = reads[7][:50]                        # ragged lengths
    c = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if "N" not in w:
                c[_canon_int(w, k)] += 1
    kmers = np.array(sorted(c), dtype=np.uint64)
    counts = np.array([c[int(x)] for x in kmers], dtype=np.uint64)
    db = str(tmp_path / "db")
    {"jax": jdb, "torch": tdb}[db_from].write_kmc1(db, kmers, counts, k)
    out = tann.annotate_with_db(tdb.KMCReader(db), reads)
    _same_rows(out, jann.annotate_with_db(jdb.KMCReader(db), reads))
    for r, row in zip(reads, out):
        assert len(row) == len(r) - k + 1
        for i, cnt in enumerate(row):
            w = r[i : i + k]
            assert cnt == (0 if "N" in w else c[_canon_int(w, k)])
    # a code matrix instead of strings
    codes = np.full((len(reads), 80), 255, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = jcodec.encode_bases(
            np.frombuffer(r.encode(), np.uint8))
    _same_rows(tann.annotate_with_db(tdb.KMCReader(db), codes),
               jann.annotate_with_db(jdb.KMCReader(db), codes))


def test_annotate_with_model_host_and_device():
    """tests/test_annotate.py::test_annotate_with_model, on the host model
    and on DeviceKModel (the same tensor code on the CPU), against the JAX
    package's host model built from the same pairs."""
    rng = np.random.default_rng(1)
    k = 21
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(jcodec.canonical_np(
        rng.integers(0, 1 << 62, size=30000, dtype=np.uint64) & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), 1, 1023).astype(np.uint32)
    km = tget_model(1, 1023, 7, 4)
    km.init_from_pairs(can, counts, k)
    jkm = jget_model(1, 1023, 7, 4)
    jkm.init_from_pairs(can, counts, k)

    reads = [jcodec.u64_to_string(int(can[10]), k) + "ACGT",
             jcodec.u64_to_string(int(can[99]), k)[:12] + "N"
             + jcodec.u64_to_string(int(can[500]), k) + "TT"]
    out = tann.annotate_with_model(km, reads)
    assert len(out) == 2 and len(out[0]) == 5
    assert out[0][0] == km.kmer_to_occ(jcodec.u64_to_string(int(can[10]), k))
    assert (out[1][:13] == 0).all()  # windows over the N
    _same_rows(out, jann.annotate_with_model(jkm, reads))
    _same_rows(tann.annotate_with_model(DeviceKModel(km, device="cpu"), reads),
               out)


def test_annotate_single_strand_db(tmp_path):
    """tests/test_annotate.py::test_annotate_single_strand_db."""
    k = 15
    rng = np.random.default_rng(11)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    kmers = np.unique(rng.integers(0, 1 << (2 * k), 4000, dtype=np.uint64) & mask)
    counts = rng.integers(1, 100, len(kmers), dtype=np.uint64)
    db = str(tmp_path / "ss")
    tdb.write_kmc1(db, kmers, counts, k, both_strands=False)
    r = tdb.KMCReader(db)
    assert not r.both_strands and not jdb.KMCReader(db).both_strands
    read = jcodec.u64_to_string(int(kmers[10]), k) + "A"
    (got,) = tann.annotate_with_db(r, [read])
    assert got[0] == counts[10]
    (want,) = jann.annotate_with_db(jdb.KMCReader(db), [read])
    np.testing.assert_array_equal(got, want)
    rc = jcodec.revcomp_np(np.array([kmers[10]], np.uint64), k)[0]
    if rc != kmers[10] and rc not in set(kmers.tolist()):
        (got_rc,) = tann.annotate_with_db(r, [jcodec.u64_to_string(int(rc), k)])
        assert got_rc[0] == 0


def test_annotate_quake_db_gives_float_rows(tmp_path):
    k = 15
    reads = _reads(3, 5, 40)
    c = Counter(_canon_int(r[i : i + k], k)
                for r in reads for i in range(len(r) - k + 1))
    kmers = np.array(sorted(c), dtype=np.uint64)
    fcounts = np.array([c[int(x)] + 0.5 for x in kmers], dtype=np.float32)
    db = str(tmp_path / "q")
    tdb.write_kmc1(db, kmers, fcounts, k, mode=1)
    out = tann.annotate_with_db(tdb.KMCReader(db), reads)
    assert out[0].dtype == np.float32
    _same_rows(out, jann.annotate_with_db(jdb.KMCReader(db), reads))
    assert out[0][0] == c[_canon_int(reads[0][:k], k)] + 0.5


@pytest.mark.parametrize("db_from", ["jax", "torch"])
def test_annotate_with_db_k_gt_32(tmp_path, db_from):
    """tests/test_multiword.py::test_annotate_with_db_k_gt_32."""
    k = 41
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 600))
    reads = [genome[i : i + 120] for i in range(0, 400, 37)]
    cnt = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            cnt[min(w, rc_str(w))] += 1
    strs = sorted(cnt)
    v = jmw.strings_to_mw(strs, k)
    counts = np.array([cnt[s] for s in strs], np.uint32)
    db = str(tmp_path / "ann")
    {"jax": jdb, "torch": tdb}[db_from].write_kmc1(db, v, counts, k)
    rd = tdb.KMCReader(db)
    out = tann.annotate_with_db(rd, reads)
    _same_rows(out, jann.annotate_with_db(jdb.KMCReader(db), reads))
    for r, row in zip(reads, out):
        exp = [cnt[min(r[i : i + k], rc_str(r[i : i + k]))]
               for i in range(len(r) - k + 1)]
        assert row.tolist() == exp
    nread = reads[0][:20] + "N" + reads[0][21:]
    row = tann.annotate_with_db(rd, [nread])[0]
    for i in range(len(nread) - k + 1):
        w = nread[i : i + k]
        assert row[i] == (0 if "N" in w else cnt[min(w, rc_str(w))])


# ---------------------------------------------- count_fastq (test_count.py)
def _brute(reads, k):
    c = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if set(w) <= set("ACGT"):
                c[_canon_int(w, k)] += 1
    return c


def _write_fastq(path, reads, opener=open):
    with opener(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _check(args, kw, want):
    kmers, counts, stats = tcount_fastq(*args, device="cpu", **kw)
    jk, jc, jstats = jcount_fastq(*args, **kw)
    np.testing.assert_array_equal(kmers, jk)
    np.testing.assert_array_equal(counts, jc)
    assert (stats.reads, stats.bases, stats.windows) == \
        (jstats.reads, jstats.bases, jstats.windows)
    assert dict(zip(kmers.tolist(), counts.tolist())) == want
    assert np.all(kmers[1:] > kmers[:-1])
    return stats


@pytest.mark.parametrize("accumulator", ["device", "host"])
def test_counts_vs_bruteforce(tmp_path, accumulator):
    """tests/test_count.py::test_counts_vs_bruteforce."""
    k = 21
    reads = _reads(0, 300, 100, genome_len=5000)
    reads[3] = reads[3][:30] + "N" + reads[3][31:]
    reads = reads + reads[:100]  # multiplicity
    fq = tmp_path / "t.fastq"
    _write_fastq(fq, reads)
    stats = _check((str(fq),), dict(k=k, ci=1, cs=1 << 30, seg_len=64,
                                    batch_segs=512, accumulator=accumulator),
                   dict(_brute(reads, k)))
    assert stats.reads == len(reads)


def test_gzip_and_list_inputs(tmp_path):
    """tests/test_count.py::test_gzip_and_list_inputs."""
    k = 15
    reads1, reads2 = _reads(1, 80, 90), _reads(2, 80, 90)
    f1, f2 = tmp_path / "a.fastq.gz", tmp_path / "b.fastq"
    _write_fastq(f1, reads1, gzip.open)
    _write_fastq(f2, reads2)
    lst = tmp_path / "in.lst"
    lst.write_text(f"{f1}\n{f2}\n")
    _check((f"@{lst}",), dict(k=k, seg_len=96, batch_segs=256),
           dict(_brute(reads1 + reads2, k)))


def test_ci_cs_semantics(tmp_path):
    """tests/test_count.py::test_ci_cs_semantics: ci drops, cs clamps."""
    k = 11
    reads = ["ACGTACGTACGTACGTACG"] * 10 + ["T" * 5 + "GATTACAGATT" + "C" * 5]
    fq = tmp_path / "t.fastq"
    _write_fastq(fq, reads)
    want = {km: min(c, 5) for km, c in _brute(reads, k).items() if c >= 2}
    _check((str(fq),), dict(k=k, ci=2, cs=5, seg_len=32, batch_segs=64), want)


@pytest.mark.parametrize("accumulator", ["device", "host"])
def test_fasta_input(tmp_path, accumulator):
    """tests/test_count.py::test_fasta_input, plus a wrapped record."""
    k = 9
    fa = tmp_path / "t.fa"
    fa.write_text(">s1\nACGTACGTACGTACGT\n>s2\nGGGGGGGGGGGG\n>s3\nACGGTCA\n"
                  "TTGACCGTAAC\nGT\n")
    want = _brute(["ACGTACGTACGTACGT", "GGGGGGGGGGGG",
                   "ACGGTCATTGACCGTAACGT"], k)
    _check((str(fa),), dict(k=k, seg_len=32, batch_segs=64,
                            accumulator=accumulator), dict(want))
