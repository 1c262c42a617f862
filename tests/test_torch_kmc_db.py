"""The port's database side (io/kmc_db.py, core/signature.py,
core/codec_mw.py, KModel.init) on the CPU against the JAX package's: the
cases of tests/test_kmc_db.py, tests/test_kmc2_writer.py and
tests/test_multiword.py on the same numpy-seeded tables, with the
databases crossing between the packages (one writes, the other reads).
Files and integer arrays: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest

from kmcex_tpu.core import codec as jcodec
from kmcex_tpu.core import codec_mw as jmw
from kmcex_tpu.core import signature as jsig
from kmcex_tpu.io import kmc_db as jdb
from kmcex_tpu.model.kmodel import get_model as jget_model
from kmcex_tpu_torch.core import codec_mw as tmw
from kmcex_tpu_torch.core import signature as tsig
from kmcex_tpu_torch.io import kmc_db as tdb
from kmcex_tpu_torch.model.kmodel import get_model as tget_model

MODS = {"jax": jdb, "torch": tdb}
CROSS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
EXTS = (".kmc_pre", ".kmc_suf")


def _pairs(seed, n, k):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << min(2 * k, 62), size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(jcodec.canonical_np(raw & mask, k))
    counts = rng.integers(1, 1024, size=len(can), dtype=np.uint64)
    return can, counts


def _mw_table(seed, n, k):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 63, size=(n, jmw.n_words(k)), dtype=np.uint64)
    top = 2 * k - 64 * (jmw.n_words(k) - 1)
    if top < 64:
        raw[:, 0] &= (np.uint64(1) << np.uint64(top)) - np.uint64(1)
    can = jmw.canonical_mw(raw, k)
    _, idx = np.unique(jmw.sort_key_mw(can), return_index=True)
    can = can[idx]
    return can, rng.integers(1, 900, len(can)).astype(np.uint32), rng


def _same_db(a, b):
    for ext in EXTS:
        assert open(a + ext, "rb").read() == open(b + ext, "rb").read(), ext


def _same_reader_fields(r, w):
    for name in ("kmc_version", "kmer_length", "mode", "counter_size",
                 "lut_prefix_length", "signature_len", "min_count",
                 "max_count", "total_kmers", "both_strands", "n_words",
                 "multiword", "sufix_size", "sufix_rec_size"):
        assert getattr(r, name) == getattr(w, name), name


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("m", [5, 7, 9])
def test_signatures_equal_jax(m):
    np.testing.assert_array_equal(tsig.norm_table(m), jsig.norm_table(m))
    can, _ = _pairs(m, 3000, 31)
    np.testing.assert_array_equal(tsig.signatures(can, 31, m),
                                  jsig.signatures(can, 31, m))


@pytest.mark.parametrize("k", [33, 45, 64, 75])
def test_codec_mw_equals_jax(k):
    """tests/test_multiword.py::test_codec_mw_roundtrip_and_revcomp."""
    rng = np.random.default_rng(k)
    kmers = ["".join(rng.choice(list("ACGT"), k)) for _ in range(200)]
    v = tmw.strings_to_mw(kmers, k)
    np.testing.assert_array_equal(v, jmw.strings_to_mw(kmers, k))
    assert v.shape == (200, tmw.n_words(k)) and tmw.n_words(k) == jmw.n_words(k)
    assert tmw.mw_to_strings(v, k) == kmers
    np.testing.assert_array_equal(tmw.revcomp_mw(v, k), jmw.revcomp_mw(v, k))
    np.testing.assert_array_equal(tmw.revcomp_mw(tmw.revcomp_mw(v, k), k), v)
    np.testing.assert_array_equal(tmw.canonical_mw(v, k), jmw.canonical_mw(v, k))
    np.testing.assert_array_equal(tmw.unpack_mw(v, k), jmw.unpack_mw(v, k))
    np.testing.assert_array_equal(tmw.sort_key_mw(v), jmw.sort_key_mw(v))
    np.testing.assert_array_equal(tmw.less_mw(v, v[::-1]), jmw.less_mw(v, v[::-1]))
    assert tmw.equal_mw(v, v).all()
    np.testing.assert_array_equal(tmw.signatures_mw(v, k, 9),
                                  jmw.signatures_mw(v, k, 9))
    for s in (0, 7, 64, 70):
        np.testing.assert_array_equal(tmw.shr_mw(v, s), jmw.shr_mw(v, s))
    for lowbit, nbits in [(0, 8), (60, 16), (64, 64 if k > 64 else 2), (3, 33)]:
        np.testing.assert_array_equal(tmw.extract_bits_mw(v, lowbit, nbits),
                                      jmw.extract_bits_mw(v, lowbit, nbits))


def test_counter_size_and_prefix_rules():
    for cs in (255, 256, 1023, 65536, 1 << 24):
        assert tdb.counter_size_for(cs) == jdb.counter_size_for(cs)
    for k in range(11, 40):
        assert tdb.lut_prefix_len_for(k) == jdb.lut_prefix_len_for(k)


# ------------------------------------------------------------- KMC1, k<=32
@pytest.mark.parametrize("writer,reader", CROSS)
@pytest.mark.parametrize("k", [11, 15, 21, 25, 31, 32])
def test_kmc1_roundtrip_crossing(tmp_path, writer, reader, k):
    """test_roundtrip_k31 / test_roundtrip_various_k: one package writes, the
    other reads; the files equal the JAX package's byte for byte."""
    can, counts = _pairs(k, 3000, k)
    db = str(tmp_path / "db")
    MODS[writer].write_kmc1(db, can, counts, k, min_count=1, max_count=1023)
    ref = str(tmp_path / "ref")
    jdb.write_kmc1(ref, can, counts, k, min_count=1, max_count=1023)
    _same_db(db, ref)
    r = MODS[reader].KMCReader(db)
    _same_reader_fields(r, jdb.KMCReader(ref))
    assert r.kmer_length == k and r.counter_size == 2
    kmers, cts = r.list_all()
    np.testing.assert_array_equal(kmers, can)
    np.testing.assert_array_equal(cts, counts.astype(np.uint32))


@pytest.mark.parametrize("writer,reader", CROSS)
def test_min_max_filter_and_check_kmers(tmp_path, writer, reader):
    """test_min_max_filter + test_check_kmers."""
    can, counts = _pairs(5, 4000, 31)
    db = str(tmp_path / "db")
    MODS[writer].write_kmc1(db, can, counts, 31, min_count=5, max_count=100)
    r = MODS[reader].KMCReader(db)
    kmers, cts = r.list_all()
    keep = (counts >= 5) & (counts <= 100)
    np.testing.assert_array_equal(kmers, can[keep])
    np.testing.assert_array_equal(cts, counts[keep].astype(np.uint32))
    absent = np.random.default_rng(1).integers(0, 1 << 62, 500, dtype=np.uint64)
    q = np.concatenate([can[::3], absent])
    lookup = dict(zip(can[keep].tolist(), counts[keep].tolist()))
    want = np.array([lookup.get(int(x), 0) for x in q], dtype=np.uint32)
    np.testing.assert_array_equal(r.check_kmers(q), want)
    np.testing.assert_array_equal(jdb.KMCReader(db).check_kmers(q), want)


def test_check_kmers_big_db_route(tmp_path, monkeypatch):
    """Above RA_CACHE_BYTES only the queried buckets' byte ranges are read;
    same answers as the in-RAM route and as the JAX reader."""
    can, counts = _pairs(9, 4000, 31)
    db = str(tmp_path / "db")
    tdb.write_kmc1(db, can, counts, 31, min_count=1, max_count=1023)
    absent = np.random.default_rng(2).integers(0, 1 << 62, 300, dtype=np.uint64)
    q = np.concatenate([can[::5], absent])
    want = tdb.KMCReader(db).check_kmers(q)
    monkeypatch.setattr(tdb.KMCReader, "RA_CACHE_BYTES", 0)
    monkeypatch.setattr(jdb.KMCReader, "RA_CACHE_BYTES", 0)
    r = tdb.KMCReader(db)
    np.testing.assert_array_equal(r.check_kmers(q), want)
    assert r._raw_suf is None  # the whole-table decode never ran
    np.testing.assert_array_equal(jdb.KMCReader(db).check_kmers(q), want)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_quake_mode_roundtrip(tmp_path, writer, reader):
    """test_quake_mode_roundtrip: float32 counters as raw IEEE bits; random
    access filters hits on the counter AS FLOAT."""
    can, _ = _pairs(3, 3000, 31)
    rng = np.random.default_rng(3)
    fcounts = (rng.random(len(can)) * 100).astype(np.float32) + np.float32(0.5)
    db = str(tmp_path / "qdb")
    MODS[writer].write_kmc1(db, can, fcounts, 31, min_count=1,
                            max_count=0xFFFFFFFF, mode=1)
    r = MODS[reader].KMCReader(db)
    assert r.mode == 1 and r.counter_size == 4
    kmers, cts = r.list_all()
    assert cts.dtype == np.float32
    np.testing.assert_array_equal(kmers, can)
    np.testing.assert_array_equal(cts, fcounts)
    got = r.check_kmers(can[::7])
    want = np.where(fcounts[::7] >= np.float32(1), fcounts[::7], np.float32(0))
    np.testing.assert_array_equal(got, want)
    # the model layer refuses quake databases
    with pytest.raises(ValueError, match="mode 0"):
        tget_model(1, 1023, 7, 5).init(db)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_quake_listing_or_quirk(tmp_path, writer, reader):
    """test_quake_listing_or_quirk: a record lists iff float-in-range OR
    raw-bits-in-range, while random access uses the float compare alone."""
    can, _ = _pairs(6, 64, 31)
    can = can[:3]
    fcounts = np.array([2.5, 0.5, 0.0], dtype=np.float32)
    fcounts[2] = np.uint32(5).view(np.float32)
    db = str(tmp_path / "qdb2")
    MODS[writer].write_kmc1(db, can, fcounts, 31, min_count=1, max_count=1023,
                            mode=1)
    r = MODS[reader].KMCReader(db)
    kmers, cts = r.list_all()
    np.testing.assert_array_equal(kmers, can[[0, 2]])
    np.testing.assert_array_equal(cts, fcounts[[0, 2]])
    np.testing.assert_array_equal(
        r.check_kmers(can), np.array([2.5, 0.0, 0.0], dtype=np.float32))


@pytest.mark.parametrize("chunk_bytes", [1, 64, 4096])
def test_list_chunks_equals_list_all(tmp_path, chunk_bytes):
    can, counts = _pairs(13, 5000, 31)
    db = str(tmp_path / "db")
    jdb.write_kmc1(db, can, counts, 31, min_count=2, max_count=500)
    want_k, want_c = jdb.KMCReader(db).list_all()
    parts = list(tdb.KMCReader(db).list_chunks(chunk_bytes=chunk_bytes))
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), want_k)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), want_c)


def test_reader_rejects_bad_files(tmp_path):
    can, counts = _pairs(1, 100, 21)
    db = str(tmp_path / "db")
    tdb.write_kmc1(db, can, counts, 21)
    pre = open(db + ".kmc_pre", "rb").read()
    open(str(tmp_path / "bad.kmc_pre"), "wb").write(b"XXXX" + pre[4:])
    with pytest.raises(ValueError, match="markers"):
        tdb.KMCReader(str(tmp_path / "bad"))
    suf = open(db + ".kmc_suf", "rb").read()
    open(str(tmp_path / "short.kmc_pre"), "wb").write(pre)
    open(str(tmp_path / "short.kmc_suf"), "wb").write(suf[: len(suf) // 2])
    with pytest.raises(ValueError, match="truncated"):
        tdb.KMCReader(str(tmp_path / "short")).list_all()
    with pytest.raises(ValueError, match="ascending"):
        tdb.write_kmc1(str(tmp_path / "x"), can[::-1], counts, 21)
    with pytest.raises(ValueError, match="multi-word"):
        tdb.write_kmc1(str(tmp_path / "x"), can, counts, 40)


# ------------------------------------------------------------- the writers
@pytest.mark.parametrize("k", [31, 21])
def test_stream_writer_matches_one_shot_and_jax(tmp_path, k):
    """test_stream_writer_matches_one_shot, plus the JAX stream writer's
    bytes: the port's KMC1StreamWriter writes what it always wrote."""
    can, counts = _pairs(k * 7, 6000, k)
    counts = np.minimum(counts, 1023)
    one = str(tmp_path / "one")
    tdb.write_kmc1(one, can, counts, k, min_count=1, max_count=1023,
                   counter_size=tdb.counter_size_for(1023))
    paths = {}
    for name, mod in MODS.items():
        paths[name] = str(tmp_path / name)
        w = mod.KMC1StreamWriter(paths[name], k, min_count=1, max_count=1023)
        rng = np.random.default_rng(k)
        a = 0
        while a < len(can):
            m = int(rng.integers(1, 700))
            w.write_chunk(can[a : a + m], counts[a : a + m])
            a += m
        w.close()
    _same_db(paths["torch"], one)
    _same_db(paths["torch"], paths["jax"])
    kk, cc = jdb.KMCReader(paths["torch"]).list_all()
    np.testing.assert_array_equal(kk, can)
    np.testing.assert_array_equal(cc, counts.astype(np.uint32))


def test_stream_writer_rejects_unsorted_and_aborts(tmp_path):
    w = tdb.KMC1StreamWriter(str(tmp_path / "x"), 21, max_count=1023)
    w.write_chunk(np.array([5, 9], np.uint64), np.array([1, 1], np.uint32))
    with pytest.raises(ValueError):
        w.write_chunk(np.array([9], np.uint64), np.array([1], np.uint32))
    with pytest.raises(ValueError):
        w.write_chunk(np.array([20, 12], np.uint64),
                      np.array([1, 1], np.uint32))
    w.close()
    with pytest.raises(RuntimeError):
        with tdb.KMC1StreamWriter(str(tmp_path / "y"), 21) as w:
            w.write_chunk(np.array([5], np.uint64), np.array([1], np.uint32))
            raise RuntimeError("build failed")
    assert not (tmp_path / "y.kmc_suf").exists()
    assert not (tmp_path / "y.kmc_pre").exists()


def test_stream_writer_quake_mode(tmp_path):
    k = 21
    can, _ = _pairs(99, 3000, k)
    fcounts = (np.random.default_rng(1).random(len(can)) * 50 + 0.5).astype(
        np.float32)
    one = str(tmp_path / "one")
    jdb.write_kmc1(one, can, fcounts, k, min_count=1, max_count=1023, mode=1)
    st = str(tmp_path / "st")
    with tdb.KMC1StreamWriter(st, k, min_count=1, max_count=1023,
                              mode=1) as w:
        for a in range(0, len(can), 777):
            w.write_chunk(can[a : a + 777], fcounts[a : a + 777])
    _same_db(one, st)


# -------------------------------------------------------------------- KMC2
def _zipf_pairs(seed, n, k, ci, cs):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << min(2 * k, 63), size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(jcodec.canonical_np(raw & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), ci, cs).astype(np.uint64)
    return can, counts, rng


@pytest.mark.parametrize("writer,reader", CROSS)
@pytest.mark.parametrize("k,sig_len,n_bins", [(31, 9, 512), (31, 5, 64),
                                              (21, 7, 128)])
def test_kmc2_roundtrip_crossing(tmp_path, writer, reader, k, sig_len, n_bins):
    """tests/test_kmc2_writer.py::test_kmc2_roundtrip."""
    can, counts, rng = _zipf_pairs(5, 20000, k, 1, 1023)
    db = str(tmp_path / "db2")
    MODS[writer].write_kmc2(db, can, counts, k, min_count=1, max_count=1023,
                            signature_len=sig_len, n_bins=n_bins)
    ref = str(tmp_path / "ref2")
    jdb.write_kmc2(ref, can, counts, k, min_count=1, max_count=1023,
                   signature_len=sig_len, n_bins=n_bins)
    _same_db(db, ref)
    rd = MODS[reader].KMCReader(db)
    _same_reader_fields(rd, jdb.KMCReader(ref))
    assert rd.kmc_version == 0x200
    assert rd.kmer_length == k and rd.signature_len == sig_len
    got_k, got_c = rd.list_all()
    # listing order is (bin, kmer): same multiset, ascending within bins
    order = np.argsort(got_k, kind="stable")
    np.testing.assert_array_equal(got_k[order], can)
    np.testing.assert_array_equal(got_c[order], counts.astype(np.uint32))
    bins = rd.signature_map[tsig.signatures(got_k, k, sig_len)]
    assert (np.diff(bins.astype(np.int64)) >= 0).all(), "not bin-grouped"
    q = np.concatenate([
        can[:: max(1, len(can) // 1500)],
        jcodec.canonical_np(
            rng.integers(0, 1 << min(2 * k, 63), 1000, dtype=np.uint64)
            & ((np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)), k),
    ])
    lut = dict(zip(can.tolist(), counts.tolist()))
    want = np.array([lut.get(int(x), 0) for x in q], dtype=np.uint32)
    np.testing.assert_array_equal(rd.check_kmers(q), want)


def test_balanced_signature_map_equals_jax():
    can, _, _ = _zipf_pairs(8, 5000, 31, 1, 1023)
    sigs = jsig.signatures(can, 31, 7)
    gm, gb = tdb._balanced_signature_map(sigs, 7, 64)
    wm, wb = jdb._balanced_signature_map(sigs, 7, 64)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_kmc2_multiword_roundtrip(tmp_path, writer, reader):
    """tests/test_kmc2_writer.py::test_kmc2_multiword_roundtrip."""
    k = 45
    can, counts, _ = _mw_table(3, 8000, k)
    db = str(tmp_path / "dbmw")
    MODS[writer].write_kmc2(db, can, counts, k, signature_len=9)
    rd = MODS[reader].KMCReader(db)
    got_k, got_c = rd.list_all()
    order = np.argsort(tmw.sort_key_mw(got_k), kind="stable")
    np.testing.assert_array_equal(got_k[order], can)
    np.testing.assert_array_equal(got_c[order], counts)
    q = np.concatenate([can[::11][:800], can[:200]])
    lut = {tuple(x): c for x, c in zip(can.tolist(), counts.tolist())}
    want = np.array([lut.get(tuple(x), 0) for x in q.tolist()], dtype=np.uint32)
    np.testing.assert_array_equal(rd.check_kmers(q), want)


# ----------------------------------------------------------------- k > 32
@pytest.mark.parametrize("writer,reader", CROSS)
@pytest.mark.parametrize("k", [33, 45, 55])
def test_kmc1_db_roundtrip_k_gt_32(tmp_path, writer, reader, k):
    """tests/test_multiword.py::test_kmc1_db_roundtrip_k_gt_32."""
    v, counts, rng = _mw_table(k, 600, k)
    db = str(tmp_path / "mw")
    MODS[writer].write_kmc1(db, v, counts, k)
    ref = str(tmp_path / "ref")
    jdb.write_kmc1(ref, v, counts, k)
    _same_db(db, ref)
    rd = MODS[reader].KMCReader(db)
    assert rd.kmer_length == k and rd.multiword
    assert rd.n_words == tmw.n_words(k)
    got_k, got_c = rd.list_all()
    np.testing.assert_array_equal(got_k, v)
    np.testing.assert_array_equal(got_c, counts)
    absent, _, _ = _mw_table(k + 100, 50, k)
    q = np.concatenate([v[::7], absent])
    lut = {tuple(x): int(c) for x, c in zip(v.tolist(), counts)}
    exp = [lut.get(tuple(x), 0) for x in q.tolist()]
    assert rd.check_kmers(q).tolist() == exp
    with pytest.raises(ValueError, match="multi-word"):
        rd.check_kmers(np.zeros(3, np.uint64))


# ------------------------------------------------------------- KModel.init
@pytest.mark.parametrize("version", ["kmc1", "kmc2"])
@pytest.mark.parametrize("ci,cs", [(1, 1023), (2, 255)])
def test_model_init_from_db_equals_jax(tmp_path, version, ci, cs):
    """test_streaming_init_equals_in_memory_build: KModel.init streams the
    database twice; the model equals the JAX package's init of the same
    database and, for KMC1 order, the in-memory init_from_pairs build."""
    can, counts, _ = _zipf_pairs(17, 20000, 31, ci, cs)
    db = str(tmp_path / "db")
    if version == "kmc1":
        tdb.write_kmc1(db, can, counts, 31, min_count=ci, max_count=cs)
    else:
        tdb.write_kmc2(db, can, counts, 31, min_count=ci, max_count=cs)
    km_t = tget_model(ci, cs, 7, 5)
    km_t.init(db)
    km_j = jget_model(ci, cs, 7, 5)
    km_j.init(db)
    km_t.save(tmp_path / "t")
    km_j.save(tmp_path / "j")
    dirs = ["j"]
    if version == "kmc1":
        km_p = tget_model(ci, cs, 7, 5)
        km_p.init_from_pairs(can, counts.astype(np.uint32), 31)
        km_p.save(tmp_path / "p")
        dirs.append("p")
    for d in dirs:
        for fn in ("header", "km.bin", "rest.bin"):
            assert (tmp_path / "t" / fn).read_bytes() == \
                (tmp_path / d / fn).read_bytes(), (d, fn)
    assert km_t.total_kmer_count == len(can)
