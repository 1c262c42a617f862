"""The port's device Bloom-bank build on the CPU against the JAX package:
the scatter-built filter bytes equal the JAX ``DeviceBloomBuilder``'s and
the host insert's, and ``count_encode`` builds the same model bytes as the
JAX package in all three build configurations (device Bloom, host insert,
model-only drop), on the single-tier and on the run-LSM route.  Integers
throughout: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmcex_tpu.core import codec as jcodec
from kmcex_tpu.count import device_lsm as j_lsm
from kmcex_tpu.count.pipeline import count_encode as j_count_encode
from kmcex_tpu.model.bloom import BloomBank as JBloomBank
from kmcex_tpu.model.device_bloom import DeviceBloomBuilder as JBuilder
from kmcex_tpu.model.kmodel import get_model as j_get_model
from kmcex_tpu_torch.count import device_lsm
from kmcex_tpu_torch.count.pipeline import count_encode
from kmcex_tpu_torch.model import device_bloom
from kmcex_tpu_torch.model.bloom import BloomBank
from kmcex_tpu_torch.model.device_bloom import DeviceBloomBuilder
from tests.test_byte_ranges import _write_fastq

S = np.uint64(0xFFFFFFFFFFFFFFFF)
MODEL_FILES = ("header", "km.bin", "rest.bin")


def _rand_table(rng, n, k, ci, max_c=9):
    kmers = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    kmers = np.unique(jcodec.canonical_np(kmers, k))
    counts = rng.integers(ci, max_c, size=len(kmers)).astype(np.uint32)
    return kmers, counts


def _hist(counts, ci):
    return np.array([np.count_nonzero(counts == ci + i) for i in range(3)],
                    np.uint64)


def _dev(kmers, counts):
    return (torch.from_numpy(kmers.view(np.int64)),
            torch.from_numpy(counts.astype(np.int32)))


def _assert_banks_equal(a, b, bf_num):
    for i in range(bf_num):
        np.testing.assert_array_equal(a.bit_bf[i], b.bit_bf[i])
        np.testing.assert_array_equal(a.bit_bf_back[i], b.bit_bf_back[i])


@pytest.mark.parametrize("k,ci,nh", [(31, 1, 7), (25, 2, 7), (31, 2, 5)])
def test_device_bloom_matches_jax_and_host(k, ci, nh):
    rng = np.random.default_rng(42 + k + ci)
    kmers, counts = _rand_table(rng, 4000, k, ci)
    bf_num = 1 if ci == 1 else 3
    hist = _hist(counts, ci)

    host = BloomBank(hist, nh, ci)
    for i in range(bf_num):
        host.insert(i, kmers[counts == ci + i], k)

    # SENTINEL-padded device table, like the fused finalize produces
    pad = 173
    ku = np.concatenate([kmers, np.full(pad, S)])
    kc = np.concatenate([counts, np.zeros(pad, np.uint32)])

    jb = JBuilder(k, ci, 1023, nh, hist)
    jb.feed_table(jnp.asarray(ku), jnp.asarray(kc), len(kmers))
    jbank = JBloomBank(hist, nh, ci)
    jb.into(jbank)

    b = DeviceBloomBuilder(k, ci, 1023, nh, hist, device="cpu")
    assert b.total_bytes == jb.total_bytes
    b.feed_table(*_dev(ku, kc), len(kmers))
    bank = BloomBank(hist, nh, ci)
    b.into(bank)

    _assert_banks_equal(bank, jbank, bf_num)
    _assert_banks_equal(bank, host, bf_num)
    # membership answers agree too (the port's check_all, the JAX one)
    probe = jcodec.canonical_np(np.concatenate([kmers[:200], rng.integers(
        0, 1 << (2 * k), 100, dtype=np.uint64)]), k)
    want = jbank.check_all(probe, k)
    assert bank.probe_order == jbank.probe_order
    np.testing.assert_array_equal(bank.check_all(probe, k), want)
    np.testing.assert_array_equal(host.check_all(probe, k), want)
    assert (want[:200] != 0).any()


@pytest.mark.parametrize("tile", [None, 700])
def test_device_bloom_split_feeds_match(tile, monkeypatch):
    """Feeding the table in two finalize-style calls equals one feed, also
    when every call crosses several tiles."""
    if tile:
        monkeypatch.setattr(device_bloom, "TILE", tile)
    k, ci, nh = 31, 1, 7
    rng = np.random.default_rng(7)
    kmers, counts = _rand_table(rng, 3000, k, ci)
    hist = _hist(counts, ci)
    u, c = _dev(kmers, counts)

    one = DeviceBloomBuilder(k, ci, 1023, nh, hist, device="cpu")
    one.feed_table(u, c, len(kmers))
    cut = len(kmers) // 2
    two = DeviceBloomBuilder(k, ci, 1023, nh, hist, device="cpu")
    two.feed_table(u[:cut], c[:cut], cut)
    two.feed_table(u[cut:], c[cut:], len(kmers) - cut)
    host = BloomBank(hist, nh, ci)
    host.insert(0, kmers[counts == ci], k)
    b1, b2 = BloomBank(hist, nh, ci), BloomBank(hist, nh, ci)
    one.into(b1)
    two.into(b2)
    _assert_banks_equal(b1, b2, 1)
    _assert_banks_equal(b1, host, 1)


def test_device_bloom_clamps_counts_to_cs():
    """Membership follows the cs-CLAMPED count: with cs = 2 every count
    above 2 feeds the pair of count 2."""
    k, ci, cs, nh = 25, 2, 2, 7
    rng = np.random.default_rng(3)
    kmers, counts = _rand_table(rng, 2000, k, 1, max_c=7)
    clamped = np.minimum(counts, cs)
    hist = _hist(clamped[clamped >= ci], ci)
    host = BloomBank(hist, nh, ci)
    host.insert(0, kmers[clamped == ci], k)
    b = DeviceBloomBuilder(k, ci, cs, nh, hist, device="cpu")
    b.feed_table(*_dev(kmers, counts), len(kmers))
    bank = BloomBank(hist, nh, ci)
    b.into(bank)
    _assert_banks_equal(bank, host, 3)


def test_device_bloom_refuses_oversized_bitmap(monkeypatch):
    monkeypatch.setattr(device_bloom, "MAX_BITMAP_BYTES", 1000)
    with pytest.raises(ValueError, match="bitmap"):
        DeviceBloomBuilder(31, 1, 1023, 7, np.array([5000, 0, 0]),
                           device="cpu")


def test_device_bloom_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBloomBuilder(31, 1, 1023, 7, np.array([100, 0, 0]))


@pytest.mark.parametrize("ci", [1, 2])
def test_drop_compact_matches_jax(ci):
    """The low-key drop (``_drop_low``) and the stats of the table it
    keeps (``_final_stats``) equal the JAX ``_drop_compact``'s."""
    rng = np.random.default_rng(20 + ci)
    kmers, counts = _rand_table(rng, 3000, 31, 1)
    pad = 1096 - len(kmers) % 1096
    ku = np.concatenate([kmers, np.full(pad, S)])
    kc = np.concatenate([counts, np.zeros(pad, np.uint32)])
    thresh = ci + (1 if ci == 1 else 3)
    ju, jc, jstats = j_lsm._drop_compact(jnp.asarray(ku), jnp.asarray(kc),
                                         jnp.uint32(thresh), 1)
    u2, c2 = device_lsm._drop_low(*_dev(ku, kc), thresh)
    stats2 = device_lsm._final_stats(u2, c2, thresh)
    np.testing.assert_array_equal(u2.numpy().view(np.uint64), np.asarray(ju))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc).astype(np.int32))
    np.testing.assert_array_equal(stats2.view(np.uint64),
                                  np.asarray(jstats)[:9])
    assert int(stats2[4]) == np.count_nonzero(counts >= thresh)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Reads over a small genome at ~7x coverage with 2% errors, so the
    counts spread over the Bloom pairs (low counts) and the coupled arrays
    for ci = 1 and for ci = 2."""
    fq = tmp_path_factory.mktemp("bloom_fq") / "reads.fastq"
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 3000)
    with open(fq, "wb") as f:
        for i in range(400):
            a = int(rng.integers(0, len(genome) - 56))
            r = genome[a : a + 56].copy()
            err = rng.random(56) < 0.02
            r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[r].tobytes(), b"I" * 56))
    return fq


@pytest.fixture(scope="module")
def jax_models(reads, tmp_path_factory):
    """The JAX package's model for ci in {1, 2}, host Bloom insert."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("KMCEX_DEVICE_BLOOM", "0")
    try:
        for ci in (1, 2):
            km, kk, cc, _ = j_count_encode(str(reads), k=19, ci=ci)
            d = tmp_path_factory.mktemp(f"jax_ci{ci}")
            km.save(d)
            out[ci] = (d, len(kk))
    finally:
        mp.undo()
    return out


def _same_model(km, want_dir, tmp_path):
    km.save(tmp_path / "m")
    for name in MODEL_FILES:
        assert ((tmp_path / "m" / name).read_bytes()
                == (want_dir / name).read_bytes()), name


@pytest.mark.parametrize("route", ["single_tier", "run_lsm"])
@pytest.mark.parametrize("ci", [1, 2])
@pytest.mark.parametrize("config", ["device_bloom", "host_insert",
                                    "model_only"])
def test_count_encode_model_identical_to_jax(config, ci, route, reads,
                                             jax_models, tmp_path,
                                             monkeypatch):
    want_dir, n_pairs = jax_models[ci]
    if route == "run_lsm":
        monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "2000")
    if config == "host_insert":  # no bitmap fits: the host inserts
        monkeypatch.setattr(device_bloom, "MAX_BITMAP_BYTES", 0)
    kwargs = dict(k=19, ci=ci, device="cpu", keep_pairs=False)
    if route == "run_lsm":
        kwargs["batch_segs"] = 64  # several batches, so several collapses
    if config != "model_only":
        kwargs["db_path"] = str(tmp_path / "o.res")
    km, kk, cc, stats = count_encode(str(reads), **kwargs)
    assert kk is None and cc is None
    _same_model(km, want_dir, tmp_path)
    assert stats.distinct_kmers == n_pairs
    if route == "run_lsm":
        assert stats.tiers["device_merges"] > 0
    else:
        assert stats.tiers == {"raw_collapses": 0, "device_merges": 0,
                               "host_spills": 0, "disk_spills": 0}
    n_low = km.bloom.bf_kmercount
    if config == "host_insert":
        assert "encode.bloom_insert" in stats.phases
        assert "encode.bloom_pull" not in stats.phases
    else:
        assert "encode.bloom_insert" not in stats.phases
        assert "encode.bloom_pull" in stats.phases
        assert "finalize.bloom_feed_dispatch" in stats.phases
    if config == "model_only":
        # only the keys the coupled arrays take crossed to the host
        assert "finalize.drop_low" in stats.phases
        assert stats.table_bytes_to_host == 12 * (n_pairs - n_low)
        assert stats.counters["table.pairs"] == km.km_kmercount
        assert 0 < n_low < n_pairs
    else:
        assert stats.table_bytes_to_host >= 12 * n_pairs


def test_count_encode_keep_pairs_matches_jax(reads, tmp_path):
    """keep_pairs keeps the low pairs in the stream (no drop) and returns
    the listing the JAX package returns."""
    km_j, kk_j, cc_j, _ = j_count_encode(str(reads), k=19, ci=2)
    km, kk, cc, stats = count_encode(str(reads), k=19, ci=2, device="cpu",
                                     keep_pairs=True)
    np.testing.assert_array_equal(kk, kk_j)
    np.testing.assert_array_equal(cc, cc_j)
    assert "finalize.drop_low" not in stats.phases
    km_j.save(tmp_path / "j")
    _same_model(km, tmp_path / "j", tmp_path)


def test_narrow_cs_clamped_membership(tmp_path):
    """With cs < ci + bf_num the Bloom membership must match the cs-CLAMPED
    counters.  Ground truth is the JAX package's init_from_pairs fed the
    clamped table."""
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=500, seed=13)
    k, ci, cs = 19, 1, 1  # every counter clamps to 1 -> everything is low
    _, kk, cc, _ = j_count_encode(str(fq), k=k, ci=ci, cs=cs)
    assert cc.max() == 1
    truth = j_get_model(ci, cs, 7, 5)
    truth.init_from_pairs(kk, cc, k)
    truth.save(tmp_path / "truth")
    for name, kwargs in (("db", dict(db_path=str(tmp_path / "o.res"),
                                     keep_pairs=False)),
                         ("model_only", dict(keep_pairs=False)),
                         ("keep", dict(keep_pairs=True))):
        km, _, _, _ = count_encode(str(fq), k=k, ci=ci, cs=cs, device="cpu",
                                   **kwargs)
        (tmp_path / name).mkdir()
        _same_model(km, tmp_path / "truth", tmp_path / name)


def test_oversized_bitmap_takes_the_host_build(reads, jax_models, tmp_path,
                                               monkeypatch, capsys):
    """A bitmap past MAX_BITMAP_BYTES: the host inserts, the model is the
    same, nothing is dropped, and KMCEX_VERBOSE=1 says so in one line."""
    monkeypatch.setattr(device_bloom, "MAX_BITMAP_BYTES", 64)
    monkeypatch.setenv("KMCEX_VERBOSE", "1")
    km, _, _, stats = count_encode(str(reads), k=19, ci=1, device="cpu",
                                   keep_pairs=False)
    _same_model(km, jax_models[1][0], tmp_path)
    assert "encode.bloom_insert" in stats.phases
    assert "finalize.drop_low" not in stats.phases
    out = capsys.readouterr().out
    assert out.count("device bloom build not taken") == 1
