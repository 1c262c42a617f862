"""The port's query side on the CPU against the JAX package: the host
``KModel.kmer_to_occ_u64`` and ``DeviceKModel(km, device="cpu")`` both equal
the JAX ``KModel.kmer_to_occ_u64`` on every query, the rest store's
inclusive-high quirk included.  The model is built once by the JAX package
and handed to the port two ways: ``save`` -> ``load_model``, and
``KModel.from_arrays`` with no file between.  Integers throughout: every
comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from kmcex_tpu.core import codec as jcodec
from kmcex_tpu.model.kmodel import get_model as j_get_model
from kmcex_tpu.query import device_model as j_dm
from kmcex_tpu_torch import DeviceKModel, KModel, load_model
from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.query import device_model as t_dm

CONFIGS = {
    "k31_ci1": (11, 60000, 31, 1, 1023, 7, 5),
    "k31_ci2": (12, 40000, 31, 2, 1023, 7, 5),
    "k21_cs255_nb4": (13, 30000, 21, 1, 255, 7, 4),
}


def _build(seed, n, k, ci, cs, nh, nb):
    """The generator of tests/test_device_query.py: a JAX-package model over
    random canonical k-mers with zipf counts."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(jcodec.canonical_np(raw & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), ci, cs).astype(np.uint64)
    km = j_get_model(ci, cs, nh, nb)
    km.init_from_pairs(can, counts.astype(np.uint32), k)
    return km, can, rng


def from_jax_arrays(km) -> KModel:
    """The JAX model's numpy arrays handed to the port with no file."""
    return KModel.from_arrays(
        n_hash=km.n_hash, n_bits=km.n_bits, ci=km.ci, cs=km.cs,
        kmer_length=km.kmer_length, km_kmercount=km.km_kmercount,
        kmer_counts=km.bloom.kmer_counts, bit_bf=km.bloom.bit_bf,
        bit_bf_back=km.bloom.bit_bf_back, km_back=km.km_back, bit1=km.bit1,
        bit2=km.bit2, rest_hash2index=km.kld.hash2index,
        rest_pre_buffer=km.kld.pre_buffer, rest_suffix_bin=km.kld.suffix_bin,
        rest_count_bin=km.kld.count_bin)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (JAX model, port model from files, port model from arrays,
    counted k-mers, queries, the JAX host answers)."""
    out = {}
    for name, cfg in CONFIGS.items():
        km, can, rng = _build(*cfg)
        k = cfg[2]
        d = tmp_path_factory.mktemp("q_" + name)
        km.save(d)
        q = np.concatenate([can[::9][:3000], rng.integers(
            0, 1 << (2 * k), size=1500, dtype=np.uint64)])
        out[name] = (km, load_model(d), from_jax_arrays(km), can, q,
                     km.kmer_to_occ_u64(q))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("carried", ["files", "arrays"])
def test_host_query_matches_jax(name, carried, models):
    _, t_files, t_arrays, _, q, want = models[name]
    tm = t_files if carried == "files" else t_arrays
    got = tm.kmer_to_occ_u64(q)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (want[:3000] != 0).mean() > 0.9  # the present half is answered


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("carried", ["files", "arrays"])
def test_device_query_matches_jax(name, carried, models):
    _, t_files, t_arrays, _, q, want = models[name]
    dm = DeviceKModel(t_files if carried == "files" else t_arrays,
                      device="cpu")
    got = dm.kmer_to_occ(q)
    assert got.dtype == np.int32 and got.shape == q.shape
    np.testing.assert_array_equal(got, want)
    assert dm.n_resolved > 0  # the resolve pass really ran
    # a second call gives the same answers
    np.testing.assert_array_equal(dm.kmer_to_occ(q), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_arrays_saves_identical(name, models, tmp_path):
    km, _, t_arrays, _, _, _ = models[name]
    km.save(tmp_path / "j")
    t_arrays.save(tmp_path / "t")
    for fn in ("header", "km.bin", "rest.bin"):
        assert (tmp_path / "j" / fn).read_bytes() \
            == (tmp_path / "t" / fn).read_bytes(), fn
    assert t_arrays.total_kmer_count == km.total_kmer_count
    assert t_arrays.total_model_bytes() == km.total_model_bytes()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_query_tiles_and_groups(name, models, monkeypatch):
    """Tiles, groups and resolve steps far smaller than the batch: the
    answers do not depend on how the batch is cut."""
    _, t_files, _, _, q, want = models[name]
    dm = DeviceKModel(t_files, device="cpu")
    monkeypatch.setattr(dm, "GROUP", 3)
    monkeypatch.setattr(dm, "RESOLVE_TILE", 5)
    np.testing.assert_array_equal(dm.kmer_to_occ(q, tile=257), want)
    full = DeviceKModel(t_files, device="cpu").kmer_to_occ(q)
    np.testing.assert_array_equal(full, want)


def test_device_query_matches_jax_device_model(models):
    """The JAX DeviceKModel (its gated main pass included) gives the same
    answers as the port's ungated one."""
    km, t_files, _, _, q, want = models["k31_ci1"]
    np.testing.assert_array_equal(
        np.asarray(j_dm.DeviceKModel(km).kmer_to_occ(q)), want)
    np.testing.assert_array_equal(
        DeviceKModel(t_files, device="cpu").kmer_to_occ(q), want)


def test_query_shapes(models):
    km, t_files, _, can, _, _ = models["k31_ci1"]
    dm = DeviceKModel(t_files, device="cpu")
    q = can[:128].reshape(2, 64)
    want = km.kmer_to_occ_u64(q.reshape(-1)).reshape(2, 64)
    out = dm.kmer_to_occ(q)
    assert out.shape == (2, 64)
    np.testing.assert_array_equal(out, want)
    assert dm.kmer_to_occ(np.zeros((0,), np.uint64)).shape == (0,)
    assert dm.kmer_to_occ(np.zeros((3, 0), np.uint64)).shape == (3, 0)


def test_non_canonical_queries_are_canonicalized(models):
    km, t_files, _, can, _, _ = models["k31_ci1"]
    q = jcodec.revcomp_np(can[:500], 31)
    want = km.kmer_to_occ_u64(can[:500])
    np.testing.assert_array_equal(t_files.kmer_to_occ_u64(q), want)
    np.testing.assert_array_equal(
        DeviceKModel(t_files, device="cpu").kmer_to_occ(q), want)


def test_rest_quirk_keys_match_jax():
    """The cuckoo rest table's phantom entries must reproduce the
    reference's inclusive-high quirk (rest.hpp:236-247): derive the
    quirk-triggering keys independently from the CSR arrays and compare the
    port's host and device answers with the JAX host's on exactly those."""
    km, can, rng = _build(21, 60000, 31, 1, 1023, 7, 5)
    kld = km.kld
    assert kld.suffix_bin_count > 100, "model must have a real rest store"
    suffix = kld._ensure_suffix_int()
    pre = kld.pre_buffer.astype(np.int64)
    suf_bits = 2 * kld.suf_len
    quirks = []
    for p in np.flatnonzero(kld.hash2index >= 0):
        pi = kld.hash2index[p]
        lo, hi = pre[pi], pre[pi + 1]
        if hi < kld.suffix_bin_count and (lo == hi or suffix[hi] > suffix[hi - 1]):
            quirks.append((np.uint64(p) << np.uint64(suf_bits)) | suffix[hi])
    q = np.array(quirks, dtype=np.uint64)
    # only canonical quirk keys stay quirk keys after canonicalization
    q = q[jcodec.canonical_np(q, 31) == q]
    assert len(q) > 5
    want = km.kmer_to_occ_u64(q)
    tm = from_jax_arrays(km)
    np.testing.assert_array_equal(tm.kld.check_kmer(q), kld.check_kmer(q))
    np.testing.assert_array_equal(tm.kmer_to_occ_u64(q), want)
    np.testing.assert_array_equal(
        DeviceKModel(tm, device="cpu").kmer_to_occ(q), want)
    # the quirk actually fires for at least some of these keys
    assert (tm.kld.check_kmer(q) > 0).any()
    assert int(tm.kld.check_kmer(q[0])) == int(kld.check_kmer(q[0]))  # scalar


@pytest.mark.parametrize("n", [10, 500, 20000])
def test_cuckoo_tables_match_jax(n):
    """Same keys, same seed: the same tables and multipliers; every key is
    found by the port's tensor lookup (wrapping multiply, logical shift)."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 63, n, dtype=np.uint64)
                     * np.uint64(2))  # top bit set on half of them
    vals = rng.integers(1, 1000, len(keys)).astype(np.int32)
    want = j_dm._build_cuckoo(keys, vals)
    got = t_dm._build_cuckoo(keys, vals)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4:] == want[4:]
    t1k, t1v, t2k, t2v, m1, m2, bits = got
    h1, h2 = t_dm._cuckoo_hashes(keys, m1, m2, bits)
    from kmcex_tpu_torch.core.codec import _srl
    from kmcex_tpu_torch.core.murmur import _signed

    kt = torch.from_numpy(keys.view(np.int64))
    np.testing.assert_array_equal(_srl(kt * _signed(m1), 64 - bits).numpy(), h1)
    np.testing.assert_array_equal(_srl(kt * _signed(m2), 64 - bits).numpy(), h2)
    found = np.where(t1k[h1] == keys, t1v[h1], np.where(t2k[h2] == keys,
                                                        t2v[h2], 0))
    np.testing.assert_array_equal(found, vals)


def test_string_and_list_inputs(models):
    km, t_files, _, can, _, _ = models["k31_ci1"]
    strings = [codec.u64_to_string(int(x), 31) for x in can[:40]]
    assert t_files.kmer_to_occ(strings[0]) == km.kmer_to_occ(strings[0])
    assert t_files.kmer_to_occ(strings) == km.kmer_to_occ(strings)
    assert t_files.kmer_to_occ(tuple(strings[:3])) == km.kmer_to_occ(strings[:3])
    assert t_files.kmer_to_occ([]) == []
    np.testing.assert_array_equal(t_files.kmer_to_occ(can[:40]),
                                  km.kmer_to_occ(can[:40]))
    assert t_files.kmer_to_occ(strings, t_num=1) == km.kmer_to_occ(strings)


def test_probe_primitives_match_jax(models):
    """check_all, the native back-filter probe and find_bitarray, each
    against the JAX package's on the same queries."""
    from kmcex_tpu import native as j_native
    from kmcex_tpu_torch import native as t_native

    km, t_files, _, _, q, _ = models["k31_ci2"]
    q = jcodec.canonical_np(q, 31)
    np.testing.assert_array_equal(t_files.bloom.check_all(q, 31),
                                  km.bloom.check_all(q, 31))
    np.testing.assert_array_equal(
        t_native.check_bloom(q, 31, t_files.km_back, t_files.bit_km_back,
                             t_files.km_back_num_hash, substr_mode=1),
        j_native.check_bloom(q, 31, km.km_back, km.bit_km_back,
                             km.km_back_num_hash, substr_mode=1))
    np.testing.assert_array_equal(t_files._find_bitarray(q),
                                  km._find_bitarray(q))
    dm = DeviceKModel(t_files, device="cpu")
    qt = torch.from_numpy(q.view(np.int64))
    h_k, h_m = dm._hash_state(qt)
    np.testing.assert_array_equal(dm._find_bitarray(qt, h_k).numpy(),
                                  km._find_bitarray(q))
    np.testing.assert_array_equal(dm._check_all_bf(qt, h_k, h_m).numpy(),
                                  km.bloom.check_all(q, 31))
    np.testing.assert_array_equal(dm._check_rest(qt).numpy(),
                                  km.kld.check_kmer(q))


def test_device_model_default_device_raises_without_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceKModel(models["k31_ci1"][1])


def test_empty_rest_store_and_tiny_model():
    """A model of 40 k-mers, its rest store empty and its coupled arrays at
    the 16-k-mer floor, still answers like the JAX package."""
    k = 21
    can = np.unique(jcodec.canonical_np(np.random.default_rng(1).integers(
        0, 1 << 42, 40, dtype=np.uint64), k))
    counts = np.full(len(can), 1, np.uint32)
    counts[::3] = 9
    km = j_get_model(1, 1023, 7, 5)
    km.init_from_pairs(can, counts, k)
    assert km.kld.suffix_bin_count == 0 and km.km_byte_size == 7
    tm = from_jax_arrays(km)
    q = np.concatenate([can, can + np.uint64(1)])
    want = km.kmer_to_occ_u64(q)
    np.testing.assert_array_equal(tm.kmer_to_occ_u64(q), want)
    np.testing.assert_array_equal(
        DeviceKModel(tm, device="cpu").kmer_to_occ(q), want)
