"""The mesh Bloom build of the port (model/device_bloom.py
ShardedDeviceBloomBuilder, engaged by parallel/sharded.py finalize_stream)
on CPU meshes: the three sharded cases of tests/test_device_bloom.py (model
identical; skipped when spilled; skipped on a spill inside the finalize) and
the filter bytes against the host insert.  Bytes and integers: exact."""

import numpy as np
import pytest
import torch

from kmcex_tpu.count.pipeline import count_encode as j_count_encode
from kmcex_tpu.model.bloom import BloomBank as JBloomBank
from kmcex_tpu.parallel import sharded as jsharded
from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.count import extract
from kmcex_tpu_torch.count.pipeline import count_encode
from kmcex_tpu_torch.model import device_bloom
from kmcex_tpu_torch.model.bloom import BloomBank
from kmcex_tpu_torch.model.device_bloom import (
    DeviceBloomBuilder,
    ShardedDeviceBloomBuilder,
)
from kmcex_tpu_torch.model.kmodel import get_model
from kmcex_tpu_torch.model.route import BuildRoute
from kmcex_tpu_torch.parallel import sharded
from tests.test_byte_ranges import _write_fastq

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def _cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _watched_route(k):
    """A route of a ci = 1 build whose ``feed_shards`` calls are listed in
    its ``fed``."""
    route = BuildRoute(get_model(1, 1023, 7, 5), k, keep_low=True)
    route.fed = []
    feed = route.feed_shards
    route.feed_shards = lambda *a: (route.fed.append(a), feed(*a))
    return route


def _model_bytes(km, d):
    km.save(d)
    return [(d / name).read_bytes() for name in ("header", "km.bin", "rest.bin")]


@pytest.mark.parametrize("n,ci", [(4, 1), (8, 1), (4, 2)])
def test_sharded_device_bloom_model_identical(tmp_path, monkeypatch, n, ci):
    """The mesh-built Bloom bank (per-shard scatter, OR of the local
    bitmaps) gives a model byte-identical to the host-insert build and to
    the JAX package's mesh build."""
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=600, seed=9)
    k = 19
    with monkeypatch.context() as mp:  # no bitmap fits: the host inserts
        mp.setattr(device_bloom, "MAX_BITMAP_BYTES", 0)
        km_host, _, _, st_host = count_encode(
            str(fq), k=k, ci=ci, accumulator="sharded", mesh=_cpu_mesh(n))
    assert "encode.bloom_insert" in st_host.phases
    km_mesh, _, _, st_mesh = count_encode(
        str(fq), k=k, ci=ci, accumulator="sharded", mesh=_cpu_mesh(n))
    assert "encode.bloom_insert" not in st_mesh.phases
    assert "encode.bloom_pull" in st_mesh.phases
    want = _model_bytes(km_host, tmp_path / "m_host")
    assert _model_bytes(km_mesh, tmp_path / "m_mesh") == want
    km_jax, _, _, _ = j_count_encode(str(fq), k=k, ci=ci,
                                     accumulator="sharded",
                                     mesh=jsharded.make_mesh(n))
    assert _model_bytes(km_jax, tmp_path / "m_jax") == want


@pytest.mark.parametrize("n,ci,cs", [(1, 1, 1023), (3, 1, 1023), (4, 2, 1023),
                                     (8, 2, 3)])
def test_sharded_builder_bytes_equal_host_insert(n, ci, cs):
    """The builder alone: a table split over the shards by the owner hash,
    one shard left empty; global_low_hist is the table's histogram and the
    filter bytes are the host insert's (of either package)."""
    rng = np.random.default_rng(40 + n + ci)
    k, nh = 23, 7
    kmers = np.unique(codec.canonical_np(
        rng.integers(0, 1 << (2 * k), 6000, dtype=np.uint64), k))
    counts = rng.integers(1, 9, len(kmers)).astype(np.uint32)
    mesh = _cpu_mesh(n + 1)  # the last shard holds nothing
    own = sharded.owner_of(kmers, n).numpy()
    us, cs_ = [], []
    for s in range(n):
        ku, kc = kmers[own == s], counts[own == s]
        pad = 7 * s
        us.append(torch.from_numpy(np.concatenate(
            [ku, np.full(pad, PAD)]).view(np.int64)))
        cs_.append(torch.from_numpy(np.concatenate(
            [kc, np.zeros(pad, np.uint32)]).view(np.int32)))
    us.append(None)
    cs_.append(None)
    clamped = np.minimum(counts, cs)
    want_hist = [int(np.count_nonzero(clamped == ci + i)) for i in range(3)]
    hist = ShardedDeviceBloomBuilder.global_low_hist(mesh, us, cs_, ci, cs)
    assert hist.tolist() == want_hist
    b = ShardedDeviceBloomBuilder(mesh, k, ci, cs, nh, hist)
    b.feed_table_sharded(us, cs_)
    got = BloomBank(hist, nh, ci)
    b.into(got)
    bf_num = 1 if ci == 1 else 3
    for bank_cls in (BloomBank, JBloomBank):
        host = bank_cls(np.asarray(hist, np.uint64), nh, ci)
        for i in range(bf_num):
            host.insert(i, kmers[clamped == ci + i], k)
            np.testing.assert_array_equal(got.bit_bf[i], host.bit_bf[i])
            np.testing.assert_array_equal(got.bit_bf_back[i],
                                          host.bit_bf_back[i])
    # and the single-device builder fed the whole table agrees
    one = DeviceBloomBuilder(k, ci, cs, nh, hist, device="cpu")
    one.feed_table(torch.from_numpy(kmers.view(np.int64)),
                   torch.from_numpy(counts.view(np.int32)), len(kmers))
    whole = BloomBank(hist, nh, ci)
    one.into(whole)
    for i in range(bf_num):
        np.testing.assert_array_equal(got.bit_bf[i], whole.bit_bf[i])


def test_sharded_device_bloom_skipped_when_spilled():
    """Spilled runs would be missed by the device feed: the builder does
    not engage and the table is whole."""
    mesh = _cpu_mesh(4)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(8, 64)).astype(np.uint8)
    acc = sharded.ShardedCountAccumulator(mesh, 19, 2, 64, spill_threshold=1)
    acc.add_batch(codes)
    route = _watched_route(19)
    total, hist, it = acc.finalize_stream(ci=1, route=route)
    assert route.bloom is None and not route.fed  # spilled -> host build
    got = np.concatenate([p[0] for p in it])
    flat = extract.extract_canonical(torch.from_numpy(codes), 19)[0]
    flat = flat.numpy().view(np.uint64)
    np.testing.assert_array_equal(got, np.unique(flat[flat != PAD]))


def test_sharded_device_bloom_skipped_on_finalize_time_spill():
    """The no-spill test comes AFTER the finalize's own device merge: the
    raw collapse there can cascade a merge over the spill threshold, and a
    builder fed only the surviving device runs would lose the spilled
    keys' low counts."""
    mesh = _cpu_mesh(2)
    k, rows, seg = 19, 2, 64
    rng = np.random.default_rng(17)
    acc = sharded.ShardedCountAccumulator(
        mesh, k, rows, seg, raw_tier_elems=1 << 60, spill_threshold=1 << 60)
    batches = [rng.integers(0, 4, size=(2 * rows, seg)).astype(np.uint8)
               for _ in range(11)]
    flats = []
    for cb in batches:
        flat = extract.extract_canonical(torch.from_numpy(cb), k)[0]
        flat = flat.numpy().view(np.uint64)
        flats.append(flat[flat != PAD])
    # per shard: a run of 6 batches, a run of 2 batches, 3 batches left raw
    for cb in batches[:6]:
        acc.add_batch(cb)
    for sh in acc.shards:
        sh._collapse_raw()
    for cb in batches[6:8]:
        acc.add_batch(cb)
    for sh in acc.shards:
        sh._collapse_raw()
    for cb in batches[8:]:
        acc.add_batch(cb)
    assert all(len(sh.runs) == 2 and sh.raw for sh in acc.shards)
    # the finalize-time cascade (2 + 3 batches -> one run) crosses this
    for sh in acc.shards:
        sh.spill_threshold = sh.runs[1][2] + 1
    route = _watched_route(k)
    total, hist, it = acc.finalize_stream(ci=1, route=route)
    assert acc.tier_events["host_spills"] > 0
    assert route.bloom is None and not route.fed, \
        "builder must not engage after a finalize-time spill"
    parts = list(it)
    got_k = np.concatenate([p[0] for p in parts])
    got_c = np.concatenate([p[1] for p in parts])
    want_k, want_c = np.unique(np.concatenate(flats), return_counts=True)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c.astype(np.uint32))
    assert total == len(want_k)


def test_oversized_mesh_bitmap_takes_the_host_build(tmp_path, monkeypatch):
    from kmcex_tpu_torch.model import device_bloom

    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=300, seed=2)
    km_mesh, _, _, _ = count_encode(str(fq), k=19, accumulator="sharded",
                                    mesh=_cpu_mesh(4))
    monkeypatch.setattr(device_bloom, "MAX_BITMAP_BYTES", 64)
    km, _, _, st = count_encode(str(fq), k=19, accumulator="sharded",
                                mesh=_cpu_mesh(4))
    assert "encode.bloom_insert" in st.phases
    assert (_model_bytes(km, tmp_path / "a")
            == _model_bytes(km_mesh, tmp_path / "b"))
