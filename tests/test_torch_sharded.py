"""The port's multi-shard counting (parallel/sharded.py) on CPU meshes of 4
and 8 shards in one process, against the JAX package on its virtual 8-device
CPU mesh and against the single-device accumulators, on the same
numpy-seeded inputs.  Everything is integers and bytes: every comparison is
exact (tolerance 0).  Tier events are compared with the port's own
expectation only: its raw tier counts received keys, so its collapses fall
at other batches than the JAX package's."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcex_tpu.count import device_lsm as jlsm
from kmcex_tpu.count import extract as jextract
from kmcex_tpu.count import pipeline as jpipe
from kmcex_tpu.parallel import sharded as jsharded
from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.count import device_lsm as tlsm
from kmcex_tpu_torch.count import extract as textract
from kmcex_tpu_torch.count import pipeline as tpipe
from kmcex_tpu_torch.parallel import sharded

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
FILES = ["db.kmc_pre", "db.kmc_suf", "m/header", "m/km.bin", "m/rest.bin"]


def _cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _random_codes(rng, rows, seg_len, n_rate=0.02):
    codes = rng.integers(0, 4, size=(rows, seg_len)).astype(np.uint8)
    codes[rng.random(codes.shape) < n_rate] = 255
    return codes


def _single_device(k, batches, ci=1, cs=0xFFFFFFFF):
    """The JAX package's single-device table of the same batches."""
    ref = jlsm.DeviceCountAccumulator(k)
    for b in batches:
        ref.add_batch(b)
    return ref.finalize(ci=ci, cs=cs)


def _write_reads(path, seed, n_reads, genome=20000, length=80):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.integers(0, 4, size=genome)
    with open(path, "wb") as f:
        for i, s in enumerate(rng.integers(0, genome - length, size=n_reads)):
            seq = bases[g[s : s + length]].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * length))
    return str(path)


# ----------------------------------------------------------------- owner_of
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_owner_of_equals_jax(n):
    rng = np.random.default_rng(n)
    keys = np.concatenate([
        rng.integers(0, 1 << 62, 5000, dtype=np.uint64),
        rng.integers(0, 1 << 63, 2000, dtype=np.uint64) | np.uint64(1 << 63),
        np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1], np.uint64),
        PAD - np.arange(0, 5, dtype=np.uint64),  # SENTINEL and its neighbours
    ])
    want = np.asarray(jsharded.owner_of(jnp.asarray(keys), n))
    got = sharded.owner_of(keys, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    as_tensor = sharded.owner_of(torch.from_numpy(keys.view(np.int64)), n)
    np.testing.assert_array_equal(as_tensor.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < n


def test_owner_balance():
    rng = np.random.default_rng(1)
    kmers = codec.canonical_np(
        rng.integers(0, 1 << 62, size=200000, dtype=np.uint64), 31)
    frac = np.bincount(sharded.owner_of(kmers, 8).numpy(), minlength=8) / len(kmers)
    assert frac.max() < 0.16 and frac.min() > 0.09  # ~0.125 each


def test_default_route_capacity_equals_jax():
    for args in ((64, 34, 8), (2048, 120, 4), (1, 5, 8), (4096, 226, 3)):
        assert (sharded.default_route_capacity(*args)
                == jsharded.default_route_capacity(*args))


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_mesh(4)
    m = _cpu_mesh(3)
    assert (m.n, m.local, m.world, m.rank) == (3, 3, 1, 0)
    assert m.shard_index(2) == 2


# ------------------------------------------------------------ sharded_count
@pytest.mark.parametrize("n", [4, 8])
def test_sharded_count_partitions_equal_jax(n):
    rng = np.random.default_rng(n)
    k = 21
    codes = _random_codes(rng, 64, 96)
    kmers, counts, parts, windows = sharded.sharded_count(
        codes, _cpu_mesh(n), k)
    jk, jc, jparts, jwindows = jsharded.sharded_count(
        codes, jsharded.make_mesh(n), k)
    assert windows == jwindows
    np.testing.assert_array_equal(kmers, jk)
    np.testing.assert_array_equal(counts, jc)
    assert len(parts) == len(jparts) == n
    for i, ((pk, pc), (qk, qc)) in enumerate(zip(parts, jparts)):
        np.testing.assert_array_equal(pk, np.asarray(qk))
        np.testing.assert_array_equal(pc, np.asarray(qc))
        if len(pk):
            assert (sharded.owner_of(pk, n).numpy() == i).all()

    # the single-device truth
    flat, n_valid = textract.extract_canonical(torch.from_numpy(codes), k)
    flat = flat.numpy().view(np.uint64)
    want_k, want_c = np.unique(flat[flat != PAD], return_counts=True)
    np.testing.assert_array_equal(kmers, want_k)
    np.testing.assert_array_equal(counts, want_c.astype(np.uint32))
    assert windows == int(n_valid)


# ------------------------------------------------------------- accumulator
@pytest.mark.parametrize("n", [3, 4, 8])
def test_sharded_accumulator_matches_single_device(n):
    rng = np.random.default_rng(11)
    k, rows, L = 19, 24, 72
    batches = [_random_codes(rng, rows, L) for _ in range(5)]
    acc = sharded.ShardedCountAccumulator(_cpu_mesh(n), k, rows // n, L)
    tref = tlsm.DeviceCountAccumulator(k, device="cpu")
    for codes in batches:
        acc.add_batch(codes)
        tref.add_batch(codes)
    got_k, got_c = acc.finalize(ci=1, cs=1023)
    want_k, want_c = _single_device(k, batches, ci=1, cs=1023)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    tk, tc = tref.finalize(ci=1, cs=1023)
    np.testing.assert_array_equal(got_k, tk)
    np.testing.assert_array_equal(got_c, tc)
    assert acc.reroutes == 0
    # valid windows, reduced at the finalize
    flat = np.concatenate([np.asarray(jextract.extract_canonical(b, k)[0])
                           for b in batches])
    assert acc.total_windows == int((flat != PAD).sum())


def test_sharded_accumulator_packed_equals_codes():
    rng = np.random.default_rng(13)
    k, n, rows, L = 17, 4, 16, 64
    batches = [_random_codes(rng, rows, L, n_rate=0.05) for _ in range(4)]
    a = sharded.ShardedCountAccumulator(_cpu_mesh(n), k, rows // n, L)
    b = sharded.ShardedCountAccumulator(_cpu_mesh(n), k, rows // n, L,
                                        packed=True)
    for codes in batches:
        a.add_batch(codes)
        packed, maskbits = textract.pack_codes_np(codes)
        b.add_batch_packed(packed, maskbits)
    ka, ca = a.finalize()
    kb, cb = b.finalize()
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(ca, cb)
    want_k, want_c = _single_device(k, batches)
    np.testing.assert_array_equal(ka, want_k)
    np.testing.assert_array_equal(ca, want_c)


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_accumulator_tiers_and_spill(n):
    """The raw tier, the per-shard LSM merges (the port's _merge_runs) and
    the host spill path agree with the single-device accumulator — forced
    by tiny thresholds."""
    rng = np.random.default_rng(23)
    k, rows, L = 15, 16, 48
    batches = [_random_codes(rng, rows, L) for _ in range(9)]
    acc = sharded.ShardedCountAccumulator(
        _cpu_mesh(n), k, rows // n, L, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=0)
    for codes in batches:
        acc.add_batch(codes)
    assert any(acc.host_runs), "spill threshold should have triggered"
    ev = acc.tier_events
    assert ev["raw_collapses"] > 0 and ev["device_merges"] > 0
    assert ev["host_spills"] > 0 and ev["disk_spills"] == 0
    assert acc.spill_stats["copy_bytes"] > 0
    got_k, got_c = acc.finalize(ci=2, cs=255)
    want_k, want_c = _single_device(k, batches, ci=2, cs=255)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("flavour", ["finalize_stream", "finalize"])
def test_sharded_disk_spill_tier(tmp_path, flavour):
    """Tiny thresholds force the DISK tier; both finalize flavours agree
    with the single-device accumulator, and nothing is left on disk."""
    rng = np.random.default_rng(29)
    k, n, rows, L = 15, 8, 16, 48
    batches = [_random_codes(rng, rows, L) for _ in range(9)]
    acc = sharded.ShardedCountAccumulator(
        _cpu_mesh(n), k, rows // n, L, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=2048, disk_dir=str(tmp_path / "lsm"))
    for codes in batches:
        acc.add_batch(codes)
    assert any(acc.disk_runs), "disk tier never engaged"
    names = sorted(os.listdir(tmp_path / "lsm"))
    assert names and all(
        len(x) == len("s000_run0000.bin") and x.startswith("s")
        and x[4:8] == "_run" for x in names)
    assert acc.tier_events["disk_spills"] == sum(map(len, acc.disk_runs))
    want_k, want_c = _single_device(k, batches)
    if flavour == "finalize":
        got_k, got_c = acc.finalize(ci=1)
    else:
        total, hist, chunks = acc.finalize_stream(ci=1, cs=0xFFFFFFFF)
        got_k, got_c, prev_last = [], [], -1
        for ku, kc in chunks:
            assert int(ku[0]) > prev_last  # globally ascending stream
            prev_last = int(ku[-1])
            got_k.append(ku)
            got_c.append(kc)
        got_k, got_c = np.concatenate(got_k), np.concatenate(got_c)
        assert total == len(want_k)
        for i in range(3):
            assert hist[i] == int(np.count_nonzero(want_c == 1 + i))
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert not any(acc.disk_runs) and acc._disk_dir is None, "disk not cleaned"
    assert os.listdir(tmp_path / "lsm") == []


def test_finalize_single_merge_traversal(tmp_path, monkeypatch):
    """The out-of-core finalize traverses the k-way merge ONCE (stats
    computed while spooling)."""
    rng = np.random.default_rng(31)
    k, n, rows, L = 15, 8, 16, 48
    acc = sharded.ShardedCountAccumulator(
        _cpu_mesh(n), k, rows // n, L, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=2048, disk_dir=str(tmp_path / "lsm"))
    for _ in range(9):
        acc.add_batch(_random_codes(rng, rows, L))
    calls = []
    orig = tlsm.DeviceCountAccumulator._merge_streams

    def counting(runs, chunk_elems=1 << 22):
        calls.append(1)
        return orig(runs, chunk_elems)

    monkeypatch.setattr(tlsm.DeviceCountAccumulator, "_merge_streams",
                        staticmethod(counting))
    total, hist, it = acc.finalize_stream(ci=1)
    for _ in it:
        pass
    assert sum(calls) == 1


def test_route_poly_a_skew_loses_nothing():
    """Degenerate input (every window the same k-mer, so one owner shard):
    the JAX package overflows its routing buffers and re-routes; the port
    sends real sizes, so nothing overflows and ``reroutes`` stays 0."""
    k, n, rows, L = 15, 8, 512, 48
    codes = np.full((rows, L), 1, dtype=np.uint8)  # poly-C reads
    assert (sharded.default_route_capacity(rows // n, L - k + 1, n)
            < (rows // n) * (L - k + 1)), "the JAX package would re-route"
    acc = sharded.ShardedCountAccumulator(_cpu_mesh(n), k, rows // n, L)
    acc.add_batch(codes)
    assert acc.reroutes == 0
    sizes = [sum(r.numel() for r in sh.raw) for sh in acc.shards]
    assert sorted(sizes)[:-1] == [0] * (n - 1)  # all on one shard
    got_k, got_c = acc.finalize(ci=1)
    want_k, want_c = _single_device(k, [codes])
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert len(got_k) == 1 and got_c[0] == rows * (L - k + 1)


def test_route_sentinel_flood_loses_nothing():
    """A batch that is MOSTLY invalid windows (partial tail buffers, N-rich
    reads): SENTINELs are never sent, and the real k-mer planted in the
    first window of every shard's rows survives."""
    rng = np.random.default_rng(37)
    k, n, rows, L = 15, 8, 512, 48
    codes = np.full((rows, L), 255, dtype=np.uint8)
    per_dev = rows // n
    probe = rng.integers(0, 4, size=k).astype(np.uint8)
    for d in range(n):
        codes[d * per_dev, :k] = probe
    sprinkle = _random_codes(rng, rows, L, n_rate=0.0)
    pick = rng.random(codes.shape) < 0.02
    codes[pick] = sprinkle[pick]
    acc = sharded.ShardedCountAccumulator(_cpu_mesh(n), k, per_dev, L)
    acc.add_batch(codes)
    assert acc.reroutes == 0
    flat = np.asarray(jextract.extract_canonical(codes, k)[0])
    n_real = int((flat != PAD).sum())
    assert sum(r.numel() for sh in acc.shards for r in sh.raw) == n_real
    assert n_real < len(flat) // 10
    got_k, got_c = acc.finalize(ci=1)
    want_k, want_c = _single_device(k, [codes])
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


def test_rows_must_divide_the_local_shards():
    acc = sharded.ShardedCountAccumulator(_cpu_mesh(4), 9, 2, 32)
    with pytest.raises(ValueError, match="divide"):
        acc.add_batch(np.zeros((6, 32), np.uint8))


# --------------------------------------------------------------- pipelines
@pytest.mark.parametrize("n", [4, 8])
def test_count_fastq_sharded_end_to_end(tmp_path, n):
    """FASTQ -> packed segments -> sharded extract and exchange -> per-shard
    LSM -> streaming finalize through count_fastq(accumulator="sharded"),
    equal to the JAX package's sharded and device pipelines."""
    fq = _write_reads(tmp_path / "reads.fastq", 5, 3000)
    k = 21
    sk, sc, sstats = tpipe.count_fastq(fq, k=k, ci=1, cs=1023, batch_segs=512,
                                       accumulator="sharded",
                                       mesh=_cpu_mesh(n))
    dk, dc, dstats = jpipe.count_fastq(fq, k=k, ci=1, cs=1023, batch_segs=512,
                                       accumulator="device")
    np.testing.assert_array_equal(sk, dk)
    np.testing.assert_array_equal(sc, dc)
    # sharded counts VALID windows; single-device counts window slots
    assert sstats.windows == 3000 * (80 - k + 1)
    assert dstats.windows >= sstats.windows
    assert sstats.reads == dstats.reads == 3000
    assert sstats.bases == dstats.bases
    if n == 8:
        jk, jc, jstats = jpipe.count_fastq(
            fq, k=k, ci=1, cs=1023, batch_segs=512, accumulator="sharded",
            mesh=jsharded.make_mesh(8))
        np.testing.assert_array_equal(sk, jk)
        np.testing.assert_array_equal(sc, jc)
        assert (sstats.windows, sstats.reads) == (jstats.windows, jstats.reads)


def _tiny_thresholds(monkeypatch):
    for cls in (sharded.ShardedCountAccumulator,
                jsharded.ShardedCountAccumulator):
        monkeypatch.setattr(cls, "RAW_TIER_ELEMS", 4096)
        monkeypatch.setattr(cls, "SPILL_THRESHOLD", 8192)
        monkeypatch.setattr(cls, "DISK_SPILL_BYTES", 4096)
    monkeypatch.setenv("KMCEX_DISK_SPILL_BYTES", "4096")


def _build(mod, fq, d, **kw):
    d.mkdir()
    km, kk, cc, st = mod.count_encode(fq, 21, 1, 1023, 7, 5, None, 512, True,
                                      str(d / "db"), **kw)
    km.save(d / "m")
    return kk, cc, st, [(d / f).read_bytes() for f in FILES]


def test_genome_scale_e2e_sharded_disk_to_model(tmp_path, monkeypatch):
    """Sharded count -> per-shard DISK-spilled runs -> one-pass streaming
    finalize -> streaming encode + streaming KMC1 writer: model and DB bytes
    identical to the in-RAM single-device build of either package, and the
    host inserted the Bloom bank (the mesh build must not engage)."""
    fq = _write_reads(tmp_path / "reads.fastq", 8, 4000, genome=30000)
    _tiny_thresholds(monkeypatch)
    gk, gc, gst, gfiles = _build(tpipe, fq, tmp_path / "sharded",
                                 accumulator="sharded", mesh=_cpu_mesh(8))
    assert gst.tiers["disk_spills"] > 0 and gst.tiers["host_spills"] > 0
    assert "encode.bloom_insert" in gst.phases
    monkeypatch.undo()
    wk, wc, wst, wfiles = _build(jpipe, fq, tmp_path / "jax_device")
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    assert gfiles == wfiles
    assert gst.distinct_kmers == len(wk)
    tk, tc, _, tfiles = _build(tpipe, fq, tmp_path / "torch_device",
                               device="cpu")
    assert gfiles == tfiles


@pytest.mark.parametrize("n", [4, 8])
def test_count_encode_sharded_files_equal_jax_and_device(tmp_path, n):
    """count_encode(accumulator="sharded") on a CPU mesh: the five files
    equal the JAX package's sharded build, the JAX device build and the
    port's device build; the mesh Bloom build ran (no host insert)."""
    fq = _write_reads(tmp_path / "reads.fastq", 6, 2500)
    gk, gc, gst, gfiles = _build(tpipe, fq, tmp_path / "sharded",
                                 accumulator="sharded", mesh=_cpu_mesh(n))
    assert "encode.bloom_insert" not in gst.phases
    jk, jc, jst, jfiles = _build(jpipe, fq, tmp_path / "jax_sharded",
                                 accumulator="sharded",
                                 mesh=jsharded.make_mesh(n))
    assert gfiles == jfiles
    np.testing.assert_array_equal(gk, jk)
    np.testing.assert_array_equal(gc, jc)
    assert (gst.reads, gst.bases, gst.windows, gst.distinct_kmers) == \
        (jst.reads, jst.bases, jst.windows, jst.distinct_kmers)
    _, _, _, dfiles = _build(tpipe, fq, tmp_path / "torch_device",
                             device="cpu")
    assert gfiles == dfiles
    if n == 4:
        _, _, _, jd = _build(jpipe, fq, tmp_path / "jax_device")
        assert gfiles == jd


def test_cli_accsharded_equals_accdevice(tmp_path):
    import kmcex_tpu_torch.cli as torch_cli

    fq = _write_reads(tmp_path / "reads.fastq", 3, 1500)
    out = {}
    for kind in ("device", "sharded"):
        wd = tmp_path / kind
        wd.mkdir()
        assert torch_cli.main(["kmcex", "-k21", f"-acc{kind}", fq,
                               str(wd / "o.res"), str(wd)], device="cpu") == 0
        out[kind] = [(wd / f).read_bytes() for f in
                     ("o.res.kmc_pre", "o.res.kmc_suf", "o.res/header",
                      "o.res/km.bin", "o.res/rest.bin")]
    assert out["device"] == out["sharded"]


# -------------------------------------------------------------- checkpoint
def test_sharded_checkpoint_resume(tmp_path):
    """Mid-count checkpoint -> restore on a fresh mesh accumulator ->
    continue == straight through; a mesh of another size is refused."""
    rng = np.random.default_rng(67)
    k, n, rows, L = 15, 8, 16, 48
    batches = [_random_codes(rng, rows, L) for _ in range(6)]
    want_k, want_c = _single_device(k, batches)
    mesh = _cpu_mesh(n)
    acc = sharded.ShardedCountAccumulator(mesh, k, rows // n, L,
                                          raw_tier_elems=64,
                                          spill_threshold=256)
    for b in batches[:3]:
        acc.add_batch(b)
    ck = tmp_path / "ck"
    acc.checkpoint(str(ck), extra={"n_batches": 3})
    m = sharded.ShardedCountAccumulator.read_manifest(str(ck))
    assert set(m) == {"k", "n_shards", "seg_rows", "seg_len", "total_windows",
                      "gen", "shard_files", "extra"}
    assert (m["n_shards"], m["seg_rows"], m["seg_len"], m["gen"]) == \
        (n, rows // n, L, 0)
    assert m["extra"] == {"n_batches": 3} and len(m["shard_files"]) == n
    assert all(f.startswith(f"g0000_s{s:03d}_run")
               for s, fs in enumerate(m["shard_files"]) for f in fs)
    res = sharded.ShardedCountAccumulator.restore(
        mesh, str(ck), raw_tier_elems=64, spill_threshold=256)
    assert res.total_windows == m["total_windows"] > 0
    for b in batches[3:]:
        res.add_batch(b)
    # a second checkpoint writes a new generation and prunes the first
    res.checkpoint(str(ck))
    left = [x for x in os.listdir(ck) if x.endswith(".bin")]
    assert left and all(x.startswith("g0001_") for x in left)
    got_k, got_c = res.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    # the original accumulator goes on counting after its checkpoint too
    for b in batches[3:]:
        acc.add_batch(b)
    k2, c2 = acc.finalize(ci=1)
    np.testing.assert_array_equal(k2, want_k)
    np.testing.assert_array_equal(c2, want_c)
    with pytest.raises(ValueError, match="shards"):
        sharded.ShardedCountAccumulator.restore(_cpu_mesh(4), str(ck))
    assert sharded.ShardedCountAccumulator.read_manifest(
        str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_checkpoint_crosses_packages(tmp_path, writer):
    """A sharded checkpoint written by one package restores in the other on
    a mesh of the same n, disk runs included, and counting continues to the
    same table."""
    rng = np.random.default_rng(71)
    k, n, rows, L = 15, 4, 16, 48
    batches = [_random_codes(rng, rows, L) for _ in range(8)]
    want_k, want_c = _single_device(k, batches)
    kw = dict(raw_tier_elems=64, spill_threshold=256, disk_spill_bytes=2048)
    jmesh, tmesh = jsharded.make_mesh(n), _cpu_mesh(n)
    ck = str(tmp_path / "ck")
    if writer == "jax":
        first = jsharded.ShardedCountAccumulator(
            jmesh, k, rows // n, L, disk_dir=str(tmp_path / "d1"), **kw)
    else:
        first = sharded.ShardedCountAccumulator(
            tmesh, k, rows // n, L, disk_dir=str(tmp_path / "d1"), **kw)
    for b in batches[:5]:
        first.add_batch(b)
    assert any(first.disk_runs)
    first.checkpoint(ck, extra={"n_batches": 5})
    with open(os.path.join(ck, "manifest.json")) as f:
        m = json.load(f)
    assert any("_disk_" in name for fs in m["shard_files"] for name in fs)
    if writer == "jax":
        second = sharded.ShardedCountAccumulator.restore(
            tmesh, ck, disk_dir=str(tmp_path / "d2"), **kw)
    else:
        second = jsharded.ShardedCountAccumulator.restore(
            jmesh, ck, disk_dir=str(tmp_path / "d2"), **kw)
    assert second.total_windows == m["total_windows"]
    for b in batches[5:]:
        second.add_batch(b)
    got_k, got_c = second.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    first.close()


@pytest.mark.parametrize("crash_with,resume_with",
                         [("torch", "torch"), ("jax", "torch"),
                          ("torch", "jax")])
def test_count_encode_sharded_ckpt_resume(tmp_path, monkeypatch, crash_with,
                                          resume_with):
    """count_encode(accumulator="sharded", ckpt_dir=...): an injected crash
    leaves a manifest, the rerun (by either package) skips the counted
    batches and writes the bytes of an uninterrupted build."""
    fq = _write_reads(tmp_path / "reads.fastq", 9, 3000)
    n = 4
    mesh = {"torch": _cpu_mesh(n), "jax": jsharded.make_mesh(n)}
    mods = {"torch": tpipe, "jax": jpipe}
    ck = str(tmp_path / "ck")
    _, _, _, want = _build(tpipe, fq, tmp_path / "straight", device="cpu")
    monkeypatch.setenv("KMCEX_CKPT_EVERY", "2")
    monkeypatch.setenv("KMCEX_CRASH_AFTER_BATCHES", "5")
    with pytest.raises(RuntimeError, match="injected crash"):
        _build(mods[crash_with], fq, tmp_path / "crash",
               accumulator="sharded", mesh=mesh[crash_with], ckpt_dir=ck)
    m = sharded.ShardedCountAccumulator.read_manifest(ck)
    assert m["extra"]["n_batches"] == 4 and m["n_shards"] == n
    assert m["extra"]["fingerprint"]["accumulator"] == "sharded"
    monkeypatch.delenv("KMCEX_CRASH_AFTER_BATCHES")
    _, _, st, got = _build(mods[resume_with], fq, tmp_path / "resume",
                           accumulator="sharded", mesh=mesh[resume_with],
                           ckpt_dir=ck)
    assert got == want
    if resume_with == "torch":
        assert st.skipped_batches == 4
    assert sharded.ShardedCountAccumulator.read_manifest(ck) is None
