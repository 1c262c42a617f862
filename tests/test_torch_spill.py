"""The port's out-of-core count path (count/device_lsm.py host and disk
levels, count/counter.py, pipeline.count_fastq) on the CPU against the JAX
package's, on the same numpy-seeded inputs and the same forced thresholds.
Everything is integers and bytes: the comparison is exact (tolerance 0).

Where the JAX accumulator is the reference it runs as its own tests run it
on the CPU (the plain lax.sort route; no Pallas kernel engages there)."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcex_tpu import native as jnative
from kmcex_tpu.count import counter as jcounter
from kmcex_tpu.count import device_lsm as jlsm
from kmcex_tpu.count import pipeline as jpipe
from kmcex_tpu.model.kmodel import get_model as jget_model
from kmcex_tpu_torch import native as tnative
from kmcex_tpu_torch.count import counter as tcounter
from kmcex_tpu_torch.count import device_lsm as tlsm
from kmcex_tpu_torch.count import pipeline as tpipe
from kmcex_tpu_torch.model.device_bloom import DeviceBloomBuilder
from kmcex_tpu_torch.model.kmodel import get_model as tget_model
from kmcex_tpu_torch.model.route import BuildRoute

JaxAcc = jlsm.DeviceCountAccumulator
TorchAcc = tlsm.DeviceCountAccumulator
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def _batches(seed, n, rows, L, n_frac=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = rng.integers(0, 4, size=(rows, L)).astype(np.uint8)
        if n_frac:
            codes[rng.random(codes.shape) < n_frac] = 255
        out.append(codes)
    return out


def _both(k, batches, **kw):
    """The same batches through a JAX and a port accumulator."""
    jacc = JaxAcc(k, **kw)
    tacc = TorchAcc(k, device="cpu", **kw)
    for codes in batches:
        jacc.add_batch(codes)
        tacc.add_batch(codes)
    return jacc, tacc


def _drain(result):
    total, hist, chunks = result
    parts = list(chunks)
    ks = (np.concatenate([p[0] for p in parts]) if parts
          else np.zeros(0, np.uint64))
    cs_ = (np.concatenate([p[1] for p in parts]) if parts
           else np.zeros(0, np.uint32))
    return total, np.asarray(hist, dtype=np.int64), ks, cs_.astype(np.uint32)


def _assert_same(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


# ---------------------------------------------------------------- merges
def _unique_run(rng, n, pad, hi=1 << 20, cmax=50):
    k = np.sort(rng.choice(hi, size=n, replace=False)).astype(np.uint64)
    c = rng.integers(1, cmax, n).astype(np.uint32)
    return (np.concatenate([k, np.full(pad, PAD)]),
            np.concatenate([c, np.zeros(pad, np.uint32)]))


def _merge_cases():
    rng = np.random.default_rng(5)
    a = _unique_run(rng, 300, 212, hi=600)   # dense key space: many ties
    b = _unique_run(rng, 200, 56, hi=600)
    yield "ties_and_pads", a, b
    yield "all_ties", a, a
    yield "no_pads", _unique_run(rng, 256, 0), _unique_run(rng, 128, 0)
    yield "empty_b", a, (np.full(64, PAD), np.zeros(64, np.uint32))
    yield "both_empty", (np.full(8, PAD), np.zeros(8, np.uint32)), \
        (np.full(8, PAD), np.zeros(8, np.uint32))
    yield "zero_length", a, (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
    # k = 32 keys with bit 63 set: unsigned order at the int64 seam
    top = (np.array([3, 1 << 63, (1 << 63) + 5, PAD - np.uint64(1)], np.uint64),
           np.array([1, 2, 3, 4], np.uint32))
    yield "high_bit", top, (np.array([1 << 63, PAD], np.uint64),
                            np.array([7, 0], np.uint32))
    # sums that cross 2^31 and 2^32: both packages hold the count column as
    # 32 unsigned bits and saturate at 2^32-1
    big = (np.array([10, 20, 30, PAD], np.uint64),
           np.array([(1 << 31) - 2, 1 << 30, 5, 0], np.uint32))
    yield "near_clamp", big, (np.array([10, 20, 40, PAD], np.uint64),
                              np.array([(1 << 31) - 3, 1 << 30, 9, 0],
                                       np.uint32))
    huge = (np.array([1, 2, 3, 4, PAD], np.uint64),
            np.array([0xFFFFFFF0, 1 << 31, 0xFFFFFFFF, 3_000_000_000, 0],
                     np.uint32))
    yield "cross_2_32", huge, (np.array([1, 2, 3, 5, PAD], np.uint64),
                               np.array([0x20, 1 << 31, 1, 7, 0], np.uint32))


@pytest.mark.parametrize("name,a,b", list(_merge_cases()),
                         ids=[c[0] for c in _merge_cases()])
def test_merge_runs_equals_jax_on_unique_runs(name, a, b):
    """_merge_runs (no prefix sum: a key occurs at most twice) against the
    JAX _merge_runs_kernel on sorted unique runs."""
    (ka, ca), (kb, cb) = a, b
    wu, wc, wn = jlsm._merge_runs_kernel(jnp.asarray(ka), jnp.asarray(ca),
                                         jnp.asarray(kb), jnp.asarray(cb))
    gu, gc, gn = tlsm._merge_runs(
        torch.from_numpy(ka.view(np.int64)), torch.from_numpy(ca.view(np.int32)),
        torch.from_numpy(kb.view(np.int64)), torch.from_numpy(cb.view(np.int32)))
    assert int(gn) == int(wn)
    np.testing.assert_array_equal(gu.numpy().view(np.uint64), np.asarray(wu))
    np.testing.assert_array_equal(gc.numpy().view(np.uint32), np.asarray(wc))
    if name == "near_clamp":
        assert gc.numpy().view(np.uint32)[0] == (1 << 32) - 5  # past 2^31
    if name == "cross_2_32":
        np.testing.assert_array_equal(
            gc.numpy().view(np.uint32)[:5],
            [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 3_000_000_000, 7])


def test_native_merge_runs_equals_jax_and_takes_memmaps(tmp_path):
    rng = np.random.default_rng(3)
    ka, ca = _unique_run(rng, 500, 0, hi=900)
    kb, cb = _unique_run(rng, 400, 0, hi=900)
    ca[0] = cb[0] = 0xFFFFFFF0  # u32 saturation when the first keys tie
    kb[0] = ka[0]
    kb.sort()
    want = jnative.merge_runs(ka, ca, kb, cb)
    got = tnative.merge_runs(ka, ca, kb, cb)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # read-only memmaps, as a restored checkpoint holds them
    tlsm.write_run_file(str(tmp_path / "a.bin"), ka, ca)
    ma, mc = tlsm.open_run_file(str(tmp_path / "a.bin"))
    assert not ma.flags.writeable
    got = tnative.merge_runs(ma, mc, kb, cb)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tnative.murmur64(b"ACGTACGT", 7) == jnative.murmur64(b"ACGTACGT", 7)


def test_segment_buffer_equals_jax():
    data = np.frombuffer(b"@r\nACGTNACGTACGTAC\n+\nIIIIIIIIIIIIIIII\n", np.uint8)
    outs = []
    for seg in (jnative.segment_buffer,
                lambda *a: tnative.segment(*a)[:5]):
        rows = np.full((8, 8), 255, np.uint8)
        outs.append((seg(data, False, 0, 4, 8, rows), rows))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_merge_streams_equals_np_unique():
    rng = np.random.default_rng(12)
    runs, allk, allc = [], [], []
    for n in (900, 40, 0, 333, 1200):
        k, c = _unique_run(rng, n, 0, hi=2500)
        runs.append((k, c))
        allk.append(k)
        allc.append(c)
    allk, allc = np.concatenate(allk), np.concatenate(allc)
    want_k, inv = np.unique(allk, return_inverse=True)
    want_c = np.bincount(inv, weights=allc).astype(np.uint32)
    for mod, acc in ((jlsm, JaxAcc), (tlsm, TorchAcc)):
        parts = list(acc._merge_streams(runs, chunk_elems=128))
        assert len(parts) > 3  # the windowing really stepped
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                      want_k)
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                      want_c)


# ----------------------------------------------------------- host level
def test_constructor_reads_the_environment(monkeypatch):
    monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "777")
    monkeypatch.setenv("KMCEX_SPILL_THRESHOLD", "4096")
    monkeypatch.setenv("KMCEX_DISK_SPILL_BYTES", "0")
    j, t = JaxAcc(17), TorchAcc(17, device="cpu")
    for name in ("raw_tier_elems", "spill_threshold", "disk_spill_bytes"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.disk_spill_bytes == 0
    monkeypatch.delenv("KMCEX_SPILL_THRESHOLD")
    monkeypatch.delenv("KMCEX_DISK_SPILL_BYTES")
    t = TorchAcc(17, device="cpu")
    assert t.spill_threshold == JaxAcc.SPILL_THRESHOLD == TorchAcc.SPILL_THRESHOLD
    assert t.disk_spill_bytes == JaxAcc.DISK_SPILL_BYTES
    assert TorchAcc(17, spill_threshold=9, disk_spill_bytes=5,
                    device="cpu").disk_spill_bytes == 5


def test_add_batch_equals_packed_and_jax():
    """tests/test_device_lsm.py: accumulator vs numpy, packed vs unpacked."""
    k = 17
    batches = _batches(0, 7, 64, 80, n_frac=0.03)
    jacc, tacc = _both(k, batches)
    tacc2 = TorchAcc(k, device="cpu")
    from kmcex_tpu_torch.count.extract import pack_codes_np

    for codes in batches:
        p, m = pack_codes_np(codes)
        tacc2.add_batch_packed(torch.from_numpy(p), torch.from_numpy(m))
    wk, wc = jacc.finalize(ci=1)
    gk, gc = tacc.finalize(ci=1)
    pk, pc = tacc2.finalize(ci=1)
    assert gk.dtype == np.uint64 and gc.dtype == np.uint32
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(pk, wk)
    np.testing.assert_array_equal(pc, wc)
    assert tacc.total_windows == jacc.total_windows


@pytest.mark.parametrize("ci,cs", [(1, 1023), (2, 9), (3, 5)])
def test_spill_to_host_equals_jax(ci, cs):
    """tests/test_device_lsm.py::test_spill_to_host_matches and
    ::test_spill_finalize_stream_matches, both packages side by side."""
    k = 17
    batches = _batches(9, 6, 32, 80)
    batches += batches[:2]  # multiplicities straddle the ci thresholds
    kw = dict(raw_tier_elems=2000, spill_threshold=4096)
    jacc, tacc = _both(k, batches, **kw)
    assert tacc.host_runs, "spill did not trigger"
    assert tacc.tier_events == jacc.tier_events
    assert tacc.tier_events["host_spills"] > 0
    assert [len(r[0]) for r in tacc.host_runs] == \
        [len(r[0]) for r in jacc.host_runs]
    for (tk, tc), (jk, jc) in zip(tacc.host_runs, jacc.host_runs):
        assert tk.dtype == np.uint64 and tc.dtype == np.uint32
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tc, jc)
    assert tacc.spill_stats["copy_bytes"] > 0
    want = _drain(jacc.finalize_stream(ci=ci, cs=cs))
    route = BuildRoute(tget_model(ci, cs, 7, 5), k, keep_low=True)
    got = _drain(tacc.finalize_stream(ci=ci, cs=cs, route=route))
    _assert_same(got, want)
    assert route.bloom is None and route.encoder is None
    # finalize() against finalize_stream(), and against the unspilled build
    jacc2, tacc2 = _both(k, batches, **kw)
    fk, fc = tacc2.finalize(ci=ci, cs=cs)
    np.testing.assert_array_equal(fk, want[2])
    np.testing.assert_array_equal(fc, want[3])
    plain = TorchAcc(k, device="cpu")
    for codes in batches:
        plain.add_batch(codes)
    assert not plain.host_runs
    _assert_same(_drain(plain.finalize_stream(ci=ci, cs=cs)), want)


def test_host_route_n_chunks():
    k = 17
    batches = _batches(10, 6, 32, 80)
    acc = TorchAcc(k, raw_tier_elems=2000, spill_threshold=4096, device="cpu")
    for codes in batches:
        acc.add_batch(codes)
    total, hist, chunks = acc.finalize_stream(ci=1, cs=1023, n_chunks=5)
    parts = list(chunks)
    assert len(parts) == 5
    assert sum(len(p[0]) for p in parts) == total


# ----------------------------------------------------------- disk level
@pytest.mark.parametrize("flavour", ["finalize_stream", "finalize"])
def test_disk_spill_equals_jax(tmp_path, flavour):
    """tests/test_device_lsm.py::test_disk_spill_tier: tiny thresholds force
    every run through the disk tier; both finalize flavours."""
    k = 15
    batches = _batches(42, 6, 48, 60)
    kw = dict(raw_tier_elems=1500, spill_threshold=1024, disk_spill_bytes=4096)
    jacc = JaxAcc(k, disk_dir=str(tmp_path / "j"), **kw)
    tacc = TorchAcc(k, disk_dir=str(tmp_path / "t"), device="cpu", **kw)
    for codes in batches:
        jacc.add_batch(codes)
        tacc.add_batch(codes)
    assert tacc.disk_runs, "disk tier never engaged"
    assert tacc.tier_events == jacc.tier_events
    assert tacc.tier_events["disk_spills"] > 0
    # run files cross between the packages byte for byte
    for tp, jp in zip(tacc.disk_runs, jacc.disk_runs):
        assert open(tp, "rb").read() == open(jp, "rb").read()
    if flavour == "finalize_stream":
        want = _drain(jacc.finalize_stream(ci=1, cs=0xFFFFFFFF))
        got = _drain(tacc.finalize_stream(ci=1, cs=0xFFFFFFFF))
        _assert_same(got, want)
        assert tacc.spill_stats["merge_pass_seconds"] > 0
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ResourceWarning)
            wk, wc = jacc.finalize(ci=1)
            with pytest.warns(ResourceWarning, match="finalize_stream"):
                gk, gc = tacc.finalize(ci=1)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)
    # a disk_dir the caller passed stays, and holds no file any more
    assert os.listdir(tmp_path / "t") == []


def test_disk_spill_ci_filter_equals_jax(tmp_path):
    """tests/test_device_lsm.py::test_disk_spill_ci_filter."""
    k = 13
    batches = _batches(9, 4, 40, 50)
    kw = dict(raw_tier_elems=900, spill_threshold=512, disk_spill_bytes=2048)
    jacc = JaxAcc(k, disk_dir=str(tmp_path / "j"), **kw)
    tacc = TorchAcc(k, disk_dir=str(tmp_path / "t"), device="cpu", **kw)
    for codes in batches:
        jacc.add_batch(codes)
        tacc.add_batch(codes)
    assert tacc.disk_runs
    want = _drain(jacc.finalize_stream(ci=2, cs=3))
    got = _drain(tacc.finalize_stream(ci=2, cs=3))
    _assert_same(got, want)
    assert len(got[2]) and (got[3] >= 2).all() and (got[3] <= 3).all()


def test_close_leaves_no_file(tmp_path, monkeypatch):
    """An owned mkdtemp directory goes with close(); the merged files go
    when the chunk iterator ends; close() is idempotent."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    k = 15
    batches = _batches(7, 6, 48, 60)
    kw = dict(raw_tier_elems=1500, spill_threshold=1024, disk_spill_bytes=4096,
              device="cpu")
    acc = TorchAcc(k, **kw)
    for codes in batches:
        acc.add_batch(codes)
    (owned,) = [p for p in tmp_path.iterdir()]
    assert owned.name.startswith("kmcex_lsm_") and list(owned.iterdir())
    acc.close()
    acc.close()
    assert list(tmp_path.iterdir()) == []
    # through the finalize: run files go after the merge pass, the merged
    # files and the directory when the iterator is exhausted
    acc = TorchAcc(k, **kw)
    for codes in batches:
        acc.add_batch(codes)
    total, _, chunks = acc.finalize_stream()
    (owned,) = [p for p in tmp_path.iterdir()]
    assert sorted(p.name for p in owned.iterdir()) == ["merged_c.bin",
                                                       "merged_k.bin"]
    assert sum(len(ku) for ku, _ in chunks) == total > 0
    assert list(tmp_path.iterdir()) == []
    # an abandoned iterator cleans up when closed
    acc = TorchAcc(k, **kw)
    for codes in batches:
        acc.add_batch(codes)
    _, _, chunks = acc.finalize_stream()
    next(chunks)
    chunks.close()
    assert list(tmp_path.iterdir()) == []


def test_finalize_refuses_a_table_beyond_ram(tmp_path):
    acc = TorchAcc(15, raw_tier_elems=1500, spill_threshold=1024,
                   disk_spill_bytes=4096, disk_dir=str(tmp_path), device="cpu")
    for codes in _batches(1, 6, 48, 60):
        acc.add_batch(codes)
    assert acc.disk_runs
    real = acc._open_disk_run
    acc._open_disk_run = lambda p: (np.broadcast_to(np.uint64(0), (1 << 30,)),
                                    real(p)[1])
    with pytest.raises(MemoryError, match="finalize_stream"):
        acc.finalize()
    acc.close()


# ------------------------------------------- finalize-time spill + Bloom
def _stage_finalize_time_spill(acc, batches):
    """Two device runs and a raw remainder; the spill threshold is then set
    so that only the merge cascade inside finalize_stream crosses it."""
    for cb in batches[:6]:
        acc.add_batch(cb)
    acc._collapse_raw()
    for cb in batches[6:8]:
        acc.add_batch(cb)
    acc._collapse_raw()
    for cb in batches[8:]:
        acc.add_batch(cb)
    assert len(acc.runs) == 2 and acc.raw and not acc.host_runs
    acc.spill_threshold = acc.runs[1][2] * 2


def test_finalize_time_spill_with_bloom_factory(tmp_path):
    """A run that spills only in the finalize-time merge: the device Bloom
    build must not engage, and the model must be the host-insert model byte
    for byte (the JAX package's, built from the same chunks)."""
    k, ci, cs, nh, nb = 19, 1, 1023, 7, 5
    batches = _batches(17, 11, 4, 64)
    jacc = JaxAcc(k, raw_tier_elems=1 << 60, spill_threshold=1 << 60)
    tacc = TorchAcc(k, raw_tier_elems=1 << 60, spill_threshold=1 << 60,
                    device="cpu")
    _stage_finalize_time_spill(jacc, batches)
    _stage_finalize_time_spill(tacc, batches)
    tkm = tget_model(ci, cs, nh, nb)
    # a model-only route: it would drop the low pairs on the device
    route = BuildRoute(tkm, k, keep_low=False)
    made = []
    plan = route.plan_table
    route.plan_table = lambda *a: (made.append(a), plan(*a))[1]

    total, hist, chunks = tacc.finalize_stream(ci, cs, route=route)
    assert tacc.tier_events["host_spills"] > 0
    assert route.bloom is None and not made, \
        "no device Bloom build after a finalize-time spill"
    got = _drain((total, hist, chunks))
    want = _drain(jacc.finalize_stream(ci, cs))
    _assert_same(got, want)  # no drop: the low pairs are all there

    tkm.init_from_chunks(iter([(got[2], got[3])]), k, got[0], got[1],
                         route=route)
    jkm = jget_model(ci, cs, nh, nb)
    jkm.init_from_chunks(iter([(want[2], want[3])]), k, want[0], want[1])
    tkm.save(tmp_path / "t")
    jkm.save(tmp_path / "j")
    for fn in ("header", "km.bin", "rest.bin"):
        assert (tmp_path / "t" / fn).read_bytes() == \
            (tmp_path / "j" / fn).read_bytes(), fn


def test_unspilled_merge_route_still_builds_on_device():
    """The same staging below the threshold keeps the device Bloom build."""
    k = 19
    acc = TorchAcc(k, raw_tier_elems=1 << 60, spill_threshold=1 << 60,
                   device="cpu")
    _stage_finalize_time_spill(acc, _batches(17, 11, 4, 64))
    acc.spill_threshold = 1 << 60
    route = BuildRoute(tget_model(1, 1023, 7, 5), k, keep_low=True)
    acc.finalize_stream(1, 1023, route=route)
    assert route.bloom is not None and not acc.host_runs


# ------------------------------------------------ host accumulator, entry
def test_host_count_accumulator_equals_jax():
    k = 17
    batches = _batches(4, 9, 16, 80, n_frac=0.02)
    jacc = jcounter.CountAccumulator(k)
    tacc = tcounter.CountAccumulator(k, device="cpu")
    for codes in batches:
        jacc.add_batch(codes)
        tacc.add_batch(torch.from_numpy(codes))
    assert tacc.total_windows == jacc.total_windows
    for ci, cs in ((1, 0xFFFFFFFF), (2, 3)):
        ja = jcounter.CountAccumulator(k)
        ta = tcounter.CountAccumulator(k, device="cpu")
        ja.runs, ta.runs = list(jacc.runs), list(tacc.runs)
        wk, wc = ja.finalize(ci, cs)
        gk, gc = ta.finalize(ci, cs)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)
        assert gc.dtype == np.uint32
    a = (np.array([1, 4, 9], np.uint64), np.array([1, 2, 3], np.uint64))
    b = (np.array([4, 5], np.uint64), np.array([10, 20], np.uint64))
    for g, w in zip(tcounter.merge_runs(a, b), jcounter.merge_runs(a, b)):
        np.testing.assert_array_equal(g, w)
    wk, wc = jcounter.count_codes_batches(batches, k, ci=2, cs=7)
    gk, gc = tcounter.count_codes_batches(batches, k, ci=2, cs=7, device="cpu")
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)


def test_host_accumulator_merging():
    """tests/test_count.py::test_accumulator_merging: many tiny runs merge
    to the same table as one big batch, in both packages."""
    rng = np.random.default_rng(3)
    k = 13
    vals = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.uint64)
    jacc = jcounter.CountAccumulator(k)
    tacc = tcounter.CountAccumulator(k, device="cpu")
    for chunk in np.array_split(vals, 23):
        u, c = np.unique(chunk, return_counts=True)
        jacc.add_kmer_run(u, c.astype(np.uint64))
        tacc.add_kmer_run(u, c.astype(np.uint64))
    assert [len(r[0]) for r in tacc.runs] == [len(r[0]) for r in jacc.runs]
    kmers, counts = tacc.finalize()
    wk, wc = jacc.finalize()
    u, c = np.unique(vals, return_counts=True)
    np.testing.assert_array_equal(kmers, u)
    np.testing.assert_array_equal(counts, c.astype(np.uint32))
    np.testing.assert_array_equal(kmers, wk)
    np.testing.assert_array_equal(counts, wc)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 6000)
    fq = tmp_path_factory.mktemp("fq") / "r.fastq"
    with open(fq, "wb") as f:
        for i in range(700):
            s = int(rng.integers(0, len(genome) - 90))
            seq = bytearray(acgt[genome[s : s + 90]].tobytes())
            if i % 50 == 0:
                seq[40] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), b"I" * 90))
    return str(fq)


@pytest.mark.parametrize("accumulator", ["device", "host"])
def test_count_fastq_equals_jax(fastq, accumulator):
    wk, wc, ws = jpipe.count_fastq(fastq, k=21, ci=2, cs=50, batch_segs=256,
                                   accumulator=accumulator)
    gk, gc, gs = tpipe.count_fastq(fastq, k=21, ci=2, cs=50, batch_segs=256,
                                   accumulator=accumulator, device="cpu")
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    assert (gs.reads, gs.bases, gs.windows, gs.distinct_kmers) == \
        (ws.reads, ws.bases, ws.windows, ws.distinct_kmers)
    assert len(gk) > 1000


def test_count_fastq_sharded_names_the_later_slice(fastq):
    """The sharded backend is ported: on the one CPU shard ``device="cpu"``
    names it gives the device accumulator's table; an unknown backend is
    refused with the known ones named."""
    gk, gc, _ = tpipe.count_fastq(fastq, k=21, batch_segs=256,
                                  accumulator="sharded", device="cpu")
    wk, wc, _ = tpipe.count_fastq(fastq, k=21, batch_segs=256, device="cpu")
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    with pytest.raises(ValueError, match="sharded"):
        tpipe.count_fastq(fastq, accumulator="nope", device="cpu")


def test_count_encode_spilled_equals_jax(fastq, tmp_path, monkeypatch):
    """The slice as a whole: count_encode with the tiers forced through the
    environment, host route and disk route, against the JAX package under
    the same variables and against the unspilled build: listing, stats,
    database and model bytes."""
    def files(d):
        return [(d / n).read_bytes() for n in
                ("db.kmc_pre", "db.kmc_suf", "m/header", "m/km.bin",
                 "m/rest.bin")]

    def build(mod, name, **kw):
        d = tmp_path / name
        d.mkdir()
        km, kk, cc, st = mod.count_encode(fastq, k=21, ci=1, cs=1023,
                                          batch_segs=128, keep_pairs=True,
                                          db_path=str(d / "db"), **kw)
        km.save(d / "m")
        return kk, cc, st, files(d)

    base = build(tpipe, "plain", device="cpu")
    assert base[2].tiers["host_spills"] == 0
    monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "9000")
    monkeypatch.setenv("KMCEX_SPILL_THRESHOLD", "8192")
    for route, disk_bytes in (("host", "0"), ("disk", "30000")):
        monkeypatch.setenv("KMCEX_DISK_SPILL_BYTES", disk_bytes)
        want = build(jpipe, "j" + route)
        got = build(tpipe, "t" + route, device="cpu")
        assert got[2].tiers == want[2].tiers, route
        assert got[2].tiers["host_spills"] > 0
        assert (got[2].tiers["disk_spills"] > 0) == (route == "disk")
        assert got[2].spill["copy_bytes"] > 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[3] == want[3] == base[3], route


# ------------------------------------------- counts as 32 unsigned bits
def _big_count_runs():
    """Three unique runs whose per-key sums cross 2^31, reach exactly
    2^32-1, and pass 2^32 (which saturates)."""
    keys = np.array([5, 9, 12, 40, 77, 1 << 63], np.uint64)
    runs = [np.array([1 << 30, 0x7FFFFFFF, 0xFFFFFFF0, 1, 3_000_000_000, 7]),
            np.array([1 << 30, 1, 0x0F, 2, 2_000_000_000, 0x7FFFFFFF]),
            np.array([1 << 31, 0x7FFFFFFF, 1, 3, 5, 0x7FFFFFFF])]
    pad_k = np.full(2, PAD)
    pad_c = np.zeros(2, np.uint32)
    return [(np.concatenate([keys, pad_k]),
             np.concatenate([c.astype(np.uint32), pad_c])) for c in runs]


@pytest.mark.parametrize("ci,cs", [(1, 0xFFFFFFFF), (1, 1 << 31),
                                   (3, 3_500_000_000), (2, 1023)])
def test_counts_above_2_31_equal_jax(ci, cs):
    """Repair of the int32 saturation: device runs whose sums cross 2^31 and
    2^32 merged by both accumulators; finalize and finalize_stream (table,
    total, low histogram) equal, saturating at 2^32-1."""
    def load(acc, to_dev):
        for ku, kc in _big_count_runs():
            acc.runs.append((to_dev(ku, np.int64), to_dev(kc, np.int32), 8))

    def to_jax(a, _):
        return jnp.asarray(a)

    def to_torch(a, signed):
        return torch.from_numpy(a.view(signed))

    jacc, tacc = JaxAcc(15), TorchAcc(15, device="cpu")
    load(jacc, to_jax)
    load(tacc, to_torch)
    wk, wc = jacc.finalize(ci=ci, cs=cs)
    gk, gc = tacc.finalize(ci=ci, cs=cs)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    jacc, tacc = JaxAcc(15), TorchAcc(15, device="cpu")
    load(jacc, to_jax)
    load(tacc, to_torch)
    _assert_same(_drain(tacc.finalize_stream(ci=ci, cs=cs)),
                 _drain(jacc.finalize_stream(ci=ci, cs=cs)))


def test_counts_saturate_at_2_32_minus_1():
    tacc = TorchAcc(15, device="cpu")
    for ku, kc in _big_count_runs():
        tacc.runs.append((torch.from_numpy(ku.view(np.int64)),
                          torch.from_numpy(kc.view(np.int32)), 8))
    gk, gc = tacc.finalize(ci=1, cs=0xFFFFFFFF)
    assert gk.tolist() == [5, 9, 12, 40, 77, 1 << 63]
    assert gc.dtype == np.uint32
    # 2^32 exactly, 2^32-1 exactly, 2^32 by one, 6, 5e9, 2^32+5
    assert gc.tolist() == [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 6, 0xFFFFFFFF,
                           0xFFFFFFFF]


def test_low_key_drop_and_bloom_feed_read_counts_unsigned():
    """A count past 2^31 is a large count, not a negative one: the low-key
    drop keeps it and the Bloom feed does not take it for a low key."""
    u = torch.tensor([3, 8, 20, -1], dtype=torch.int64)
    c = torch.from_numpy(np.array([1, 3_000_000_000, 2, 0],
                                  np.uint32).view(np.int32))
    u2, c2 = tlsm._drop_low(u, c, 2)
    flat = tlsm._final_stats(u2, c2, 2)
    assert u2.tolist()[:2] == [8, 20] and int(flat[0]) == 2
    assert c2.numpy().view(np.uint32).tolist()[:2] == [3_000_000_000, 2]
    stats = tlsm._final_stats(u, c, 1)
    assert stats[:5].tolist() == [3, 1, 1, 0, 3]
    b = DeviceBloomBuilder(15, 1, 0xFFFFFFFF, 7, np.array([1, 0, 0]),
                           device="cpu")
    b.feed_table(u, c, 4)
    one = DeviceBloomBuilder(15, 1, 0xFFFFFFFF, 7, np.array([1, 0, 0]),
                             device="cpu")
    one.feed_table(u[:1], c[:1], 1)
    assert torch.equal(b._bitmap, one._bitmap) and int(b._bitmap.sum()) > 0
