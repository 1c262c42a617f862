"""The coupled-array encode on the device route (``model.device_encode``)
against the native encoder, on the CPU.

The plain batched version must write the native ``BitArrayEncoder``'s
bytes: ``bit1``, ``bit2``, ``km_back`` and the rest pairs in hand-off order,
over several flushes, the partial tail bucket, the empty buckets after a
full flush (the reference's resurrection of slot 0), arrays of a few
hundred bits (high conflict rates) and batches of 1, 7 and more than a
bucket.  Then the route: ``count_encode`` with the device route taken on
CPU tensors writes the host route's model files and records every
``table.*`` and ``encode.*`` phase; every other route keeps the native
encoder.
"""

import numpy as np
import pytest
import torch

from kmcex_tpu_torch import native
from kmcex_tpu_torch.core.occu_bin import OccuBin
from kmcex_tpu_torch.model import device_bloom, device_encode
from kmcex_tpu_torch.model.kmodel import km_sizes

K, NH, CS = 31, 7, 1023


def _pairs(seed: int, n: int, ci: int):
    """n ascending distinct 62-bit keys and counts >= ci + bf_num, a few
    past the OccuBin LUT."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, n + 64, dtype=np.uint64))[:n]
    lo = ci + (1 if ci == 1 else 3)
    occs = (lo + rng.geometric(0.3, n) - 1).astype(np.uint32)
    big = rng.random(n) < 0.02
    occs[big] = rng.integers(lo, 3 * CS, int(big.sum()))
    return keys, occs


def _native(keys, occs, plan):
    size = plan.n_bits * plan.km_byte_size
    bit1, bit2 = np.zeros(size, np.uint8), np.zeros(size, np.uint8)
    back = np.zeros(plan.byte_km_back, np.uint8)
    enc = native.BitArrayEncoder(
        plan.k, plan.n_bits, plan.n_hash, plan.occ2bin, bit1, bit2,
        plan.km_byte_size * 8, back, plan.byte_km_back * 8,
        plan.back_num_hash, bucket_size=plan.bucket_size, n_threads=2)
    for a in range(0, len(keys), 333):  # chunked, as the host route feeds
        enc.feed(keys[a : a + 333], occs[a : a + 333])
    rk, ro = enc.finish()
    return bit1, bit2, back, rk, ro


BS = 64
# (n_bits, ci, pairs, array bytes or None for the model's size, batch)
CASES = {
    # two full flushes, bucket 1 partial, buckets 2-4 empty after the tail
    "nb5_ci1_tail_w1": (5, 1, 2 * 5 * BS + BS + 17, None, 1),
    "nb5_ci1_tail_w7": (5, 1, 2 * 5 * BS + BS + 17, None, 7),
    "nb5_ci1_tail_wbig": (5, 1, 2 * 5 * BS + BS + 17, None, 1000),
    "nb3_ci2_tail_w1": (3, 2, 4 * 3 * BS + 5, None, 1),
    "nb3_ci2_tail_w7": (3, 2, 4 * 3 * BS + 5, None, 7),
    "nb3_ci2_tail_wbig": (3, 2, 4 * 3 * BS + 5, None, 1000),
    # an exact number of flushes: every bucket of the tail flush empty
    "nb5_ci2_exact_w7": (5, 2, 3 * 5 * BS, None, 7),
    "nb3_ci1_exact_wbig": (3, 1, 3 * 3 * BS, None, 1000),
    # arrays of a few hundred bits: most inserts conflict and fail
    "nb3_ci2_tiny_w7": (3, 2, 3 * 3 * BS, 40, 7),
    "nb3_ci2_tiny_wbig": (3, 2, 3 * 3 * BS + 70, 40, 1000),
    "nb5_ci1_tiny_w1": (5, 1, 2 * 5 * BS + 2 * BS + 9, 60, 1),
    "nb5_ci1_tiny_wbig": (5, 1, 2 * 5 * BS + 2 * BS + 9, 60, 1000),
    "nb5_ci1_empty": (5, 1, 0, None, 7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_encode_equals_native(case):
    nb, ci, n, arr, batch = CASES[case]
    keys, occs = _pairs(len(case) + n, n, ci)
    km_byte_size, byte_km_back = km_sizes(n, NH)
    plan = device_encode.EncodePlan(
        K, nb, NH, NH - 2, arr or km_byte_size, byte_km_back,
        OccuBin(CS + 1, NH).occ2bin_lut, BS, batch)
    bit1, bit2, back, rk, ro = _native(keys, occs, plan)
    got = device_encode.encode_arrays(torch.from_numpy(keys.view(np.int64)),
                                      torch.from_numpy(occs.view(np.int32)),
                                      plan)
    rest_n, attempts, serial = got.stats.tolist()
    assert np.array_equal(got.bit1.numpy(), bit1)
    assert np.array_equal(got.bit2.numpy(), bit2)
    assert np.array_equal(got.km_back.numpy(), back)
    assert rest_n == len(rk)
    assert np.array_equal(got.rest_keys[:rest_n].numpy().view(np.uint64), rk)
    assert np.array_equal(got.rest_occs[:rest_n].numpy().view(np.uint32), ro)
    assert attempts >= n
    if batch == 1:
        assert serial == 0
    if arr is not None:
        # survivors of a full flush handed off twice (the empty tail
        # buckets retry their slot 0), and conflicts in the batches
        assert len(np.unique(rk)) < len(rk)
        assert serial > 0 or batch == 1


def _fastq(path, seed=6, n_reads=2000, genome=20000):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, s in enumerate(rng.integers(0, genome - 100, n_reads)):
            r = g[s : s + 100].copy()
            err = rng.random(100) < 0.01
            r[err] = (r[err] + 1) % 4
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[r].tobytes(), b"I" * 100))
    return str(path)


PHASES = {"table.pull_wait", "table.host_prep", "encode.chunk_wait",
          "encode.array_feed", "encode.array_finish", "encode.rest_build",
          "encode.route_split", "encode.bloom_pull"}


def _build(fq, tmp_path, name, ci, **kw):
    from kmcex_tpu_torch.count.pipeline import count_encode

    km, _, _, stats = count_encode(fq, k=K, ci=ci, device="cpu",
                                   keep_pairs=False, **kw)
    km.save(tmp_path / name)
    files = [(tmp_path / name / fn).read_bytes()
             for fn in ("header", "km.bin", "rest.bin")]
    return km, stats, files


@pytest.mark.parametrize("ci", [1, 2])
def test_device_route_equals_host_route(tmp_path, monkeypatch, ci):
    """count_encode with the device encode taken on the CPU (the plain
    version): the model path (no table pulled) and the spool path (the
    table pulled for the database, not split) write the host route's files
    and record every table.* and encode.* phase."""
    fq = _fastq(tmp_path / "r.fastq")
    _, st_host, want = _build(fq, tmp_path, "host", ci)
    assert "encode.device_kmers" not in st_host.counters
    monkeypatch.setattr(device_encode, "_fits", lambda device, nbytes: True)
    for name, kw in (("model", {}), ("spool", {"db_path": str(tmp_path / "db")})):
        km, st, got = _build(fq, tmp_path, name, ci, **kw)
        assert got == want, name
        assert PHASES <= set(st.phases), (name, sorted(st.phases))
        c = st.counters
        assert c["encode.device_kmers"] == km.km_kmercount > 0
        assert c["encode.attempts"] >= km.km_kmercount
        assert 0 <= c["encode.serial_attempts"] <= c["encode.attempts"]
        if name == "model":
            assert st.table_bytes_to_host == 0 and "table.pairs" not in c
        else:
            assert c["table.pairs"] >= st.distinct_kmers


@pytest.mark.parametrize("route", ["cpu", "no_device_bloom", "sharded",
                                   "spill"])
def test_other_routes_keep_the_native_encoder(tmp_path, monkeypatch, route):
    """Where the device route does not apply the native encoder runs, and
    the files are the same: a CPU table, a Bloom bitmap too large for the
    device build, a sharded build and a table that spilled to the host (the
    latter three even where the device encoder would fit)."""
    fq = _fastq(tmp_path / "r.fastq", seed=7, n_reads=1200)
    _, _, want = _build(fq, tmp_path, "host", 1)
    fed = []
    real = native.BitArrayEncoder.feed
    monkeypatch.setattr(native.BitArrayEncoder, "feed",
                        lambda self, k, o: (fed.append(len(k)),
                                            real(self, k, o)))
    kw = {}
    if route != "cpu":
        monkeypatch.setattr(device_encode, "_fits", lambda d, n: True)
    if route == "no_device_bloom":
        monkeypatch.setattr(device_bloom, "MAX_BITMAP_BYTES", 0)
    elif route == "sharded":
        from kmcex_tpu_torch.parallel import sharded

        kw = dict(accumulator="sharded",
                  mesh=sharded.make_mesh(devices=["cpu"] * 2))
    elif route == "spill":
        monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "20000")
        monkeypatch.setenv("KMCEX_SPILL_THRESHOLD", "16384")
    km, st, got = _build(fq, tmp_path, route, 1, **kw)
    assert got == want
    assert sum(fed) == km.km_kmercount > 0
    assert "encode.device_kmers" not in st.counters
    if route == "spill":
        assert st.tiers["host_spills"] > 0
