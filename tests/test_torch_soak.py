"""The port's soak tool on the CPU, at a small size: the package's generator
writes the benchmark generator's bytes, the partitioned oracle equals one
``np.unique``, and ``tools.soak.main`` (three passes + oracle) agrees with
the JAX package's ``count_encode`` on the same file under the same tier
thresholds.  All integers and bytes: tolerance 0."""

import functools
import json
import pathlib

import numpy as np
import pytest

import bench
from kmcex_tpu.count import pipeline as jpipe
from kmcex_tpu_torch.count import pipeline as tpipe
from kmcex_tpu_torch.tools import soak, workload
from kmcex_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parent.parent
N_READS, GENOME, BATCH_SEGS = 3000, 30_000, 512
ARTIFACT_KEYS = ["workload", "wall_seconds", "warm_pass_seconds",
                 "mreads_per_s", "windows", "distinct_kmers", "count_seconds",
                 "encode_seconds", "phases", "tiers", "peak_rss_mb", "oracle",
                 "device", "peak_device_mb", "spill", "kernel_launches",
                 "table_bytes_to_host"]
MODEL_FILES = ["header", "km.bin", "rest.bin"]


# ------------------------------------------------------------- the generator
@pytest.mark.parametrize("n_reads,err_rate,rows",
                         [(300, 0.002, None), (1234, 0.005, None),
                          (7, 0.002, None), (1234, 0.002, 101),
                          (300, 0.01, 1)])
def test_generator_writes_the_benchmark_bytes(tmp_path, monkeypatch, n_reads,
                                              err_rate, rows):
    """Same seed, same bytes as bench.make_fastq, across the changes of the
    record number's digit count (7, 300 and 1234 reads) and with the draws
    and the file cut into many blocks of rows (an odd count and one row)."""
    if rows:
        monkeypatch.setattr(workload, "_ROWS", rows)
    bench.make_fastq(tmp_path / "want.fq", genome_len=50_000, n_reads=n_reads,
                     seed=2025, err_rate=err_rate)
    reads = workload.make_fastq(tmp_path / "got.fq", 50_000, n_reads, 2025,
                                err_rate)
    assert ((tmp_path / "got.fq").read_bytes()
            == (tmp_path / "want.fq").read_bytes())
    assert reads.shape == (n_reads, 150) and reads.dtype == np.uint8
    lines = (tmp_path / "got.fq").read_bytes().split(b"\n")
    assert lines[1] == reads[0].tobytes()
    assert lines[4 * (n_reads - 1)] == b"@r%d" % (n_reads - 1)


def test_serving_queries_are_the_benchmark_mix():
    """bench.py's query mix, draw for draw."""
    kmers = np.unique(np.random.default_rng(3).integers(
        0, 1 << 62, 5000, dtype=np.uint64))
    rng = np.random.default_rng(0)
    want = np.concatenate([rng.choice(kmers, 500),
                           rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    rng.shuffle(want)
    np.testing.assert_array_equal(workload.serving_queries(kmers, 1000), want)


# ---------------------------------------------------------------- the oracle
def _one_unique(reads: np.ndarray, k: int):
    """The plain oracle: every window base by base, one np.unique."""
    code = np.full(256, 255, np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    c = code[reads]
    if c.shape[1] < k:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    w = np.lib.stride_tricks.sliding_window_view(c, k, axis=1)
    wv = w.reshape(-1, k)[(w < 4).all(axis=2).reshape(-1)].astype(np.uint64)
    fwd = np.zeros(len(wv), np.uint64)
    rc = np.zeros(len(wv), np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | wv[:, j]
        rc = (rc << np.uint64(2)) | (np.uint64(3) ^ wv[:, k - 1 - j])
    return np.unique(np.minimum(fwd, rc), return_counts=True)


def _odd_reads(length: int) -> np.ndarray:
    """Generator reads with extra trouble: N-runs, reads whose tail is all N
    (a read shorter than k), lower case, and a few all-A reads."""
    reads = workload.make_reads(5_000, 400, 11, 0.01)[:, :length].copy()
    rng = np.random.default_rng(5)
    reads[rng.random(reads.shape) < 0.01] = ord("N")
    reads[::7, 20:] = ord("N")       # 20 bases left: no window at k = 31
    reads[::11, :10] = ord("N")
    reads[5] = np.frombuffer(b"acgt" * (length // 4) + b"a" * (length % 4),
                             np.uint8)  # lower case is not ACGT here
    reads[6:9] = ord("A")
    return reads


@pytest.mark.parametrize("k", [15, 31])
@pytest.mark.parametrize("length,block_reads,part_bits,workers",
                         [(150, 64, 6, 4), (150, 20000, 1, 1), (40, 100, 8, 2),
                          (20, 64, 6, 2)])
def test_partitioned_oracle_equals_one_unique(k, length, block_reads,
                                              part_bits, workers):
    reads = _odd_reads(length)
    got_k, got_c = workload.oracle_counts(reads, k, part_bits=part_bits,
                                          block_reads=block_reads,
                                          workers=workers)
    want_k, want_c = _one_unique(reads, k)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_k.dtype == np.uint64
    assert (len(got_k) == 0) == (length < k)
    if len(got_k):
        assert got_c.max() > 1 and got_c.sum() < len(reads) * (length - k + 1)


# ------------------------------------------------------------------ the tool
@pytest.fixture(scope="module")
def small_soak(tmp_path_factory):
    """``soak.main --device cpu`` once, at 3,000 reads of a 30,000-base
    genome in batches of 512 segments, with a raw tier of 100,000 windows;
    and the JAX package's two builds of the same file under the same
    variables."""
    d = tmp_path_factory.mktemp("soak")
    runs = []
    real_run = soak.run

    def spy(*a, **kw):
        runs.append(real_run(*a, **kw))
        return runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KMCEX_RAW_TIER_ELEMS", "100000")
        mp.delenv("KMCEX_SPILL_THRESHOLD", raising=False)
        mp.delenv("KMCEX_DISK_SPILL_BYTES", raising=False)
        mp.delenv("KMCEX_TRACE_DIR", raising=False)
        mp.setattr(soak, "GENOME", GENOME)
        mp.setattr(soak, "count_encode", functools.partial(
            tpipe.count_encode, batch_segs=BATCH_SEGS))
        mp.setattr(soak, "run", spy)
        rc = soak.main([str(N_READS), str(d / "SOAK.json"), "--device", "cpu"])
        fq = d / "reads.fastq"
        workload.make_fastq(fq, GENOME, N_READS, soak.SEED, soak.ERR_RATE)
        args = (str(fq), soak.K, soak.CI, soak.CS, soak.NH, soak.NB)
        jkm, _, _, jst = jpipe.count_encode(*args, batch_segs=BATCH_SEGS,
                                            keep_pairs=False)
        jkm2, jk, jc, _ = jpipe.count_encode(*args, batch_segs=BATCH_SEGS)
    jkm.save(d / "jax_model")
    jkm2.save(d / "jax_verify")
    run = runs[0]
    run.km.save(d / "model")
    run.km_verify.save(d / "verify")
    return dict(rc=rc, dir=d, run=run, jst=jst, jk=jk, jc=jc,
                artifact=json.loads((d / "SOAK.json").read_text()))


def test_soak_main_exits_0_and_the_oracle_agrees(small_soak):
    assert small_soak["rc"] == 0
    assert small_soak["run"].ok
    assert small_soak["artifact"]["oracle"] == {
        "keys_exact": True, "counts_exact": True, "model_total_matches": True}


@pytest.mark.parametrize("key", ARTIFACT_KEYS)
def test_soak_artifact_has_every_key(small_soak, key):
    art = small_soak["artifact"]
    assert key in art
    ref = json.loads((REPO / "SOAK_r05.json").read_text())
    if key in ref and isinstance(ref[key], dict) and key != "phases":
        assert set(ref[key]) <= set(art[key]), key
    if key == "workload":
        assert art[key] == {**ref[key], "n_reads": N_READS,
                            "genome_len": GENOME}
    if key == "device":
        assert art[key] == "cpu" and art["peak_device_mb"] is None
    if key == "kernel_launches":  # CPU tensors take the plain versions
        assert art[key] == {"sort_u64": 0, "merge_sorted_u64": 0,
                            "compact_pairs": 0, "encode_arrays": 0}
    if key == "phases":
        assert {"stream+extract", "merge+stats",
                "transfer+encode"} <= set(art[key])


@pytest.mark.parametrize("field", ["windows", "distinct_kmers", "tiers",
                                   "reads"])
def test_soak_counts_equal_jax(small_soak, field):
    art, jst = small_soak["artifact"], small_soak["jst"]
    if field == "reads":
        assert art["workload"]["n_reads"] == jst.reads == N_READS
        return
    assert art[field] == getattr(jst, field)
    if field == "tiers":
        assert art[field]["raw_collapses"] >= 3
        assert art[field]["device_merges"] >= 2
        assert art[field]["host_spills"] == art[field]["disk_spills"] == 0
        assert art["thresholds"]["raw_tier_elems"] == 100000
        assert art["thresholds"]["spill_threshold"] == 128 << 20
    if field == "windows":
        assert art[field] > N_READS * (150 - soak.K + 1)  # padded segments


@pytest.mark.parametrize("fn", MODEL_FILES)
@pytest.mark.parametrize("which", ["model", "verify"])
def test_soak_model_files_equal_jax(small_soak, which, fn):
    d = small_soak["dir"]
    got = (d / which / fn).read_bytes()
    assert got == (d / f"jax_{which}" / fn).read_bytes()
    assert got == (d / "model" / fn).read_bytes()  # both routes, one model


def test_soak_oracle_table_equals_jax_listing(small_soak):
    np.testing.assert_array_equal(small_soak["run"].want_k, small_soak["jk"])
    np.testing.assert_array_equal(small_soak["run"].want_c, small_soak["jc"])


@pytest.mark.parametrize("what", ["count", "key"])
def test_soak_exits_1_when_the_oracle_disagrees(tmp_path, monkeypatch, what):
    real = workload.oracle_counts

    def wrong(reads, k):
        kmers, counts = real(reads, k)
        if what == "count":
            counts[len(counts) // 2] += 1
        else:
            kmers[-1] += np.uint64(1)
        return kmers, counts

    monkeypatch.setattr(soak, "GENOME", GENOME)
    monkeypatch.setattr(workload, "oracle_counts", wrong)
    out = tmp_path / "sub" / "SOAK.json"
    assert soak.main(["500", str(out), "--device", "cpu"]) == 1
    oracle = json.loads(out.read_text())["oracle"]
    assert oracle["keys_exact"] == (what == "count")
    assert oracle["counts_exact"] == (what == "key")


def test_soak_default_device_raises_without_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        soak.main(["100", str(tmp_path / "SOAK.json")])
    assert not (tmp_path / "SOAK.json").exists()


@pytest.mark.parametrize("module", ["soak", "workload"])
def test_soak_modules_import_no_jax(module):
    src = (REPO / "kmcex_tpu_torch" / "tools" / f"{module}.py").read_text()
    tops = {line.split()[1].split(".")[0] for line in src.splitlines()
            if line.split()[:1] in (["import"], ["from"])}
    assert tops and not tops & {"jax", "jaxlib", "kmcex_tpu", "bench"}
    if module == "workload":  # the oracle's module: numpy and the stdlib
        assert tops == {"__future__", "concurrent", "os", "numpy"}


# ------------------------------------------------------ the trace's idle share
def test_trace_device_busy_unions_the_device_intervals(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "ts": 100, "dur": 50},
          {"ph": "X", "cat": "kernel", "ts": 120, "dur": 10},      # inside
          {"ph": "X", "cat": "gpu_memcpy", "ts": 140, "dur": 30},  # overlaps
          {"ph": "X", "cat": "gpu_memset", "ts": 400, "dur": 5},
          {"ph": "X", "cat": "cuda_runtime", "ts": 500, "dur": 500},
          {"ph": "M", "name": "process_name"}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    busy, span = timing.trace_device_busy(tmp_path / "t.json")
    assert busy == pytest.approx(75e-6, abs=1e-12)
    assert span == pytest.approx(1000e-6, abs=1e-12)
    (tmp_path / "e.json").write_text(json.dumps({"traceEvents": []}))
    assert timing.trace_device_busy(tmp_path / "e.json") == (0.0, 0.0)


def test_soak_reads_the_idle_share_of_the_timed_pass(tmp_path, monkeypatch):
    """With KMCEX_TRACE_DIR set the artifact carries the trace's reading; a
    CPU run has no device interval, so its idle share is 1."""
    monkeypatch.setattr(soak, "GENOME", GENOME)
    monkeypatch.setenv("KMCEX_TRACE_DIR", str(tmp_path / "traces"))
    out = tmp_path / "SOAK.json"
    assert soak.main(["300", str(out), "--device", "cpu"]) == 0
    idle = json.loads(out.read_text())["device_idle"]
    assert idle["busy_seconds"] == 0 and idle["span_seconds"] > 0
    assert idle["idle_share"] == 1
