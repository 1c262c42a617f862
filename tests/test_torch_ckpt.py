"""The port's checkpoint and resume (DeviceCountAccumulator.checkpoint /
read_manifest / restore, count_encode(ckpt_dir), the CLI's -ckpt<dir>) on
the CPU against the JAX package's: the three cases of
tests/test_ckpt_cli.py through the port's CLI, and checkpoints crossing
between the packages both ways.  The state is files of integers: every
comparison is exact (tolerance 0)."""

import json
import os
import re
import subprocess
import sys
import pathlib

import numpy as np
import pytest

import kmcex_tpu.cli as jax_cli
import kmcex_tpu_torch.cli as torch_cli
from kmcex_tpu.count.device_lsm import DeviceCountAccumulator as JaxAcc
from kmcex_tpu.count.pipeline import count_encode as jax_count_encode
from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator as TorchAcc
from kmcex_tpu_torch.count.pipeline import count_encode as torch_count_encode

REPO = pathlib.Path(__file__).resolve().parent.parent


def _write_fastq(path, n_reads, read_len=60, seed=3):
    """The generator of tests/test_ckpt_cli.py."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 100_000)
    with open(path, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, len(genome) - read_len))
            seq = acgt[genome[s : s + read_len]].tobytes()
            f.write(b"@r%d\n" % i)
            f.write(seq + b"\n+\n" + b"I" * read_len + b"\n")


@pytest.fixture()
def env(monkeypatch):
    # small batches so the input spans several, checkpoint every batch
    monkeypatch.setenv("KMCEX_CKPT_EVERY", "1")
    monkeypatch.setenv("KMCEX_BATCH_SEGS", "512")
    yield monkeypatch


def _model_files(workdir, db):
    d = os.path.join(workdir, os.path.basename(db))
    return [os.path.join(d, n) for n in ("header", "km.bin", "rest.bin")] + [
        db + ".kmc_pre", db + ".kmc_suf"]


def _same_files(a, b):
    for f1, f2 in zip(a, b):
        with open(f1, "rb") as x, open(f2, "rb") as y:
            assert x.read() == y.read(), (f1, f2)


def _batches(seed=61, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = rng.integers(0, 4, size=(16, 48)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.02] = 255
        out.append(codes)
    return out


def test_cli_kill_and_resume_byte_identical(tmp_path, env, capsys):
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=2500)
    k = "-k19"
    # uninterrupted runs: the JAX package's and the port's
    wd0, wd1, wd2 = (tmp_path / n for n in ("wd0", "wd1", "wd2"))
    for d in (wd0, wd1, wd2):
        d.mkdir()
    db0, db1, db2 = (str(tmp_path / n) for n in ("db0", "db1", "db2"))
    assert jax_cli.main(["kmcex", k, str(fq), db0, str(wd0)]) == 0
    assert torch_cli.main(["kmcex", k, str(fq), db1, str(wd1)],
                          device="cpu") == 0

    # crashed run: dies after 2 batches, with checkpoints taken
    ck = str(tmp_path / "ck")
    argv = ["kmcex", k, f"-ckpt{ck}", str(fq), db2, str(wd2)]
    env.setenv("KMCEX_CRASH_AFTER_BATCHES", "2")
    with pytest.raises(RuntimeError, match="injected crash"):
        torch_cli.main(argv, device="cpu")
    m = TorchAcc.read_manifest(ck)
    assert m is not None and m["extra"]["n_batches"] >= 1
    assert m == JaxAcc.read_manifest(ck)
    assert not os.path.exists(db2 + ".kmc_pre")

    # resume: same command, crash disabled -> completes from the checkpoint
    env.delenv("KMCEX_CRASH_AFTER_BATCHES")
    stats_json = tmp_path / "stats.json"
    env.setenv("KMCEX_STATS_JSON", str(stats_json))
    assert torch_cli.main(argv, device="cpu") == 0
    assert json.load(open(stats_json))["skipped_batches"] == \
        m["extra"]["n_batches"]
    # manifest retired on success
    assert not os.path.exists(os.path.join(ck, "manifest.json"))
    assert TorchAcc.read_manifest(ck) is None
    _same_files(_model_files(str(wd1), db1), _model_files(str(wd2), db2))
    _same_files(_model_files(str(wd0), db0), _model_files(str(wd2), db2))


def test_resume_on_four_threads_equals_one_thread_build(tmp_path, env):
    """A run at -t1 killed after 3 batches and resumed at -t4 writes the
    files of an uninterrupted -t1 run: batching does not depend on the
    segmenter's thread count, and the resumed parse ran on several."""
    from kmcex_tpu_torch import native

    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=6000, seed=17)
    env.setenv("KMCEX_BATCH_SEGS", "1024")
    wd0, wd1 = tmp_path / "wd0", tmp_path / "wd1"
    wd0.mkdir()
    wd1.mkdir()
    db0, db1 = str(tmp_path / "db0"), str(tmp_path / "db1")
    ck = str(tmp_path / "ck")
    argv = ["kmcex", "-k19", f"-ckpt{ck}", str(fq), db1, str(wd1)]
    prev = native._n_threads_override
    try:
        assert torch_cli.main(["kmcex", "-k19", "-t1", str(fq), db0,
                               str(wd0)], device="cpu") == 0
        env.setenv("KMCEX_CRASH_AFTER_BATCHES", "3")
        with pytest.raises(RuntimeError, match="injected crash"):
            torch_cli.main(argv[:2] + ["-t1"] + argv[2:], device="cpu")
        assert TorchAcc.read_manifest(ck)["extra"]["n_batches"] == 3
        env.delenv("KMCEX_CRASH_AFTER_BATCHES")
        stats_json = tmp_path / "stats.json"
        env.setenv("KMCEX_STATS_JSON", str(stats_json))
        assert torch_cli.main(argv[:2] + ["-t4"] + argv[2:],
                              device="cpu") == 0
    finally:
        native.set_num_threads(prev)
    stats = json.load(open(stats_json))
    assert stats["skipped_batches"] == 3
    assert stats["counters"]["ingest.parallel_bases"] > 0
    _same_files(_model_files(str(wd0), db0), _model_files(str(wd1), db1))


def test_ckpt_fingerprint_mismatch_raises(tmp_path, env):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=1200)
    ck = str(tmp_path / "ck")
    env.setenv("KMCEX_CRASH_AFTER_BATCHES", "1")
    with pytest.raises(RuntimeError):
        torch_count_encode(str(fq), k=19, batch_segs=256, ckpt_dir=ck,
                           ckpt_every=1, device="cpu")
    env.delenv("KMCEX_CRASH_AFTER_BATCHES")
    with pytest.raises(ValueError, match="different input"):
        torch_count_encode(str(fq), k=21, batch_segs=256, ckpt_dir=ck,
                           ckpt_every=1, device="cpu")
    # the fingerprint has the JAX package's keys
    fp = TorchAcc.read_manifest(ck)["extra"]["fingerprint"]
    assert fp == {"input": str(fq), "k": 19, "seg_len": 64, "batch_segs": 256,
                  "accumulator": "device", "ci": 1, "cs": 1023}


@pytest.mark.parametrize("crash_with,resume_with",
                         [("torch", "torch"), ("jax", "torch"),
                          ("torch", "jax")])
def test_ckpt_resume_count_encode(tmp_path, env, crash_with, resume_with):
    """count_encode-level resume, model and listing against an
    uninterrupted JAX run; a crash of either package is resumed by the
    other (the manifest and the run files are the carrier)."""
    def call(which, **kw):
        if which == "jax":
            return jax_count_encode(str(fq), k=19, batch_segs=256, **kw)
        return torch_count_encode(str(fq), k=19, batch_segs=256,
                                  keep_pairs=True, device="cpu", **kw)

    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=2000, seed=11)
    km0, kk, cc, _ = call("jax")
    ck = str(tmp_path / "ck")
    env.setenv("KMCEX_CRASH_AFTER_BATCHES", "3")
    with pytest.raises(RuntimeError):
        call(crash_with, ckpt_dir=ck, ckpt_every=1)
    env.delenv("KMCEX_CRASH_AFTER_BATCHES")
    km1, k1, c1, st = call(resume_with, ckpt_dir=ck, ckpt_every=1)
    if resume_with == "torch":
        assert st.skipped_batches == 3
    np.testing.assert_array_equal(kk, k1)
    np.testing.assert_array_equal(cc, c1)
    km0.save(tmp_path / "m0")
    km1.save(tmp_path / "m1")
    for n in ("header", "km.bin", "rest.bin"):
        assert (tmp_path / "m0" / n).read_bytes() == \
            (tmp_path / "m1" / n).read_bytes(), n


def test_checkpoint_resume_equals_jax(tmp_path):
    """tests/test_device_lsm.py::test_checkpoint_resume on the port, with
    the JAX accumulator's checkpoint beside it: same file names, same
    bytes, same manifest."""
    k = 15
    batches = _batches()
    ref = JaxAcc(k)
    for b in batches:
        ref.add_batch(b)
    want_k, want_c = ref.finalize(ci=1)

    kw = dict(raw_tier_elems=1024, spill_threshold=2048)
    jacc, tacc = JaxAcc(k, **kw), TorchAcc(k, device="cpu", **kw)
    for b in batches[:5]:
        jacc.add_batch(b)
        tacc.add_batch(b)
    jck, tck = tmp_path / "j", tmp_path / "t"
    jacc.checkpoint(str(jck), extra={"n_batches": 5})
    tacc.checkpoint(str(tck), extra={"n_batches": 5})
    assert sorted(p.name for p in tck.iterdir()) == \
        sorted(p.name for p in jck.iterdir())
    for p in tck.iterdir():
        assert p.read_bytes() == (jck / p.name).read_bytes(), p.name
    assert TorchAcc.read_manifest(str(tck))["extra"] == {"n_batches": 5}

    res = TorchAcc.restore(str(tck), device="cpu", **kw)
    assert all(not r[0].flags.writeable for r in res.host_runs)
    sizes = [len(r[0]) for r in res.host_runs]
    assert sizes == sorted(sizes, reverse=True)  # the cascade invariant
    for b in batches[5:]:
        res.add_batch(b)
    got_k, got_c = res.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert res.total_windows == ref.total_windows
    # checkpoint untouched: restore again and finalize WITHOUT new batches
    ref5 = JaxAcc(k)
    for b in batches[:5]:
        ref5.add_batch(b)
    w5k, w5c = ref5.finalize(ci=1)
    pk, pc = TorchAcc.restore(str(tck), device="cpu").finalize(ci=1)
    np.testing.assert_array_equal(pk, w5k)
    np.testing.assert_array_equal(pc, w5c)
    assert (tck / "manifest.json").exists()
    assert any(re.match(r"g\d+_run", f.name) for f in tck.iterdir())
    # the original accumulator stays valid after checkpointing too
    for b in batches[5:]:
        tacc.add_batch(b)
    ak, ac = tacc.finalize(ci=1)
    np.testing.assert_array_equal(ak, want_k)
    np.testing.assert_array_equal(ac, want_c)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_checkpoint_crosses_packages(tmp_path, writer, reader):
    """A checkpoint written by one package's accumulator (with a disk run in
    it) is restored by the other's, which counts on to the same table."""
    k = 15
    batches = _batches(seed=7, n=10)
    kw = dict(raw_tier_elems=1024, spill_threshold=1024, disk_spill_bytes=6000)
    accs = {"jax": lambda **x: JaxAcc(k, **kw, **x),
            "torch": lambda **x: TorchAcc(k, device="cpu", **kw, **x)}
    restore = {"jax": lambda d: JaxAcc.restore(d, **kw),
               "torch": lambda d: TorchAcc.restore(d, device="cpu", **kw)}
    ref = JaxAcc(k)
    for b in batches:
        ref.add_batch(b)
    want = ref.finalize(ci=2, cs=7)

    acc = accs[writer](disk_dir=str(tmp_path / "lsm"))
    for b in batches[:6]:
        acc.add_batch(b)
    assert acc.disk_runs
    ck = str(tmp_path / "ck")
    acc.checkpoint(ck)
    assert any("_disk_" in n for n in os.listdir(ck))
    res = restore[reader](ck)
    assert res.total_windows == acc.total_windows
    for b in batches[6:]:
        res.add_batch(b)
    total, hist, chunks = res.finalize_stream(ci=2, cs=7)
    parts = list(chunks)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), want[0])
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), want[1])
    assert total == len(want[0])
    acc.close()
    res.close()


def test_second_generation_never_overwrites_a_mapped_file(tmp_path):
    """A restored accumulator reads memmaps of generation g; its own
    checkpoint writes generation g+1 beside them and only then drops g."""
    k = 15
    batches = _batches(seed=2, n=6)
    kw = dict(raw_tier_elems=1024, spill_threshold=1024, device="cpu")
    acc = TorchAcc(k, **kw)
    for b in batches[:3]:
        acc.add_batch(b)
    ck = tmp_path / "ck"
    acc.checkpoint(str(ck))
    gen0 = {p.name for p in ck.iterdir() if p.suffix == ".bin"}
    assert gen0 and all(n.startswith("g0000_") for n in gen0)
    res = TorchAcc.restore(str(ck), **kw)
    for b in batches[3:]:
        res.add_batch(b)
    res.checkpoint(str(ck))
    gen1 = {p.name for p in ck.iterdir() if p.suffix == ".bin"}
    assert gen1 and all(n.startswith("g0001_") for n in gen1)
    assert json.load(open(ck / "manifest.json"))["gen"] == 1
    assert not (ck / "manifest.json.tmp").exists()
    ref = TorchAcc(k, device="cpu")
    for b in batches:
        ref.add_batch(b)
    wk, wc = ref.finalize()
    gk, gc = TorchAcc.restore(str(ck), **kw).finalize()
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)


def test_cli_crash_exits_nonzero_and_does_not_hang(tmp_path):
    """The injected crash raises while both producer threads are alive; the
    CLI process must end with a non-zero code, not wait on them."""
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=4000)
    ck = tmp_path / "ck"
    code = ("import sys; from kmcex_tpu_torch import cli; "
            "sys.exit(cli.main(sys.argv, device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(REPO), KMCEX_BATCH_SEGS="256",
               KMCEX_CKPT_EVERY="2", KMCEX_CRASH_AFTER_BATCHES="3")
    res = subprocess.run(
        [sys.executable, "-c", code, "-k19", f"-ckpt{ck}", str(fq),
         str(tmp_path / "db"), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode not in (0, None)
    assert "injected crash" in res.stderr
    assert TorchAcc.read_manifest(str(ck))["extra"]["n_batches"] == 2
    assert not (tmp_path / "db.kmc_pre").exists()


def test_cli_parses_ckpt_and_refuses_sharded(tmp_path):
    p = torch_cli.parse_parameters(["kmcex", "-k21", "-ckpt/x/y", "-t2", "a",
                                    "b", "c"])
    assert (p.ckpt_dir, p.k, p.t) == ("/x/y", 21, 2)
    assert torch_cli.parse_parameters(["kmcex", "a", "b", "c"]).ckpt_dir == ""
    # -accsharded is a backend of the port now; an unknown kind is refused
    # with the known ones named
    p = torch_cli.parse_parameters(["kmcex", "-accsharded", "a", "b", "c"])
    assert p.accumulator == "sharded"
    with pytest.raises(ValueError, match="sharded"):
        torch_cli.parse_parameters(["kmcex", "-acchost", "a", "b", "c"])
