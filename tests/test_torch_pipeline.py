"""The port's slice as a whole, on the CPU, against the JAX package: the
CLI build (FASTQ -> counts -> KMC1 DB + KModel) writes byte-identical
files, a model the JAX package wrote loads and saves back byte-identical,
the port imports without JAX, and the GPU default never falls back to
the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import kmcex_tpu.cli as jax_cli
import kmcex_tpu_torch.cli as torch_cli
from kmcex_tpu.io import kmc_db as jax_kmc_db
from kmcex_tpu_torch.io import kmc_db as torch_kmc_db
from kmcex_tpu_torch.model.kmodel import load_model

REPO = pathlib.Path(__file__).resolve().parent.parent
FLAGS = {"k21": ["-k21"], "k31_ci2": ["-k31", "-ci2"],
         "k25_ci2_cs3": ["-k25", "-ci2", "-cs3"]}
FILES = ["o.res.kmc_pre", "o.res.kmc_suf", "o.res/header", "o.res/km.bin",
         "o.res/rest.bin"]


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """The generator of tests/test_cli.py::test_cli_end_to_end."""
    d = tmp_path_factory.mktemp("fq")
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=2000))
    fq = d / "r.fastq"
    with open(fq, "w") as f:
        for i in range(200):
            s = int(rng.integers(0, len(genome) - 100))
            r = genome[s : s + 100]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return fq


@pytest.fixture(scope="module")
def jax_builds(fastq, tmp_path_factory):
    """The JAX package's CLI build for every flag set (built once)."""
    out = {}
    for name, flags in FLAGS.items():
        wd = tmp_path_factory.mktemp("jax_" + name)
        assert jax_cli.main(["kmcex", *flags, str(fastq), str(wd / "o.res"),
                             str(wd)]) == 0
        out[name] = wd
    return out


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_build_byte_identical(name, fastq, jax_builds, tmp_path, capsys):
    rc = torch_cli.main(["kmcex", *FLAGS[name], str(fastq),
                         str(tmp_path / "o.res"), str(tmp_path)],
                        device="cpu")
    assert rc == 0
    assert "total kmercount" in capsys.readouterr().out
    for fn in FILES:
        assert ((tmp_path / fn).read_bytes()
                == (jax_builds[name] / fn).read_bytes()), fn


@pytest.mark.parametrize("name", list(FLAGS))
def test_jax_model_loads_and_saves_identical(name, jax_builds, tmp_path):
    src = jax_builds[name] / "o.res"
    km = load_model(src)
    km.save(tmp_path / "m")
    for fn in ("header", "km.bin", "rest.bin"):
        assert (tmp_path / "m" / fn).read_bytes() == (src / fn).read_bytes()


def test_kmc1_stream_writer_identical(tmp_path):
    rng = np.random.default_rng(11)
    kmers = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    counts = rng.integers(1, 300, len(kmers)).astype(np.uint64)
    for mod, name in ((jax_kmc_db, "j"), (torch_kmc_db, "t")):
        w = mod.KMC1StreamWriter(str(tmp_path / name), 31, min_count=2,
                                 max_count=255)
        for a in range(0, len(kmers), 1234):
            w.write_chunk(kmers[a : a + 1234], counts[a : a + 1234])
        w.close()
    for ext in (".kmc_pre", ".kmc_suf"):
        assert ((tmp_path / ("j" + ext)).read_bytes()
                == (tmp_path / ("t" + ext)).read_bytes())


def test_port_imports_without_jax():
    """Every module of the port imports in a process where importing jax or
    kmcex_tpu fails."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kmcex_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kmcex_tpu_torch
for m in pkgutil.walk_packages(kmcex_tpu_torch.__path__, "kmcex_tpu_torch."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "kmcex_tpu")]
assert not bad, bad
for name in ("core.murmur", "model.device_bloom", "query.device_model",
             "core.signature", "core.codec_mw", "io.kmc_db", "query.annotate",
             "count.counter", "count.device_lsm", "count.pipeline",
             "parallel.comm", "parallel.sharded", "parallel.serve",
             "parallel.distributed"):
    assert "kmcex_tpu_torch." + name in sys.modules, name
assert kmcex_tpu_torch.DeviceKModel and kmcex_tpu_torch.load_model
from kmcex_tpu_torch.io.kmc_db import KMCReader, write_kmc1, write_kmc2
from kmcex_tpu_torch.count.pipeline import count_fastq, count_encode, run
from kmcex_tpu_torch.native import merge_runs, murmur64, segment_buffer
from kmcex_tpu_torch.native import encode_bitarrays
from kmcex_tpu_torch.parallel.serve import make_server
from kmcex_tpu_torch.parallel.distributed import distributed_count_fastq
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_default_device_raises_without_cuda(fastq, tmp_path, monkeypatch):
    from kmcex_tpu_torch.count import pipeline
    from kmcex_tpu_torch.config import KParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["kmcex", "-k21", str(fastq), str(tmp_path / "o.res"),
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.count_encode(str(fastq), k=21)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run(KParams(k=21, input_file_name=str(fastq),
                             output_file_name=str(tmp_path / "o.res"),
                             working_directory=str(tmp_path)))
    assert not (tmp_path / "o.res.kmc_suf").exists()


# ------------------------------------------------- the reference's call surface
def test_count_encode_signature_is_the_reference(fastq, tmp_path):
    """Same positional order and defaults as the JAX package's count_encode
    (the port adds ``device``, keyword only): both called with the same nine
    positional arguments, and with the input alone, give the same table,
    model and statistics."""
    import inspect

    from kmcex_tpu.count import pipeline as jpipe
    from kmcex_tpu_torch.count import pipeline as tpipe

    jsig = inspect.signature(jpipe.count_encode).parameters
    tsig = inspect.signature(tpipe.count_encode).parameters
    assert list(tsig)[:-1] == list(jsig) and list(tsig)[-1] == "device"
    assert tsig["device"].kind is inspect.Parameter.KEYWORD_ONLY
    for name in jsig:
        assert tsig[name].default == jsig[name].default, name
    jfq = inspect.signature(jpipe.count_fastq).parameters
    tfq = inspect.signature(tpipe.count_fastq).parameters
    assert list(tfq)[:-1] == list(jfq) and list(tfq)[-1] == "device"

    def model_bytes(km, d):
        km.save(d)
        return [(d / f).read_bytes() for f in ("header", "km.bin", "rest.bin")]

    nine = (str(fastq), 21, 2, 300, 6, 4, 64, 128, True)
    for i, args in enumerate((nine, (str(fastq),))):
        wkm, wk, wc, wst = jpipe.count_encode(*args)
        gkm, gk, gc, gst = tpipe.count_encode(*args, device="cpu")
        assert gk is not None and len(gk) > 500  # keep_pairs defaults True
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)
        assert (model_bytes(gkm, tmp_path / f"t{i}")
                == model_bytes(wkm, tmp_path / f"j{i}"))
        assert (gst.reads, gst.bases, gst.distinct_kmers) == \
            (wst.reads, wst.bases, wst.distinct_kmers)
    # the tenth positional argument is db_path in both
    for mod, name, kw in ((jpipe, "j", {}), (tpipe, "t", {"device": "cpu"})):
        mod.count_encode(*nine[:8], False, str(tmp_path / f"db_{name}"), **kw)
    for ext in (".kmc_pre", ".kmc_suf"):
        assert ((tmp_path / f"db_j{ext}").read_bytes()
                == (tmp_path / f"db_t{ext}").read_bytes())


def test_kparams_accepts_sharded_and_names_the_backends():
    from kmcex_tpu_torch.config import KParams

    assert KParams(accumulator="sharded").accumulator == "sharded"
    with pytest.raises(ValueError, match="device|sharded"):
        KParams(accumulator="host")


def test_phases_report_and_device_trace(fastq, tmp_path, monkeypatch):
    """Phases.report prints what the JAX package's prints; device_trace is a
    no-op without KMCEX_TRACE_DIR and writes a Chrome trace of count_encode
    with it."""
    import json

    from kmcex_tpu.utils import timing as jtiming
    from kmcex_tpu_torch.count.pipeline import count_encode
    from kmcex_tpu_torch.utils import timing

    a, b = timing.Phases(), jtiming.Phases()
    for ph in (a, b):
        ph.add("stream+extract", 1.25)
        ph.add("merge+stats", 0.5)
        ph.add("stream+extract", 0.25)
    assert a.report() == b.report()
    assert "(sum of phases)" in a.report() and "2.000s" in a.report()

    monkeypatch.delenv("KMCEX_TRACE_DIR", raising=False)
    with timing.device_trace("nothing"):
        pass
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("KMCEX_TRACE_DIR", str(tmp_path / "traces"))
    count_encode(str(fastq), k=21, keep_pairs=False, device="cpu")
    trace = json.loads((tmp_path / "traces" / "count_encode.json").read_text())
    assert len(trace["traceEvents"]) > 10


def test_native_encode_bitarrays_equals_jax():
    """The one-shot encode against the JAX package's binding, and against
    the chunked BitArrayEncoder it wraps."""
    from kmcex_tpu import native as jnative
    from kmcex_tpu_torch import native as tnative

    rng = np.random.default_rng(21)
    k, n_bits, n_hash = 21, 3, 4
    kmers = np.unique(rng.integers(0, 1 << 42, 3000, dtype=np.uint64))
    occs = rng.integers(1, 30, len(kmers)).astype(np.uint32)
    occ2bin = np.arange(64, dtype=np.uint32)
    km_bit = 4096
    nbytes = n_bits * km_bit // 8

    def run(fn):
        b1, b2 = np.zeros(nbytes, np.uint8), np.zeros(nbytes, np.uint8)
        back = np.zeros(2048, np.uint8)
        rest = fn(kmers, occs, k, n_bits, n_hash, occ2bin, b1, b2, km_bit,
                  back, 2048 * 8, n_hash - 2, 1 << 10, 2)
        return b1, b2, back, rest[0], rest[1]

    def chunked(kmers, occs, *args):
        enc = tnative.BitArrayEncoder(*args)
        for a in range(0, len(kmers), 700):
            enc.feed(kmers[a : a + 700], occs[a : a + 700])
        return enc.finish()

    want = run(jnative.encode_bitarrays)
    assert want[0].any() and len(want[3]) > 0  # something encoded, some rest
    for fn in (tnative.encode_bitarrays, chunked):
        for g, w in zip(run(fn), want):
            np.testing.assert_array_equal(g, w)
