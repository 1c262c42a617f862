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
             "count.counter", "count.device_lsm", "count.pipeline"):
    assert "kmcex_tpu_torch." + name in sys.modules, name
assert kmcex_tpu_torch.DeviceKModel and kmcex_tpu_torch.load_model
from kmcex_tpu_torch.io.kmc_db import KMCReader, write_kmc1, write_kmc2
from kmcex_tpu_torch.count.pipeline import count_fastq, count_encode, run
from kmcex_tpu_torch.native import merge_runs, murmur64, segment_buffer
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
