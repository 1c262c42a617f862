"""The port builds its host runtime from its own copy of the native source:
a copy of ``kmcex_tpu_torch/`` alone, in a directory without the JAX
package, compiles ``libkmcex_native.so`` with g++ and writes the same model
files as the port in the repo."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

import kmcex_tpu_torch.cli as torch_cli
from kmcex_tpu_torch.native import build

REPO = pathlib.Path(__file__).resolve().parent.parent
MODEL_FILES = ("header", "km.bin", "rest.bin")

BUILD_ALONE = r"""
import pathlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kmcex_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kmcex_tpu_torch
from kmcex_tpu_torch.cli import main
from kmcex_tpu_torch.native import build

here = pathlib.Path.cwd().resolve()
assert pathlib.Path(kmcex_tpu_torch.__file__).resolve().parent.parent == here
assert build.NATIVE_SRC.resolve().is_relative_to(here), build.NATIVE_SRC
fq, out, wd = sys.argv[1:4]
assert main(["kmcex", "-k25", "-ci2", fq, out, wd], device="cpu") == 0
assert (build.BUILD_DIR / "libkmcex_native.so").exists()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "kmcex_tpu")]
assert not bad, bad
print("ok")
"""


def _fastq(path: pathlib.Path) -> None:
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    with open(path, "w") as f:
        for i in range(300):
            s = int(rng.integers(0, len(genome) - 100))
            r = genome[s : s + 100]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def test_port_builds_native_without_jax_package(tmp_path):
    """Copy the port (without its build directory) where no ``kmcex_tpu/``
    exists, build and run the CLI there; the model bytes equal the in-repo
    port's on the same input."""
    root = tmp_path / "alone"
    shutil.copytree(REPO / "kmcex_tpu_torch", root / "kmcex_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    assert not (root / "kmcex_tpu").exists()
    fq = tmp_path / "r.fastq"
    _fastq(fq)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", BUILD_ALONE, str(fq), str(tmp_path / "a.res"),
         str(tmp_path)], cwd=root, env=dict(env, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")

    here = tmp_path / "here"
    here.mkdir()
    assert torch_cli.main(["kmcex", "-k25", "-ci2", str(fq),
                           str(here / "b.res"), str(here)], device="cpu") == 0
    for fn in MODEL_FILES:
        assert ((tmp_path / "a.res" / fn).read_bytes()
                == (here / "b.res" / fn).read_bytes()), fn


def test_native_source_is_the_jax_packages_code():
    """The port's copy lies inside the port and holds the JAX package's
    code line for line; only comment lines may read differently."""
    port = build.NATIVE_SRC
    assert port.resolve().is_relative_to(REPO / "kmcex_tpu_torch")
    jax_src = REPO / "kmcex_tpu" / "native" / "src" / "kmcex_native.cpp"
    a = port.read_text().splitlines()
    b = jax_src.read_text().splitlines()
    assert len(a) == len(b)
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    assert all(a[i].lstrip().startswith("//") and
               b[i].lstrip().startswith("//") for i in differ), differ
