"""Build the port's two shared libraries at first use, into ``_build/``.

* ``libkmcex_native.so`` — the host runtime (sequential coupled-array
  encoder, Bloom insert, FASTQ segmenter), compiled with g++ from the
  port's own copy of the JAX package's C++ source,
  ``native/src/kmcex_native.cpp`` (the same code, so the same encoder
  bytes), so the port builds without the JAX package's directory.
* ``libkmcex_kernels.so`` — the hand-written CUDA kernels of ``csrc/``,
  compiled with nvcc for sm_90a behind a plain C interface and loaded with
  ctypes (no PyTorch headers, so a build takes seconds, not minutes).

Both are cached by source mtime and replaced atomically, so concurrent
builds never load a half-written library.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG / "native" / "src" / "kmcex_native.cpp"
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def _fresh(lib: pathlib.Path, sources: list[pathlib.Path]) -> bool:
    return lib.exists() and all(
        lib.stat().st_mtime >= s.stat().st_mtime for s in sources)


def _compile(cmd_for, lib: pathlib.Path) -> pathlib.Path:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(".so.tmp%d" % os.getpid())
    res = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {lib.name} failed:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def build_native(force: bool = False) -> pathlib.Path:
    lib = BUILD_DIR / "libkmcex_native.so"
    if not NATIVE_SRC.exists():
        raise FileNotFoundError(f"native source missing: {NATIVE_SRC}")
    if not force and _fresh(lib, [NATIVE_SRC]):
        return lib
    return _compile(lambda out: [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fopenmp", str(NATIVE_SRC), "-o", str(out)], lib)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise FileNotFoundError("nvcc not found (CUDA toolkit needed to build "
                            "the kernels)")


def kernel_sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_kernels(force: bool = False) -> pathlib.Path:
    lib = BUILD_DIR / "libkmcex_kernels.so"
    srcs = kernel_sources()
    if not force and _fresh(lib, srcs):
        return lib
    cu = [str(s) for s in srcs if s.suffix == ".cu"]
    return _compile(lambda out: [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(out), *cu], lib)
