"""Build variants of ``csrc/merge.cu`` and time them against each other on
one NVIDIA GPU.

    python3 -m kmcex_tpu_torch.tools.tune_merge \
        [--variants 256x15x4,256x17x4,128x15x8] [--also OTHER/merge.cu] \
        [--reps 9] [--ptxas]

A variant is THREADSxITEMSxBLOCKS_PER_SM, passed to nvcc as
``-DKX_MERGE_THREADS`` / ``-DKX_MERGE_ITEMS`` / ``-DKX_MERGE_BLOCKS_PER_SM``;
``--also`` adds another source with the same ``kx_merge_u64`` entry point
(an earlier version of the file, say) under its path.  All builds start
together, one nvcc each.  Every variant must equal the plain version
(``merge_sorted_u64_plain``) exactly, keys and payloads, at every shape,
the tie-heavy one included; then the variants are timed in turns (CUDA
events around one launch into preallocated outputs, median of ``--reps``).
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from kmcex_tpu_torch.core.codec import BIAS
from kmcex_tpu_torch.count import sort
from kmcex_tpu_torch.native import build

SENT = -1
SHAPES = {"16M+16M": (16 << 20, 16 << 20), "64M+4M": (64 << 20, 4 << 20),
          "700+1100": (700, 1100)}
TIES = (4 << 20, 4 << 20)


def padded_run(rng, m: int, fill: float, dev):
    """An ascending run of m keys (half with bit 63 set), the last
    ``1 - fill`` of it (SENTINEL, 0) padding, and int32 payloads."""
    k = torch.from_numpy(rng.integers(0, 1 << 63, m, dtype=np.int64)
                         | np.where(rng.random(m) < 0.5, BIAS, 0)).to(dev)
    k = sort.sort_u64_plain(k)
    real = int(m * fill)
    k[real:] = SENT
    c = torch.from_numpy(rng.integers(1, 1 << 20, m).astype(np.int32)).to(dev)
    c[real:] = 0
    return k, c


def tie_run(rng, m: int, first_payload: int, dev):
    """An ascending run of m keys drawn from 2^16 values; the payload is a
    unique index, so a wrong order among equal keys shows."""
    k = torch.from_numpy(rng.integers(0, 1 << 16, m, dtype=np.int64)).to(dev)
    k = sort.sort_u64_plain(k << 40)
    c = torch.arange(first_payload, first_payload + m, dtype=torch.int32,
                     device=dev)
    return k, c


def start_build(src: pathlib.Path, defines: list[str], out: pathlib.Path,
                ptxas: bool):
    cmd = [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *(["-Xptxas", "-v"] if ptxas else []), *defines, "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load(path: pathlib.Path):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    L = ctypes.CDLL(str(path))
    L.kx_merge_u64.restype = ctypes.c_int
    L.kx_merge_u64.argtypes = [p, p, i64, p, p, i64, p, p, p]
    return L


def launch(L, a, ca, b, cb, ok, oc) -> None:
    rc = L.kx_merge_u64(a.data_ptr(), ca.data_ptr(), a.numel(), b.data_ptr(),
                        cb.data_ptr(), b.numel(), ok.data_ptr(), oc.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kx_merge_u64: CUDA error {rc} at launch")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="256x15x4")
    ap.add_argument("--also", action="append", default=[])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas -v (registers, spills) for each build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out_dir = build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)

    jobs = {}
    for v in args.variants.split(","):
        t, i, bl = (int(x) for x in v.split("x"))
        defs = [f"-DKX_MERGE_THREADS={t}", f"-DKX_MERGE_ITEMS={i}",
                f"-DKX_MERGE_BLOCKS_PER_SM={bl}"]
        so = out_dir / f"merge_{v}.so"
        jobs[v] = (so, start_build(build.CSRC_DIR / "merge.cu", defs, so,
                                   args.ptxas))
    for n_, path in enumerate(args.also):
        so = out_dir / f"merge_also{n_}.so"
        jobs[path] = (so, start_build(pathlib.Path(path), [], so, args.ptxas))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[build] {name} FAILED:\n{log}")
            continue
        if args.ptxas:
            print(f"[build] {name}:\n{log}")
        libs[name] = load(so)
    if not libs:
        return 1

    rng = np.random.default_rng(2024)
    results = {name: {} for name in libs}
    cases = [(label, padded_run(rng, la, 0.85, dev),
              padded_run(rng, lb, 0.7, dev))
             for label, (la, lb) in SHAPES.items()]
    ta = tie_run(rng, TIES[0], 0, dev)
    cases.append(("ties4M+4M", ta, tie_run(rng, TIES[1], TIES[0], dev)))
    for label, (a, ca), (b, cb) in cases:
        wk, wc = sort.merge_sorted_u64_plain(a, ca, b, cb)
        ok, oc = torch.empty_like(wk), torch.empty_like(wc)
        times = {name: [] for name in libs}
        for name, L in libs.items():
            ok.zero_()
            oc.zero_()
            launch(L, a, ca, b, cb, ok, oc)
            torch.cuda.synchronize()
            bad = int((ok != wk).sum()) + int((oc != wc).sum())
            results[name][f"{label}_mismatches"] = bad
        for _ in range(args.reps):
            for name, L in libs.items():
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                launch(L, a, ca, b, cb, ok, oc)
                t1.record()
                torch.cuda.synchronize()
                times[name].append(t0.elapsed_time(t1))
        for name in libs:
            results[name][f"{label}_ms"] = float(np.median(times[name]))
        del wk, wc, ok, oc
    bad = 0
    for name, row in results.items():
        bad += sum(v for k_, v in row.items() if k_.endswith("mismatches"))
        print(json.dumps({"variant": name, **row}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
