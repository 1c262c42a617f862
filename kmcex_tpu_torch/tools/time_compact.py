"""Time ``compact_pairs`` on one NVIDIA GPU beside a plain device copy of the
same bytes and its bytes bound, at the main path's shapes.

    python3 -m kmcex_tpu_torch.tools.time_compact [--reps 9] [--ptxas] \
        [--variants 4x4,8x2] [--clocks]

Cases (``CASES``): 64M pairs with 80% holes (a segment count: ascending
keys, duplicate slots holed), 96M with 60% (the merge of a 64M run and a 32M
one), and 64M with none and with all holes.  Each is first held exactly
against ``compact_pairs_plain`` (0 elements differ), then timed in turns:
the wrapper's whole call (``ms``), ``out.copy_(in)`` of its keys and counts
(``copy_ms``: 12 bytes read and 12 written a pair, as the kernel must), and
the device time of each kernel of one call from torch.profiler.

A variant is RUNSxMIN_BLOCKS, passed to nvcc as ``-DKX_COMPACT_RUNS`` /
``-DKX_COMPACT_MIN_BLOCKS`` on ``csrc/compact.cu``; all builds start
together.  Each build is held exactly against the plain version too, then
timed in the same turns as one launch into preallocated outputs (the
scratch zeroed before the events).  ``--ptxas`` prints nvcc's register and
shared-memory report of each build.  ``--clocks`` builds every variant with
``-DKX_COMPACT_CLOCKS``: each block then adds its phase clocks (SM cycles:
claim, load and count, stage and look-back, stores, blocks, whole lives) to
six words after its scratch, and the row carries them under ``clocks``,
summed over the blocks of the last timed launch.

It times whichever ``kmcex_tpu_torch`` is importable, so another version of
the package is timed the same way with ``PYTHONPATH=<other checkout>
python3 kmcex_tpu_torch/tools/time_compact.py``.  Prints one JSON line per
case, then the card's name and power limit; exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kmcex_tpu_torch.count import compact
from kmcex_tpu_torch.native import build

SENT = -1
PEAK_BYTES_S = 3.35e12  # one H100 SXM's device memory
CASES = ((64 << 20, 0.8), (96 << 20, 0.6), (64 << 20, 0.0), (64 << 20, 1.0))


def compact_case(rng, n: int, hole_share: float, dev):
    """Ascending keys below 2^62 with a ``hole_share`` of the slots holed
    (SENTINEL, 0); counts in [1, 2^20)."""
    keys, _ = torch.sort(torch.from_numpy(
        rng.integers(0, 1 << 62, n, dtype=np.int64)).to(dev))
    holes = torch.from_numpy(rng.random(n) < hole_share).to(dev)
    keys[holes] = SENT
    cnt = torch.from_numpy(rng.integers(1, 1 << 20, n).astype(np.int32)).to(dev)
    cnt[holes] = 0
    return keys, cnt


def event_ms(fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def kernel_ms(fn) -> dict:
    """Device ms of each kernel (and memset) of one call of ``fn``."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: getattr(e, "device_time_total", 0.0) / 1e3
            for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0}


def start_build(src: pathlib.Path, defines: list[str], out: pathlib.Path,
                ptxas: bool):
    cmd = [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *(["-Xptxas", "-v"] if ptxas else []), *defines, "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load(path: pathlib.Path):
    p = ctypes.c_void_p
    L = ctypes.CDLL(str(path))
    L.kx_compact_tile.restype = ctypes.c_int
    L.kx_compact_tile.argtypes = []
    L.kx_compact_scratch_words.restype = ctypes.c_int64
    L.kx_compact_scratch_words.argtypes = [ctypes.c_int64]
    L.kx_compact_pairs.restype = ctypes.c_int
    L.kx_compact_pairs.argtypes = [p, p, ctypes.c_int64, p, p, p, p]
    return L


def build_all(variants: list[str], ptxas: bool, clocks: bool) -> dict:
    out_dir = build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    clock_flag = ["-DKX_COMPACT_CLOCKS"] if clocks else []
    jobs = {}
    for v in variants:
        runs, blocks = (int(x) for x in v.split("x"))
        so = out_dir / f"compact_{v}.so"
        jobs[v] = (so, start_build(build.CSRC_DIR / "compact.cu",
                                   [f"-DKX_COMPACT_RUNS={runs}",
                                    f"-DKX_COMPACT_MIN_BLOCKS={blocks}",
                                    *clock_flag], so, ptxas))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{log}")
        if ptxas:
            print(f"[build] {name}:\n{log}")
        libs[name] = load(so)
    return libs


def launch(L, keys, cnt, ok, oc, scratch) -> None:
    rc = L.kx_compact_pairs(keys.data_ptr(), cnt.data_ptr(), keys.numel(),
                            ok.data_ptr(), oc.data_ptr(), scratch.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kx_compact_pairs: CUDA error {rc} at launch")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"[time_compact] {compact.__file__}")
    libs = build_all([v for v in args.variants.split(",") if v], args.ptxas,
                     args.clocks)
    rng = np.random.default_rng(2024)
    bad_total = 0
    for n, hole_share in CASES:
        keys, cnt = compact_case(rng, n, hole_share, dev)
        wk, wc = compact.compact_pairs_plain(keys, cnt)
        gk, gc = compact.compact_pairs(keys, cnt)
        bad = {"package": int((gk != wk).sum()) + int((gc != wc).sum())}
        del gk, gc
        ok, oc = torch.empty_like(keys), torch.empty_like(cnt)
        scratch = {}
        for name, L in libs.items():
            # the kernel's scratch, then the phase clocks of a
            # -DKX_COMPACT_CLOCKS build
            scratch[name] = torch.zeros(L.kx_compact_scratch_words(n) + 6,
                                        dtype=torch.int64, device=dev)
            ok.fill_(7)
            oc.fill_(7)
            launch(L, keys, cnt, ok, oc, scratch[name])
            bad[name] = int((ok != wk).sum()) + int((oc != wc).sum())
        bad_total += sum(bad.values())
        del wk, wc

        def copy():
            ok.copy_(keys)
            oc.copy_(cnt)

        times = {"ms": [], "copy_ms": [], "host_ms": [],
                 **{name: [] for name in libs}}
        for _ in range(args.reps):
            times["ms"].append(event_ms(lambda: compact.compact_pairs(keys,
                                                                      cnt)))
            # the wrapper's own host time: what the device waits for before
            # its first kernel when nothing else is queued
            torch.cuda.synchronize()
            t = time.perf_counter()
            compact.compact_pairs(keys, cnt)
            times["host_ms"].append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            times["copy_ms"].append(event_ms(copy))
            for name, L in libs.items():
                scratch[name].zero_()
                times[name].append(event_ms(
                    lambda: launch(L, keys, cnt, ok, oc, scratch[name])))
        med = {k_: float(np.median(v)) for k_, v in times.items()}
        bound_ms = 24 * n / PEAK_BYTES_S * 1e3
        row = {"n": n, "holes": hole_share, "mismatches": bad,
               "ms": med["ms"], "copy_ms": med["copy_ms"],
               "host_ms": med["host_ms"],
               "bound_ms": bound_ms, "share_of_bound": bound_ms / med["ms"],
               "share_of_copy": med["copy_ms"] / med["ms"],
               "launch_ms": {name: med[name] for name in libs},
               "clocks": {name: scratch[name][-6:].tolist() for name in libs
                          if args.clocks},
               "device_ms": kernel_ms(lambda: compact.compact_pairs(keys,
                                                                    cnt))}
        print(json.dumps(row))
        del keys, cnt, ok, oc, scratch
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 1 if bad_total else 0


if __name__ == "__main__":
    sys.exit(main())
