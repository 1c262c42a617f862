"""Scale soak of the port on one NVIDIA GPU: ten times the benchmark's read
set through ``count_encode`` at whatever tier thresholds the environment
gives (none set: the defaults), with sustained throughput, tier events, peak
device memory and peak RSS on record, and the whole table checked against an
independent numpy count.

    python3 -m kmcex_tpu_torch.tools.soak [n_reads] [out_json] [--device cpu]

The counterpart of the JAX package's ``tools/soak.py``: 2,000,000 reads of
150 bp from a 20M-base genome (the benchmark's generator, seed 2025, 0.2%
errors), k=31 ci=1 cs=1023 num_hash=7 num_bit=5.  Three passes: a warm
model-only ``count_encode(keep_pairs=False)``, the timed one, and a
verification pass that keeps the pairs; then the oracle.  Writes a JSON
artifact (default ``chiprun_out/SOAK_torch.json`` under the repository root)
and exits 1 when keys, counts or the model's total disagree with the oracle.
Runs on the card unless ``--device cpu`` asks for the plain versions; without
a card and without that flag it raises.  With ``KMCEX_TRACE_DIR`` set every
pass is traced, and the artifact carries the device's idle share of the timed
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator
from kmcex_tpu_torch.count.pipeline import count_encode
from kmcex_tpu_torch.model.kmodel import KModel
from kmcex_tpu_torch.native import kernels
from kmcex_tpu_torch.tools import workload
from kmcex_tpu_torch.utils.device import resolve_device
from kmcex_tpu_torch.utils.timing import trace_device_busy

N_READS = 2_000_000
GENOME = 20_000_000
SEED = 2025
ERR_RATE = 0.002
K, CI, CS, NH, NB = 31, 1, 1023, 7, 5
DEFAULT_OUT = (pathlib.Path(__file__).resolve().parents[2] / "chiprun_out"
               / "SOAK_torch.json")


def log(m: str) -> None:
    print(m, file=sys.stderr, flush=True)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def peak_rss_mb() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024


@dataclasses.dataclass
class SoakRun:
    """What ``run`` found: the artifact, the verdict, and the objects a
    caller may want to look at further."""
    artifact: dict
    ok: bool
    km: KModel            # the timed model-only pass
    km_verify: KModel     # the verification pass (pairs kept)
    want_k: np.ndarray    # the oracle's table, counts cs-clamped
    want_c: np.ndarray


def run(n_reads: int, workdir: pathlib.Path, device=None) -> SoakRun:
    """Generate the read set under ``workdir``, run the three passes and the
    oracle.  Changes no threshold: the environment decides."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rss_start = peak_rss_mb()  # the imports alone
    fq = pathlib.Path(workdir) / f"reads_soak_{n_reads}.fastq"
    log(f"generating soak FASTQ ({n_reads} reads, {GENOME} base genome)")
    t0 = time.time()
    reads = workload.make_fastq(fq, GENOME, n_reads, SEED, ERR_RATE)
    t_gen = time.time() - t0
    rss_gen = peak_rss_mb()
    trace_dir = os.environ.get("KMCEX_TRACE_DIR")

    def build(**kw):
        return count_encode(str(fq), K, CI, CS, NH, NB, device=device, **kw)

    # pass 1 builds the kernels and warms the allocator; pass 2 is the record
    log("pass 1 (warm) ...")
    t0 = time.time()
    build(keep_pairs=False)
    t_warm = time.time() - t0
    log(f"pass 1: {t_warm:.1f}s")
    log("pass 2 (timed) ...")
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.time()
    km, _, _, stats = build(keep_pairs=False)
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak_dev = (torch.cuda.max_memory_allocated(device) / 2**20 if on_card
                else None)
    rss_mb = peak_rss_mb()
    idle = None
    if trace_dir:  # the next pass overwrites the trace: read it now
        busy, span = trace_device_busy(
            pathlib.Path(trace_dir) / "count_encode.json")
        idle = {"busy_seconds": busy, "span_seconds": span,
                "idle_share": 1 - busy / span if span else None}
    rate = stats.reads / wall / 1e6
    log(f"soak: {stats.reads} reads, {stats.windows} windows, "
        f"{stats.distinct_kmers} distinct in {wall:.1f}s -> {rate:.3f} "
        f"Mreads/s; tiers {stats.tiers}; launches {launches}; peak RSS "
        f"{rss_mb}MB")

    # verification pass (keeps pairs) + independent numpy oracle
    log("verification pass + oracle ...")
    km2, kmers, counts, _ = build()
    t0 = time.time()
    want_k, want_c = workload.oracle_counts(reads, K)
    t_oracle = time.time() - t0
    del reads
    want_c = np.minimum(want_c, CS).astype(np.uint32)
    ok_keys = np.array_equal(kmers, want_k)
    ok_counts = np.array_equal(counts, want_c)
    log(f"oracle: keys {'OK' if ok_keys else 'MISMATCH'}, counts "
        f"{'OK' if ok_counts else 'MISMATCH'} ({len(want_k)} distinct, "
        f"{t_oracle:.1f}s)")
    # model totals line up with the table
    ok_model = km.total_kmer_count == len(want_k)

    acc = DeviceCountAccumulator(K, device=device)  # the thresholds in force
    artifact = {
        "workload": {"n_reads": n_reads, "read_len": workload.READ_LEN,
                     "genome_len": GENOME, "k": K, "err_rate": ERR_RATE,
                     "seed": SEED},
        "device": device_label(device),
        "thresholds": {"raw_tier_elems": acc.raw_tier_elems,
                       "spill_threshold": acc.spill_threshold,
                       "disk_spill_bytes": acc.disk_spill_bytes},
        "wall_seconds": wall,
        "warm_pass_seconds": t_warm,
        "mreads_per_s": rate,
        "windows": stats.windows,
        "distinct_kmers": stats.distinct_kmers,
        "count_seconds": stats.count_seconds,
        "encode_seconds": stats.encode_seconds,
        "phases": dict(stats.phases),
        "tiers": stats.tiers,
        "spill": stats.spill,
        "kernel_launches": launches,
        "table_bytes_to_host": stats.table_bytes_to_host,
        "peak_device_mb": peak_dev,
        "peak_rss_mb": rss_mb,
        "peak_rss_at_start_mb": rss_start,
        "peak_rss_after_generate_mb": rss_gen,
        "device_idle": idle,
        "generate_seconds": t_gen,
        "oracle_seconds": t_oracle,
        "oracle": {"keys_exact": bool(ok_keys),
                   "counts_exact": bool(ok_counts),
                   "model_total_matches": bool(ok_model)},
    }
    return SoakRun(artifact, bool(ok_keys and ok_counts and ok_model), km,
                   km2, want_k, want_c)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=N_READS)
    ap.add_argument("out_json", nargs="?", type=pathlib.Path,
                    default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="kmcex_soak_") as tmp:
        res = run(args.n_reads, pathlib.Path(tmp), args.device)
    args.out_json.parent.mkdir(parents=True, exist_ok=True)
    args.out_json.write_text(json.dumps(res.artifact, indent=1) + "\n")
    log(f"wrote {args.out_json}")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
