#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kmcex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA kernel library (nvcc, sm_90a) and the native host
     library (g++), from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, exact equality (differing elements
     counted in integers, keys as unsigned 64-bit), with median
     kernel and plain times from CUDA events (the sort at 64M keys and at
     the realistic workload's 65,961,984, keys and payloads exact; the
     merge at 16M + 16M, 700 + 1100, 64M + 4M, a tie-heavy 4M + 4M pair
     whose payloads show the order of equal keys, and the soak's 32M + 32M
     (four fifths of one run's keys also in the other) and 64M + 32M; the
     run LSM's whole merge step, ``_merge_runs``, at 16M + 16M and at 32M +
     32M beside the merge kernel; the compaction at 64M pairs and at the
     96M pairs a 64M + 32M merge leaves), each beside its bound: the bytes
     it must move at the card's 3.35 TB/s or its operations at 67 T/s,
     whichever takes longer;
  4. the port's CLI build on the realistic-spectrum workload (the seeded
     generator of bench.py: 2M-base genome, 533,000 x 150 bp reads, 0.5%
     errors; k=31 ci=1 cs=1023 nh=7 nb=5), the Bloom bank built on the
     device: 10,883,515 distinct k-mers, and the KMC1 database and the model
     byte-identical to an independent numpy count fed to the port's host
     encoder (host Bloom insert); its peak device memory; then the same
     build twice more, warm, with ``KMCEX_DEVICE_BLOOM=0`` and without, the
     two encode times side by side;
  5. the same on the headline workload (200,000 reads, 0.2% errors) with a
     small raw tier, so the run LSM collapses and merges;
  6. the Bloom bank alone on the realistic table: ``DeviceBloomBuilder`` fed
     in one call and in two, against the host insert, 0 differing bytes;
     CUDA-event times of the feed and of the byte pack;
  7. the model-only path, ``count_encode(..., db_path=None)``: the model
     equal to phase 4's byte for byte, one more compaction launch (the
     low-key drop), and the table bytes that crossed to the host with and
     without the drop;
  8. serving: ``load_model`` on phase 4's model, ``DeviceKModel`` on the
     card, bench.py's query mix (1,000,000 queries, half counted k-mers,
     half random): the device answers equal the host's on every query,
     twice; host, end-to-end and device-resident Mq/s;
  9. spill: the realistic CLI build with the tiers forced by
     ``KMCEX_RAW_TIER_ELEMS`` / ``KMCEX_SPILL_THRESHOLD`` /
     ``KMCEX_DISK_SPILL_BYTES``: raw collapses, device merges, host spills
     and disk spills all happen, the five files equal phase 4's byte for
     byte, the temp directory is empty afterwards; again with
     ``KMCEX_DISK_SPILL_BYTES=0`` (the all-RAM host route), same bytes;
 10. kill and resume: the CLI in a subprocess with ``-ckpt<dir>`` and an
     injected crash exits non-zero and leaves a manifest; another ``-k``
     against that directory fails on the fingerprint; the same command
     without the crash resumes, skips the counted batches, writes the same
     bytes and retires the manifest;
 11. database: ``KMCReader`` on phase 4's database (listing and 1,000,000
     random-access lookups against the numpy oracle), ``KModel.init`` from
     it (model bytes equal phase 4's), a ``write_kmc2`` round trip, and
     per-window annotation of 1,000 reads from the database and the model;
 12. sharded build at full width: the realistic read set through
     ``count_encode(accumulator="sharded")`` on a mesh of four logical
     shards of the card, in this process: the five files equal phase 4's
     byte for byte, the Bloom bank is built across the mesh (no host
     insert), no re-route, all shards' sizes printed; then with the tiers
     forced per shard (host and disk runs on every shard, the host inserts
     the Bloom bank), same bytes; then an injected crash after a checkpoint
     and a resume through ``ShardedCountAccumulator.restore``, same bytes;
 13. sharded serving: ``make_server`` over four shards of the card on phase
     8's 1,000,000 queries, every answer equal to ``DeviceKModel``'s and the
     host's;
 14. two processes: two spawned ranks of two shards each, both on the one
     card, joined by gloo (KMCEX_COORDINATOR, KMCEX_NUM_PROCESSES,
     KMCEX_PROCESS_ID, KMCEX_LOCAL_SHARDS), run the CLI with ``-accsharded``
     on the headline read set: rank 0's files equal the numpy oracle's,
     rank 1 writes none, both exit 0;
 15. soak: ``kmcex_tpu_torch.tools.soak`` at its full size (2,000,000 reads
     of a 20M-base genome, seed 2025: 245,858,304 windows) with no tier
     threshold set, so the raw tier (64M windows) and the spill threshold
     (128M entries) are the defaults: a warm model-only build, the timed
     one, one that keeps the pairs, and the partitioned numpy oracle:
     34,151,483 distinct k-mers, keys and cs-clamped counts equal element
     by element, at least 3 raw collapses and 2 device merges and no spill,
     no host Bloom insert on the model-only pass, ``header``, ``km.bin``
     and ``rest.bin`` equal between the two builds and the host encoder fed
     the oracle's table; then phase 8's serving check on that model;

then one JSON line with every kernel's launches on the main path (phases 4,
5, 7, 9, 12 and 15) and times, the card line, and the result line.  The read
generator, the oracle and the query mix are the package's own
(``kmcex_tpu_torch.tools.workload``, numpy only).  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
K, CI, CS, NH, NB = 31, 1, 1023, 7, 5
REALISTIC_DISTINCT = 10_883_515
# phase 15: the JAX package's soak record (SOAK_r05.json), same generator
# and seed: integers that a right count reproduces on any machine
SOAK_DISTINCT = 34_151_483
SOAK_WINDOWS = 245_858_304
# phase-3 shapes: the default raw tier's collapse size, and two runs of the
# run LSM at the headline workload's merge size
SORT_N = 64 << 20
SORT_SIZES = (SORT_N, 65_961_984)  # + the realistic workload's collapse
MERGE_RUN = 16 << 20
SENT = -1
# published peaks of one H100 SXM: device memory, and float32 outside the
# tensor cores (the nearest listed rate for the kernels' integer compares)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# phase 9: thresholds that push the realistic table through every tier
SPILL_ENV = {"KMCEX_RAW_TIER_ELEMS": "8388608",
             "KMCEX_SPILL_THRESHOLD": "8388608",
             "KMCEX_DISK_SPILL_BYTES": "50331648"}
# phase 12: per-shard thresholds (four shards) that push every shard of the
# realistic table through every tier: a shard receives ~0.5M windows a batch,
# so it collapses every second batch into a run of 2^20, two runs merge to
# 2^21 and leave the card; the host budget is one for all shards
SHARD_TIERS = {"RAW_TIER_ELEMS": 1 << 19, "SPILL_THRESHOLD": 1 << 21,
               "DISK_SPILL_BYTES": 50331648}
N_SHARDS = 4
FILES = ["o.res.kmc_pre", "o.res.kmc_suf", "o.res/header", "o.res/km.bin",
         "o.res/rest.bin"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 5):
    """(last result, median ms) over ``reps`` calls, CUDA events around
    each, synchronized after each launch."""
    import torch

    times, res = [], None
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return res, float(np.median(times))


def top_device_ops(fn, k: int = 3, totals: bool = False):
    """The k kernels with the most device time in one call of ``fn``, from
    torch.profiler: [(name, ms, launches)]; with ``totals`` also the summed
    device time of all kernels (ms) and their number."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[1])
    top = [(name[:48], ms, count) for name, ms, count in rows[:k]]
    if totals:
        return top, sum(r[1] for r in rows), sum(r[2] for r in rows)
    return top


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the peak rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare_exact(pairs) -> tuple[int, int]:
    """(elements that differ, largest absolute difference) over integer
    (got, want) tensor pairs, both counted in integers: int64 keys as
    unsigned 64-bit, int32 payloads as int64, so no low bit is lost."""
    bad, err = 0, 0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{got.dtype}{tuple(got.shape)} != "
                                 f"{want.dtype}{tuple(want.shape)}")
        differ = got != want
        n_bad = int(differ.sum())
        if n_bad:
            g, w = got[differ].cpu().numpy(), want[differ].cpu().numpy()
            if g.dtype == np.int64:
                g, w = g.view(np.uint64), w.view(np.uint64)
            else:
                g, w = g.astype(np.int64), w.astype(np.int64)
            bad += n_bad
            err = max(err, int(np.where(g > w, g - w, w - g).max()))
    return bad, err


def merge_runs_prefix_sum(ka, ca, kb, cb):
    """The run LSM's merge step as it was before it used the uniqueness of
    its inputs: segment sums by a prefix sum differenced at run boundaries
    found with a reverse ``torch.cummin``.  Kept here as the second plain
    version that ``device_lsm._merge_runs`` is held against, and timed
    beside it."""
    import torch

    from kmcex_tpu_torch.count import compact, sort

    k, c = sort.merge_sorted_u64(ka, ca, kb, cb)
    n = k.numel()
    idxs = torch.arange(n, dtype=torch.int64, device=k.device)
    first = torch.ones(n, dtype=torch.bool, device=k.device)
    first[1:] = k[1:] != k[:-1]
    real = k != SENT
    valid = first & real
    csum = torch.cumsum(c, 0, dtype=torch.int64)
    bpos = torch.where(first, idxs, n)
    nxt = torch.cat([bpos[1:], bpos.new_full((1,), n)])
    next_b = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    seg_end = torch.minimum(next_b, real.sum())
    start_excl = torch.where(idxs > 0, csum[(idxs - 1).clamp(min=0)], 0)
    seg_sum = csum[(seg_end - 1).clamp(min=0)] - start_excl
    seg_sum = torch.where(seg_end > idxs, seg_sum, 0)
    counts = torch.where(valid, seg_sum, 0).clamp(
        max=(1 << 31) - 1).to(torch.int32)
    uniq, counts_c = compact.compact_pairs(torch.where(valid, k, SENT), counts)
    return uniq, counts_c, valid.sum()


def phase_kernels(dev):
    import torch

    from kmcex_tpu_torch.core.codec import BIAS
    from kmcex_tpu_torch.count import compact, device_lsm, sort
    from kmcex_tpu_torch.tools.tune_merge import padded_run, tie_run

    rng = np.random.default_rng(2024)
    out = {}

    # sort_u64: 64M keys (the raw tier's collapse size) and the realistic
    # workload's single collapse (not a power of two); ~10% SENTINEL, half
    # with bit 63 set (k = 32 keys).  Both sorts are stable, so keys AND
    # payloads (input positions) must be equal.
    rows = {}
    for n in SORT_SIZES:
        x_np = rng.integers(0, 1 << 63, n, dtype=np.int64)
        x_np[rng.random(n) < 0.5] |= BIAS
        x_np[rng.random(n) < 0.1] = SENT
        x = torch.from_numpy(x_np).to(dev)
        del x_np
        got, ms = timed(lambda: sort.sort_u64(x))
        want, plain_ms = timed(lambda: sort.sort_u64_plain(x))
        _, lib_ms = timed(lambda: torch.sort(x, stable=True))  # yardstick only
        p = torch.arange(n, dtype=torch.int32, device=dev)
        (gk, gp), ms_p = timed(lambda: sort.sort_u64(x, p))
        (wk, wp), plain_ms_p = timed(lambda: sort.sort_u64_plain(x, p))
        # every payload is its key's input position: x[gp] must be gk
        bad, err = compare_exact([(got, want), (gk, wk), (gp, wp),
                                  (x[gp.long()], gk)])
        if bad:
            raise AssertionError(f"sort_u64 n={n} disagrees with its plain "
                                 f"version: {bad} elements differ, max abs "
                                 f"err {err}")
        print(f"[kernels] sort_u64 n={n}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms; with int32 payload: kernel {ms_p:.3f} ms, "
              f"plain {plain_ms_p:.3f} ms; keys and payloads exact (0 "
              f"elements differ)")
        # n log2 n key comparisons; keys in and out, 8 bytes each way (12
        # with the payload)
        ops = int(n * np.log2(n))
        rows[n] = dict(mismatches=bad, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       payload_ms=ms_p, payload_plain_ms=plain_ms_p,
                       payload_bound_ms=bound(24 * n, ops)["bound_ms"],
                       **bound(16 * n, ops))
        del x, got, want, p, gk, gp, wk, wp
    # the JSON row: the 64M times, plus the realistic collapse's beside them
    real_n = SORT_SIZES[1]
    out["sort_u64"] = dict(rows[SORT_N], n=SORT_N, **{
        f"{k_}_n{real_n}": v for k_, v in rows[real_n].items()
        if k_.endswith("ms")})
    torch.cuda.empty_cache()

    # merge_sorted_u64: two SENTINEL-padded 16M runs (run-LSM shape), two
    # runs of < 2048 keys in total (the one-block case), a large run against
    # a fresh one, a tie-heavy pair (keys from 2^16 values, payload = a
    # unique index, so keys AND payloads must equal the stable plain
    # version), and the soak's shapes: two 32M runs as two collapses of one
    # genome leave them (72% real, four fifths of b's keys also in a), and a
    # merged 64M run (55% real) against a fresh 32M one
    main_shape, soak_shape = "16M+16M", "32M+32M"
    def pair(la, lb, fa=0.85, fb=0.7):
        return (lambda: (padded_run(rng, la, fa, dev),
                         padded_run(rng, lb, fb, dev)))

    def sharing_pair(m, fill, shared):
        a, ca = padded_run(rng, m, fill, dev)
        real = int(m * fill)
        kb = a[:real][torch.from_numpy(rng.random(real) < shared).to(dev)]
        fresh = torch.from_numpy(rng.integers(
            0, 1 << 63, real - kb.numel(), dtype=np.int64)).to(dev)
        b = torch.full((m,), SENT, dtype=torch.int64, device=dev)
        b[:real] = sort.sort_u64_plain(torch.cat([kb, fresh]))
        cb = torch.zeros(m, dtype=torch.int32, device=dev)
        cb[:real] = torch.from_numpy(
            rng.integers(1, 1 << 20, real).astype(np.int32)).to(dev)
        return (a, ca), (b, cb)

    shapes = ((main_shape, pair(MERGE_RUN, MERGE_RUN)),
              ("700+1100", pair(700, 1100)),
              ("64M+4M", pair(64 << 20, 4 << 20)),
              ("ties4M+4M", lambda: (tie_run(rng, 4 << 20, 0, dev),
                                     tie_run(rng, 4 << 20, 4 << 20, dev))),
              (soak_shape, lambda: sharing_pair(32 << 20, 0.72, 0.8)),
              ("64M+32M", pair(64 << 20, 32 << 20, 0.55, 0.72)))
    row, said = dict(mismatches=0, max_abs_err=0, library_ms=None), []
    whole = {}
    for label, make in shapes:
        (a, ca), (b, cb) = make()
        (gk, gc), t = timed(lambda: sort.merge_sorted_u64(a, ca, b, cb))
        (wk, wc), tp = timed(lambda: sort.merge_sorted_u64_plain(a, ca, b, cb))
        bad, err = compare_exact([(gk, wk), (gc, wc)])
        if bad:
            raise AssertionError(f"merge_sorted_u64 {label} disagrees: {bad} "
                                 f"elements differ, max abs err {err}")
        del gk, gc, wk, wc
        n = a.numel() + b.numel()
        bnd = bound(24 * n, n)  # one comparison and 12 bytes in + out each
        said.append(f"{label}: kernel {t:.3f} ms, plain {tp:.3f} ms, bound "
                    f"{bnd['bound_ms']:.3f} ms")
        if label == main_shape:
            row.update(ms=t, plain_ms=tp, **bnd)
        else:
            row.update({f"ms_{label}": t, f"plain_ms_{label}": tp,
                        f"bound_ms_{label}": bnd["bound_ms"]})
        if label in (main_shape, soak_shape):
            # the run LSM's whole merge step: this kernel, a few torch ops
            # (a key of two unique runs occurs at most twice), compact_pairs;
            # beside it the form it had before, with its prefix sum
            got_r, t_runs = timed(
                lambda: device_lsm._merge_runs(a, ca, b, cb))
            want_r, t_before = timed(
                lambda: merge_runs_prefix_sum(a, ca, b, cb))
            bad, err = compare_exact(
                [(g, w) for g, w in zip(got_r[:2], want_r[:2])])
            if bad or int(got_r[2]) != int(want_r[2]):
                raise AssertionError(
                    f"_merge_runs {label} disagrees with its prefix-sum "
                    f"form: {bad} elements differ, max abs err {err}")
            summed = int((a != SENT).sum() + (b != SENT).sum()) - int(got_r[2])
            del got_r, want_r
            top = top_device_ops(
                lambda: device_lsm._merge_runs(a, ca, b, cb))
            whole[label] = (t, t_runs, t_before, summed, top)
            suffix = "" if label == main_shape else f"_{label}"
            row.update({f"merge_runs_ms{suffix}": t_runs,
                        f"merge_runs_before_ms{suffix}": t_before,
                        f"merge_runs_top_ops{suffix}": top})
        del a, ca, b, cb
        torch.cuda.empty_cache()
    print(f"[kernels] merge_sorted_u64 {'; '.join(said)}; keys "
          f"and payloads exact (0 elements differ)")
    for label, (t, t_runs, t_before, summed, top) in whole.items():
        print(f"[kernels] _merge_runs {label} whole (merge kernel + segment "
              f"sums in torch + compact_pairs; {summed} keys in both runs): "
              f"{t_runs:.3f} ms, of which the merge kernel {t:.3f} ms; "
              f"before, with the prefix sum and torch.cummin: "
              f"{t_before:.3f} ms, same output (0 elements differ); most "
              f"device time: "
              + ", ".join(f"{name} {ms:.3f} ms x{count}"
                          for name, ms, count in top))
    out["merge_sorted_u64"] = row

    # compact_pairs: 64M (key, count) pairs, ~80% holes (segment-count shape:
    # ascending keys, duplicate slots holed), and 96M pairs with the 60% holes
    # that the merge of a 64M run and a 32M one leaves (pads and doubles)
    for n, hole_share in ((SORT_N, 0.8), (96 << 20, 0.6)):
        keys = sort.sort_u64_plain(torch.from_numpy(
            rng.integers(0, 1 << 62, n, dtype=np.int64)).to(dev))
        holes = torch.from_numpy(rng.random(n) < hole_share).to(dev)
        keys[holes] = SENT
        cnt = torch.from_numpy(
            rng.integers(1, 1 << 20, n).astype(np.int32)).to(dev)
        cnt[holes] = 0
        (gk, gc), ms = timed(lambda: compact.compact_pairs(keys, cnt))
        (wk, wc), plain_ms = timed(
            lambda: compact.compact_pairs_plain(keys, cnt))
        bad, err = compare_exact([(gk, wk), (gc, wc)])
        if bad:
            raise AssertionError(f"compact_pairs n={n} disagrees: {bad} "
                                 f"elements differ, max abs err {err}")
        bnd = bound(24 * n, n)  # one predicate, 12 bytes in and 12 out each
        print(f"[kernels] compact_pairs n={n} {hole_share:.0%} holes: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms; exact (0 elements differ)")
        if n == SORT_N:
            out["compact_pairs"] = dict(mismatches=bad, max_abs_err=err,
                                        ms=ms, plain_ms=plain_ms,
                                        library_ms=None, **bnd)
        else:
            out["compact_pairs"].update({f"ms_n{n}": ms,
                                         f"plain_ms_n{n}": plain_ms,
                                         f"bound_ms_n{n}": bnd["bound_ms"]})
        del keys, holes, cnt, gk, gc, wk, wc
        torch.cuda.empty_cache()
    return out


def cli_build(fq: pathlib.Path, wd: pathlib.Path, extra_env=None):
    """Run the port's CLI on cuda into ``wd``; returns (distinct, stats)."""
    from kmcex_tpu_torch.cli import main

    wd.mkdir()
    stats_json = wd / "stats.json"
    env = {"KMCEX_STATS_JSON": str(stats_json), **(extra_env or {})}
    old = {k_: os.environ.get(k_) for k_ in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(["kmcex", f"-k{K}", f"-nh{NH}", f"-nb{NB}", str(fq),
                       str(wd / "o.res"), str(wd)])
    finally:
        for k_, v in old.items():
            if v is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    text = buf.getvalue()
    distinct = int(text.split("total kmercount")[1].split(":")[1].split()[0])
    return distinct, json.loads(stats_json.read_text())


def oracle_build(od: pathlib.Path, ascii_reads):
    """The numpy oracle's database and model (host encoder, host Bloom
    insert) under ``od``; returns its (kmers, counts), ci-filtered and
    cs-clamped."""
    from kmcex_tpu_torch.io.kmc_db import KMC1StreamWriter
    from kmcex_tpu_torch.model.kmodel import get_model
    from kmcex_tpu_torch.tools import workload

    kmers, counts = workload.oracle_counts(ascii_reads, K)
    counts = np.minimum(counts, CS).astype(np.uint32)
    keep = counts >= CI
    kmers, counts = kmers[keep], counts[keep]
    km = get_model(CI, CS, NH, NB)
    km.init_from_pairs(kmers, counts, K)
    km.save(od / "o.res")
    w = KMC1StreamWriter(str(od / "o.res"), K, min_count=CI, max_count=CS)
    w.write_chunk(kmers, counts.astype(np.uint64))
    w.close()
    return kmers, counts


def same_files(name: str, wd: pathlib.Path, od: pathlib.Path, files=FILES):
    for fn in files:
        if (wd / fn).read_bytes() != (od / fn).read_bytes():
            raise AssertionError(f"{name}: {fn} differs from the oracle")


def run_cli(work: pathlib.Path, name: str, ascii_reads, extra_env=None):
    """Write the FASTQ, run the port's CLI on cuda, check it against the
    numpy oracle byte for byte; returns (distinct, stats, oracle kmers,
    oracle counts)."""
    from kmcex_tpu_torch.tools import workload

    fq = work / f"{name}.fastq"
    workload.write_fastq(fq, ascii_reads)
    distinct, stats = cli_build(fq, work / name, extra_env)
    kmers, counts = oracle_build(work / f"{name}_oracle", ascii_reads)
    if distinct != len(kmers):
        raise AssertionError(f"{name}: CLI counted {distinct} distinct, "
                             f"oracle {len(kmers)}")
    same_files(name, work / name, work / f"{name}_oracle")
    return distinct, stats, kmers, counts


def encode_line(st) -> str:
    ph = st["phases"]
    keys = ("finalize.bloom_feed_dispatch", "encode.bloom_pull",
            "encode.bloom_insert", "encode.chunk_wait", "encode.array_feed",
            "encode.array_finish", "merge+stats")
    return ", ".join(f"{k_} {ph[k_]:.3f} s" for k_ in keys if k_ in ph)


def phase_bloom_alone(dev, kmers, counts):
    """DeviceBloomBuilder on the realistic table, fed in one call and in two
    split calls, against the host insert: differing bytes must be 0.
    Returns the CUDA-event times of the feed and of the byte pack."""
    import torch

    from kmcex_tpu_torch.model import device_bloom
    from kmcex_tpu_torch.model.bloom import BloomBank

    hist = np.array([np.count_nonzero(counts == CI + i) for i in range(3)])
    host = BloomBank(hist, NH, CI)
    t = time.time()
    host.insert(0, kmers[counts == CI], K)
    t_host = time.time() - t
    u = torch.from_numpy(kmers.view(np.int64)).to(dev)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    n = len(kmers)
    res = {}
    for cuts in (1, 2, 1):  # the last one-call build is the warm, timed one
        b = device_bloom.DeviceBloomBuilder(K, CI, CS, NH, hist, device=dev)
        step = -(-n // cuts)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        for a in range(0, n, step):
            b.feed_table(u[a : a + step], c[a : a + step], step)
        ev[1].record()
        ev[2].record()
        device_bloom._pack_bytes(b._bitmap)
        ev[3].record()
        bank = BloomBank(hist, NH, CI)
        b.into(bank)
        torch.cuda.synchronize()
        bad = int((bank.bit_bf[0] != host.bit_bf[0]).sum()
                  + (bank.bit_bf_back[0] != host.bit_bf_back[0]).sum())
        if bad:
            raise AssertionError(f"device Bloom bank fed in {cuts} call(s): "
                                 f"{bad} bytes differ from the host insert")
        res = dict(feed_ms=ev[0].elapsed_time(ev[1]),
                   pack_ms=ev[2].elapsed_time(ev[3]))
    def feed_once():
        b2 = device_bloom.DeviceBloomBuilder(K, CI, CS, NH, hist, device=dev)
        b2.feed_table(u, c, n)
    top, busy_ms, launches = top_device_ops(feed_once, totals=True)
    n_low = int(hist[0])
    print(f"[bloom] feed under torch.profiler: {launches} launches, "
          f"{busy_ms:.3f} ms of kernels; most device time: "
          + ", ".join(f"{name} {ms:.3f} ms x{count}"
                      for name, ms, count in top))
    print(f"[bloom] {n_low} low-count keys of {n}, {b.total_bytes} filter "
          f"bytes: fed in one call and in two, 0 bytes differ from the host "
          f"insert; device feed {res['feed_ms']:.3f} ms "
          f"({n_low * (2 * NH - 3) / res['feed_ms'] / 1e6:.3f} G probe "
          f"bits/s), byte pack {res['pack_ms']:.3f} ms; host insert (all "
          f"cores) {t_host * 1e3:.1f} ms")
    return res


def phase_model_only(work: pathlib.Path, fq: pathlib.Path, cli_dir, st_cli,
                     compact_cli: int):
    """count_encode(..., db_path=None): Bloom bank on the device, low keys
    dropped from the transfer.  Model bytes equal the CLI run's; one more
    compaction launch.  Returns this run's launch counts."""
    from kmcex_tpu_torch.count.pipeline import count_encode
    from kmcex_tpu_torch.native import kernels

    kernels.reset_launches()  # the model-only path's run starts here
    km, _, _, st = count_encode(str(fq), K, CI, CS, NH, NB, keep_pairs=False)
    launches = dict(kernels.LAUNCHES)
    km.save(work / "model_only" / "o.res")
    same_files("model-only", work / "model_only", cli_dir,
               ["o.res/header", "o.res/km.bin", "o.res/rest.bin"])
    if launches["sort_u64"] < 1 or launches["compact_pairs"] != compact_cli + 1:
        raise AssertionError(
            f"model-only run launched {launches}; the CLI run launched "
            f"compact_pairs {compact_cli} times and the drop adds one")
    if "encode.bloom_insert" in st.phases or "finalize.drop_low" not in st.phases:
        raise AssertionError(f"model-only phases: {sorted(st.phases)}")
    print(f"[model-only] header, km.bin, rest.bin equal the CLI run's; "
          f"launches {launches}; table bytes to the host "
          f"{st.table_bytes_to_host} with the drop, "
          f"{st_cli['table_bytes_to_host']} without; count "
          f"{st.count_seconds:.3f} s, encode {st.encode_seconds:.3f} s, "
          f"chunk_wait {st.phases['encode.chunk_wait']:.3f} s, drop_low "
          f"{st.phases['finalize.drop_low']:.3f} s")
    return launches


def phase_serving(dev, model_dir: pathlib.Path, kmers, counts,
                  tag: str = "serving"):
    """bench.py's query mix against the model in ``model_dir`` (built from
    the table ``kmers``, ``counts``), host and device.  Returns the host and
    the device end-to-end Mq/s."""
    import torch

    from kmcex_tpu_torch import DeviceKModel, load_model
    from kmcex_tpu_torch.core import codec
    from kmcex_tpu_torch.tools import workload

    km = load_model(model_dir)
    t = time.time()
    dm = DeviceKModel(km)  # device=None: the card
    torch.cuda.synchronize()
    t_load = time.time() - t
    q = workload.serving_queries(kmers)
    nq = len(q)

    km.kmer_to_occ_u64(q[:1000])  # warm
    best_h, host = 1e9, None
    for _ in range(2):
        t = time.time()
        host = km.kmer_to_occ_u64(q)
        best_h = min(best_h, time.time() - t)
    dm.kmer_to_occ(q[: dm.TILE])  # warm
    best_d, answers = 1e9, []
    for _ in range(3):
        t = time.time()
        answers.append(dm.kmer_to_occ(q))
        best_d = min(best_d, time.time() - t)
    n_resolved = dm.n_resolved
    bad = int((answers[0] != host).sum())
    if bad:
        raise AssertionError(f"{tag}: {bad} of {nq} device answers differ "
                             f"from the host's")
    if not all(np.array_equal(a, answers[0]) for a in answers[1:]):
        raise AssertionError(f"{tag}: a second call gave other answers")

    # queries resident on the card, main pass only
    qd = torch.from_numpy(q.view(np.int64)).to(dev)
    def main_pass():
        for a in range(0, nq, dm.TILE):
            dm._main(qd[a : a + dm.TILE])
    _, main_ms = timed(main_pass, reps=5)
    _, both_ms = timed(lambda: dm.query_tensor(qd), reps=5)
    top, busy_ms, launches = top_device_ops(main_pass, totals=True)

    # the oracle's count of every present query, through OccuBin
    qc = codec.canonical_np(q, K)
    pos = np.minimum(np.searchsorted(kmers, qc), len(kmers) - 1)
    present = kmers[pos] == qc
    ob = km.occu_bin
    want = ob.bin_to_mean_np(ob.occ_to_bin_np(counts[pos[present]]))
    exact = float((answers[0][present] == want.astype(np.int32)).mean())
    fp = float((answers[0][~present] != 0).mean())
    print(f"[{tag}] {nq} queries ({int(present.sum())} present): device "
          f"answers equal the host's on all, twice more the same; resolve "
          f"pass took {n_resolved} ambiguous queries; host "
          f"{nq / best_h / 1e6:.3f} Mq/s, device end to end "
          f"{nq / best_d / 1e6:.3f} Mq/s, device resident main pass "
          f"{nq / main_ms / 1e3:.3f} Mq/s ({main_ms:.3f} ms), resident both "
          f"passes {nq / both_ms / 1e3:.3f} Mq/s ({both_ms:.3f} ms); present "
          f"answers equal to OccuBin(count): {exact:.6f}; absent answered "
          f"non-zero: {fp:.6f}; model on the device {dm.device_bytes()} "
          f"bytes (host model {km.total_model_bytes()} bytes), upload + "
          f"cuckoo build {t_load:.3f} s")
    print(f"[{tag}] main pass under torch.profiler: {launches} launches, "
          f"{busy_ms:.3f} ms of kernels in {main_ms:.3f} ms; most device "
          f"time: " + ", ".join(f"{name} {ms:.3f} ms x{count}"
                                for name, ms, count in top))
    return {"host_mqs": nq / best_h / 1e6, "device_mqs": nq / best_d / 1e6,
            "resident_main_mqs": nq / main_ms / 1e3}


def phase_spill(work: pathlib.Path, fq: pathlib.Path, cli_dir, peak4_mb):
    """The realistic build with the tiers forced: once through the disk
    level, once all in host RAM.  Both must write phase 4's bytes; the disk
    tier must leave its temp directory empty.  Returns the disk run's launch
    counts."""
    import torch

    from kmcex_tpu_torch.native import kernels

    lsm_tmp = work / "lsm_tmp"
    lsm_tmp.mkdir()
    old_tmp, tempfile.tempdir = tempfile.tempdir, str(lsm_tmp)
    launches = {}
    try:
        for name, env in (("disk", SPILL_ENV),
                          ("host", {**SPILL_ENV,
                                    "KMCEX_DISK_SPILL_BYTES": "0"})):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()  # the spill path's run starts here
            distinct, st = cli_build(fq, work / f"spill_{name}", env)
            launches[name] = dict(kernels.LAUNCHES)
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            same_files(f"spill/{name}", work / f"spill_{name}", cli_dir)
            ev, sp = st["tiers"], st["spill"]
            want_disk = name == "disk"
            if (distinct != REALISTIC_DISTINCT
                    or not all(ev[k_] > 0 for k_ in
                               ("raw_collapses", "device_merges",
                                "host_spills"))
                    or (ev["disk_spills"] > 0) != want_disk):
                raise AssertionError(f"spill/{name}: distinct {distinct}, "
                                     f"tier events {ev}")
            if not all(v > 0 for v in launches[name].values()):
                raise AssertionError(f"spill/{name} skipped a kernel: "
                                     f"{launches[name]}")
            if "encode.bloom_insert" not in st["phases"]:
                raise AssertionError(f"spill/{name}: the host did not insert "
                                     f"the Bloom bank")
            left = sorted(p.name for p in lsm_tmp.iterdir())
            if left:
                raise AssertionError(f"spill/{name}: left in the temp "
                                     f"directory: {left}")
            rate = sp["copy_bytes"] / max(sp["copy_seconds"], 1e-9) / 1e9
            print(f"[spill] {name} route: tiers {ev}, launches "
                  f"{launches[name]}, count {st['count_seconds']:.3f} s, "
                  f"encode {st['encode_seconds']:.3f} s; spill copies "
                  f"{sp['copy_bytes']} bytes in {sp['copy_seconds']:.3f} s "
                  f"({rate:.3f} GB/s); native.merge_runs "
                  f"{sp['host_merge_seconds']:.3f} s; out-of-core merge pass "
                  f"{sp['merge_pass_seconds']:.3f} s; merge+stats "
                  f"{st['phases']['merge+stats']:.3f} s; peak device memory "
                  f"{peak_mb:.1f} MB (phase 4: {peak4_mb:.1f} MB); files "
                  f"byte-identical to phase 4's; temp directory empty")
    finally:
        tempfile.tempdir = old_tmp
    return launches["disk"]


def phase_resume(work: pathlib.Path, fq: pathlib.Path, cli_dir):
    """Kill and resume through the CLI, each run its own process."""
    from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator

    wd = work / "resume"
    wd.mkdir()
    ck = work / "ckpt"
    stats_json = wd / "stats.json"

    def cli(k: int, out: str, **env):
        cmd = [sys.executable, "-m", "kmcex_tpu_torch.cli", f"-k{k}",
               f"-nh{NH}", f"-nb{NB}", f"-ckpt{ck}", str(fq),
               str(wd / out), str(wd)]
        t = time.time()
        res = subprocess.run(
            cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(REPO),
                 "KMCEX_CKPT_EVERY": "8",
                 "KMCEX_STATS_JSON": str(stats_json), **env})
        return res, time.time() - t

    res, t_crash = cli(K, "o.res", KMCEX_CRASH_AFTER_BATCHES="20")
    m = DeviceCountAccumulator.read_manifest(str(ck))
    if res.returncode == 0 or "injected crash" not in res.stderr or m is None:
        raise AssertionError(f"crash run: exit {res.returncode}, manifest "
                             f"{m}\n{res.stderr[-2000:]}")
    n_ck = m["extra"]["n_batches"]
    if n_ck != 16 or (wd / "o.res.kmc_pre").exists():
        raise AssertionError(f"crash run: checkpoint at batch {n_ck}, or a "
                             f"database was written")
    bad, t_bad = cli(K - 2, "other.res")
    if bad.returncode == 0 or "different input" not in bad.stderr:
        raise AssertionError(f"-k{K - 2} against the -k{K} checkpoint: exit "
                             f"{bad.returncode}\n{bad.stderr[-2000:]}")
    if DeviceCountAccumulator.read_manifest(str(ck)) != m:
        raise AssertionError("the refused run touched the manifest")
    res2, t_resume = cli(K, "o.res")
    if res2.returncode != 0:
        raise AssertionError(f"resume: exit {res2.returncode}\n"
                             f"{res2.stderr[-2000:]}")
    st = json.loads(stats_json.read_text())
    if st["skipped_batches"] != n_ck:
        raise AssertionError(f"resume skipped {st['skipped_batches']} "
                             f"batches, the checkpoint held {n_ck}")
    same_files("resume", wd, cli_dir)
    if DeviceCountAccumulator.read_manifest(str(ck)) is not None:
        raise AssertionError("resume: the manifest was not retired")
    print(f"[resume] crash run exit {res.returncode} after 20 batches "
          f"({t_crash:.1f} s), manifest at batch {n_ck}; -k{K - 2} against "
          f"it refused on the fingerprint, exit {bad.returncode} "
          f"({t_bad:.1f} s); resume skipped {st['skipped_batches']} batches "
          f"of 33 ({t_resume:.1f} s; count {st['count_seconds']:.3f} s, "
          f"encode {st['encode_seconds']:.3f} s, tiers {st['tiers']}); files "
          f"byte-identical to phase 4's; manifest retired")


def phase_database(dev, work: pathlib.Path, cli_dir, kmers, counts, reads_1k):
    """The database side on phase 4's database, against the numpy oracle."""
    from kmcex_tpu_torch import DeviceKModel, load_model
    from kmcex_tpu_torch.core import codec
    from kmcex_tpu_torch.io import kmc_db
    from kmcex_tpu_torch.model.kmodel import get_model
    from kmcex_tpu_torch.query import annotate
    from kmcex_tpu_torch.tools import workload

    db = str(cli_dir / "o.res")
    secs = {}

    def clock(name, fn):
        t = time.time()
        out = fn()
        secs[name] = time.time() - t
        return out

    rd = kmc_db.KMCReader(db)
    lk, lc = clock("list_all", rd.list_all)
    if not (np.array_equal(lk, kmers) and np.array_equal(lc, counts)):
        raise AssertionError("KMCReader.list_all differs from the oracle")
    q = codec.canonical_np(workload.serving_queries(kmers), K)
    pos = np.minimum(np.searchsorted(kmers, q), len(kmers) - 1)
    want = np.where(kmers[pos] == q, counts[pos], 0).astype(np.uint32)
    got = clock("check_kmers", lambda: kmc_db.KMCReader(db).check_kmers(q))
    if not np.array_equal(got, want):
        raise AssertionError(f"check_kmers: {int((got != want).sum())} of "
                             f"{len(q)} counts differ from the oracle")

    km = get_model(CI, CS, NH, NB)
    clock("KModel.init", lambda: km.init(db))
    km.save(work / "from_db" / "o.res")
    same_files("KModel.init", work / "from_db", cli_dir, FILES[2:])

    db2 = str(work / "kmc2")
    clock("write_kmc2", lambda: kmc_db.write_kmc2(
        db2, kmers, counts, K, min_count=CI, max_count=CS))
    rd2 = kmc_db.KMCReader(db2)
    k2, c2 = clock("read_kmc2", rd2.list_all)
    order = np.argsort(k2, kind="stable")
    if not (rd2.kmc_version == 0x200 and np.array_equal(k2[order], kmers)
            and np.array_equal(c2[order], counts)):
        raise AssertionError("the KMC2 round trip differs from the oracle")
    got2 = clock("check_kmers_kmc2", lambda: rd2.check_kmers(q[:100_000]))
    if not np.array_equal(got2, want[:100_000]):
        raise AssertionError("KMC2 check_kmers differs from the oracle")

    reads = [r.tobytes().decode() for r in reads_1k]
    by_db = clock("annotate_with_db", lambda: annotate.annotate_with_db(rd, reads))
    host = load_model(cli_dir / "o.res")
    by_host = clock("annotate_with_model(host)",
                    lambda: annotate.annotate_with_model(host, reads))
    dm = DeviceKModel(host)
    by_dev = clock("annotate_with_model(device)",
                   lambda: annotate.annotate_with_model(dm, reads))
    exact_db = np.concatenate(by_db).astype(np.int64)
    kw, valid = annotate.extract_windows_np(annotate._reads_to_codes(reads), K)
    wpos = np.minimum(np.searchsorted(kmers, kw), len(kmers) - 1)
    wwant = np.where(valid & (kmers[wpos] == kw), counts[wpos], 0)
    if not np.array_equal(exact_db, wwant.reshape(-1)):
        raise AssertionError("annotate_with_db differs from the oracle")
    m_host = np.concatenate(by_host)
    if not np.array_equal(m_host, np.concatenate(by_dev)):
        raise AssertionError("annotation: device model differs from the host")
    ob = host.occu_bin
    present = exact_db > 0
    binned = ob.bin_to_mean_np(ob.occ_to_bin_np(
        exact_db[present].astype(np.uint32))).astype(np.int32)
    agree = float((m_host[present] == binned).mean())
    if (m_host[~valid.reshape(-1)] != 0).any() or agree < 0.99:
        raise AssertionError(f"annotation: model equals OccuBin(database "
                             f"count) on {agree:.6f} of the present windows")
    print(f"[database] KMCReader.list_all {len(lk)} pairs equal the oracle; "
          f"check_kmers {len(q)} queries equal the oracle "
          f"({int((want > 0).sum())} present); KModel.init model "
          f"byte-identical to phase 4's; write_kmc2 round trip exact, "
          f"check_kmers through its signature bins exact on 100000; "
          f"annotation of {len(reads)} reads ({len(exact_db)} windows, "
          f"{int(present.sum())} present): database counts equal the "
          f"oracle, host and device model rows equal, model == "
          f"OccuBin(database count) on {agree:.6f} of the present windows; "
          f"seconds: " + ", ".join(f"{k_} {v:.3f}" for k_, v in secs.items()))


def sharded_build(fq: pathlib.Path, wd: pathlib.Path, mesh, **kw):
    """count_encode(accumulator="sharded") over ``mesh`` into ``wd`` (the
    database and the model under the CLI's names); returns its stats."""
    from kmcex_tpu_torch.count.pipeline import count_encode

    wd.mkdir(exist_ok=True)
    km, _, _, st = count_encode(str(fq), K, CI, CS, NH, NB, keep_pairs=False,
                                db_path=str(wd / "o.res"),
                                accumulator="sharded", mesh=mesh, **kw)
    km.save(wd / "o.res")
    return st


def phase_sharded_build(dev, work: pathlib.Path, fq: pathlib.Path, cli_dir,
                        card: str):
    """The realistic read set on a mesh of four logical shards of the card:
    unforced (mesh Bloom build), tiers forced per shard (host and disk runs
    on every shard), crash + restore.  Every build must write phase 4's
    bytes.  Returns the launch counts of the unforced and the forced run."""
    import torch

    from kmcex_tpu_torch.native import kernels
    from kmcex_tpu_torch.parallel.sharded import (
        ShardedCountAccumulator,
        make_mesh,
    )

    mesh = make_mesh(devices=[dev] * N_SHARDS)
    lsm_tmp = work / "sharded_tmp"
    lsm_tmp.mkdir()
    old_tmp, tempfile.tempdir = tempfile.tempdir, str(lsm_tmp)
    saved = {k_: getattr(ShardedCountAccumulator, k_) for k_ in SHARD_TIERS}
    env_keys = ("KMCEX_DISK_SPILL_BYTES", "KMCEX_CKPT_EVERY",
                "KMCEX_CRASH_AFTER_BATCHES")
    old_env = {k_: os.environ.pop(k_, None) for k_ in env_keys}
    launches = {}
    try:
        for name in ("mesh", "forced"):
            if name == "forced":
                for k_, v in SHARD_TIERS.items():
                    setattr(ShardedCountAccumulator, k_, v)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()  # the sharded path's run starts here
            st = sharded_build(fq, work / f"sharded_{name}", mesh)
            launches[name] = dict(kernels.LAUNCHES)
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            same_files(f"sharded/{name}", work / f"sharded_{name}", cli_dir)
            sh, ev = st.shards, st.tiers
            if (st.distinct_kmers != REALISTIC_DISTINCT or sh["reroutes"]
                    or sh["n"] != N_SHARDS or len(sh["sizes"]) != N_SHARDS):
                raise AssertionError(f"sharded/{name}: distinct "
                                     f"{st.distinct_kmers}, shards {sh}")
            host_insert = "encode.bloom_insert" in st.phases
            if name == "mesh":
                if host_insert or sum(sh["sizes"]) != REALISTIC_DISTINCT:
                    raise AssertionError(
                        f"sharded/mesh: host Bloom insert {host_insert}, "
                        f"shard sizes {sh['sizes']}")
                need = ("sort_u64", "compact_pairs")
            else:
                if not host_insert or not ev["disk_spills"] or not all(
                        ev[k_] >= N_SHARDS for k_ in
                        ("raw_collapses", "device_merges", "host_spills")):
                    raise AssertionError(
                        f"sharded/forced: host Bloom insert {host_insert}, "
                        f"tier events {ev}")
                need = tuple(launches[name])
            if not all(launches[name][k_] >= N_SHARDS for k_ in need):
                raise AssertionError(f"sharded/{name} skipped a kernel: "
                                     f"{launches[name]}")
            left = sorted(p_.name for p_ in lsm_tmp.iterdir())
            if left:
                raise AssertionError(f"sharded/{name}: left in the temp "
                                     f"directory: {left}")
            secs = st.count_seconds + st.encode_seconds
            print(f"[sharded] {name}: {N_SHARDS} shards on {card}; shard "
                  f"sizes {sh['sizes']} (max/mean "
                  f"{max(sh['sizes']) * N_SHARDS / sum(sh['sizes']):.4f}), "
                  f"reroutes {sh['reroutes']}, distinct {st.distinct_kmers}, "
                  f"launches {launches[name]}, tiers {ev}, count "
                  f"{st.count_seconds:.3f} s, encode "
                  f"{st.encode_seconds:.3f} s, "
                  f"{st.reads / secs / 1e6:.4f} Mreads/s, stream+extract "
                  f"{st.phases['stream+extract']:.3f} s, merge+stats "
                  f"{st.phases['merge+stats']:.3f} s, spill copies "
                  f"{st.spill['copy_bytes']} bytes in "
                  f"{st.spill['copy_seconds']:.3f} s, merge pass "
                  f"{st.spill['merge_pass_seconds']:.3f} s; host Bloom "
                  f"insert {'ran' if host_insert else 'absent'}; peak device "
                  f"memory {peak_mb:.1f} MB; files byte-identical to phase "
                  f"4's; temp directory empty")
        # checkpoint in the middle, crash, restore (tiers still forced)
        ck = work / "sharded_ckpt"
        os.environ["KMCEX_CKPT_EVERY"] = "8"
        os.environ["KMCEX_CRASH_AFTER_BATCHES"] = "20"
        try:
            sharded_build(fq, work / "sharded_resume", mesh, ckpt_dir=str(ck))
        except RuntimeError as e:
            if "injected crash" not in str(e):
                raise
        else:
            raise AssertionError("sharded/resume: the injected crash did "
                                 "not fire")
        m = ShardedCountAccumulator.read_manifest(str(ck))
        if (m is None or m["extra"]["n_batches"] != 16
                or m["n_shards"] != N_SHARDS
                or (work / "sharded_resume" / "o.res.kmc_pre").exists()):
            raise AssertionError(f"sharded/resume: manifest {m}")
        del os.environ["KMCEX_CRASH_AFTER_BATCHES"]
        st = sharded_build(fq, work / "sharded_resume", mesh,
                           ckpt_dir=str(ck))
        same_files("sharded/resume", work / "sharded_resume", cli_dir)
        if (st.skipped_batches != 16
                or ShardedCountAccumulator.read_manifest(str(ck)) is not None):
            raise AssertionError(f"sharded/resume: skipped "
                                 f"{st.skipped_batches} batches")
        print(f"[sharded] resume: crash after 20 batches left a manifest of "
              f"{N_SHARDS} shards at batch 16 "
              f"({sum(map(len, m['shard_files']))} run files); restore "
              f"skipped {st.skipped_batches} batches of 33, count "
              f"{st.count_seconds:.3f} s, encode {st.encode_seconds:.3f} s, "
              f"tiers {st.tiers}; files byte-identical to phase 4's; "
              f"manifest retired")
    finally:
        for k_, v in saved.items():
            setattr(ShardedCountAccumulator, k_, v)
        for k_, v in old_env.items():
            os.environ.pop(k_, None)
            if v is not None:
                os.environ[k_] = v
        tempfile.tempdir = old_tmp
    return launches


def phase_sharded_serving(dev, model_dir: pathlib.Path, kmers):
    """make_server over four shards of the card on phase 8's queries."""
    from kmcex_tpu_torch import DeviceKModel, load_model
    from kmcex_tpu_torch.parallel.serve import make_server
    from kmcex_tpu_torch.tools import workload

    km = load_model(model_dir)
    q = workload.serving_queries(kmers)
    host = km.kmer_to_occ_u64(q)
    one = DeviceKModel(km).kmer_to_occ(q)
    srv = make_server(km, devices=[dev] * N_SHARDS)
    srv.kmer_to_occ(q[:100_000])  # warm
    best, got = 1e9, None
    for _ in range(3):
        t = time.time()
        got = srv.kmer_to_occ(q)
        best = min(best, time.time() - t)
    bad = int((got != host).sum()) + int((got != one).sum())
    if bad:
        raise AssertionError(f"sharded serving: {bad} answers differ from "
                             f"the host's or DeviceKModel's")
    n_resolved = srv.n_resolved
    short = srv.kmer_to_occ(q[:3])  # fewer queries than shards
    if not np.array_equal(short, host[:3]):
        raise AssertionError("sharded serving: a short batch differs")
    print(f"[sharded-serving] {len(q)} queries over {N_SHARDS} shards of the "
          f"card ({len(srv.models)} model copy): every answer equal to "
          f"DeviceKModel's and the host's; {len(q) / best / 1e6:.3f} Mq/s end "
          f"to end (best of 3); resolve pass took {n_resolved} queries")


def phase_two_ranks(work: pathlib.Path, fq: pathlib.Path, oracle_dir):
    """Two ranks x two shards on the one card over gloo, through the CLI."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "KMCEX_COORDINATOR": f"localhost:{port}",
           "KMCEX_NUM_PROCESSES": "2", "KMCEX_LOCAL_SHARDS": "2"}
    for k_ in ("KMCEX_RAW_TIER_ELEMS", "KMCEX_DISK_SPILL_BYTES"):
        env.pop(k_, None)
    t = time.time()
    procs = []
    for r in range(2):
        wd = work / f"rank{r}"
        wd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kmcex_tpu_torch.cli", f"-k{K}", f"-nh{NH}",
             f"-nb{NB}", "-accsharded", str(fq), str(wd / "o.res"), str(wd)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**env, "KMCEX_PROCESS_ID": str(r),
                            "KMCEX_STATS_JSON": str(wd / "stats.json")}))
    try:
        outs = [p_.communicate(timeout=300) for p_ in procs]
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.communicate()
    wall = time.time() - t
    for r, (p_, (out, err)) in enumerate(zip(procs, outs)):
        if p_.returncode != 0:
            raise AssertionError(f"two-ranks: rank {r} exit {p_.returncode}"
                                 f"\n{err[-3000:]}")
    same_files("two-ranks", work / "rank0", oracle_dir)
    left = sorted(p_.name for p_ in (work / "rank1").iterdir())
    if left != ["stats.json"]:
        raise AssertionError(f"two-ranks: rank 1 wrote {left}")
    st = [json.loads((work / f"rank{r}" / "stats.json").read_text())
          for r in range(2)]
    if not (st[0]["distinct_kmers"] == st[1]["distinct_kmers"]
            and st[0]["reads"] == st[1]["reads"] == 200_000
            and [s_["shards"]["rank"] for s_ in st] == [0, 1]
            and all(s_["shards"]["n"] == 4 for s_ in st)):
        raise AssertionError(f"two-ranks: stats {st}")
    print(f"[two-ranks] 2 ranks x 2 shards on one card, gloo: both exit 0 in "
          f"{wall:.1f} s wall; rank 0's files byte-identical to the numpy "
          f"oracle, rank 1 wrote none; distinct {st[0]['distinct_kmers']}, "
          f"reads {st[0]['reads']} (global); per rank: shard sizes "
          + " / ".join(str(s_["shards"]["sizes"]) for s_ in st)
          + ", count " + " / ".join(f"{s_['count_seconds']:.3f}" for s_ in st)
          + " s, encode "
          + " / ".join(f"{s_['encode_seconds']:.3f}" for s_ in st)
          + " s, host Bloom insert "
          + " / ".join("ran" if "encode.bloom_insert" in s_["phases"]
                       else "absent" for s_ in st))


def phase_soak(dev, work: pathlib.Path, serving8: dict):
    """tools.soak at its full size and the default tier thresholds, in this
    process: three builds, the partitioned numpy oracle, then the model
    against the host encoder fed the oracle's table, and serving on it.
    Returns the timed pass's launch counts."""
    import torch

    from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator as Acc
    from kmcex_tpu_torch.model.kmodel import get_model
    from kmcex_tpu_torch.tools import soak

    forced = [k_ for k_ in (*SPILL_ENV, "KMCEX_DEVICE_BLOOM",
                            "KMCEX_TRACE_DIR") if k_ in os.environ]
    if forced:
        raise AssertionError(f"soak: set in the environment: {forced}")
    torch.cuda.empty_cache()
    wd = work / "soak"
    wd.mkdir()
    t_phase = time.time()
    res = soak.run(soak.N_READS, wd, dev)
    art = res.artifact
    soak.DEFAULT_OUT.parent.mkdir(parents=True, exist_ok=True)
    soak.DEFAULT_OUT.write_text(json.dumps(art, indent=1) + "\n")
    if art["thresholds"] != {"raw_tier_elems": Acc.RAW_TIER_ELEMS,
                             "spill_threshold": Acc.SPILL_THRESHOLD,
                             "disk_spill_bytes": Acc.DISK_SPILL_BYTES}:
        raise AssertionError(f"soak: thresholds {art['thresholds']} are not "
                             f"the defaults")
    if not res.ok:
        raise AssertionError(f"soak: against the oracle: {art['oracle']}")
    ev, launches, ph = art["tiers"], art["kernel_launches"], art["phases"]
    if (art["distinct_kmers"] != SOAK_DISTINCT
            or art["windows"] != SOAK_WINDOWS
            or len(res.want_k) != SOAK_DISTINCT):
        raise AssertionError(
            f"soak: distinct {art['distinct_kmers']} (oracle "
            f"{len(res.want_k)}), windows {art['windows']}; expected "
            f"{SOAK_DISTINCT} and {SOAK_WINDOWS}")
    if (ev["raw_collapses"] < 3 or ev["device_merges"] < 2
            or ev["host_spills"] or ev["disk_spills"]):
        raise AssertionError(f"soak: tier events {ev}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"soak skipped a kernel: {launches}")
    if "encode.bloom_insert" in ph or "finalize.drop_low" not in ph:
        raise AssertionError(f"soak: model-only phases {sorted(ph)}")
    # one model by three routes: model-only (device Bloom build, low keys
    # dropped), pairs kept, and the host encoder fed the oracle's table
    res.km.save(wd / "model_only" / "o.res")
    res.km_verify.save(wd / "verify" / "o.res")
    t = time.time()
    km = get_model(CI, CS, NH, NB)
    km.init_from_pairs(res.want_k, res.want_c, K)
    km.save(wd / "oracle" / "o.res")
    t_host_encode = time.time() - t
    for name in ("verify", "oracle"):
        same_files(f"soak/{name}", wd / name, wd / "model_only", FILES[2:])
    rates = phase_serving(dev, wd / "model_only" / "o.res", res.want_k,
                          res.want_c, tag="soak-serving")
    sp = art["spill"]
    print(f"[soak] reads {art['workload']['n_reads']}, windows "
          f"{art['windows']}, distinct {art['distinct_kmers']}, thresholds "
          f"{art['thresholds']} (the defaults), tiers {ev}, launches "
          f"{launches}, count {art['count_seconds']:.3f} s, encode "
          f"{art['encode_seconds']:.3f} s, wall {art['wall_seconds']:.3f} s, "
          f"{art['mreads_per_s']:.4f} Mreads/s (warm pass "
          f"{art['warm_pass_seconds']:.3f} s), peak device memory "
          f"{art['peak_device_mb']:.1f} MB, peak RSS {art['peak_rss_mb']} MB "
          f"({art['peak_rss_at_start_mb']} MB when the phase began, "
          f"{art['peak_rss_after_generate_mb']} MB before the first pass), "
          f"table bytes to the host {art['table_bytes_to_host']}, spill "
          f"copies {sp['copy_bytes']} bytes; keys and counts equal the "
          f"oracle's; host Bloom insert absent; header, km.bin, rest.bin "
          f"equal between the model-only pass, the pass that keeps the "
          f"pairs and the host encoder fed the oracle's table "
          f"({t_host_encode:.3f} s); generator {art['generate_seconds']:.3f} "
          f"s, oracle {art['oracle_seconds']:.3f} s, phase "
          f"{time.time() - t_phase:.1f} s")
    print("[soak] timed pass, phases: " + ", ".join(
        f"{k_} {v:.3f}" for k_, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    print(f"[soak] serving on the {art['distinct_kmers']}-k-mer model: host "
          f"{rates['host_mqs']:.3f} Mq/s, device end to end "
          f"{rates['device_mqs']:.3f} Mq/s, resident main pass "
          f"{rates['resident_main_mqs']:.3f} Mq/s; on phase 8's "
          f"{REALISTIC_DISTINCT}-k-mer model: {serving8['host_mqs']:.3f}, "
          f"{serving8['device_mqs']:.3f}, "
          f"{serving8['resident_main_mqs']:.3f}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    card = nvidia_smi()
    print(f"[card] {card}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    sys.path.insert(0, str(REPO))
    from kmcex_tpu_torch import native
    from kmcex_tpu_torch.native import build, kernels
    from kmcex_tpu_torch.tools import workload

    t = time.time()
    build.build_kernels(force=True)
    kernels.lib()
    t_k = time.time() - t
    t = time.time()
    build.build_native(force=True)
    native.lib()
    t_n = time.time() - t
    print(f"[build] CUDA kernels {t_k:.2f} s, native host library {t_n:.2f} s")

    dev = torch.device("cuda")
    bench = phase_kernels(dev)

    build_dir = REPO / "kmcex_tpu_torch" / "_build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_", dir=build_dir) as tmp:
        work = pathlib.Path(tmp)
        reads = workload.make_reads(2_000_000, 533_000, 4242, 0.005)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()  # the main path's run starts here
        distinct, st, kmers, counts = run_cli(work, "realistic", reads)
        l4 = dict(kernels.LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if distinct != REALISTIC_DISTINCT:
            raise AssertionError(f"realistic: {distinct} distinct k-mers, "
                                 f"expected {REALISTIC_DISTINCT}")
        if not (l4["sort_u64"] > 0 and l4["compact_pairs"] > 0):
            raise AssertionError(f"realistic run skipped a kernel: {l4}")
        secs = st["count_seconds"] + st["encode_seconds"]
        print(f"[realistic] reads {st['reads']}, distinct {distinct}, count "
              f"{st['count_seconds']:.3f} s, encode {st['encode_seconds']:.3f} s, "
              f"{st['reads'] / secs / 1e6:.4f} Mreads/s, launches {l4}, "
              f"tiers {st['tiers']}, peak device memory {peak_mb:.1f} MB; DB "
              f"and model byte-identical to the numpy oracle")
        if "encode.bloom_insert" in st["phases"]:
            raise AssertionError("realistic: the host Bloom insert ran")
        print(f"[realistic] device Bloom build: {encode_line(st)}")
        reads_1k = reads[:1000].copy()
        del reads
        st_cli = st
        # the same build twice more, warm: host insert, then device build
        fq = work / "realistic.fastq"
        warm = {}
        for name, env in (("host_insert", {"KMCEX_DEVICE_BLOOM": "0"}),
                          ("device_bloom", {})):
            d_, warm[name] = cli_build(fq, work / f"warm_{name}", env)
            same_files(name, work / f"warm_{name}", work / "realistic_oracle")
            if d_ != REALISTIC_DISTINCT:
                raise AssertionError(f"{name}: {d_} distinct k-mers")
        if "encode.bloom_insert" not in warm["host_insert"]["phases"]:
            raise AssertionError("KMCEX_DEVICE_BLOOM=0 did not insert on "
                                 "the host")
        print(f"[realistic] warm, one process: encode "
              f"{warm['device_bloom']['encode_seconds']:.3f} s with the "
              f"device Bloom build (count "
              f"{warm['device_bloom']['count_seconds']:.3f} s; "
              f"{encode_line(warm['device_bloom'])}) against "
              f"{warm['host_insert']['encode_seconds']:.3f} s with "
              f"KMCEX_DEVICE_BLOOM=0 (count "
              f"{warm['host_insert']['count_seconds']:.3f} s; "
              f"{encode_line(warm['host_insert'])}); both byte-identical "
              f"to the oracle")
        print("[realistic] warm device-Bloom run, phases: " + ", ".join(
            f"{k_} {v:.3f}" for k_, v in sorted(
                warm["device_bloom"]["phases"].items(), key=lambda kv: -kv[1])))

        phase_bloom_alone(dev, kmers, counts)
        l6 = phase_model_only(work, fq, work / "realistic", st_cli,
                              l4["compact_pairs"])
        serving8 = phase_serving(dev, work / "realistic" / "o.res", kmers,
                                 counts)
        l9 = phase_spill(work, fq, work / "realistic", peak_mb)
        phase_resume(work, fq, work / "realistic")
        phase_database(dev, work, work / "realistic", kmers, counts, reads_1k)
        l12 = phase_sharded_build(dev, work, fq, work / "realistic", card)
        phase_sharded_serving(dev, work / "realistic" / "o.res", kmers)
        del kmers, counts
        torch.cuda.empty_cache()

        reads = workload.make_reads(2_000_000, 200_000, 12345, 0.002)
        kernels.reset_launches()  # the run-LSM path's run starts here
        distinct, st, _, _ = run_cli(work, "headline", reads,
                                     {"KMCEX_RAW_TIER_ELEMS": "8388608"})
        l5 = dict(kernels.LAUNCHES)
        if not all(v > 0 for v in l5.values()):
            raise AssertionError(f"run-LSM run skipped a kernel: {l5}")
        secs = st["count_seconds"] + st["encode_seconds"]
        print(f"[run-lsm] reads {st['reads']}, distinct {distinct}, count "
              f"{st['count_seconds']:.3f} s, encode {st['encode_seconds']:.3f} s, "
              f"{st['reads'] / secs / 1e6:.4f} Mreads/s, launches {l5}, "
              f"tiers {st['tiers']}; DB and model byte-identical to the "
              f"numpy oracle")
        phase_two_ranks(work, work / "headline.fastq",
                        work / "headline_oracle")
        del reads
        l15 = phase_soak(dev, work, serving8)
    src = {"sort_u64": ("kmcex_tpu_torch/csrc/sort.cu",
                        "kmcex_tpu/count/sort_pallas.py:203",
                        ["kmcex_tpu/count/sort_pallas.py:266"]),
           "merge_sorted_u64": ("kmcex_tpu_torch/csrc/merge.cu",
                                "kmcex_tpu/count/sort_pallas.py:434",
                                ["kmcex_tpu/count/sort_pallas.py:266"]),
           "compact_pairs": ("kmcex_tpu_torch/csrc/compact.cu",
                             "kmcex_tpu/count/compact_pallas.py:157", [])}
    rows = []
    for name, (path, repl, also) in src.items():
        rows.append({"name": name, "route": "cuda", "source": path,
                     "replaces": repl, "also_replaces": also,
                     "launches": (l4[name] + l5[name] + l6[name] + l9[name]
                                  + l12["mesh"][name] + l12["forced"][name]
                                  + l15[name]),
                     "launches_realistic": l4[name],
                     "launches_run_lsm": l5[name],
                     "launches_model_only": l6[name],
                     "launches_spill": l9[name],
                     "launches_sharded": l12["mesh"][name],
                     "launches_sharded_forced": l12["forced"][name],
                     "launches_soak": l15[name],
                     **bench[name]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
