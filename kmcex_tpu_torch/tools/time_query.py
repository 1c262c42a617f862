"""Time the torch-op device paths at several tile sizes on one NVIDIA GPU:
``DeviceKModel``'s main pass and ``DeviceBloomBuilder``'s feed.

    python3 -m kmcex_tpu_torch.tools.time_query \
        [--kmers 4000000] [--queries 1000000] \
        [--tiles 65536,262144,1048576] [--bloom-tiles 524288,2097152] [--reps 5]

Builds a model of ``--kmers`` random canonical 31-mers (zipf counts, seed 0)
with the host encoder, uploads it, and answers ``--queries`` resident queries
(half counted k-mers, half random) with the main pass cut into tiles of each
size: CUDA events around the whole batch, the sizes taken in turns (up, then
down), median of ``--reps`` each; beside it the summed kernel time and the
launch count from torch.profiler, which say whether the launches or the
kernels bound the pass.  The answers of every tile size must be equal.  The
Bloom feed is timed the same way on the model's own table.  Prints one JSON
line per size, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.model import device_bloom
from kmcex_tpu_torch.model.kmodel import get_model
from kmcex_tpu_torch.query.device_model import DeviceKModel

K, CI, CS, NH, NB = 31, 1, 1023, 7, 5


def event_ms(fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def kernel_time(fn) -> tuple[float, int]:
    """(summed device time of all kernels in ms, launches) of one call."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    return (sum(getattr(e, "device_time_total", 0.0) for e in rows) / 1e3,
            sum(e.count for e in rows))


def in_turns(variants: dict, reps: int) -> dict:
    """name -> median ms of ``reps`` rounds; each round runs the variants
    up, then down, so a drift of the clocks falls on all alike."""
    times = {name: [] for name in variants}
    for name, fn in variants.items():
        fn()  # warm
    order = list(variants) + list(variants)[::-1]
    for _ in range(reps):
        for name in order:
            times[name].append(event_ms(variants[name]))
    return {name: float(np.median(t)) for name, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kmers", type=int, default=4_000_000)
    ap.add_argument("--queries", type=int, default=1_000_000)
    ap.add_argument("--tiles", default="65536,262144,1048576")
    ap.add_argument("--bloom-tiles", default="524288,2097152")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_query needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    kmers = np.unique(codec.canonical_np(
        rng.integers(0, 1 << (2 * K), args.kmers, dtype=np.uint64), K))
    counts = np.clip(rng.zipf(1.5, len(kmers)), CI, CS).astype(np.uint32)
    km = get_model(CI, CS, NH, NB)
    km.init_from_pairs(kmers, counts, K)
    dm = DeviceKModel(km, device=dev)
    q = np.concatenate([rng.choice(kmers, args.queries // 2), rng.integers(
        0, 1 << 62, args.queries // 2, dtype=np.uint64)])
    rng.shuffle(q)
    qd = torch.from_numpy(q.view(np.int64)).to(dev)
    n = len(q)

    def main_pass(tile):
        return lambda: [dm._main(qd[a : a + tile]) for a in range(0, n, tile)]

    tiles = [int(t) for t in args.tiles.split(",")]
    want = dm.query_tensor(qd, tiles[0])
    for t in tiles[1:]:
        if not torch.equal(dm.query_tensor(qd, t), want):
            raise AssertionError(f"tile {t}: other answers than {tiles[0]}")
    ms = in_turns({t: main_pass(t) for t in tiles}, args.reps)
    for t in tiles:
        busy, launches = kernel_time(main_pass(t))
        print(json.dumps({"path": "query_main_pass", "tile": t, "queries": n,
                          "ms": ms[t], "mqs": n / ms[t] / 1e3,
                          "kernel_ms": busy, "launches": launches}))

    hist = np.array([np.count_nonzero(counts == CI + i) for i in range(3)])
    u = torch.from_numpy(kmers.view(np.int64)).to(dev)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)

    def feed(tile):
        def run():
            device_bloom.TILE = tile
            b = device_bloom.DeviceBloomBuilder(K, CI, CS, NH, hist, device=dev)
            b.feed_table(u, c, len(kmers))
        return run

    default_tile = device_bloom.TILE
    btiles = [int(t) for t in args.bloom_tiles.split(",")]
    try:
        ms = in_turns({t: feed(t) for t in btiles}, args.reps)
        for t in btiles:
            busy, launches = kernel_time(feed(t))
            print(json.dumps({"path": "bloom_feed", "tile": t,
                              "keys": len(kmers), "low_keys": int(hist[0]),
                              "ms": ms[t], "kernel_ms": busy,
                              "launches": launches}))
    finally:
        device_bloom.TILE = default_tile
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
