"""The port's multi-process runtime (parallel/distributed.py, parallel/comm.py)
with two spawned gloo ranks of two CPU shards each: the workers import torch
and the port only, the parent holds what they wrote against a single-process
run of the port and against the JAX package.  Integers and bytes: exact.

Every worker has its own time limit, so a hung collective fails the test
at once instead of holding the suite."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from kmcex_tpu.count import pipeline as jpipe
from kmcex_tpu_torch.count import pipeline as tpipe
from kmcex_tpu_torch.parallel import sharded
from tests.test_byte_ranges import _write_fastq

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER_SECONDS = 60
FILES = ["o.res.kmc_pre", "o.res.kmc_suf", "o.res/header", "o.res/km.bin",
         "o.res/rest.bin"]

WORKER = r"""
import json, os, sys
import numpy as np
import torch

mode, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
args = sys.argv[4:]
assert "jax" not in sys.modules

from kmcex_tpu_torch.parallel import comm, distributed, sharded
from kmcex_tpu_torch.parallel.sharded import ShardedCountAccumulator

if mode != "cli":
    distributed.initialize()        # KMCEX_* from the environment
    distributed.initialize()        # idempotent
    assert distributed.process_count() == 2
    assert distributed.process_index() == rank
    mesh = distributed.global_mesh("cpu")   # KMCEX_LOCAL_SHARDS=2
    assert (mesh.n, mesh.local, mesh.world, mesh.rank) == (4, 2, 2, rank)
    assert comm.stages_through_host(mesh.group)

if mode == "raw":
    # the raw add_batch exchange: one seeded stream, each rank takes the
    # rows of its own shards
    K, SEG_ROWS, SEG_LEN = 7, 4, 24
    acc = ShardedCountAccumulator(mesh, K, SEG_ROWS, SEG_LEN)
    rng = np.random.default_rng(123)
    for _ in range(3):
        batch = rng.integers(0, 4, size=(4 * SEG_ROWS, SEG_LEN)).astype(np.uint8)
        batch[rng.random(batch.shape) < 0.02] = 255
        local = batch[rank * 8 : (rank + 1) * 8]
        acc.add_batch(distributed.process_local_batch(mesh, local))
    kmers, counts = acc.finalize(ci=1)
    np.savez(out, kmers=kmers, counts=counts, windows=acc.total_windows)
elif mode == "count_fastq":
    items = distributed.host_input_slices(args[0])
    kmers, counts = distributed.distributed_count_fastq(
        args[0], k=9, ci=1, cs=1023, seg_len=32, batch_segs=4, device="cpu")
    np.savez(out, kmers=kmers, counts=counts,
             ranged=[int(it[1] is not None) for it in items], n_items=len(items))
elif mode == "tiers":
    # disk tier on both ranks, runs gathered by path (one machine) or, with
    # host names faked apart, by content; then a 2-rank checkpoint
    if args[1] == "by_content":
        comm.hostname = lambda: f"host{rank}"
    K, SEG_ROWS, SEG_LEN = 11, 8, 40
    acc = ShardedCountAccumulator(
        mesh, K, SEG_ROWS, SEG_LEN, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=1024, disk_dir=os.path.join(args[0], "lsm"))
    rng = np.random.default_rng(77)
    for i in range(8):
        batch = rng.integers(0, 4, size=(4 * SEG_ROWS, SEG_LEN)).astype(np.uint8)
        acc.add_batch(batch[rank * 16 : (rank + 1) * 16])
        if i == 4:
            acc.checkpoint(os.path.join(args[0], "ck"), extra={"n_batches": 5})
    ev = acc.tier_events
    assert ev["disk_spills"] > 0 and ev["host_spills"] > 0, ev
    total, hist, it = acc.finalize_stream(ci=1)
    parts = list(it)
    np.savez(out, kmers=np.concatenate([p[0] for p in parts]),
             counts=np.concatenate([p[1] for p in parts]), total=total,
             hist=hist, windows=acc.total_windows)
    comm.barrier(mesh.group)   # the other rank's spool lives until it drained
    left =[os.path.join(d, f) for d, _, fs in os.walk(os.path.join(args[0], "lsm"))
            for f in fs]
    assert not left, left
elif mode == "encode":
    # count_encode on the 2-rank mesh; "spill1" makes rank 1 alone spill
    from kmcex_tpu_torch.count.pipeline import count_encode
    if args[1] == "spill1" and rank == 1:
        ShardedCountAccumulator.RAW_TIER_ELEMS = 512
        ShardedCountAccumulator.SPILL_THRESHOLD = 1024
    db = os.path.join(args[2], "o.res") if rank == 0 else None
    km, kk, cc, st = count_encode(args[0], k=15, ci=1, cs=1023, seg_len=32,
                                  batch_segs=64, keep_pairs=True, db_path=db,
                                  accumulator="sharded", device="cpu")
    if rank == 0:
        km.save(os.path.join(args[2], "o.res"))
    np.savez(out, kmers=kk, counts=cc)
    with open(out + ".json", "w") as f:
        json.dump({"phases": sorted(st.phases), "tiers": st.tiers,
                   "reads": st.reads, "bases": st.bases,
                   "windows": st.windows, "distinct": st.distinct_kmers}, f)
    if args[1] == "ckpt":
        try:
            count_encode(args[0], k=15, accumulator="sharded", device="cpu",
                         ckpt_dir=os.path.join(args[2], "ck"))
        except NotImplementedError:
            pass
        else:
            raise AssertionError("ckpt_dir on two processes was not refused")
elif mode == "cli":
    from kmcex_tpu_torch import cli
    wd = os.path.join(args[1], f"rank{rank}")
    os.makedirs(wd)
    rc = cli.main(["kmcex", "-k15", "-accsharded", args[0],
                   os.path.join(wd, "o.res"), wd], device="cpu")
    assert rc == 0
    assert distributed.process_count() == 2
else:
    raise SystemExit(f"unknown mode {mode}")
print("OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(tmp_path, mode, *args, env_extra=None):
    """Two ranks of WORKER; a rank that fails, or that outlives its time
    limit, fails the test and takes the other down with it."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(PYTHONPATH=str(REPO), KMCEX_COORDINATOR=f"localhost:{_free_port()}",
               KMCEX_NUM_PROCESSES="2", KMCEX_LOCAL_SHARDS="2",
               OMP_NUM_THREADS="2", **(env_extra or {}))
    outs = [str(tmp_path / f"out{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), mode, str(r), outs[r], *map(str, args)],
        env=dict(env, KMCEX_PROCESS_ID=str(r)), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=WORKER_SECONDS)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of mode {mode} still ran after "
                            f"{WORKER_SECONDS} s (a hung collective?)")
            assert p.returncode == 0 and b"OK" in out, \
                (r, out.decode()[-2000:], err.decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _same_tables(outs):
    r0, r1 = np.load(outs[0]), np.load(outs[1])
    np.testing.assert_array_equal(r0["kmers"], r1["kmers"])
    np.testing.assert_array_equal(r0["counts"], r1["counts"])
    return r0, r1


def test_two_process_all_to_all_count(tmp_path):
    r0, r1 = _same_tables(_run_ranks(tmp_path, "raw"))
    # the same stream through one process of 4 shards and through the JAX
    # package's single-device accumulator
    from kmcex_tpu.count.device_lsm import DeviceCountAccumulator as JAcc

    one = sharded.ShardedCountAccumulator(
        sharded.make_mesh(devices=["cpu"] * 4), 7, 4, 24)
    ref = JAcc(7)
    rng = np.random.default_rng(123)
    for _ in range(3):
        batch = rng.integers(0, 4, size=(16, 24)).astype(np.uint8)
        batch[rng.random(batch.shape) < 0.02] = 255
        one.add_batch(batch)
        ref.add_batch(batch)
    for want_k, want_c in (one.finalize(ci=1), ref.finalize(ci=1)):
        np.testing.assert_array_equal(r0["kmers"], want_k)
        np.testing.assert_array_equal(r0["counts"], want_c)
    assert int(r0["windows"]) == int(r1["windows"]) == one.total_windows


def test_two_process_distributed_count_fastq(tmp_path):
    """distributed_count_fastq on ONE uncompressed FASTQ: byte-range split
    across processes, lockstep feeding, equal to a single-process count."""
    fq = tmp_path / "big.fastq"
    _write_fastq(fq, n_reads=350, seed=99)
    r0, r1 = _same_tables(_run_ranks(tmp_path, "count_fastq", fq))
    assert r0["ranged"].tolist() == [1] and int(r0["n_items"]) == 1
    want_k, want_c, _ = jpipe.count_fastq(str(fq), k=9, ci=1, cs=1023,
                                          seg_len=32, accumulator="host")
    np.testing.assert_array_equal(r0["kmers"], want_k)
    np.testing.assert_array_equal(r0["counts"], want_c)


def test_two_process_unequal_batch_counts(tmp_path):
    """Three files of very different sizes, owned round-robin: rank 0 parses
    two of them and steps many more batches than rank 1, which feeds empty
    buffers until rank 0 is done (lockstep)."""
    names = []
    for i, n_reads in enumerate((300, 20, 150)):
        fq = tmp_path / f"part{i}.fastq"
        _write_fastq(fq, n_reads=n_reads, seed=50 + i)
        names.append(str(fq))
    lst = tmp_path / "reads.lst"
    lst.write_text("\n".join(names) + "\n")
    r0, r1 = _same_tables(_run_ranks(tmp_path, "count_fastq", f"@{lst}"))
    assert r0["ranged"].tolist() == [0, 0] and r1["ranged"].tolist() == [0]
    want_k, want_c, _ = tpipe.count_fastq(f"@{lst}", k=9, ci=1, cs=1023,
                                          seg_len=32, accumulator="host",
                                          device="cpu")
    np.testing.assert_array_equal(r0["kmers"], want_k)
    np.testing.assert_array_equal(r0["counts"], want_c)


@pytest.mark.parametrize("gather", ["by_path", "by_content"])
def test_two_process_disk_tier_and_checkpoint(tmp_path, gather):
    """Both ranks spill to disk; the finalize gathers the runs (files by
    path on one machine, by content across machines), every rank returns
    the same table and cleans up; a checkpoint taken on both ranks restores
    in ONE process on a mesh of the same n."""
    r0, r1 = _same_tables(_run_ranks(tmp_path, "tiers", tmp_path, gather))
    rng = np.random.default_rng(77)
    batches = [rng.integers(0, 4, size=(32, 40)).astype(np.uint8)
               for _ in range(8)]
    mesh = sharded.make_mesh(devices=["cpu"] * 4)
    one = sharded.ShardedCountAccumulator(mesh, 11, 8, 40)
    for b in batches:
        one.add_batch(b)
    want_k, want_c = one.finalize(ci=1)
    np.testing.assert_array_equal(r0["kmers"], want_k)
    np.testing.assert_array_equal(r0["counts"], want_c)
    assert int(r0["total"]) == int(r1["total"]) == len(want_k)
    assert r0["hist"].tolist() == [int(np.count_nonzero(want_c == 1 + i))
                                   for i in range(3)]
    assert int(r0["windows"]) == int(r1["windows"]) == one.total_windows

    m = sharded.ShardedCountAccumulator.read_manifest(str(tmp_path / "ck"))
    assert m["n_shards"] == 4 and m["extra"] == {"n_batches": 5}
    assert len(m["shard_files"]) == 4 and all(m["shard_files"])
    assert all(f"_s{s:03d}_" in name
               for s, fs in enumerate(m["shard_files"]) for name in fs)
    res = sharded.ShardedCountAccumulator.restore(mesh, str(tmp_path / "ck"))
    for b in batches[5:]:
        res.add_batch(b)
    got_k, got_c = res.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("variant", ["mesh_bloom", "spill1", "ckpt"])
def test_two_process_count_encode(tmp_path, variant):
    """count_encode(accumulator="sharded") on two ranks: rank 0's five files
    equal the single-process device build of both packages, both ranks get
    the same table and the global read statistics.  Unspilled, the Bloom
    bank is built across the ranks (no host insert); with rank 1 alone
    spilled no rank builds it and nothing hangs."""
    import json

    fq = tmp_path / "big.fastq"
    _write_fastq(fq, n_reads=400, seed=77)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    outs = _run_ranks(tmp_path, "encode", fq, variant, out_dir)
    r0, _ = _same_tables(outs)
    st = [json.loads(pathlib.Path(o + ".json").read_text()) for o in outs]
    assert st[0]["reads"] == st[1]["reads"] == 400
    for key in ("bases", "windows", "distinct"):
        assert st[0][key] == st[1][key]
    for s in st:
        assert ("encode.bloom_insert" in s["phases"]) == (variant == "spill1")
    # the finalize drains each of a rank's two shards to the host once
    assert st[0]["tiers"]["host_spills"] == 2
    assert (st[1]["tiers"]["host_spills"] > 2) == (variant == "spill1")
    got = [(out_dir / f).read_bytes() for f in FILES]
    for mod, kw in ((tpipe, {"device": "cpu"}), (jpipe, {})):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        km, kk, cc, wst = mod.count_encode(
            str(fq), k=15, ci=1, cs=1023, seg_len=32, batch_segs=64,
            keep_pairs=True, db_path=str(d / "o.res"), **kw)
        km.save(d / "o.res")
        assert got == [(d / f).read_bytes() for f in FILES]
        np.testing.assert_array_equal(r0["kmers"], kk)
        np.testing.assert_array_equal(r0["counts"], cc)
        assert (st[0]["reads"], st[0]["bases"], st[0]["distinct"]) == \
            (wst.reads, wst.bases, wst.distinct_kmers)


def test_two_process_cli_accsharded_equals_accdevice(tmp_path):
    """-accsharded through the CLI on two ranks (KMCEX_COORDINATOR,
    KMCEX_NUM_PROCESSES, KMCEX_PROCESS_ID, KMCEX_LOCAL_SHARDS in the
    environment): rank 0's files equal -accdevice's, rank 1 writes none."""
    import kmcex_tpu_torch.cli as torch_cli

    fq = tmp_path / "big.fastq"
    _write_fastq(fq, n_reads=400, seed=78)
    _run_ranks(tmp_path, "cli", fq, tmp_path)
    wd = tmp_path / "device"
    wd.mkdir()
    assert torch_cli.main(["kmcex", "-k15", "-accdevice", str(fq),
                           str(wd / "o.res"), str(wd)], device="cpu") == 0
    for f in FILES:
        assert (tmp_path / "rank0" / f).read_bytes() == (wd / f).read_bytes(), f
    assert sorted(os.listdir(tmp_path / "rank1")) == []
