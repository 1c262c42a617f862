"""End-to-end pipeline: FASTQ -> counts -> KMC1 DB + KModel -> model dir.

The counterpart of the JAX package's ``count/pipeline.py`` (``count_fastq``,
``count_encode`` and ``run``; the device, sharded and host accumulators), in
PyTorch: a producer thread parses and 2-bit packs reads (native
segmenter), a second one copies them to the device, the main thread enqueues extract / sort / merge work, and
the finalized table streams back in chunks that feed the KMC1 spool and the
native coupled-array encoder.  The Bloom bank is built on the device from
the counted table (``model.device_bloom``); ``KMCEX_DEVICE_BLOOM=0`` selects
the host insert instead, and the model bytes are the same either way.  A
table that outgrows the device spills to the host and disk levels of
``count.device_lsm``; ``ckpt_dir`` makes the count phase resumable.
``accumulator="sharded"`` counts on a mesh of shards (``parallel.sharded``),
in one process or, after ``parallel.distributed.initialize``, in several
that step in lockstep.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time

import numpy as np
import torch

from kmcex_tpu_torch import native
from kmcex_tpu_torch.config import KParams
from kmcex_tpu_torch.count.counter import CountAccumulator
from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator
from kmcex_tpu_torch.io import fastq, kmc_db
from kmcex_tpu_torch.model.device_bloom import (
    DeviceBloomBuilder,
    ShardedDeviceBloomBuilder,
)
from kmcex_tpu_torch.model.kmodel import KModel, get_model, split_chunk
from kmcex_tpu_torch.parallel import distributed
from kmcex_tpu_torch.parallel.sharded import ShardedCountAccumulator, make_mesh
from kmcex_tpu_torch.utils import prefetch_iterator
from kmcex_tpu_torch.utils.device import resolve_device
from kmcex_tpu_torch.utils.timing import Phases, device_trace


@dataclasses.dataclass
class PipelineStats:
    reads: int = 0
    bases: int = 0
    windows: int = 0
    distinct_kmers: int = 0
    count_seconds: float = 0.0
    encode_seconds: float = 0.0
    phases: dict = dataclasses.field(default_factory=dict)
    # tier-transition counts from the accumulator (raw collapses, device
    # merges, host and disk spills)
    tiers: dict = dataclasses.field(default_factory=dict)
    # cost of the host and disk levels (DeviceCountAccumulator.spill_stats)
    spill: dict = dataclasses.field(default_factory=dict)
    # batches a resumed run did not parse again (count_encode ckpt_dir)
    skipped_batches: int = 0
    # bytes of the counted table copied to the host (keys + counts)
    table_bytes_to_host: int = 0
    # sharded runs: mesh size, this process's rank and the entries each of
    # its shards drained at the finalize (owner balance), re-routes (always 0)
    shards: dict = dataclasses.field(default_factory=dict)


def _seg_len_for(input_spec: str, k: int, seg_len: int | None) -> int:
    """``None`` sizes segments to the observed read length, so no window
    slot is padding; the packed path needs a multiple of 8."""
    if seg_len is None:
        sniffed = fastq.sniff_read_length(input_spec)
        seg_len = min(512, max(k + 33, sniffed))
    return (seg_len + 7) & ~7


def _to_device(device):
    def put(batch):
        packed, maskbits = batch
        return (torch.from_numpy(packed).to(device),
                torch.from_numpy(maskbits).to(device))

    return put


def _to_shards(mesh):
    def put(batch):
        packed, maskbits = batch
        return (mesh.put_rows(torch.from_numpy(packed)),
                mesh.put_rows(torch.from_numpy(maskbits)))

    return put


def _default_mesh(device):
    """The mesh of a sharded run that was given none: every rank's shards
    once ``parallel.distributed.initialize`` ran, else every visible card
    (one shard each), or one shard on the ``device`` the caller named."""
    if distributed.process_count() > 1:
        return distributed.global_mesh(device)
    if device is None:
        return make_mesh()
    return make_mesh(devices=[device])


def count_fastq(
    input_spec: str,
    k: int = 31,
    ci: int = 1,
    cs: int = 1023,
    seg_len: int | None = None,
    batch_segs: int = fastq.DEFAULT_BATCH_SEGS,
    accumulator: str = "device",
    mesh=None,
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, PipelineStats]:
    """Count canonical k-mers in FASTQ/FASTA input: (uint64 kmers, uint32
    counts, stats), ascending, ci-filtered and cs-clamped.

    ``accumulator="device"`` keeps all run merging on the GPU (one host
    transfer in total unless the table spills); ``"sharded"`` runs the
    hash-routed accumulator over ``mesh`` (default: every visible card, one
    shard each; this entry point is single-process); ``"host"`` is the
    NumPy LSM over per-batch device counts.  ``device=None`` means the GPU
    and raises without one."""
    if accumulator not in ("device", "sharded", "host"):
        raise ValueError(
            f"accumulator must be device|sharded|host, got {accumulator!r}")
    if accumulator == "sharded":
        mesh = mesh or _default_mesh(device)
    else:
        device = resolve_device(device)
    t0 = time.time()
    seg_len = _seg_len_for(input_spec, k, seg_len)
    if accumulator == "device":
        stream = fastq.SegmentStream(input_spec, k, seg_len, batch_segs,
                                     packed=True)
        acc = DeviceCountAccumulator(k, device=device)
        parsed = prefetch_iterator(iter(stream), depth=2)
        for packed, maskbits in prefetch_iterator(parsed, depth=2,
                                                  transform=_to_device(device)):
            acc.add_batch_packed(packed, maskbits)
    elif accumulator == "sharded":
        n = mesh.n
        batch_segs = max(n, (batch_segs // n) * n)  # rows divide the mesh
        stream = fastq.SegmentStream(input_spec, k, seg_len, batch_segs,
                                     packed=True)
        acc = ShardedCountAccumulator(mesh, k, batch_segs // n, seg_len,
                                      packed=True)
        parsed = prefetch_iterator(iter(stream), depth=2)
        for packed, maskbits in prefetch_iterator(parsed, depth=2,
                                                  transform=_to_shards(mesh)):
            acc.add_batch_packed(packed, maskbits)
    else:
        stream = fastq.segment_batches(input_spec, k, seg_len, batch_segs)
        acc = CountAccumulator(k, device=device)
        for codes in prefetch_iterator(iter(stream), depth=3):
            acc.add_batch(codes)
    kmers, counts = acc.finalize(ci, cs)
    stats = PipelineStats(
        reads=stream.reads,
        bases=stream.bases,
        windows=acc.total_windows,
        distinct_kmers=len(kmers),
        count_seconds=time.time() - t0,
        tiers=dict(getattr(acc, "tier_events", {})),
    )
    return kmers, counts, stats


def count_encode(
    input_spec: str,
    k: int = 31,
    ci: int = 1,
    cs: int = 1023,
    num_hash: int = 7,
    num_bit: int = 5,
    seg_len: int | None = None,
    batch_segs: int = fastq.DEFAULT_BATCH_SEGS,
    keep_pairs: bool = True,
    db_path: str | None = None,
    accumulator: str = "device",
    mesh=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 256,
    *,
    device=None,
) -> tuple[KModel, np.ndarray | None, np.ndarray | None, PipelineStats]:
    """Count + encode, the device->host table pull overlapping the host
    encode.  ``db_path`` spools the KMC1 database chunk by chunk.
    ``device=None`` means the GPU and raises without one.  The argument
    order and defaults are the JAX package's ``count_encode``; ``device`` is
    the port's own, keyword only.

    Returns (model, kmers, counts, stats); the ci-filtered, cs-clamped
    listing (uint64 kmers, uint32 counts) only with ``keep_pairs`` (it costs
    host memory, not time), else None.

    The Bloom bank is built on the device unless ``KMCEX_DEVICE_BLOOM=0``.
    With ``accumulator="device"``, when the host needs no low pairs
    (``keep_pairs=False`` and no ``db_path``) the keys that only feed the
    Bloom bank are dropped from the transfer: the model-only path.

    ``accumulator="sharded"`` runs the hash-routed accumulator over ``mesh``
    (``parallel.sharded``; default: every visible card, one shard each) and
    builds the Bloom bank across the mesh.  On a multi-process runtime
    (``parallel.distributed.initialize`` ran) every process must call this;
    each parses its own slice of the input in lockstep with the others,
    every process gets the same model, and only process 0 should pass
    ``db_path``.

    ``ckpt_dir`` makes the COUNT phase resumable: every ``ckpt_every``
    batches (``KMCEX_CKPT_EVERY`` overrides) the accumulator state plus the
    stream position land in ``ckpt_dir`` (manifest written last — a crash
    mid-checkpoint is invisible).  On the next call with the same ckpt_dir,
    input and parameters, counting resumes after the last checkpointed
    batch; batch segmentation is a pure function of the input, ``seg_len``
    and ``batch_segs``, so the resumed model is byte-identical to an
    uninterrupted run.  A manifest written for another input or parameter
    set raises ``ValueError``.  The manifest is retired on success.
    Single-process only (the multi-process stream does not checkpoint its
    byte-range position and raises).  ``KMCEX_CRASH_AFTER_BATCHES=N`` raises
    after N batches of this call (fault injection for the resume tests).

    ``KMCEX_TRACE_DIR`` writes a torch.profiler trace of the whole call."""
    with device_trace("count_encode"):
        return _count_encode(input_spec, k, ci, cs, num_hash, num_bit,
                             seg_len, batch_segs, keep_pairs, db_path,
                             accumulator, mesh, ckpt_dir, ckpt_every, device)


def _count_encode(input_spec, k, ci, cs, num_hash, num_bit, seg_len,
                  batch_segs, keep_pairs, db_path, accumulator, mesh,
                  ckpt_dir, ckpt_every, device):
    if accumulator not in ("device", "sharded"):
        raise ValueError(
            f"accumulator must be device|sharded, got {accumulator!r}")
    sharded = accumulator == "sharded"
    if sharded:
        mesh = mesh or _default_mesh(device)
    else:
        device = resolve_device(device)
    ph = Phases()
    t0 = time.time()
    with ph.phase("sniff_read_length"):
        seg_len = _seg_len_for(input_spec, k, seg_len)
    ckpt_fp = {"input": str(input_spec), "k": int(k),
               "seg_len": int(seg_len), "batch_segs": int(batch_segs),
               "accumulator": accumulator, "ci": int(ci), "cs": int(cs)}
    skip = 0
    n_reads = n_bases = None
    if sharded and mesh.world > 1:
        if ckpt_dir:
            raise NotImplementedError(
                "ckpt_dir is single-process only; the multi-process stream "
                "does not checkpoint its byte-range position")
        # each process parses only its byte-range / file slice, stepping
        # the exchange in lockstep with the others
        stream = None
        acc = ShardedCountAccumulator(mesh, k, max(1, batch_segs // mesh.n),
                                      seg_len, packed=True)
        with ph.phase("stream+extract"):
            n_reads, n_bases = distributed.stream_into_accumulator(
                acc, input_spec, k, seg_len)
    else:
        if sharded:
            n = mesh.n
            batch_segs = max(n, (batch_segs // n) * n)
            acc = ShardedCountAccumulator(mesh, k, batch_segs // n, seg_len,
                                          packed=True)
            put = _to_shards(mesh)
        else:
            acc = DeviceCountAccumulator(k, device=device)
            put = _to_device(device)
        stream = fastq.SegmentStream(input_spec, k, seg_len, batch_segs,
                                     packed=True)
        # resume: swap in the checkpointed accumulator and skip the batches
        # it already consumed
        if ckpt_dir:
            m = type(acc).read_manifest(ckpt_dir)
            if m is not None:
                if m.get("extra", {}).get("fingerprint") != ckpt_fp:
                    raise ValueError(
                        f"checkpoint in {ckpt_dir} was written for a "
                        f"different input/parameter set "
                        f"({m.get('extra', {}).get('fingerprint')}); delete "
                        f"it to start fresh")
                if sharded:
                    acc = ShardedCountAccumulator.restore(mesh, ckpt_dir,
                                                          packed=True)
                else:
                    acc = DeviceCountAccumulator.restore(ckpt_dir,
                                                         device=device)
                skip = int(m["extra"]["n_batches"])
        ckpt_every = int(os.environ.get("KMCEX_CKPT_EVERY", ckpt_every))
        crash_after = int(os.environ.get("KMCEX_CRASH_AFTER_BATCHES", 0))

        # two producer stages: thread A parses + packs (one native pass),
        # thread B copies to the device; the main thread only enqueues
        # device work.  Both queues are FIFO, so batches arrive in stream
        # order; the skip drops already-counted batches before their copy.
        with ph.phase("stream+extract"):
            parsed = prefetch_iterator(iter(stream), depth=2)
            if skip:
                base = parsed
                parsed = (x for j, x in enumerate(base) if j >= skip)
            nb = skip
            for packed, maskbits in prefetch_iterator(parsed, depth=2,
                                                      transform=put):
                acc.add_batch_packed(packed, maskbits)
                nb += 1
                if ckpt_dir and ckpt_every and nb % ckpt_every == 0:
                    acc.checkpoint(ckpt_dir, extra={"fingerprint": ckpt_fp,
                                                    "n_batches": nb})
                if crash_after and nb - skip >= crash_after:
                    raise RuntimeError(
                        "injected crash (KMCEX_CRASH_AFTER_BATCHES)")
    fin_kwargs = {}
    if os.environ.get("KMCEX_DEVICE_BLOOM", "1") != "0":
        if sharded:
            fin_kwargs = dict(
                bloom_factory=lambda hist: ShardedDeviceBloomBuilder(
                    mesh, k, ci, cs, num_hash, hist))
        else:
            fin_kwargs = dict(
                bloom_factory=lambda hist: DeviceBloomBuilder(
                    k, ci, cs, num_hash, hist, device=device),
                drop_low=(not keep_pairs) and db_path is None,
            )
    with ph.phase("merge+stats"):
        total, low_hist, chunks = acc.finalize_stream(ci, cs, **fin_kwargs)
    for name, secs in acc.finalize_phases.items():
        ph.add(f"finalize.{name}", secs)

    bf_num = 1 if ci == 1 else 3
    writer = None
    if db_path:
        writer = kmc_db.KMC1StreamWriter(db_path, k, min_count=ci,
                                         max_count=cs)

    collected: list[tuple[np.ndarray, np.ndarray]] = []

    def produce(item):
        ku, kc = item
        if keep_pairs:
            collected.append((ku, kc))
        if writer is not None:
            writer.write_chunk(ku, kc.astype(np.uint64))
        return split_chunk(ku, kc, ci, bf_num)

    # a producer thread owns the pulls, the DB spool and the counter routing
    # so the (GIL-releasing) native encode on this thread only feeds
    chunks = prefetch_iterator(chunks, depth=4, transform=produce)
    t_count = time.time() - t0

    km = get_model(ci, cs, num_hash, num_bit)
    try:
        with ph.phase("transfer+encode"):
            km.init_from_chunks(chunks, k, total, low_hist,
                                device_bloom=acc.device_bloom)
    except BaseException:
        # a partial spool must not look like a complete database
        if writer is not None:
            writer.abort()
        raise
    if writer is not None:
        writer.close()
    if ckpt_dir:
        # retire the manifest: the run completed, a later run with this dir
        # starts fresh (run files stay until overwritten)
        try:
            os.unlink(os.path.join(ckpt_dir, "manifest.json"))
        except OSError:
            pass
    for name, secs in km.encode_phases.items():
        ph.add(f"encode.{name}", secs)
    t_total = time.time() - t0
    stats = PipelineStats(
        reads=stream.reads if n_reads is None else n_reads,
        bases=stream.bases if n_bases is None else n_bases,
        windows=acc.total_windows,
        distinct_kmers=total,
        count_seconds=t_count,
        encode_seconds=t_total - t_count,
        phases=dict(ph.seconds),
        tiers=dict(acc.tier_events),
        table_bytes_to_host=acc.table_bytes_to_host,
        spill=dict(acc.spill_stats),
        skipped_batches=skip,
    )
    if sharded:
        stats.shards = {"n": mesh.n, "rank": mesh.rank,
                        "sizes": list(acc.shard_sizes),
                        "reroutes": acc.reroutes}
    kmers = counts = None
    if keep_pairs:
        kmers = (np.concatenate([x[0] for x in collected]) if collected
                 else np.zeros(0, np.uint64))
        counts = (np.concatenate([x[1] for x in collected]) if collected
                  else np.zeros(0, np.uint32))
    return km, kmers, counts, stats


def run(params: KParams, save_dir: str | None = None, write_db: bool = True,
        device=None) -> tuple[KModel, PipelineStats]:
    """Full kmcEx-equivalent run: count, (optionally) stream the KMC1 DB to
    ``output_file_name``, build + save the model under ``save_dir``, by
    default ``working_directory/<basename>`` (main.cpp:143-149).
    ``params.ckpt_dir`` makes the count phase resumable.

    ``params.accumulator`` picks the counting backend: "device" (default,
    one GPU) or "sharded" (the hash-routed mesh).  With "sharded" and
    KMCEX_NUM_PROCESSES > 1 in the environment this process joins the
    multi-process runtime (``parallel.distributed.initialize``: also
    KMCEX_COORDINATOR and KMCEX_PROCESS_ID; KMCEX_LOCAL_SHARDS shards per
    process): every process must run the same command, and only process 0
    writes the database and the model."""
    sharded = params.accumulator == "sharded"
    if not sharded:
        device = resolve_device(device)
    elif int(os.environ.get("KMCEX_NUM_PROCESSES", 1)) > 1:
        distributed.initialize()
    is_primary = distributed.process_index() == 0
    if params.t:
        native.set_num_threads(params.t)
    batch_env = int(os.environ.get("KMCEX_BATCH_SEGS", 0))
    db_path = (params.output_file_name
               if write_db and params.output_file_name and is_primary
               else None)
    km, _, _, stats = count_encode(
        params.input_file_name, params.k, params.ci, params.cs,
        params.num_hash, params.num_bit, keep_pairs=False, db_path=db_path,
        accumulator=params.accumulator, ckpt_dir=params.ckpt_dir or None,
        device=device,
        **({"batch_segs": batch_env} if batch_env else {}),
    )
    if save_dir is None and params.output_file_name:
        base = pathlib.Path(params.output_file_name).name
        save_dir = str(pathlib.Path(params.working_directory) / base)
    if save_dir and is_primary:
        km.save(save_dir)
    return km, stats
