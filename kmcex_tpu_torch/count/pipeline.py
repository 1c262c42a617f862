"""End-to-end pipeline: FASTQ -> counts -> KMC1 DB + KModel -> model dir.

The counterpart of the JAX package's ``count/pipeline.py`` (``count_encode``
and ``run``, single-device accumulator), in PyTorch: a producer thread
parses and 2-bit packs reads (native segmenter), a second one copies them
to the device, the main thread enqueues extract / sort / merge work, and
the finalized table streams back in chunks that feed the KMC1 spool and the
native coupled-array encoder.  The Bloom bank is built on the device from
the counted table (``model.device_bloom``); ``KMCEX_DEVICE_BLOOM=0`` selects
the host insert instead, and the model bytes are the same either way.  No
checkpointing yet.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time

import numpy as np
import torch

from kmcex_tpu_torch.config import KParams
from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator
from kmcex_tpu_torch.io import fastq, kmc_db
from kmcex_tpu_torch.model.device_bloom import DeviceBloomBuilder
from kmcex_tpu_torch.model.kmodel import KModel, get_model, split_chunk
from kmcex_tpu_torch.utils import prefetch_iterator
from kmcex_tpu_torch.utils.device import resolve_device
from kmcex_tpu_torch.utils.timing import Phases


@dataclasses.dataclass
class PipelineStats:
    reads: int = 0
    bases: int = 0
    windows: int = 0
    distinct_kmers: int = 0
    count_seconds: float = 0.0
    encode_seconds: float = 0.0
    phases: dict = dataclasses.field(default_factory=dict)
    # tier-transition counts from the accumulator (raw collapses, merges)
    tiers: dict = dataclasses.field(default_factory=dict)
    # bytes of the counted table copied to the host (keys + counts)
    table_bytes_to_host: int = 0


def count_encode(
    input_spec: str,
    k: int = 31,
    ci: int = 1,
    cs: int = 1023,
    num_hash: int = 7,
    num_bit: int = 5,
    batch_segs: int = fastq.DEFAULT_BATCH_SEGS,
    db_path: str | None = None,
    device=None,
    keep_pairs: bool = False,
) -> tuple[KModel, np.ndarray | None, np.ndarray | None, PipelineStats]:
    """Count + encode, the device->host table pull overlapping the host
    encode.  ``db_path`` spools the KMC1 database chunk by chunk.
    ``device=None`` means the GPU and raises without one.

    The Bloom bank is built on the device unless ``KMCEX_DEVICE_BLOOM=0``.
    When the host needs no low pairs (no ``db_path``, no ``keep_pairs``)
    the keys that only feed the Bloom bank are dropped from the transfer:
    the model-only path.  Returns (model, kmers, counts, stats) as the JAX
    package's ``count_encode`` does; the ci-filtered, cs-clamped listing
    (uint64 kmers, uint32 counts) only with ``keep_pairs=True``, else None."""
    device = resolve_device(device)
    ph = Phases()
    t0 = time.time()
    with ph.phase("sniff_read_length"):
        # segments as long as the reads, so no window slot is padding
        sniffed = fastq.sniff_read_length(input_spec)
        seg_len = (min(512, max(k + 33, sniffed)) + 7) & ~7
    stream = fastq.SegmentStream(input_spec, k, seg_len, batch_segs)
    acc = DeviceCountAccumulator(k, device=device)

    def put(batch):
        packed, maskbits = batch
        return (torch.from_numpy(packed).to(device),
                torch.from_numpy(maskbits).to(device))

    # two producer stages: thread A parses + packs (one native pass), thread
    # B copies to the device; the main thread only enqueues device work
    with ph.phase("stream+extract"):
        parsed = prefetch_iterator(iter(stream), depth=2)
        for packed, maskbits in prefetch_iterator(parsed, depth=2,
                                                  transform=put):
            acc.add_batch_packed(packed, maskbits)
    fin_kwargs = {}
    if os.environ.get("KMCEX_DEVICE_BLOOM", "1") != "0":
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
    for name, secs in km.encode_phases.items():
        ph.add(f"encode.{name}", secs)
    t_total = time.time() - t0
    stats = PipelineStats(
        reads=stream.reads,
        bases=stream.bases,
        windows=acc.total_windows,
        distinct_kmers=total,
        count_seconds=t_count,
        encode_seconds=t_total - t_count,
        phases=dict(ph.seconds),
        tiers=dict(acc.tier_events),
        table_bytes_to_host=acc.table_bytes_to_host,
    )
    kmers = counts = None
    if keep_pairs:
        kmers = (np.concatenate([x[0] for x in collected]) if collected
                 else np.zeros(0, np.uint64))
        counts = (np.concatenate([x[1] for x in collected]) if collected
                  else np.zeros(0, np.uint32))
    return km, kmers, counts, stats


def run(params: KParams, device=None) -> tuple[KModel, PipelineStats]:
    """Full kmcEx-equivalent run: count, stream the KMC1 DB to
    ``output_file_name``, build + save the model under
    ``working_directory/<basename>`` (main.cpp:143-149)."""
    device = resolve_device(device)
    if params.t:
        from kmcex_tpu_torch import native

        native.set_num_threads(params.t)
    batch_env = int(os.environ.get("KMCEX_BATCH_SEGS", 0))
    db_path = params.output_file_name or None
    km, _, _, stats = count_encode(
        params.input_file_name, params.k, params.ci, params.cs,
        params.num_hash, params.num_bit, db_path=db_path, device=device,
        **({"batch_segs": batch_env} if batch_env else {}),
    )
    if params.output_file_name:
        base = pathlib.Path(params.output_file_name).name
        km.save(pathlib.Path(params.working_directory) / base)
    return km, stats
