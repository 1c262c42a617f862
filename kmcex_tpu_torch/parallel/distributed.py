"""Multi-process runtime: a shard mesh that spans ``torch.distributed`` ranks.

The counterpart of the JAX package's ``parallel/distributed.py``.  Each
process owns ``L`` local shards; ``initialize`` brings up the process group,
``global_mesh`` joins the ranks' shards into one mesh in (rank, local)
order, and the counting step (``parallel.sharded``) runs unchanged: its
exchange goes in-process between local shards and through
``parallel.comm`` across ranks.

Data flow per process:
  * each process reads ITS OWN slice of the input (``host_input_slices``:
    byte ranges of a single uncompressed file, else round-robin whole
    files),
  * extract / canonicalize on its own shards (data parallel),
  * k-mers route to owner shards by hash (``all_to_all_single`` with real
    split sizes),
  * per-shard sorted count tables stay with their rank until
    ``finalize_stream`` gathers them.

Backends: gloo when a rank has no card of its own (CPU shards, or several
ranks on one card: CUDA tensors are then staged through the host), NCCL
when every rank has one.  The NCCL branch has run nowhere yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from kmcex_tpu_torch.parallel import comm
from kmcex_tpu_torch.parallel.sharded import (
    ShardedCountAccumulator,
    ShardMesh,
    make_mesh,
)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Bring up the process group.  Arguments default to KMCEX_COORDINATOR
    (``host:port``), KMCEX_NUM_PROCESSES and KMCEX_PROCESS_ID.  ``backend``
    defaults to NCCL when it is built in and there are at least as many
    cards as processes (every rank gets its own), else gloo.  Safe to call
    twice (the second call is a no-op)."""
    if dist.is_initialized():
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("KMCEX_COORDINATOR"))
    if num_processes is None and "KMCEX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KMCEX_NUM_PROCESSES"])
    if process_id is None and "KMCEX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KMCEX_PROCESS_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize needs the coordinator's host:port, the number of "
            "processes and this process's id (arguments, or "
            "KMCEX_COORDINATOR / KMCEX_NUM_PROCESSES / KMCEX_PROCESS_ID)")
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= num_processes)
        backend = "nccl" if own_card and dist.is_nccl_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(device=None, local_shards: int | None = None) -> ShardMesh:
    """1-D mesh over the shards of every rank, in (rank, local) order.
    Every rank has ``local_shards`` shards (default KMCEX_LOCAL_SHARDS, else
    1) on ``device`` (default: the card ``rank % device_count``; without a
    card it raises, pass ``device="cpu"``)."""
    if local_shards is None:
        local_shards = int(os.environ.get("KMCEX_LOCAL_SHARDS", 1))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run a mesh "
                "of CPU shards")
        device = torch.device(
            "cuda", process_index() % torch.cuda.device_count())
    group = dist.group.WORLD if dist.is_initialized() else None
    return make_mesh(devices=[device] * local_shards, group=group)


def host_slice(paths: list[str]) -> list[str]:
    """Round-robin ownership of input files for this process — each process
    parses only its own slice (data parallelism over reads)."""
    pid, n = process_index(), process_count()
    return [p for i, p in enumerate(paths) if i % n == pid]


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def host_input_slices(input_spec: str
                      ) -> list[tuple[str, tuple[int, int] | None]]:
    """This process's (path, byte_range) work items.

    A single uncompressed file is split by byte ranges at record boundaries
    (io.fastq.split_byte_ranges) so one genome-scale FASTQ parses in
    parallel across all processes.  Multiple files (or gzip, which has no
    random access) fall back to round-robin whole-file ownership."""
    from kmcex_tpu_torch.io import fastq

    paths = fastq.resolve_inputs(input_spec)
    pid, n = process_index(), process_count()
    if len(paths) == 1 and n > 1 and not _is_gzip(paths[0]):
        return [(paths[0], fastq.split_byte_ranges(paths[0], n)[pid])]
    return [(p, None) for p in host_slice(paths)]


def process_local_batch(mesh: ShardMesh, codes) -> list[torch.Tensor]:
    """This process's rows of a batch, one part on each of its shards'
    devices (``ShardMesh.put_rows``): the form ``add_batch`` takes.  The
    global batch is the concatenation over ranks."""
    return mesh.put_rows(codes)


def stream_into_accumulator(acc: ShardedCountAccumulator, input_spec: str,
                            k: int, seg_len: int) -> tuple[int, int]:
    """Drain this process's input slice into ``acc`` in LOCKSTEP with every
    other process: the exchange inside each count step needs all ranks to
    step together, but their slices can yield different batch counts, so
    every step starts with a one-int reduction of "I still have data" and
    ranks that ran dry feed fully-masked empty buffers until all are done.
    After this returns on every rank, ``acc.finalize_stream`` yields the
    identical global table everywhere.  Returns GLOBAL (reads, bases).

    Batches move in the accumulator's transfer format: 2-bit packed +
    validity bitmask when ``acc`` was built with ``packed=True``, byte codes
    otherwise."""
    from kmcex_tpu_torch.io import fastq

    mesh = acc.mesh
    packed_mode = acc._packed
    items = host_input_slices(input_spec)
    local_rows = acc.seg_rows * mesh.local
    streams: list = []

    def new_buf():
        if packed_mode:
            return (np.zeros((local_rows, seg_len // 4), dtype=np.uint8),
                    np.zeros((local_rows, seg_len // 8), dtype=np.uint8))
        return np.full((local_rows, seg_len), 255, dtype=np.uint8)

    def copy_rows(dst, src, at, lo, hi):
        if packed_mode:
            dst[0][at : at + hi - lo] = src[0][lo:hi]
            dst[1][at : at + hi - lo] = src[1][lo:hi]
        else:
            dst[at : at + hi - lo] = src[lo:hi]

    def local_full_buffers():
        buf = new_buf()
        fill = 0
        for path, brange in items:
            stream = fastq.SegmentStream(path, k, seg_len, local_rows,
                                         use_native=True, packed=packed_mode,
                                         byte_range=brange)
            streams.append(stream)
            for batch in stream:
                nb = len(batch[0]) if packed_mode else len(batch)
                take = min(local_rows - fill, nb)
                copy_rows(buf, batch, fill, 0, take)
                fill += take
                if fill == local_rows:
                    yield buf
                    buf = new_buf()
                    fill = 0
                if take < nb:
                    copy_rows(buf, batch, 0, take, nb)
                    fill = nb - take
        if fill:
            yield buf

    def put(buf):
        if packed_mode:
            acc.add_batch_packed(buf[0], buf[1])
        else:
            acc.add_batch(buf)

    def totals():
        return [sum(s.reads for s in streams), sum(s.bases for s in streams)]

    it = local_full_buffers()
    if mesh.world == 1:
        for buf in it:
            put(buf)
        return tuple(totals())
    empty = new_buf()
    while True:
        nxt = next(it, None)
        alive = comm.all_reduce_sum([0 if nxt is None else 1], mesh.group,
                                    mesh.devices[0])
        if not int(alive[0]):
            break
        put(empty if nxt is None else nxt)
    reads, bases = comm.all_reduce_sum(totals(), mesh.group, mesh.devices[0])
    return int(reads), int(bases)


def distributed_count_fastq(input_spec: str, k: int, ci: int = 1,
                            cs: int = 1023, seg_len: int = 256,
                            batch_segs: int = 4096, *, device=None):
    """Multi-process counting entry point: each process streams its input slice
    (``host_input_slices``) in lockstep with the others
    (``stream_into_accumulator``) into the hash-routed sharded accumulator
    over ``global_mesh(device)``; ``batch_segs`` rows per shard and step.

    Returns host-side (kmers, counts) — identical on every process (the
    per-shard tables are gathered; fine for model-building, which every
    process replicates).  For tables too large to gather, consume
    ``ShardedCountAccumulator.finalize_stream`` instead."""
    mesh = global_mesh(device)
    packed = seg_len % 8 == 0
    acc = ShardedCountAccumulator(mesh, k, batch_segs, seg_len, packed=packed)
    stream_into_accumulator(acc, input_spec, k, seg_len)
    return acc.finalize(ci, cs)
