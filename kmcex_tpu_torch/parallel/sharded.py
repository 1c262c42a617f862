"""Multi-shard counting: data-parallel reads, hash-sharded k-mer table.

The counterpart of the JAX package's ``parallel/sharded.py``.  Read segments
are split over the shards of a mesh (data parallel); each shard extracts and
canonicalizes its k-mers; k-mers are routed to their OWNER shard by a
multiplicative hash; each shard then sort-counts its partition.  The
shard-local results together form the global count table (disjoint by
construction).  Every shard keeps the tiers of the single-device accumulator
(``count.device_lsm``): a raw tier collapsed by one sort + segment-count, a
run LSM merged pairwise on the device, a host level, a disk level — so all
three CUDA kernels run here, once per shard.

**What a mesh is.**  The JAX package is one process that drives ``n``
devices through ``shard_map``; on a pod it is ``P`` processes of ``L`` local
devices, ``n = P * L``, in (process, local) order.  ``ShardMesh`` keeps that
shape: the list of THIS process's shard devices (the same device may appear
more than once, which gives several logical shards on one card or on the
CPU), an optional ``torch.distributed`` process group, ``rank``, ``world``
and ``n = world * len(devices)``.  Global shard ``s`` lives on rank
``s // L`` as its local shard ``s % L``.  With ``world == 1`` every
exchange is slices and copies inside the process; with ``world > 1`` the
cross-process part goes through ``parallel.comm``.

**Where collectives sit.**  In the JAX package every shape, and so every
collapse and spill decision, is the same on all shards.  Here a shard's
sizes are its own, so a collapse, a device merge, a spill and a disk spill
are rank-local and contain no collective.  Collectives sit only in
``add_batch*`` (the exchange: the same number of calls on every rank),
``finalize_stream``, ``checkpoint`` and the mesh Bloom build.

Left out of the JAX module, on purpose:

  * the routing capacity, the SENTINEL padding of the send buffers and the
    worst-case re-route (``default_route_capacity``, ``_full_step``,
    sharded.py:100-110, 276-287): they exist only because XLA's
    ``all_to_all`` has a static shape.  The exchange here sends each group
    with its real size, so nothing can overflow; ``default_route_capacity``
    stays as a function (callers name it) and ``reroutes`` stays 0;
  * the per-batch ``psum`` of the window count and of the diagnostic real
    count (:94-96): they are summed locally and reduced once, in
    ``finalize_stream`` and ``checkpoint``, so a step does not wait for the
    other ranks twice;
  * ``_pull``'s gather of every run to every process at each spill
    (:208-214): a rank's runs stay on that rank and are gathered once, in
    ``finalize_stream``;
  * the raw tier counts the keys a shard received, not ``n * cap`` slots, so
    collapses fall at other batches than in the JAX package.  The table
    cannot differ; the tier events can.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.count import device_lsm, extract
from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator
from kmcex_tpu_torch.parallel import comm

SENTINEL = extract.SENTINEL
GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)  # the uint64 constant's int64 bits


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """This process's part of a 1-D mesh of shards (module docstring)."""

    devices: tuple
    group: object | None = None
    rank: int = 0
    world: int = 1

    @property
    def local(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def n(self) -> int:
        """Shards of the whole mesh."""
        return self.world * len(self.devices)

    def shard_index(self, local: int) -> int:
        return self.rank * len(self.devices) + local

    def put_rows(self, batch) -> list[torch.Tensor]:
        """Split this process's rows of a batch evenly over its shards and
        copy each part to its shard's device.  A list is taken as already
        split."""
        if isinstance(batch, (list, tuple)):
            return list(batch)
        t = torch.as_tensor(batch)
        L = len(self.devices)
        if t.shape[0] % L:
            raise ValueError(f"{t.shape[0]} batch rows do not divide over "
                             f"{L} local shards")
        r = t.shape[0] // L
        return [t[i * r : (i + 1) * r].to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]


def make_mesh(n_devices: int | None = None, devices=None,
              group=None) -> ShardMesh:
    """A mesh over ``devices`` (this process's shards; default: every
    visible CUDA device, or the first ``n_devices`` of them, one shard
    each).  Without ``devices`` and without a card it raises.  ``group``
    joins the meshes of the ranks of a ``torch.distributed`` group into one
    of ``world * len(devices)`` shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu', ...] explicitly to "
                "run a mesh of CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    if group is None:
        return ShardMesh(devices)
    import torch.distributed as dist

    return ShardMesh(devices, group, dist.get_rank(group),
                     dist.get_world_size(group))


def owner_of(kmers, n_shards: int) -> torch.Tensor:
    """Owner shard by multiplicative (Fibonacci) hash of the canonical
    k-mer: ``((kmer * GOLDEN mod 2^64) >> 32) % n`` as int32.

    Plain ``kmer % n`` would skew: canonical k-mers concentrate in the lower
    half of the value space (min of a k-mer and its reverse complement).
    int64 multiplication wraps to the same 64 bits as the uint64 product;
    the shift must be LOGICAL (``codec._srl``).  Takes an int64 tensor of
    bit patterns, or a uint64 NumPy array."""
    if isinstance(kmers, np.ndarray):
        kmers = torch.from_numpy(
            np.ascontiguousarray(kmers, dtype=np.uint64).view(np.int64))
    return (codec._srl(kmers * GOLDEN, 32) % n_shards).to(torch.int32)


def _route_local(kmers: torch.Tensor, n: int):
    """Local half of the exchange: this shard's k-mers grouped by owner.
    Returns (real k-mers stable-sorted by owner, sizes of the n groups as a
    list).  SENTINEL (invalid-window) entries get owner ``n``, sort past
    every real group and are never sent.  One device sync: the sizes."""
    owner = torch.where(kmers != SENTINEL, owner_of(kmers, n), n)
    owner_s, order = torch.sort(owner, stable=True)
    sizes = torch.bincount(owner_s, minlength=n + 1)[:n].tolist()
    return kmers[order][: sum(sizes)], sizes


def route_batch(mesh: ShardMesh, kmers_per_shard) -> tuple[list, int]:
    """One exchange: ``kmers_per_shard[l]`` are the canonical k-mers local
    shard ``l`` extracted.  Returns (recv, n_real): ``recv[d]`` holds every
    k-mer of the batch that local shard ``d`` owns, on its device, in no
    particular order; ``n_real`` is the number of real k-mers THIS process
    extracted.  With ``world > 1`` every rank must call this the same
    number of times."""
    L, n = mesh.local, mesh.n
    routed = [_route_local(km, n) for km in kmers_per_shard]
    offs = [np.concatenate([[0], np.cumsum(sz)]) for _, sz in routed]
    n_real = int(sum(o[-1] for o in offs))
    if mesh.world == 1:
        recv = []
        for d, dev in enumerate(mesh.devices):
            parts = [ks[o[d] : o[d + 1]].to(dev)
                     for (ks, _), o in zip(routed, offs)]
            recv.append(torch.cat(parts) if L > 1 else parts[0])
        return recv, n_real
    # send buffer ordered (destination rank, source shard, destination
    # shard): source shard l's groups for one rank are one slice of its
    # owner-sorted keys, so each shard is staged with ONE copy
    stage = mesh.devices[0]
    if comm.stages_through_host(mesh.group):
        stage = torch.device("cpu")
    staged = [ks.to(stage) for ks, _ in routed]
    counts = np.zeros((mesh.world, L, L), dtype=np.int64)
    pieces = []
    for r in range(mesh.world):
        for l in range(L):
            counts[r, l] = routed[l][1][r * L : (r + 1) * L]
            pieces.append(staged[l][offs[l][r * L] : offs[l][(r + 1) * L]])
    got, got_counts = comm.exchange_keys(torch.cat(pieces), counts,
                                         mesh.group, mesh.devices[0])
    chunks = torch.split(got, got_counts.reshape(-1).tolist())
    recv = []
    for d, dev in enumerate(mesh.devices):
        mine = [chunks[(r * L + l) * L + d]
                for r in range(mesh.world) for l in range(L)]
        recv.append(torch.cat(mine).to(dev))
    return recv, n_real


def default_route_capacity(seg_rows: int, W: int, n: int) -> int:
    """The JAX package's per-destination routing buffer size: 2.2x the mean
    group (the owner hash spreads k-mers about binomially) with a floor,
    capped at the worst case.  The port's exchange sends real sizes and
    needs no capacity (module docstring); the function stays so that
    callers and sizing estimates that name it keep their meaning."""
    worst = seg_rows * W
    mean = -(-seg_rows * W // n)
    cap = max(1024, ((int(2.2 * mean) + 127) // 128) * 128)
    return min(worst, cap)


class _ShardTiers(DeviceCountAccumulator):
    """One shard's raw tier, run LSM and host runs: the single-device
    accumulator, with the disk level handed to the mesh accumulator, which
    holds ONE host-RAM budget for all its shards."""

    def __init__(self, owner: "ShardedCountAccumulator", device):
        super().__init__(owner.k, raw_tier_elems=owner.raw_tier_elems,
                         spill_threshold=owner.spill_threshold,
                         disk_spill_bytes=0, device=device)
        self._owner = owner

    def _maybe_spill_to_disk(self) -> None:
        self._owner._maybe_spill_to_disk()


class ShardedCountAccumulator:
    """Streaming multi-shard counting: every batch is extracted and routed
    to owner shards; routed k-mers buffer per shard and collapse by one
    sort + count pass per tier, collapsed runs merge in a per-shard LSM,
    oversized runs spill to host RAM, and past a RAM budget runs stream to
    disk — the tiers of ``count.device_lsm.DeviceCountAccumulator``, per
    shard.  ``host_runs[l]``, ``disk_runs[l]`` and ``shards[l]`` are indexed
    by LOCAL shard; global shard numbers appear in file names and in the
    checkpoint manifest.

    ``reroutes`` is always 0: the exchange sends real sizes, so no batch can
    overflow a routing buffer (module docstring).  ``capacity`` is accepted
    and ignored for the same reason.
    """

    RAW_TIER_ELEMS = 32 << 20   # per-shard raw k-mers before a collapse
    SPILL_THRESHOLD = 64 << 20  # per-shard run size that leaves the device
    DISK_SPILL_BYTES = 16 << 30  # host-RAM budget before runs go to disk

    def __init__(self, mesh: ShardMesh, k: int, seg_rows: int, seg_len: int,
                 packed: bool = False, raw_tier_elems: int | None = None,
                 spill_threshold: int | None = None,
                 capacity: int | None = None,
                 disk_spill_bytes: int | None = None,
                 disk_dir: str | None = None):
        self.mesh = mesh
        self.k = k
        self.n = mesh.n
        self.seg_rows = seg_rows
        self.seg_len = seg_len
        self._packed = packed
        self.reroutes = 0
        self.raw_tier_elems = raw_tier_elems or self.RAW_TIER_ELEMS
        self.spill_threshold = spill_threshold or self.SPILL_THRESHOLD
        if disk_spill_bytes is None:
            disk_spill_bytes = int(os.environ.get(
                "KMCEX_DISK_SPILL_BYTES", self.DISK_SPILL_BYTES))
        self.disk_spill_bytes = disk_spill_bytes
        self._disk_dir_arg = disk_dir
        self._disk_dir: str | None = None
        self._ckpt_gen = 0
        self.shards = [_ShardTiers(self, d) for d in mesh.devices]
        self.disk_runs: list[list[str]] = [[] for _ in self.shards]
        self._disk_spills = 0
        # global after a reduce (finalize_stream, checkpoint); the windows
        # this process routed since then wait in _windows_pending
        self.total_windows = 0
        self._windows_pending = 0
        self.merge_pass_seconds = 0.0
        # entries per local shard as they drained at the finalize (keys a
        # shard holds in several runs count once per run): owner balance
        self.shard_sizes: list[int] = []
        # set by finalize_stream when a bloom_factory ran on the mesh
        self.device_bloom = None
        self.finalize_phases: dict[str, float] = {}
        self.table_bytes_to_host = 0

    # -- views over the shards ---------------------------------------------
    @property
    def host_runs(self) -> list[list]:
        return [sh.host_runs for sh in self.shards]

    @property
    def tier_events(self) -> dict:
        ev = {name: sum(sh.tier_events[name] for sh in self.shards)
              for name in ("raw_collapses", "device_merges", "host_spills")}
        ev["disk_spills"] = self._disk_spills
        return ev

    @property
    def spill_stats(self) -> dict:
        st = {name: sum(sh.spill_stats[name] for sh in self.shards)
              for name in ("copy_bytes", "copy_seconds",
                           "host_merge_seconds")}
        st["merge_pass_seconds"] = self.merge_pass_seconds
        return st

    # -- the count step ----------------------------------------------------
    def add_batch(self, codes) -> None:
        """This process's rows of one batch: [local * rows, seg_len] uint8
        codes (0..3 valid), or a list with one part per local shard."""
        self._push([extract.extract_canonical(c, self.k)[0]
                    for c in self.mesh.put_rows(codes)])

    def add_batch_packed(self, packed, maskbits) -> None:
        """2-bit packed input (see extract.pack_codes_np)."""
        self._push([extract.extract_canonical_packed(p, m, self.k)[0]
                    for p, m in zip(self.mesh.put_rows(packed),
                                    self.mesh.put_rows(maskbits))])

    def _push(self, kmers_per_shard) -> None:
        recv, n_real = route_batch(self.mesh, kmers_per_shard)
        self._windows_pending += n_real
        for sh, r in zip(self.shards, recv):
            if r.numel():
                sh._push_raw(r, r.numel())

    def _sync_totals(self) -> None:
        """Fold the windows routed since the last reduce into the global
        ``total_windows`` (a collective when ``world > 1``)."""
        pending = self._windows_pending
        if self.mesh.world > 1:
            pending = int(comm.all_reduce_sum(
                [pending], self.mesh.group, self.mesh.devices[0])[0])
        self.total_windows += pending
        self._windows_pending = 0

    # -- disk tier (one budget for all local shards) -------------------------
    def _host_bytes(self) -> int:
        return sum(12 * len(k) for sh in self.shards for k, _ in sh.host_runs)

    def _maybe_spill_to_disk(self) -> None:
        if not self.disk_spill_bytes:
            return
        while self._host_bytes() > self.disk_spill_bytes:
            # drop the biggest run of the heaviest shard to disk
            l = max(range(len(self.shards)), key=lambda i: sum(
                len(k) for k, _ in self.shards[i].host_runs))
            if not self.shards[l].host_runs:
                return
            ku, kc = self.shards[l].host_runs.pop(0)  # cascade: largest first
            if self._disk_dir is None:
                self._disk_dir = self._disk_dir_arg or tempfile.mkdtemp(
                    prefix="kmcex_sharded_")
            os.makedirs(self._disk_dir, exist_ok=True)
            path = os.path.join(
                self._disk_dir, f"s{self.mesh.shard_index(l):03d}_run"
                                f"{len(self.disk_runs[l]):04d}.bin")
            device_lsm.write_run_file(path, ku, kc)
            self.disk_runs[l].append(path)
            self._disk_spills += 1

    def _unlink_disk_runs(self) -> None:
        for lst in self.disk_runs:
            for p in lst:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        self.disk_runs = [[] for _ in self.shards]

    def _spool_dir(self) -> str | None:
        """Where the out-of-core finalize spools its merged table: the disk
        directory, in a sub-directory of this rank's own when the mesh
        spans processes (they may share the directory)."""
        if self._disk_dir is None:
            return None
        if self.mesh.world == 1:
            return self._disk_dir
        return os.path.join(self._disk_dir, f"rank{self.mesh.rank:03d}")

    def close(self) -> None:
        """Delete disk-tier files (idempotent; mirrors
        DeviceCountAccumulator.close)."""
        self._unlink_disk_runs()
        if self._disk_dir is not None:
            spool = self._spool_dir()
            for name in ("merged_k.bin", "merged_c.bin"):
                try:
                    os.unlink(os.path.join(spool, name))
                except OSError:
                    pass
            if spool != self._disk_dir:
                try:
                    os.rmdir(spool)
                except OSError:
                    pass
            if self._disk_dir_arg is None:
                shutil.rmtree(self._disk_dir, ignore_errors=True)
            self._disk_dir = None

    def _merge_all_device(self) -> None:
        for sh in self.shards:
            sh._merge_device_runs()

    def _drain_to_host(self) -> None:
        self._merge_all_device()
        for sh in self.shards:
            sh._spill_last_device_run()

    def _spilled(self) -> bool:
        return any(sh.host_runs for sh in self.shards) or any(self.disk_runs)

    # -- checkpoint / resume ------------------------------------------------
    def checkpoint(self, ckpt_dir: str, extra: dict | None = None) -> None:
        """Persist the sharded counting state (per-shard run sets) so a
        count can resume; same file names and manifest keys as the JAX
        package, so a checkpoint written by one restores in the other on a
        mesh of the same ``n``.  With ``world > 1`` call it on ALL ranks
        (the window total is reduced, and the file lists are gathered):
        every rank writes its own shards' files into the shared directory,
        and rank 0 writes the manifest LAST and prunes the old
        generation."""
        self._drain_to_host()
        self._sync_totals()
        os.makedirs(ckpt_dir, exist_ok=True)
        # a new file generation per checkpoint: a restored accumulator maps
        # the previous generation read-only, so files are never overwritten
        # in place; stale generations unlink after the manifest lands
        gen = self._ckpt_gen
        shard_files: list[list[str]] = []
        for l, sh in enumerate(self.shards):
            s = self.mesh.shard_index(l)
            files = []
            for i, (ku, kc) in enumerate(sh.host_runs):
                name = f"g{gen:04d}_s{s:03d}_run{i:04d}.bin"
                device_lsm.write_run_file(os.path.join(ckpt_dir, name),
                                          np.asarray(ku), np.asarray(kc))
                files.append(name)
            for p in self.disk_runs[l]:
                name = f"g{gen:04d}_s{s:03d}_disk_{os.path.basename(p)}"
                shutil.copyfile(p, os.path.join(ckpt_dir, name))
                files.append(name)
            shard_files.append(files)
        self._ckpt_gen = gen + 1
        if self.mesh.world > 1:
            # the gather returns only when every rank has written its files
            shard_files = [f for per_rank in comm.gather_objects(
                shard_files, self.mesh.group) for f in per_rank]
            if self.mesh.rank != 0:
                return
        tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"k": self.k, "n_shards": self.n,
                       "seg_rows": self.seg_rows, "seg_len": self.seg_len,
                       "total_windows": self.total_windows, "gen": gen,
                       "shard_files": shard_files, "extra": extra or {}}, f)
        os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))
        keep = {n for fs in shard_files for n in fs} | {"manifest.json"}
        for name in os.listdir(ckpt_dir):
            if name not in keep and name.endswith(".bin"):
                try:
                    os.unlink(os.path.join(ckpt_dir, name))
                except OSError:
                    pass

    @staticmethod
    def read_manifest(ckpt_dir: str) -> dict | None:
        """The checkpoint manifest, or None when no complete checkpoint
        exists (mirrors DeviceCountAccumulator.read_manifest)."""
        return DeviceCountAccumulator.read_manifest(ckpt_dir)

    @classmethod
    def restore(cls, mesh: ShardMesh, ckpt_dir: str,
                **kwargs) -> "ShardedCountAccumulator":
        """Rebuild from ``checkpoint``; the mesh size must match.  Runs load
        as read-only memmaps; checkpoint files are never deleted.  Each
        process opens its own shards' files."""
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            m = json.load(f)
        if int(m["n_shards"]) != mesh.n:
            raise ValueError(
                f"checkpoint has {m['n_shards']} shards, mesh has {mesh.n}")
        acc = cls(mesh, int(m["k"]), int(m["seg_rows"]), int(m["seg_len"]),
                  **kwargs)
        acc.total_windows = int(m["total_windows"])
        for l, sh in enumerate(acc.shards):
            sh.host_runs = [
                device_lsm.open_run_file(os.path.join(ckpt_dir, name))
                for name in m["shard_files"][mesh.shard_index(l)]]
            sh.host_runs.sort(key=lambda r: -len(r[0]))  # cascade invariant
        acc._ckpt_gen = int(m.get("gen", 0)) + 1
        return acc

    # -- finalize ------------------------------------------------------------
    def finalize(self, ci: int = 1, cs: int = 0xFFFFFFFF):
        """Global host-side (kmers, counts) sorted ascending.  Materializes
        the table — bounded by the RAM budget unless disk runs exist; use
        finalize_stream for the out-of-core regime."""
        total, hist, it = self.finalize_stream(ci, cs)
        parts = list(it)
        if not parts:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def _mesh_bloom(self, ci: int, cs: int, bloom_factory):
        """Build the Bloom bank across the mesh from the shards' merged
        device runs, when no shard of ANY rank holds a host or disk run
        (their keys would be missed).  The test comes AFTER the device
        merge, which can itself spill; with ``world > 1`` it is a reduced
        flag, so that every rank enters the bitmap reduce or none does."""
        from kmcex_tpu_torch.model.device_bloom import (
            ShardedDeviceBloomBuilder,
        )

        flags = [int(self._spilled()), sum(len(sh.runs) for sh in self.shards)]
        if self.mesh.world > 1:
            flags = comm.all_reduce_sum(flags, self.mesh.group,
                                        self.mesh.devices[0])
        if flags[0] or not flags[1]:
            return None
        us = [sh.runs[0][0] if sh.runs else None for sh in self.shards]
        cs_ = [sh.runs[0][1] if sh.runs else None for sh in self.shards]
        hist = ShardedDeviceBloomBuilder.global_low_hist(
            self.mesh, us, cs_, ci, cs)
        try:
            builder = bloom_factory(hist)
        except ValueError:  # bitmap too large: the host inserts
            return None
        builder.feed_table_sharded(us, cs_)
        return builder

    def finalize_stream(self, ci: int = 1, cs: int = 0xFFFFFFFF,
                        n_chunks: int = 16, bloom_factory=None):
        """Streaming finalize with the (total, low_hist, chunk_iter)
        contract of DeviceCountAccumulator.finalize_stream: ascending
        ci-filtered cs-clamped chunks, ONE k-way merge traversal
        (``one_pass_finalize`` sizes the encode while it spools the merged
        table; to disk when any shard went to disk, else to RAM).
        ``n_chunks`` is kept for API compatibility.

        ``bloom_factory`` (callable(low_hist) ->
        model.device_bloom.ShardedDeviceBloomBuilder) builds the Bloom bank
        ACROSS THE MESH before the table drains (``_mesh_bloom``); the
        builder lands on ``self.device_bloom``, None when it did not
        engage.

        With ``world > 1`` every rank must call this; the runs of all ranks
        are gathered (``comm.gather_runs``) and every rank returns the
        identical table."""
        self.device_bloom = None
        self._merge_all_device()
        self._sync_totals()
        if bloom_factory is not None:
            self.device_bloom = self._mesh_bloom(ci, cs, bloom_factory)
        self._drain_to_host()
        runs = [r for sh in self.shards for r in sh.host_runs]
        paths = [p for lst in self.disk_runs for p in lst]
        self.shard_sizes = [
            sum(len(k) for k, _ in sh.host_runs)
            + sum(len(device_lsm.open_run_file(p)[0]) for p in lst)
            for sh, lst in zip(self.shards, self.disk_runs)]
        any_disk = bool(paths)
        if self.mesh.world > 1:
            runs, paths = comm.gather_runs(runs, paths, self.mesh.group,
                                           self.mesh.devices[0])
            any_disk = bool(comm.all_reduce_sum(
                [int(any_disk)], self.mesh.group, self.mesh.devices[0])[0])
        sources = [device_lsm.open_run_file(p) for p in paths] + runs
        if not sources:
            return 0, np.zeros(3, dtype=np.int64), iter(())
        if any_disk and self._disk_dir is None:
            self._disk_dir = self._disk_dir_arg or tempfile.mkdtemp(
                prefix="kmcex_sharded_")
        t = time.time()
        total, hist, it = device_lsm.one_pass_finalize(
            sources, ci, cs, self._spool_dir() if any_disk else None,
            cleanup=self.close)
        self.merge_pass_seconds += time.time() - t
        if any_disk:
            # the merged spool replaced the run files: free them, once
            # every rank has read the ones it was given by path
            del sources
            if self.mesh.world > 1:
                comm.barrier(self.mesh.group)
            self._unlink_disk_runs()
        for sh in self.shards:
            sh.host_runs = []
        return total, hist, it


def build_sharded_count_step(mesh: ShardMesh, k: int, seg_rows: int,
                             seg_len: int, capacity: int | None = None):
    """The one-batch form: returns ``step(codes) -> (uniq, counts,
    n_unique, windows)`` where ``codes`` are this process's [local *
    seg_rows, seg_len] rows, the first three are lists with one entry per
    local shard (route + immediate sort-count, SENTINEL-padded), and
    ``windows`` is the number of valid windows this process extracted.
    ``capacity`` is accepted and ignored (module docstring)."""
    def step(codes):
        parts = mesh.put_rows(codes)
        recv, n_real = route_batch(
            mesh, [extract.extract_canonical(c, k)[0] for c in parts])
        out = [extract.sort_count_unique(r) for r in recv]
        return ([o[0] for o in out], [o[1] for o in out],
                [o[2] for o in out], n_real)

    return step


def sharded_count(codes, mesh: ShardMesh, k: int):
    """Count canonical k-mers of one batch across the mesh; returns merged
    host-side (kmers, counts), the per-shard partitions of THIS process and
    the valid windows it extracted."""
    codes = np.asarray(codes)
    if codes.shape[0] % mesh.local:
        raise ValueError("batch rows must divide the mesh")
    step = build_sharded_count_step(mesh, k, codes.shape[0] // mesh.local,
                                    codes.shape[1])
    uniq, counts, n_unique, windows = step(codes)
    parts = []
    for u, c, nu in zip(uniq, counts, n_unique):
        nu = int(nu)
        parts.append((u[:nu].cpu().numpy().view(np.uint64),
                      c[:nu].cpu().numpy().view(np.uint32)))
    merged_k = np.concatenate([p[0] for p in parts])
    merged_c = np.concatenate([p[1] for p in parts])
    order = np.argsort(merged_k)
    return merged_k[order], merged_c[order], parts, windows
