"""Device-resident accumulation of (k-mer, count) runs, single GPU.

The counterpart of the JAX package's ``count/device_lsm.py``, single-device
subset, in PyTorch:

  * **Raw tier** — per input batch only the extract runs; the flat
    canonical k-mer vectors stay on the device unsorted.  When the tier
    reaches ``raw_tier_elems`` windows it is concatenated and collapsed by
    ONE sort + segment-count pass into a sorted unique run.
  * **Run LSM** — collapsed tiers are sorted unique runs (SENTINEL-padded
    to a power of two), merged pairwise whenever two reach the same size
    class: ``merge_sorted_u64`` + segment-sum + ``compact_pairs``.
  * **Finalize** — the single-tier case runs concat + sort + segment-count
    + compaction + cs-clamp + sizing stats (``_fused_finalize``); otherwise
    the runs merge down to one and the same clamp + stats follow.  Counts
    are cs-clamped right after compaction, before the histogram (the
    reference's counters are clamped when its kmc binary writes the
    database, so every consumer must see clamped values).  The table then
    streams to pinned host memory in ~16 ascending chunks with
    ``non_blocking`` copies, ci-filtered on the host.  A build's route
    (``model.route.BuildRoute``) says what of the table streams: all of
    it, the pairs a low-key drop keeps (the low keys masked out and the
    table recompacted with ``compact_pairs``), or nothing; it is fed the
    table, and the drop's pairs, on the device.
  * **Host level** — a run that reaches ``spill_threshold`` entries leaves
    the device: one synchronous copy to host RAM, pads dropped, then a
    size-tiered cascade of two-pointer merges (``native.merge_runs``).  The
    device stays the fast "memtable" level of the LSM, so a table larger
    than device memory can still be counted.
  * **Disk level** — when the host runs pass ``disk_spill_bytes`` the
    largest one streams to a run file and leaves RAM; the finalize then
    merges disk and RAM runs out of core in ONE k-way pass
    (``one_pass_finalize``) that sizes the encode while it spools the merged
    table.  The host and disk routes stream the whole table and never
    reach the build's route: the host inserts the Bloom bank.
  * **Checkpoint** — every tier is a set of sorted (kmers, counts) runs, so
    a checkpoint drains the device tiers to the host level and writes each
    run as a run file, the manifest last.

Keys are int64 tensors holding the uint64 bit pattern (SENTINEL = -1);
counts are int32 tensors holding the uint32 bit pattern (merged sums
saturate at 2^32-1, as the JAX package's uint32 counts do; ``codec.u32``
widens them wherever the device compares or clamps).  The kernels move
counts as an opaque 32-bit payload.  On the host, run files and
``host_runs`` are ``<u8`` / ``<u4``, u32-saturating; the seam (``_spill``)
reinterprets the bits and never casts.

Left out of the JAX module, on purpose:

  * ``tile_mode`` (device_lsm.py:119-248, :726-762): it exists only for
    the Pallas block layout;
  * the segmented finalize (:370-431, :1115-1149), an opt-in diagnostic;
  * the bit-packed delta transfer (:434-513, :1151-1239), built for a slow
    host link; the pinned-memory chunk copy takes its place (the encoder
    is chunk-invariant), and with it ``_pack_final``'s uint16 narrowing of
    ``finalize``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings

import numpy as np
import torch

from kmcex_tpu_torch import native
from kmcex_tpu_torch.core.codec import u32, u32_bits
from kmcex_tpu_torch.count.compact import compact_pairs
from kmcex_tpu_torch.count.extract import (
    SENTINEL,
    extract_canonical,
    extract_canonical_packed,
    segment_compact,
    sort_count_unique,
    sorted_u64,
)
from kmcex_tpu_torch.count.sort import merge_sorted_u64
from kmcex_tpu_torch.utils import timing
from kmcex_tpu_torch.utils.device import resolve_device

_U32_MAX = 0xFFFFFFFF
_U64_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _merge_runs(ka, ca, kb, cb):
    """Merge two sorted (kmer, count) runs (SENTINEL-padded), summing
    duplicates; result padded to len(ka)+len(kb).  Returns (uniq, counts,
    n_unique) — the JAX ``_merge_runs_kernel`` (device_lsm.py:46-95).

    Precondition: each input run is sorted AND unique (every caller passes
    the output of ``sort_count_unique``, ``segment_compact`` or this
    function).  A key then occurs at most twice in the merged sequence, so
    its sum is its own count plus its right neighbour's when that one holds
    the same key — no prefix sum and no boundary scan.  Sums saturate at
    2^32-1; SENTINEL pads carry count 0 and are masked out."""
    k, c = merge_sorted_u64(ka, ca, kb, cb)
    n = k.numel()
    same_next = torch.zeros(n, dtype=torch.bool, device=k.device)
    same_next[:-1] = k[1:] == k[:-1]
    first = torch.ones(n, dtype=torch.bool, device=k.device)
    first[1:] = ~same_next[:-1]
    valid = first & (k != SENTINEL)
    c64 = u32(c)
    nxt = torch.cat([c64[1:], c64.new_zeros(1)])
    seg_sum = c64 + torch.where(same_next, nxt, 0)
    counts = u32_bits(torch.where(valid, seg_sum, 0).clamp(max=_U32_MAX))
    key = torch.where(valid, k, SENTINEL)
    uniq, counts_c = compact_pairs(key, counts)
    return uniq, counts_c, valid.sum()


def _final_stats(kmers, counts, ci: int) -> np.ndarray:
    """Encode-sizing stats of the final table in ONE host pull (the JAX
    ``_final_stats`` fields [0:9], device_lsm.py:259-302):
    [0]=total pairs >= ci, [1:4]=histogram of counter==ci+i, [4]=n_real,
    [5]=first k-mer, [6]=first count, [7]=last k-mer, [8]=last count."""
    real = kmers != SENTINEL  # contiguous prefix: sentinels sort last
    counts = u32(counts)
    valid = real & (counts >= ci)
    n_real = real.sum()
    last_i = (n_real - 1).clamp(min=0)
    parts = [valid.sum()]
    parts += [(valid & (counts == ci + i)).sum() for i in range(3)]
    parts += [n_real, kmers[0], counts[0], kmers[last_i], counts[last_i]]
    return torch.stack(parts).cpu().numpy()


def _clamp_cs(c, cs: int):
    """The count column clamped at ``cs`` (0 < cs <= 2^32-1)."""
    return u32_bits(u32(c).clamp(max=cs))


def _fused_finalize(kmers_list, ci: int, cs: int):
    """The whole single-tier finalize: concat the raw tier, sort,
    segment-count, compact, cs-clamp, sizing stats."""
    flat = torch.cat(kmers_list) if len(kmers_list) > 1 else kmers_list[0]
    u, c, _ = segment_compact(sorted_u64(flat))
    c = _clamp_cs(c, cs)
    return u, c, _final_stats(u, c, ci)


def _drop_low(u, c, thresh: int):
    """The low-key drop: mask the pairs with count < ``thresh`` (= ci +
    bf_num: the Bloom-bound and sub-ci keys) to (SENTINEL, 0) and recompact
    with the compaction kernel into new buffers.  Returns (u2, c2)."""
    keep = u32(c) >= thresh
    return compact_pairs(torch.where(keep, u, SENTINEL),
                         torch.where(keep, c, 0))


_STREAM_CHUNKS = 16


def _stream_table(u, c, n_real: int, ci: int):
    """Copy the first ``n_real`` entries of a device table to host memory in
    ~16 ascending chunks and yield them ci-filtered as (uint64
    kmers, uint32 counts) numpy arrays.  On a GPU every chunk copy goes to
    pinned memory with ``non_blocking=True`` and is waited for only when the
    consumer asks for that chunk, so later copies overlap the host encode."""
    if n_real == 0:
        return iter(())
    m = -(-n_real // _STREAM_CHUNKS)
    pending = []
    on_gpu = u.device.type == "cuda"
    for a in range(0, n_real, m):
        b = min(a + m, n_real)
        ku, kc = u[a:b], c[a:b]
        if on_gpu:
            hk = torch.empty(ku.shape, dtype=ku.dtype, pin_memory=True)
            hc = torch.empty(kc.shape, dtype=kc.dtype, pin_memory=True)
            hk.copy_(ku, non_blocking=True)
            hc.copy_(kc, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            pending.append((hk, hc, done))
        else:
            pending.append((ku, kc, None))

    def chunks():
        for hk, hc, done in pending:
            with timing.span("table.pull_wait"):
                if done is not None:
                    done.synchronize()
            timing.count("table.pairs", hk.numel())
            with timing.span("table.host_prep"):
                ku = hk.numpy().view(np.uint64)
                kc = hc.numpy().view(np.uint32)
                keep = kc >= ci
                out = (ku[keep], kc[keep]) if keep.any() else None
            if out is not None:
                yield out

    return chunks()


def write_run_file(path: str, ku: np.ndarray, kc: np.ndarray) -> None:
    """Spill one sorted (kmers, counts) run: u64 length, u64 keys, u32
    counts (the disk tier's and the checkpoint's file format)."""
    with open(path, "wb") as f:
        np.array([len(ku)], dtype="<u8").tofile(f)
        ku.astype("<u8").tofile(f)
        kc.astype("<u4").tofile(f)


def open_run_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Memmap a spilled run (see write_run_file)."""
    n = int(np.fromfile(path, dtype="<u8", count=1)[0])
    km = np.memmap(path, dtype="<u8", mode="r", offset=8, shape=(n,))
    cm = np.memmap(path, dtype="<u4", mode="r", offset=8 + 8 * n, shape=(n,))
    return km, cm


def _size_stats(mc: np.ndarray, ci: int, total: int, hist: np.ndarray) -> int:
    """Fold one cs-clamped count chunk into the encode sizing stats."""
    for i in range(3):
        hist[i] += int(np.count_nonzero(mc == ci + i))
    return total + int(np.count_nonzero(mc >= ci))


def one_pass_finalize(sources, ci: int, cs: int, disk_dir: str | None,
                      cleanup=None):
    """ONE k-way merge pass over sorted unique runs: computes the encode
    sizing stats (total >= ci, low-counter histogram) while spooling the
    merged table — to ``<disk_dir>/merged_*.bin`` when a disk dir is given
    (the out-of-core regime) or to a RAM chunk list otherwise.  Returns
    (total, hist, chunk_iter); the iterator yields ascending ci-filtered
    cs-clamped (kmers, counts) chunks and runs ``cleanup`` when exhausted
    or closed."""
    total = 0
    hist = np.zeros(3, dtype=np.int64)
    cs32 = np.uint32(min(int(cs), 0xFFFFFFFF))
    if disk_dir is not None:
        os.makedirs(disk_dir, exist_ok=True)
        kpath = os.path.join(disk_dir, "merged_k.bin")
        cpath = os.path.join(disk_dir, "merged_c.bin")
        n_all = 0
        with open(kpath, "wb") as fk, open(cpath, "wb") as fc:
            for mk, mc in DeviceCountAccumulator._merge_streams(sources):
                # the reference's counters are cs-clamped: size on those
                total = _size_stats(np.minimum(mc, cs32), ci, total, hist)
                n_all += len(mk)
                mk.astype("<u8").tofile(fk)
                mc.astype("<u4").tofile(fc)
        if n_all == 0:
            if cleanup is not None:
                cleanup()
            return 0, hist, iter(())
        km = np.memmap(kpath, dtype="<u8", mode="r", shape=(n_all,))
        cm = np.memmap(cpath, dtype="<u4", mode="r", shape=(n_all,))

        def chunks(m: int = 1 << 22):
            try:
                for a in range(0, n_all, m):
                    ku = np.asarray(km[a : a + m])
                    kc = np.asarray(cm[a : a + m])
                    keep = kc >= ci
                    yield ku[keep], np.minimum(kc[keep], cs32)
            finally:
                if cleanup is not None:
                    cleanup()

        return total, hist, chunks()
    # all-RAM regime: the chunks are kept ci-filtered and cs-clamped, so the
    # retained copy is the final table, not the raw merge output
    parts = []
    for mk, mc in DeviceCountAccumulator._merge_streams(sources):
        mc = np.minimum(mc, cs32)
        total = _size_stats(mc, ci, total, hist)
        keep = mc >= ci
        if keep.any():
            parts.append((mk[keep], mc[keep]))

    def ram_chunks():
        try:
            yield from parts
        finally:
            if cleanup is not None:
                cleanup()

    return total, hist, ram_chunks()


class DeviceCountAccumulator:
    """Accumulates batches on one device; one host transfer at finalize
    unless the table outgrows the device (host and disk LSM levels)."""

    # Raw k-mers buffered on the device before one sort+count pass.
    RAW_TIER_ELEMS = 64 << 20
    # Below this size merges stay fully async; above it one scalar sync
    # shrinks the pad so memory and merge cost track the distinct count.
    SHRINK_THRESHOLD = 1 << 23
    # Runs at or above this many entries leave the device: they are copied
    # to host RAM and merged there by the native two-pointer merge.
    # Genome-scale tables (billions of distinct 31-mers) cannot live on one
    # card; the device stays the fast "memtable" level of the LSM.
    # Override with KMCEX_SPILL_THRESHOLD.
    SPILL_THRESHOLD = 128 << 20
    # Host-RAM budget for the host LSM level.  When spilled runs exceed it,
    # the largest run streams to a temp file and drops out of RAM; the
    # finalize merges disk + RAM runs out of core (the analogue of KMC's
    # external-memory bins).  Override with KMCEX_DISK_SPILL_BYTES (0
    # disables disk spill).
    DISK_SPILL_BYTES = 16 << 30

    def __init__(self, k: int, raw_tier_elems: int | None = None,
                 spill_threshold: int | None = None,
                 disk_spill_bytes: int | None = None,
                 disk_dir: str | None = None, device=None):
        self.k = k
        self.device = resolve_device(device)
        self.raw_tier_elems = (raw_tier_elems
                               or int(os.environ.get("KMCEX_RAW_TIER_ELEMS", 0))
                               or self.RAW_TIER_ELEMS)
        self.spill_threshold = (spill_threshold
                                or int(os.environ.get(
                                    "KMCEX_SPILL_THRESHOLD", 0))
                                or self.SPILL_THRESHOLD)
        if disk_spill_bytes is None:
            disk_spill_bytes = int(os.environ.get(
                "KMCEX_DISK_SPILL_BYTES", self.DISK_SPILL_BYTES))
        self.disk_spill_bytes = disk_spill_bytes
        self._disk_dir_arg = disk_dir
        self._disk_dir: str | None = None
        self._ckpt_gen = 0
        self.disk_runs: list[str] = []
        self.raw: list[torch.Tensor] = []
        self.raw_elems = 0
        self.runs: list[tuple[torch.Tensor, torch.Tensor, int]] = []
        self.host_runs: list[tuple[np.ndarray, np.ndarray]] = []
        self.total_windows = 0
        # tier-transition telemetry (surfaced via KMCEX_STATS_JSON)
        self.tier_events = {"raw_collapses": 0, "device_merges": 0,
                            "host_spills": 0, "disk_spills": 0}
        # what the host and disk levels cost: bytes and seconds of the
        # device->host run copies, seconds in native.merge_runs outside the
        # out-of-core pass, seconds of that pass
        self.spill_stats = {"copy_bytes": 0, "copy_seconds": 0.0,
                            "host_merge_seconds": 0.0,
                            "merge_pass_seconds": 0.0}
        # set by finalize_stream
        self.table_bytes_to_host = 0

    def add_batch(self, codes) -> None:
        """[B, L] uint8 codes, one base per byte (0..3, anything else
        invalid), as a tensor or a NumPy array."""
        codes = torch.as_tensor(codes).to(self.device)
        n_windows = codes.shape[0] * (codes.shape[1] - self.k + 1)
        kmers, _ = extract_canonical(codes, self.k)
        self._push_raw(kmers, n_windows)

    def add_batch_packed(self, packed: torch.Tensor,
                         maskbits: torch.Tensor) -> None:
        """2-bit packed input (see extract.pack_codes_np): L = 4 * packed
        width."""
        L = packed.shape[1] * 4
        n_windows = packed.shape[0] * (L - self.k + 1)
        kmers, _ = extract_canonical_packed(packed.to(self.device),
                                            maskbits.to(self.device), self.k)
        timing.count("count.windows", n_windows)
        self._push_raw(kmers, n_windows)

    def _push_raw(self, kmers: torch.Tensor, n_windows: int) -> None:
        self.total_windows += n_windows
        self.raw.append(kmers)
        self.raw_elems += n_windows
        if self.raw_elems >= self.raw_tier_elems:
            self._collapse_raw()

    def _collapse_raw(self) -> None:
        self.tier_events["raw_collapses"] += 1
        if not self.raw:
            return
        with timing.span("count.collapse"):
            flat = torch.cat(self.raw) if len(self.raw) > 1 else self.raw[0]
            self.raw = []
            self.raw_elems = 0
            timing.count("count.collapse.keys", flat.numel())
            uniq, counts, nu = sort_count_unique(flat)
            uniq, counts, size = self._padded_run(uniq, counts, nu)
        self._place_run(uniq, counts, size)

    def _shrink(self, u, c, size: int, nu):
        if size >= self.SHRINK_THRESHOLD:
            shrunk = _next_pow2(max(int(nu), 1))  # scalar device sync
            if shrunk < size:
                u, c, size = u[:shrunk], c[:shrunk], shrunk
        return u, c, size

    def _padded_run(self, uniq, counts, nu):
        uniq, counts, size = self._shrink(uniq, counts, uniq.numel(), nu)
        # runs are pow2-padded so merge size classes stay logarithmic
        psize = _next_pow2(size)
        if psize != size:
            pad = psize - size
            uniq = torch.cat([uniq, uniq.new_full((pad,), SENTINEL)])
            counts = torch.cat([counts, counts.new_zeros(pad)])
            size = psize
        return uniq, counts, size

    def _place_run(self, uniq, counts, size: int) -> None:
        if size >= self.spill_threshold:
            self._spill(uniq, counts)
        else:
            self.runs.append((uniq, counts, size))
            self._rebalance()

    def _merge_top2(self) -> None:
        self.tier_events["device_merges"] += 1
        kb, cb, sb = self.runs.pop()
        ka, ca, sa = self.runs.pop()
        with timing.span("count.merge"):
            timing.count("count.merge.keys", ka.numel() + kb.numel())
            u, c, nu = _merge_runs(ka, ca, kb, cb)
            u, c, size = self._shrink(u, c, sa + sb, nu)
        if size >= self.spill_threshold:
            self._spill(u, c)
        else:
            self.runs.append((u, c, size))

    def _rebalance(self) -> None:
        while len(self.runs) >= 2 and self.runs[-2][2] <= self.runs[-1][2]:
            self._merge_top2()

    def _merge_device_runs(self) -> None:
        """Collapse the raw tier and merge device runs down to at most one."""
        self._collapse_raw()
        while len(self.runs) >= 2:
            self._merge_top2()

    # -- host level ------------------------------------------------------
    def _timed_host_merge(self, ka, ca, kb, cb):
        with timing.span("spill.host_merge") as sp:
            out = native.merge_runs(ka, ca, kb, cb)
        self.spill_stats["host_merge_seconds"] += sp.seconds
        return out

    def _spill(self, u: torch.Tensor, c: torch.Tensor) -> None:
        """Copy a device run to host RAM and fold it into the host LSM level
        (native two-pointer merge; raw counts — ci/cs apply at finalize).
        The copy is synchronous and pageable; the bits are reinterpreted as
        ``<u8`` / ``<u4`` (the int32 count column already holds the uint32
        bit pattern), never cast."""
        if u.device.type == "cuda":
            torch.cuda.synchronize(u.device)  # time the copy, not the queue
        with timing.span("spill.copy") as sp:
            ku = u.cpu().numpy().view(np.uint64)
            kc = c.cpu().numpy().view(np.uint32)
        self.spill_stats["copy_seconds"] += sp.seconds
        self.spill_stats["copy_bytes"] += ku.nbytes + kc.nbytes
        real = ku != _U64_SENTINEL
        ku, kc = ku[real], kc[real]
        if not len(ku):
            return
        self.tier_events["host_spills"] += 1
        self.host_runs.append((ku, kc))
        while (len(self.host_runs) >= 2
               and len(self.host_runs[-2][0]) < 2 * len(self.host_runs[-1][0])):
            kb, cb = self.host_runs.pop()
            ka, ca = self.host_runs.pop()
            self.host_runs.append(self._timed_host_merge(ka, ca, kb, cb))
        self._maybe_spill_to_disk()

    def _spill_last_device_run(self) -> None:
        if self.runs:
            u, c, _ = self.runs.pop()
            self._spill(u, c)

    # -- disk level (out-of-core runs) ------------------------------------
    def _host_bytes(self) -> int:
        return sum(12 * len(k) for k, _ in self.host_runs)

    def _maybe_spill_to_disk(self) -> None:
        if not self.disk_spill_bytes:
            return
        while self.host_runs and self._host_bytes() > self.disk_spill_bytes:
            # the size-tiered cascade keeps host_runs largest-first
            self._write_disk_run(*self.host_runs.pop(0))

    def _write_disk_run(self, ku: np.ndarray, kc: np.ndarray) -> None:
        self.tier_events["disk_spills"] += 1
        if self._disk_dir is None:
            self._disk_dir = self._disk_dir_arg or tempfile.mkdtemp(
                prefix="kmcex_lsm_")
        os.makedirs(self._disk_dir, exist_ok=True)
        path = os.path.join(self._disk_dir, f"run{len(self.disk_runs):04d}.bin")
        write_run_file(path, ku, kc)
        self.disk_runs.append(path)

    @staticmethod
    def _open_disk_run(path: str) -> tuple[np.ndarray, np.ndarray]:
        return open_run_file(path)

    @staticmethod
    def _merge_streams(runs, chunk_elems: int = 1 << 22):
        """K-way streaming merge of sorted unique (kmers, counts) runs
        (arrays or memmaps), summing duplicate keys; yields ascending
        chunks.  Per step: pick the smallest per-run window-max as the key
        bound, take everything <= bound from EVERY run (so each key's
        occurrences across runs land in one step), and fold pairwise with
        the native two-pointer merge."""
        curs = [0] * len(runs)
        while True:
            active = [i for i in range(len(runs)) if curs[i] < len(runs[i][0])]
            if not active:
                return
            bound = min(
                runs[i][0][min(curs[i] + chunk_elems, len(runs[i][0])) - 1]
                for i in active
            )
            mk = mc = None
            for i in active:
                hi = int(np.searchsorted(runs[i][0], bound, side="right"))
                ku = np.asarray(runs[i][0][curs[i]:hi], dtype=np.uint64)
                kc = np.asarray(runs[i][1][curs[i]:hi]).astype(np.uint32,
                                                               copy=False)
                curs[i] = hi
                if not len(ku):
                    continue
                if mk is None:
                    mk, mc = ku, kc
                else:
                    mk, mc = native.merge_runs(mk, mc, ku, kc)
            if mk is not None and len(mk):
                yield mk, mc

    def _finalize_disk(self, ci: int, cs: int):
        """Out-of-core finalize when disk runs exist: one k-way merge pass
        computes totals and spools the merged table to ONE file; the
        returned iterator then streams it with ci/cs applied.  Host memory
        stays bounded by (n_runs + 1) merge chunks.  Run files are deleted
        as soon as the merge pass consumed them; the merged files (and the
        temp dir, when this accumulator made it) are deleted when the
        returned iterator is exhausted or closed — see also close()."""
        runs = [self._open_disk_run(p) for p in self.disk_runs]
        runs += self.host_runs
        with timing.span("spill.merge_pass") as sp:
            total, hist, it = one_pass_finalize(runs, ci, cs, self._disk_dir,
                                                cleanup=self.close)
        self.spill_stats["merge_pass_seconds"] += sp.seconds
        del runs  # drop the memmaps so the run files can be unlinked
        self.host_runs = []
        self._unlink_disk_runs()
        return total, hist, it

    def _unlink_disk_runs(self) -> None:
        for p in self.disk_runs:
            try:
                os.unlink(p)
            except OSError:
                pass
        self.disk_runs = []

    def close(self) -> None:
        """Delete any disk-tier files this accumulator created (run files,
        merged files, and the mkdtemp dir when it owns one; a ``disk_dir``
        the caller passed stays).  Idempotent; safe to call whether or not
        a finalize ran."""
        self._unlink_disk_runs()
        if self._disk_dir is not None:
            for name in ("merged_k.bin", "merged_c.bin"):
                try:
                    os.unlink(os.path.join(self._disk_dir, name))
                except OSError:
                    pass
            if self._disk_dir_arg is None:
                shutil.rmtree(self._disk_dir, ignore_errors=True)
            self._disk_dir = None

    # -- checkpoint / resume ----------------------------------------------
    # Every tier of this accumulator is already a set of sorted (kmers,
    # counts) runs, so a checkpoint is: drain the device tiers to the host,
    # write each run as a run file, then the manifest LAST (a crash
    # mid-checkpoint leaves no manifest -> no torn state).
    def checkpoint(self, ckpt_dir: str, extra: dict | None = None) -> None:
        """Persist the full counting state to ``ckpt_dir``; counting can
        continue afterwards (the device tiers drain but the accumulator
        stays valid).  ``extra`` rides along in the manifest (the pipeline
        stores its stream position there, see pipeline.count_encode)."""
        os.makedirs(ckpt_dir, exist_ok=True)
        self._merge_device_runs()
        self._spill_last_device_run()
        # Each checkpoint writes a NEW file generation: a restored
        # accumulator holds read-only memmaps of the previous generation's
        # files, so overwriting them in place would SIGBUS the reader.
        # Stale generations are unlinked only AFTER the new manifest lands
        # (open memmaps keep the inodes alive; a crash in between just
        # leaks files the next checkpoint cleans up).
        gen = self._ckpt_gen
        files = []
        for i, (ku, kc) in enumerate(self.host_runs):
            name = f"g{gen:04d}_run{i:04d}.bin"
            write_run_file(os.path.join(ckpt_dir, name), np.asarray(ku),
                           np.asarray(kc))
            files.append(name)
        for p in self.disk_runs:
            name = f"g{gen:04d}_disk_{os.path.basename(p)}"
            shutil.copyfile(p, os.path.join(ckpt_dir, name))
            files.append(name)
        tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"k": self.k, "total_windows": self.total_windows,
                       "files": files, "gen": gen, "extra": extra or {}}, f)
        os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))
        self._ckpt_gen = gen + 1
        keep = set(files) | {"manifest.json"}
        for name in os.listdir(ckpt_dir):
            if name not in keep and name.endswith(".bin"):
                try:
                    os.unlink(os.path.join(ckpt_dir, name))
                except OSError:
                    pass

    @staticmethod
    def read_manifest(ckpt_dir: str) -> dict | None:
        """The checkpoint manifest, or None when ``ckpt_dir`` holds no
        complete checkpoint (a crash mid-checkpoint leaves no manifest)."""
        try:
            with open(os.path.join(ckpt_dir, "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @classmethod
    def restore(cls, ckpt_dir: str, **kwargs) -> "DeviceCountAccumulator":
        """Rebuild an accumulator from ``checkpoint``; more batches may be
        added before finalize.  Runs load as read-only memmaps (lazily
        paged — restoring does not pull the table into RAM); checkpoint
        files are never modified or deleted."""
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            m = json.load(f)
        acc = cls(int(m["k"]), **kwargs)
        acc.total_windows = int(m["total_windows"])
        acc.host_runs = [open_run_file(os.path.join(ckpt_dir, name))
                         for name in m["files"]]
        acc.host_runs.sort(key=lambda r: -len(r[0]))  # cascade invariant
        acc._ckpt_gen = int(m.get("gen", 0)) + 1
        return acc

    def _finalize_host(self) -> tuple[np.ndarray, np.ndarray] | None:
        """When spills happened: fold any remaining device run into the host
        level and merge host runs to one.  Returns raw (kmers, counts) or
        None when nothing spilled."""
        if not self.host_runs:
            return None
        self._spill_last_device_run()
        while len(self.host_runs) >= 2:
            kb, cb = self.host_runs.pop()
            ka, ca = self.host_runs.pop()
            self.host_runs.append(self._timed_host_merge(ka, ca, kb, cb))
        return self.host_runs[0]

    def finalize(self, ci: int = 1, cs: int = 0xFFFFFFFF
                 ) -> tuple[np.ndarray, np.ndarray]:
        """The whole table as (uint64 kmers, uint32 counts) NumPy arrays,
        ascending, ci-filtered and cs-clamped.  Materializes the table in
        host RAM; use finalize_stream for bounded memory."""
        cs32 = np.uint32(min(int(cs), 0xFFFFFFFF))
        self._merge_device_runs()
        if self.disk_runs:
            # out-of-core regime: this entry point MATERIALIZES the merged
            # table in host RAM — exactly the regime disk spill exists for.
            # Warn and point callers at finalize_stream; raise when the
            # materialized size would clearly exceed the spill budget.
            disk_bytes = sum(
                12 * self._open_disk_run(p)[0].shape[0] for p in self.disk_runs
            )
            # raise only for sizes truly beyond RAM (an absolute floor, so
            # small tables under forced-tiny thresholds still pass)
            ram_budget = max(2 * self.disk_spill_bytes, 8 << 30)
            if self.disk_spill_bytes and disk_bytes > ram_budget:
                raise MemoryError(
                    f"finalize() would materialize ~{disk_bytes >> 20}MB of "
                    f"disk-spilled table in host RAM (budget "
                    f"{ram_budget >> 20}MB); use finalize_stream() for "
                    f"bounded memory"
                )
            warnings.warn(
                "DeviceCountAccumulator.finalize() materializes the merged "
                "table despite disk spill; use finalize_stream() for "
                "bounded memory", ResourceWarning, stacklevel=2)
            self._spill_last_device_run()
            _, _, it = self._finalize_disk(ci, cs)
            parts = list(it)
            if not parts:
                return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        host = self._finalize_host()
        if host is not None:
            kmers, counts = host
            keep = counts >= ci
            return kmers[keep], np.minimum(counts[keep], cs32)
        if not self.runs:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32)
        u, c, _ = self.runs[0]
        kmers = u.cpu().numpy().view(np.uint64)
        counts = np.minimum(c.cpu().numpy().view(np.uint32), cs32)
        keep = (kmers != _U64_SENTINEL) & (counts >= ci)
        return kmers[keep], counts[keep]

    def _finalize_device_table(self, u, c, flat, ci: int, route):
        """Common tail of both finalize routes, in a fixed dispatch order on
        the one stream: the whole table's copies (so the transfer starts at
        once), the low-key drop, the dropped table's copies, then what the
        ``route`` (model.route.BuildRoute) builds from the table and the
        drop's pairs, which runs behind the copies on the device while the
        host starts to encode.  Without a route the whole table streams."""
        total = int(flat[0])
        hist = flat[1:4].astype(np.int64)
        n_real = int(flat[4])
        plan = (route.plan_table(total, hist, n_real, u) if route is not None
                else None)
        chunks = iter(())
        if plan is None or plan.stream == "table":
            chunks = self._copy_out(u, c, n_real, total, ci)
        kept = None
        if plan is not None and plan.drop_below:
            with timing.span("finalize.drop_low"):
                kept = _drop_low(u, c, plan.drop_below)
            if plan.stream == "dropped":
                chunks = self._copy_out(*kept, plan.n_kept, total, ci)
        if route is not None:
            route.feed(u, c, n_real, kept)
        return total, hist, chunks

    def _copy_out(self, u, c, n: int, total: int, ci: int):
        """Dispatch the copies of ``u[:n]`` / ``c[:n]`` to the host."""
        with timing.span("finalize.copy_dispatch"):
            if not total:
                return iter(())
            self.table_bytes_to_host = n * (u.element_size()
                                            + c.element_size())
            return _stream_table(u, c, n, ci)

    @staticmethod
    def _stream_host_run(kmers, counts, ci: int, cs: int, n_chunks: int):
        """The host route's (total, low_hist, chunk_iter) from the one
        merged host run: sized on cs-clamped counts, streamed in
        ``n_chunks`` ascending slices."""
        cs32 = np.uint32(cs)
        hist = np.zeros(3, dtype=np.int64)
        total = _size_stats(np.minimum(counts, cs32), ci, 0, hist)
        m = max(1, -(-len(kmers) // max(n_chunks, 1)))

        def hit():
            for a in range(0, len(kmers), m):
                ku = kmers[a : a + m]
                kc = counts[a : a + m]
                keep = kc >= ci
                yield ku[keep], np.minimum(kc[keep], cs32)

        return total, hist, hit()

    def finalize_stream(self, ci: int = 1, cs: int = _U32_MAX,
                        n_chunks: int = 16, route=None):
        """Streaming finalize: returns (total, low_hist, chunk_iter) where
        ``chunk_iter`` yields (uint64 kmers, uint32 counts) numpy chunks in
        ascending k-mer order, ci-filtered and cs-clamped; ``total`` and
        ``low_hist`` (count of counter == ci+i, i < 3) are the encoder's
        sizing pass over the whole table.

        ``route`` (model.route.BuildRoute) decides, for a table finalized on
        the device, what of it streams and what is built from it there; it
        holds what it built after this call.

        When runs left the device — before or DURING the merge that this
        call makes — the table comes from the disk route (one out-of-core
        merge pass) or the host route (``n_chunks`` slices of the merged
        host run) instead, whole, and the route is not consulted: the host
        inserts the Bloom bank."""
        cs = min(int(cs), _U32_MAX)
        self.table_bytes_to_host = 0
        if (not self.runs and not self.host_runs and not self.disk_runs
                and self.raw):
            u, c, flat = _fused_finalize(self.raw, ci, cs)
            self.raw = []
            self.raw_elems = 0
        else:
            self._merge_device_runs()
            # the merge above may itself have spilled: test the tiers after
            if self.disk_runs:
                self._spill_last_device_run()
                return self._finalize_disk(ci, cs)
            host = self._finalize_host()
            if host is not None:
                return self._stream_host_run(*host, ci, cs, n_chunks)
            if not self.runs:
                return 0, np.zeros(3, dtype=np.int64), iter(())
            u, c, _ = self.runs[0]
            c = _clamp_cs(c, cs)  # clamp before stats, feed and drop
            flat = _final_stats(u, c, ci)
        return self._finalize_device_table(u, c, flat, ci, route)
