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
    ``non_blocking`` copies, ci-filtered on the host.  With a
    ``bloom_factory`` the Bloom bank is built on the device from the full
    table behind those copies (``model.device_bloom``); with ``drop_low``
    the keys that only feed the Bloom bank are masked out and the table is
    recompacted (``compact_pairs``) before it streams, so they never cross
    to the host.

Keys are int64 tensors holding the uint64 bit pattern (SENTINEL = -1);
counts are int32 (merged sums saturate at 2^31-1, far above any cs).

Left out of the JAX module, on purpose:

  * ``tile_mode`` (device_lsm.py:119-248, :726-762): it exists only for
    the Pallas block layout;
  * the segmented finalize (:370-431, :1115-1149), an opt-in diagnostic;
  * the bit-packed delta transfer (:434-513, :1151-1239), built for a slow
    host link; the pinned-memory chunk copy takes its place (the encoder
    is chunk-invariant);
  * host and disk spill, and checkpoint: a run that would reach
    ``SPILL_THRESHOLD`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from kmcex_tpu_torch.count.compact import compact_pairs
from kmcex_tpu_torch.count.extract import (
    SENTINEL,
    extract_canonical_packed,
    segment_compact,
    sort_count_unique,
    sorted_u64,
)
from kmcex_tpu_torch.count.sort import merge_sorted_u64
from kmcex_tpu_torch.utils.device import resolve_device
from kmcex_tpu_torch.utils.timing import verbose

_I32_MAX = (1 << 31) - 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _merge_runs(ka, ca, kb, cb):
    """Merge two sorted (kmer, count) runs (SENTINEL-padded), summing
    duplicates; result padded to len(ka)+len(kb).  Returns (uniq, counts,
    n_unique) — the JAX ``_merge_runs_kernel`` (device_lsm.py:46-95)."""
    k, c = merge_sorted_u64(ka, ca, kb, cb)
    n = k.numel()
    dev = k.device
    idxs = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = k[1:] != k[:-1]
    real = k != SENTINEL
    valid = first & real
    n_real = real.sum()
    # segment sums by cumsum differencing at run boundaries
    csum = torch.cumsum(c, 0, dtype=torch.int64)
    bpos = torch.where(first, idxs, n)
    nxt = torch.cat([bpos[1:], bpos.new_full((1,), n)])
    next_b = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    seg_end = torch.minimum(next_b, n_real)  # exclusive
    start_excl = torch.where(idxs > 0, csum[(idxs - 1).clamp(min=0)], 0)
    seg_sum = csum[(seg_end - 1).clamp(min=0)] - start_excl
    seg_sum = torch.where(seg_end > idxs, seg_sum, 0)
    counts = torch.where(valid, seg_sum, 0).clamp(max=_I32_MAX).to(torch.int32)
    key = torch.where(valid, k, SENTINEL)
    uniq, counts_c = compact_pairs(key, counts)
    return uniq, counts_c, valid.sum()


def _final_stats(kmers, counts, ci: int) -> np.ndarray:
    """Encode-sizing stats of the final table in ONE host pull (the JAX
    ``_final_stats`` fields [0:9], device_lsm.py:259-302):
    [0]=total pairs >= ci, [1:4]=histogram of counter==ci+i, [4]=n_real,
    [5]=first k-mer, [6]=first count, [7]=last k-mer, [8]=last count."""
    real = kmers != SENTINEL  # contiguous prefix: sentinels sort last
    valid = real & (counts >= ci)
    n_real = real.sum()
    last_i = (n_real - 1).clamp(min=0)
    parts = [valid.sum()]
    parts += [(valid & (counts == ci + i)).sum() for i in range(3)]
    parts += [n_real, kmers[0], counts[0].to(torch.int64), kmers[last_i],
              counts[last_i].to(torch.int64)]
    return torch.stack(parts).cpu().numpy()


def _fused_finalize(kmers_list, ci: int, cs: int):
    """The whole single-tier finalize: concat the raw tier, sort,
    segment-count, compact, cs-clamp, sizing stats."""
    flat = torch.cat(kmers_list) if len(kmers_list) > 1 else kmers_list[0]
    u, c, _ = segment_compact(sorted_u64(flat))
    c = c.clamp(max=cs)
    return u, c, _final_stats(u, c, ci)


def _drop_compact(u, c, thresh: int):
    """The low-key drop of the model-only path: mask the pairs with count <
    ``thresh`` (= ci + bf_num: the Bloom-bound and sub-ci keys) to
    (SENTINEL, 0), recompact with the compaction kernel, and take the
    dropped table's own stats.  Returns (u2, c2, stats2)."""
    keep = c >= thresh
    u2, c2 = compact_pairs(torch.where(keep, u, SENTINEL),
                           torch.where(keep, c, 0))
    return u2, c2, _final_stats(u2, c2, thresh)


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
        ku, kc = u[a : a + m], c[a : a + m]
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
            if done is not None:
                done.synchronize()
            ku = hk.numpy().view(np.uint64)
            kc = hc.numpy().view(np.uint32)
            keep = kc >= ci
            if keep.any():
                yield ku[keep], kc[keep]

    return chunks()


class DeviceCountAccumulator:
    """Accumulates batches on one device; one host transfer at finalize."""

    # Raw k-mers buffered on the device before one sort+count pass.
    RAW_TIER_ELEMS = 64 << 20
    # Below this size merges stay fully async; above it one scalar sync
    # shrinks the pad so memory and merge cost track the distinct count.
    SHRINK_THRESHOLD = 1 << 23
    # Runs at or above this size would leave the device in the JAX package
    # (host / disk LSM tiers), which this package does not have yet.
    SPILL_THRESHOLD = 128 << 20

    def __init__(self, k: int, raw_tier_elems: int | None = None,
                 device=None):
        self.k = k
        self.device = resolve_device(device)
        self.raw_tier_elems = (raw_tier_elems
                               or int(os.environ.get("KMCEX_RAW_TIER_ELEMS", 0))
                               or self.RAW_TIER_ELEMS)
        self.raw: list[torch.Tensor] = []
        self.raw_elems = 0
        self.runs: list[tuple[torch.Tensor, torch.Tensor, int]] = []
        self.total_windows = 0
        # tier-transition telemetry (surfaced via KMCEX_STATS_JSON)
        self.tier_events = {"raw_collapses": 0, "device_merges": 0}
        # set by finalize_stream
        self.device_bloom = None
        self.finalize_phases: dict[str, float] = {}
        self.table_bytes_to_host = 0

    def add_batch_packed(self, packed: torch.Tensor,
                         maskbits: torch.Tensor) -> None:
        """2-bit packed input (see extract.pack_codes_np): L = 4 * packed
        width."""
        L = packed.shape[1] * 4
        n_windows = packed.shape[0] * (L - self.k + 1)
        kmers, _ = extract_canonical_packed(packed.to(self.device),
                                            maskbits.to(self.device), self.k)
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
        flat = torch.cat(self.raw) if len(self.raw) > 1 else self.raw[0]
        self.raw = []
        self.raw_elems = 0
        uniq, counts, nu = sort_count_unique(flat)
        self._after_collapse(uniq, counts, nu)

    def _shrink(self, u, c, size: int, nu):
        if size >= self.SHRINK_THRESHOLD:
            shrunk = _next_pow2(max(int(nu), 1))  # scalar device sync
            if shrunk < size:
                u, c, size = u[:shrunk], c[:shrunk], shrunk
        return u, c, size

    def _check_spill(self, size: int) -> None:
        if size >= self.SPILL_THRESHOLD:
            raise NotImplementedError(
                f"a run of {size} entries reaches the spill threshold "
                f"({self.SPILL_THRESHOLD}); host/disk spill tiers are not "
                f"ported yet")

    def _after_collapse(self, uniq, counts, nu) -> None:
        uniq, counts, size = self._shrink(uniq, counts, uniq.numel(), nu)
        # runs are pow2-padded so merge size classes stay logarithmic
        psize = _next_pow2(size)
        if psize != size:
            pad = psize - size
            uniq = torch.cat([uniq, uniq.new_full((pad,), SENTINEL)])
            counts = torch.cat([counts, counts.new_zeros(pad)])
            size = psize
        self._check_spill(size)
        self.runs.append((uniq, counts, size))
        self._rebalance()

    def _merge_top2(self) -> None:
        self.tier_events["device_merges"] += 1
        kb, cb, sb = self.runs.pop()
        ka, ca, sa = self.runs.pop()
        u, c, nu = _merge_runs(ka, ca, kb, cb)
        u, c, size = self._shrink(u, c, sa + sb, nu)
        self._check_spill(size)
        self.runs.append((u, c, size))

    def _rebalance(self) -> None:
        while len(self.runs) >= 2 and self.runs[-2][2] <= self.runs[-1][2]:
            self._merge_top2()

    def _merge_device_runs(self) -> None:
        """Collapse the raw tier and merge device runs down to at most one."""
        self._collapse_raw()
        while len(self.runs) >= 2:
            self._merge_top2()

    def _finalize_device_table(self, u, c, flat, ci: int, bloom_factory,
                               drop_low: bool):
        """Common tail of both finalize routes: optional device Bloom build
        (model.device_bloom) and optional low-key transfer drop, then the
        chunk copies.  Dispatch order on the one stream: the table copies go
        FIRST so the transfer starts at once; the Bloom feed runs behind
        them on the device while the host starts to encode; the byte pack
        and the pull of the filter bytes come last.  Sets
        ``self.device_bloom`` to the fed DeviceBloomBuilder (None when no
        build ran)."""
        fin = self.finalize_phases
        total = int(flat[0])
        hist = flat[1:4].astype(np.int64)
        n_real = int(flat[4])
        bloom = None
        if bloom_factory is not None and n_real:
            try:
                bloom = bloom_factory(hist)
            except ValueError as e:  # bitmap too large: the host builds
                if verbose():
                    print(f"   device bloom build not taken ({e}); the "
                          f"host inserts")
        t = time.time()
        if bloom is not None and drop_low:
            bf_num = 1 if ci == 1 else 3
            su, sc, flat2 = _drop_compact(u, c, ci + bf_num)
            n_stream = int(flat2[4])
            fin["drop_low"] = time.time() - t
            t = time.time()
        else:
            su, sc, n_stream = u, c, n_real
        chunks = iter(())
        if total:
            self.table_bytes_to_host = n_stream * (su.element_size()
                                                   + sc.element_size())
            chunks = _stream_table(su, sc, n_stream, ci)
        fin["copy_dispatch"] = time.time() - t
        if bloom is not None:
            t = time.time()
            bloom.feed_table(u, c, n_real)
            bloom.start_pull()
            fin["bloom_feed_dispatch"] = time.time() - t
        self.device_bloom = bloom
        return total, hist, chunks

    def finalize_stream(self, ci: int = 1, cs: int = _I32_MAX,
                        bloom_factory=None, drop_low: bool = False):
        """Streaming finalize: returns (total, low_hist, chunk_iter) where
        ``chunk_iter`` yields (uint64 kmers, uint32 counts) numpy chunks in
        ascending k-mer order, ci-filtered and cs-clamped; ``total`` and
        ``low_hist`` (count of counter == ci+i, i < 3) are the encoder's
        sizing pass over the whole table.

        ``bloom_factory`` (callable(low_hist) ->
        model.device_bloom.DeviceBloomBuilder) opts into building the Bloom
        bank on the device; it lands, fed, on ``self.device_bloom``.
        ``drop_low`` additionally drops the Bloom-bound keys (and sub-ci
        keys) from the host transfer — only valid when the caller does not
        need the low pairs on the host (no KMC database spool)."""
        cs = min(int(cs), _I32_MAX)
        self.device_bloom = None
        self.table_bytes_to_host = 0
        fin = self.finalize_phases = {}
        if not self.runs and self.raw:
            u, c, flat = _fused_finalize(self.raw, ci, cs)
            self.raw = []
            self.raw_elems = 0
        else:
            self._merge_device_runs()
            if not self.runs:
                return 0, np.zeros(3, dtype=np.int64), iter(())
            u, c, _ = self.runs[0]
            c = c.clamp(max=cs)  # clamp before stats, feed and drop
            flat = _final_stats(u, c, ci)
        return self._finalize_device_table(u, c, flat, ci, bloom_factory,
                                           drop_low)
