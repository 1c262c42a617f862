"""A build's route: where its Bloom bank and coupled arrays are made, and
what of the counted table crosses to the host.

``BuildRoute`` alone decides all three, from what it observes when the
table is finalized: the Bloom bank is built on the table's device (on a
mesh, across its shards) unless the builder refuses (``MAX_BITMAP_BYTES``)
or the table left the device (the host and disk routes never reach the
route), and then the host inserts it; the arrays are encoded on the card
only beside a device Bloom build, on one device, where the scratch fits,
else by the native encoder; the whole table crosses when the host needs
the low pairs (a KMC database, ``keep_pairs``) or inserts the Bloom bank,
else only the array-bound pairs, or nothing when the card encodes.  The
count layer hands the route its finalized table and streams what the plan
says; ``KModel.init_from_chunks`` reads ``bloom`` and ``encoder``.
"""

from __future__ import annotations

import typing

from kmcex_tpu_torch.model.device_bloom import (
    DeviceBloomBuilder,
    ShardedDeviceBloomBuilder,
)
from kmcex_tpu_torch.model.device_encode import DeviceArrayEncoder
from kmcex_tpu_torch.model.kmodel import split_chunk
from kmcex_tpu_torch.utils import timing
from kmcex_tpu_torch.utils.timing import verbose


class TablePlan(typing.NamedTuple):
    """What the count layer does with a table finalized on one device."""

    stream: str | None  # "table", "dropped" or None: what crosses to the host
    drop_below: int     # the low-key drop keeps counts >= this; 0: no drop
    n_kept: int         # the pairs the drop keeps


class BuildRoute:
    """The route of one build of ``km`` at k-mer length ``k``; ``keep_low``:
    the host needs the low pairs.  After the finalize ``bloom`` and
    ``encoder`` hold the fed device Bloom builder and array encoder, None
    where they did not engage.  Makes ``table.pull_wait`` and
    ``table.host_prep`` present in the current record, so that a build that
    streams no table reads 0.0."""

    def __init__(self, km, k: int, keep_low: bool):
        self.km = km
        self.k = int(k)
        self.keep_low = bool(keep_low)
        self.bloom = None
        self.encoder = None
        for name in ("table.pull_wait", "table.host_prep"):
            timing.add(name, 0.0)

    def plan_table(self, total: int, low_hist, n_real: int,
                   table_keys) -> TablePlan:
        """Engage the device builders for a table finalized on one device
        (``table_keys``: ``n_real`` real entries, ``total`` of them >= ci,
        ``low_hist`` the counter == ci + i histogram) and say what of it
        crosses to the host."""
        km = self.km
        n_kept = total - int(low_hist[: km.bf_num].sum())
        if n_real:
            try:
                self.bloom = DeviceBloomBuilder(
                    self.k, km.ci, km.cs, km.n_hash, low_hist,
                    device=table_keys.device)
            except ValueError as e:  # bitmap too large: the host builds
                if verbose():
                    print(f"   device bloom build not taken ({e}); the "
                          f"host inserts")
        if self.bloom is None:
            return TablePlan("table", 0, n_kept)
        try:  # the drop's new buffers are the encoder's input
            self.encoder = DeviceArrayEncoder(self.k, km, n_kept, table_keys,
                                              12 * table_keys.numel())
        except ValueError as e:  # not on a card, or no room: the host
            if verbose():
                print(f"   device array encode not taken ({e}); the "
                      f"host encodes")
        drop = km.ci + km.bf_num  # the array-bound pairs' least counter
        on_card = self.encoder is not None
        if self.keep_low:
            return TablePlan("table", drop if on_card else 0, n_kept)
        return TablePlan(None if on_card else "dropped", drop, n_kept)

    def feed(self, u, c, n_real: int, kept) -> None:
        """Feed the engaged builders from the table on its device: the
        encoder the drop's pairs ``kept`` (None where no drop ran), the
        Bloom build every low key of ``u[:n_real]``, then dispatch the pull
        of the filter bytes."""
        if self.encoder is not None:
            self.encoder.feed_table(*kept)
        if self.bloom is not None:
            with timing.span("finalize.bloom_feed_dispatch"):
                self.bloom.feed_table(u, c, n_real)
                self.bloom.start_pull()

    def feed_shards(self, mesh, us, cs_) -> None:
        """Build the Bloom bank across ``mesh`` from its shards' merged
        runs (None for an empty shard).  With ``world > 1`` a collective:
        every rank calls it."""
        km = self.km
        hist = ShardedDeviceBloomBuilder.global_low_hist(mesh, us, cs_, km.ci,
                                                         km.cs)
        try:
            bloom = ShardedDeviceBloomBuilder(mesh, self.k, km.ci, km.cs,
                                              km.n_hash, hist)
        except ValueError:  # bitmap too large: the host inserts
            return
        bloom.feed_table_sharded(us, cs_)
        self.bloom = bloom

    def split(self, kmers, counts):
        """One streamed chunk routed by counter for the host encode, or
        None when the card encodes the arrays."""
        if self.encoder is not None:
            return None
        with timing.span("table.host_prep"):
            return split_chunk(kmers, counts, self.km.ci, self.km.bf_num)
