"""Device-side Bloom-bank build, on one device or across a mesh.

The reference inserts low-count k-mers into the Bloom pairs with atomic
scatter-ORs on the host (kmodel.hpp:473-506) — commutative and order-free,
which makes it the one piece of the encode that can leave the sequential
host schedule entirely.  Here the (nh-1) main-filter and (nh-2) back-filter
probe positions are computed on the device straight from the counted table
(murmur over the regenerated ASCII form, exactly the host/native seed
schedule) and set in a device bitmap; only the FINISHED filter bytes cross
to the host.  The counterpart of the JAX package's ``model/device_bloom.py``.

Bitmap: ONE BYTE PER BIT, all 2*bf_num filter tables at byte-aligned
offsets in one flat tensor, so a tile needs one scatter and duplicate
positions are trivially exact (every writer stores 1).  The byte pack (bit
j of a byte is MSB-first, kmodel.hpp:576-588) runs on the device.

Where the JAX version hashes every row of a tile and sends the masked lanes
to an out-of-range index that its scatter drops, this one SELECTS THE LIVE
ROWS FIRST (boolean-mask indexing): torch raises on an index out of range,
and the rows that feed no filter — on a real spectrum one key in five, with
ci > 1 many more — are never hashed.  The price is one device sync a tile.

The mesh variant (``ShardedDeviceBloomBuilder``): every shard sets the bits
of its own disjoint keys, the bitmaps of one process are OR-ed, and
``all_reduce(MAX)`` joins the processes.  Left out of the JAX module, on
purpose: its OR is ``min(psum, 1)`` on a uint8 bitmap, which wraps at 256
shards, hence its 255-shard limit (device_bloom.py:140-144, 286-289); both
exist only because the TPU compile helper lowers sum reductions alone.  MAX
is exact at any mesh size, so neither is here.
"""

from __future__ import annotations

import numpy as np
import torch

from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.core.murmur import (
    HASH_SEEDS,
    murmur_eval,
    murmur_pre,
    seeds_tensor,
)
from kmcex_tpu_torch.model.bloom import BloomBank, bf_sizes
from kmcex_tpu_torch.utils.device import resolve_device

SENTINEL = -1

# Rows per feed step: bounds the transient tensors (ASCII bytes, hashes,
# positions; the positions of a full tile are TILE x (2 nh - 3) int64).
TILE = 1 << 21

# Bitmaps are one byte per bit; beyond this capacity the caller builds the
# Bloom bank on the host instead.
MAX_BITMAP_BYTES = 4 << 30

# (w * _PACK_MUL) >> 56 gathers the low bit of each of the 8 bytes of a
# little-endian word into one byte, first byte highest: byte j's bit lands
# at 8j + (63 - 9j) = 63 - j, and no two of the 64 partial products share a
# bit position, so nothing carries.
_PACK_MUL = 0x8040201008040201 - (1 << 64)


def _tile_positions(ut, ct, cs: int, lens, offs, seeds_main, seeds_back,
                    k: int, ci: int, bf_num: int):
    """Flat probe-bit positions (int64) of the rows of one tile that feed a
    filter: real keys whose CS-CLAMPED count is ci + i for an i < bf_num.
    Membership follows the reference's clamped counters (its kmc binary
    clamps when it writes the database), which matters when cs < ci +
    bf_num.  ``lens`` / ``offs`` are int64 tensors of the 2*bf_num table
    bit-lengths and bitmap offsets, (main_i, back_i) interleaved."""
    ct = codec.u32(ct).clamp(max=cs)
    live = (ut != SENTINEL) & (ct >= ci) & (ct < ci + bf_num)
    keys = ut[live]  # live rows only (module docstring)
    if keys.numel() == 0:
        return keys
    pair = ct[live] - ci
    bl, tl = murmur_pre(codec.ascii_bytes(keys, k))
    h_main = murmur_eval(bl, tl, k, seeds_main)
    blm, tlm = murmur_pre(codec.ascii_bytes(codec.middle_kmer(keys, k), k - 2))
    h_back = murmur_eval(blm, tlm, k - 2, seeds_back)
    pm = offs[2 * pair, None] + codec.umod(h_main, lens[2 * pair, None])
    pb = offs[2 * pair + 1, None] + codec.umod(h_back, lens[2 * pair + 1, None])
    return torch.cat([pm.reshape(-1), pb.reshape(-1)])


def _pack_bytes(bm: torch.Tensor) -> torch.Tensor:
    """bits uint8[cap] (0/1, cap a multiple of 8) -> bytes uint8[cap // 8],
    MSB-first within each byte (reference set_bit/check_bit layout,
    kmodel.hpp:576-588).  Reads eight bitmap bytes as one little-endian
    int64 word."""
    w = bm.view(torch.int64)
    return codec._srl(w * _PACK_MUL, 56).to(torch.uint8)


class DeviceBloomBuilder:
    """Accumulates the Bloom bank on the device while the count table
    streams to the host encode.  Lifecycle:

        b = DeviceBloomBuilder(k, ci, cs, n_hash, low_hist, device)
        b.feed_table(u, c, n_real)     # device tensors from the finalize
        b.start_pull()                 # byte pack + asynchronous pull
        b.into(bank)                   # fill a BloomBank's byte arrays

    Raises ValueError at construction when the bitmap would exceed
    MAX_BITMAP_BYTES (callers then build on the host).  ``device=None``
    means the GPU and raises without one."""

    def __init__(self, k: int, ci: int, cs: int, n_hash: int, low_hist,
                 device=None):
        self.device = resolve_device(device)
        self.k = int(k)
        self.ci = int(ci)
        self.cs = int(cs)
        self.n_hash = int(n_hash)
        self.bf_num = 1 if ci == 1 else 3
        counts = np.zeros(3, dtype=np.uint64)
        counts[: self.bf_num] = np.asarray(low_hist)[: self.bf_num]
        self.byte_bf, self.byte_back = bf_sizes(counts[: self.bf_num], n_hash)
        # interleaved (main_i, back_i) byte-aligned offsets into one bitmap
        sizes_bits = []
        for i in range(self.bf_num):
            sizes_bits += [int(self.byte_bf[i]) * 8, int(self.byte_back[i]) * 8]
        offs = np.cumsum([0] + sizes_bits[:-1]).astype(np.int64)
        total_bits = int(sum(sizes_bits))
        if total_bits > MAX_BITMAP_BYTES:
            raise ValueError(
                f"device bloom bitmap would need {total_bits} bytes")
        self.total_bytes = total_bits // 8
        self._lens = torch.tensor(sizes_bits, dtype=torch.int64,
                                  device=self.device)
        self._offs = torch.from_numpy(offs).to(self.device)
        self._seeds_main = seeds_tensor(HASH_SEEDS[: n_hash - 1], self.device)
        self._seeds_back = seeds_tensor(HASH_SEEDS[: n_hash - 2], self.device)
        self._bitmap = torch.zeros(total_bits, dtype=torch.uint8,
                                   device=self.device)
        self._pulled = None
        self._pull_done = None

    def feed_table(self, u: torch.Tensor, c: torch.Tensor, n_real: int) -> None:
        """Set the probe bits of every low-count key in ``u[:n_real]``
        (int64 keys, int32 counts on ``self.device``).  Each key should
        be fed once across all calls; duplicate positions and even duplicate
        keys set the same bits again."""
        n = min(int(u.shape[0]), max(int(n_real), 0))
        for a in range(0, n, TILE):
            b = min(a + TILE, n)
            pos = _tile_positions(u[a:b], c[a:b], self.cs, self._lens,
                                  self._offs, self._seeds_main,
                                  self._seeds_back, self.k, self.ci,
                                  self.bf_num)
            if pos.numel():
                self._bitmap.index_fill_(0, pos, 1)

    def start_pull(self) -> None:
        """Dispatch the byte pack and start the device->host pull of the
        finished filter bytes (call right after the last feed; on a GPU the
        copy goes to pinned memory and overlaps the host encode)."""
        if self._pulled is not None:
            return
        packed = _pack_bytes(self._bitmap)
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            self._pull_done = torch.cuda.Event()
            self._pull_done.record()
            self._pulled = host
        else:
            self._pulled = packed

    def into(self, bank: BloomBank) -> None:
        """Fill ``bank``'s filter byte arrays (the bank must be sized from
        the same low_hist / n_hash / ci)."""
        self.start_pull()
        if self._pull_done is not None:
            self._pull_done.synchronize()
        data = self._pulled.numpy()
        off = 0
        for i in range(self.bf_num):
            for arr, nbytes in ((bank.bit_bf[i], int(self.byte_bf[i])),
                                (bank.bit_bf_back[i], int(self.byte_back[i]))):
                if len(arr) != nbytes:
                    raise ValueError("bank sized from a different histogram")
                arr[:] = data[off : off + nbytes]
                off += nbytes


class ShardedDeviceBloomBuilder(DeviceBloomBuilder):
    """Bloom bank built across a shard mesh (``parallel.sharded.ShardMesh``):
    each shard sets its disjoint partition's probe bits, the bitmaps are
    OR-ed into the first local device's and, when the mesh spans processes,
    joined by ``all_reduce(MAX)``; every rank then holds the finished bytes.
    Feed it the per-shard merged runs BEFORE the table drains to the host.
    With ``world > 1`` ``global_low_hist`` and ``feed_table_sharded`` are
    collectives: every rank calls them."""

    def __init__(self, mesh, k: int, ci: int, cs: int, n_hash: int, low_hist):
        super().__init__(k, ci, cs, n_hash, low_hist, device=mesh.devices[0])
        self.mesh = mesh
        self._low_hist = np.asarray(low_hist)

    def feed_table_sharded(self, us, cs_) -> None:
        """``us[l]`` / ``cs_[l]``: local shard ``l``'s sorted unique run
        (int64 keys, int32 counts, SENTINEL-padded) on its device, or None
        for a shard that holds nothing."""
        helpers = {self.device: self}
        for dev, u, c in zip(self.mesh.devices, us, cs_):
            if u is None:
                continue
            if dev not in helpers:
                helpers[dev] = DeviceBloomBuilder(
                    self.k, self.ci, self.cs, self.n_hash, self._low_hist,
                    device=dev)
            helpers[dev].feed_table(u, c, u.shape[0])
        for dev, h in helpers.items():
            if h is not self:
                self._bitmap |= h._bitmap.to(self.device)
        if self.mesh.world > 1:
            from kmcex_tpu_torch.parallel import comm

            comm.all_reduce_max_(self._bitmap, self.mesh.group)
        self.start_pull()

    @staticmethod
    def global_low_hist(mesh, us, cs_, ci: int, cs: int) -> np.ndarray:
        """Global pass-1 histogram (cs-clamped counter == ci + i, i < 3) of
        a sharded table: a SUM of three int64 over the shards."""
        hist = np.zeros(3, dtype=np.int64)
        for u, c in zip(us, cs_):
            if u is None:
                continue
            real = u != SENTINEL
            cc = codec.u32(c).clamp(max=cs)
            hist += torch.stack([(real & (cc == ci + i)).sum()
                                 for i in range(3)]).cpu().numpy()
        if mesh.world > 1:
            from kmcex_tpu_torch.parallel import comm

            hist = comm.all_reduce_sum(hist, mesh.group, mesh.devices[0])
        return hist
