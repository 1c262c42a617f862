"""The coupled-bit-array encode on the card, from the counted table there.

The native ``Encoder`` (``native.BitArrayEncoder``) runs the reference's
buffered rotating schedule on the host (kmodel.hpp:508-573): buckets of
``BUCKET_SIZE`` k-mers filled in stream order, ``n_bits`` rounds a flush in
which bucket i drains IN ORDER into array (i+t) % n_bits, a compaction
between rounds that does not keep order, the survivors handed to the rest
store.  This module runs the same state machine, to the same bytes, with the
table on the card: ``csrc/encode.cu`` for CUDA tensors and
``encode_arrays_plain`` for CPU tensors.  Both walk a chain in batches of
``batch`` k-mers: the k-mers none of whose probe positions an earlier k-mer
of the batch probes decide at once against the state before the batch (they
cannot see each other), and the others decide one by one, in order, after
them.  That is the sequential loop's result; the share decided one by one
(``encode.serial_attempts`` of ``encode.attempts``) grows with the batch
over the array's size.

``DeviceArrayEncoder`` is the build's handle: made when the counted table
is finalized on the card, fed the array-bound pairs there, dispatched by
``KModel.init_from_chunks``, which then pulls the finished arrays and the
rest pairs into the model.  It refuses (ValueError) a table that is not on
a CUDA device or whose scratch does not fit on the card; the build then
keeps the native encoder.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.core.murmur import (
    HASH_SEEDS,
    murmur_eval,
    murmur_pre,
    seeds_tensor,
)
from kmcex_tpu_torch.model.device_bloom import _pack_bytes
from kmcex_tpu_torch.native import kernels
from kmcex_tpu_torch.utils import timing

# positions a batch may hold (batch x n_hash): the kernel's shared-memory
# hash table has twice as many slots
MAX_POS = 8192
# a chain's cluster (8 blocks of 128 threads) takes a batch of 1024 at one
# k-mer a thread
DEFAULT_BATCH = 1024


class EncodePlan(typing.NamedTuple):
    """The model's array geometry and the schedule's constants."""

    k: int
    n_bits: int
    n_hash: int
    back_num_hash: int
    km_byte_size: int      # bytes of one array
    byte_km_back: int
    occ2bin: np.ndarray    # uint32 LUT
    bucket_size: int
    batch: int


class Encoded(typing.NamedTuple):
    """An encode's results, on the device it ran on: the arrays' bytes in
    the model's layout (``n_bits`` arrays one after the other), the rest
    pairs in hand-off order (the first ``stats[0]``), and ``stats`` int64
    [rest pairs, insert attempts, attempts decided one by one]."""

    bit1: torch.Tensor
    bit2: torch.Tensor
    km_back: torch.Tensor
    rest_keys: torch.Tensor
    rest_occs: torch.Tensor
    stats: torch.Tensor


def default_batch(n_hash: int, km_bit_size: int) -> int:
    """The batch for an array of ``km_bit_size`` bits: a k-mer of a batch of
    W is decided one by one with a chance of about n_hash^2 W / (2 bits),
    and each batch costs a few barriers, so W grows with the square root of
    the array up to what the kernel's table holds (1024 at n_hash = 7 from
    about a million bits on)."""
    return max(1, min(DEFAULT_BATCH, MAX_POS // n_hash,
                      math.isqrt(km_bit_size)))


def _bins(occ: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """occ2bin[occ], or 0 past the LUT (occ as int64 values)."""
    n = lut.numel()
    return torch.where(occ < n, lut[occ.clamp(max=n - 1)], 0)


def encode_arrays_plain(keys: torch.Tensor, occs: torch.Tensor,
                        plan: EncodePlan) -> Encoded:
    """The batched schedule in PyTorch: ``keys`` int64 / ``occs`` int32
    (uint32 bit patterns) of the array-bound pairs in listing order."""
    k, nb, nh, bs, W = (plan.k, plan.n_bits, plan.n_hash, plan.bucket_size,
                        plan.batch)
    dev = keys.device
    bit_len, back_len = plan.km_byte_size * 8, plan.byte_km_back * 8
    b1 = torch.zeros((nb, bit_len), dtype=torch.bool, device=dev)
    b2 = torch.zeros((nb, bit_len), dtype=torch.bool, device=dev)
    back = torch.zeros(back_len, dtype=torch.bool, device=dev)
    bk = torch.zeros((nb, bs), dtype=torch.int64, device=dev)
    bo = torch.zeros((nb, bs), dtype=torch.int64, device=dev)  # 0: inserted
    lut = torch.from_numpy(plan.occ2bin.astype(np.int64)).to(dev)
    seeds = [seeds_tensor(HASH_SEEDS[(a * nh + np.arange(nh)) % 128], dev)
             for a in range(nb)]
    back_seeds = seeds_tensor(HASH_SEEDS[: plan.back_num_hash], dev)
    jj = torch.arange(nh, device=dev)
    occ = codec.u32(occs)
    attempts = serial = 0

    def back_or(kk):
        if plan.back_num_hash:
            bl, tl = murmur_pre(codec.ascii_bytes(codec.middle_kmer(kk, k),
                                                  k - 2))
            back[codec.umod(murmur_eval(bl, tl, k - 2, back_seeds),
                            back_len).reshape(-1)] = True

    def batch(i, a, b0, m):
        nonlocal serial
        kk, oo = bk[i, b0 : b0 + m], bo[i, b0 : b0 + m]
        bl, tl = murmur_pre(codec.ascii_bytes(kk, k))
        pos = codec.umod(murmur_eval(bl, tl, k, seeds[a]), bit_len)  # [m, nh]
        bb = ((_bins(oo, lut)[:, None] >> jj) & 1).bool()
        # the smallest index probing each position: a stable sort keeps the
        # indices of one position ascending
        flat = pos.reshape(-1)
        idx = torch.arange(m, device=dev).repeat_interleave(nh)
        order = torch.sort(flat, stable=True).indices
        sp, si = flat[order], idx[order]
        start = torch.ones_like(sp, dtype=torch.bool)
        start[1:] = sp[1:] != sp[:-1]
        first = si[start][start.cumsum(0) - 1]
        conf = torch.zeros(m, dtype=torch.bool, device=dev)
        conf[si[si > first]] = True
        # the unconflicted, at once, against the state before the batch
        a1, a2 = b1[a], b2[a]
        ok = ~conf & ~(a2[pos] & (a1[pos] != bb)).any(1)
        if ok.any():
            po = pos[ok]
            a1[po[bb[ok]]] = True
            a2[po.reshape(-1)] = True
            back_or(kk[ok])
            oo[ok] = 0
        # the conflicted, one by one, in order
        for c in conf.nonzero().flatten().tolist():
            p = pos[c]
            if not (a2[p] & (a1[p] != bb[c])).any():
                a1[p[bb[c]]] = True
                a2[p] = True
                back_or(kk[c : c + 1])
                oo[c] = 0
        serial += int(conf.sum())

    def drain(i, a, n):
        """Bucket i into array a; returns the survivors, compacted as
        reorder_buffer does."""
        for b0 in range(0, n, W):
            batch(i, a, b0, min(W, n - b0))
        if n == 0:  # reorder_buffer reads slot 0 of an empty bucket
            return int(bo[i, 0] != 0)
        live = bo[i, :n] != 0
        s = int(live.sum())
        holes = (~live[:s]).nonzero().flatten()
        movers = (live[s:].nonzero().flatten() + s).flip(0)
        bk[i, holes] = bk[i, movers]
        bo[i, holes] = bo[i, movers]
        bo[i, movers] = 0
        return s

    n = keys.numel()
    cap = nb * bs
    full = n // cap
    cnt = [0] * nb
    rest_k, rest_o = [], []
    for f in range(full + 1):
        fill = cap if f < full else n - full * cap
        for t in range(nb):
            for i in range(nb):
                if t == 0:
                    cnt[i] = min(max(fill - i * bs, 0), bs)
                    src = f * cap + i * bs
                    bk[i, : cnt[i]] = keys[src : src + cnt[i]]
                    bo[i, : cnt[i]] = occ[src : src + cnt[i]]
                attempts += cnt[i]
                cnt[i] = drain(i, (i + t) % nb, cnt[i])
        for i in range(nb):
            rest_k.append(bk[i, : cnt[i]].clone())
            rest_o.append(bo[i, : cnt[i]].clone())
    rk, ro = torch.cat(rest_k), codec.u32_bits(torch.cat(rest_o))
    return Encoded(_pack_bytes(b1.reshape(-1).to(torch.uint8)),
                   _pack_bytes(b2.reshape(-1).to(torch.uint8)),
                   _pack_bytes(back.to(torch.uint8)), rk, ro,
                   torch.tensor([rk.numel(), attempts, serial]))


def encode_arrays(keys: torch.Tensor, occs: torch.Tensor,
                  plan: EncodePlan) -> Encoded:
    """The encode of the array-bound pairs (int64 keys, int32 counts):
    CPU tensors go to the plain version, CUDA tensors to
    ``csrc/encode.cu`` (asynchronous, on the current stream), anything
    else raises."""
    if keys.device.type == "cpu" and occs.device.type == "cpu":
        return encode_arrays_plain(keys, occs, plan)
    kernels.require_cuda(keys, torch.int64, "keys")
    kernels.require_cuda(occs, torch.int32, "occs")
    if keys.dim() != 1 or keys.shape != occs.shape:
        raise ValueError("keys and occs must be 1-D and of one length")
    dev, n = keys.device, keys.numel()
    nb, bs = plan.n_bits, plan.bucket_size
    size = nb * plan.km_byte_size

    def zeros(m, dtype):
        return torch.zeros(m, dtype=dtype, device=dev)

    def empty(m, dtype):
        return torch.empty(m, dtype=dtype, device=dev)

    bkeys, bocc = zeros(nb * bs, torch.int64), zeros(nb * bs, torch.int32)
    bidx = zeros(nb * bs, torch.int64)
    tkeys, tocc = empty(nb * bs, torch.int64), empty(nb * bs, torch.int32)
    tidx = empty(nb * bs, torch.int64)
    pos = empty(nb * plan.n_hash * bs, torch.int32)
    conf = empty(nb * -(-bs // plan.batch) * -(-plan.batch // 32), torch.int32)
    inserted = zeros(max(n, 1), torch.uint8)
    bcount = zeros(nb, torch.int32)
    bits = zeros(-(-size // 4), torch.int64)   # bit1 / bit2 words interleaved
    km_back = zeros(max(1, -(-plan.byte_km_back // 4)), torch.int32)
    stats = zeros(3, torch.int64)
    rest_keys, rest_occs = empty(n + nb, torch.int64), empty(n + nb,
                                                            torch.int32)
    lut = torch.from_numpy(np.ascontiguousarray(plan.occ2bin, np.uint32)
                           .view(np.int32)).to(dev)
    lib = kernels.lib()
    kernels.check(lib.kx_encode_arrays(
        keys.data_ptr(), occs.data_ptr(), n, plan.k, nb, plan.n_hash,
        plan.back_num_hash, plan.km_byte_size, plan.byte_km_back * 8,
        lut.data_ptr(), lut.numel(), bs, plan.batch,
        *(t.data_ptr() for t in (bkeys, bocc, bidx, bcount, tkeys, tocc, tidx,
                                 pos, conf, inserted, bits, km_back, stats,
                                 rest_keys, rest_occs)),
        kernels.stream_ptr(keys)), "kx_encode_arrays")
    kernels.LAUNCHES["encode_arrays"] += 1
    halves = bits.view(torch.int32).view(-1, 2)
    return Encoded(halves[:, 0].contiguous().view(torch.uint8)[:size],
                   halves[:, 1].contiguous().view(torch.uint8)[:size],
                   km_back.view(torch.uint8)[: plan.byte_km_back],
                   rest_keys, rest_occs, stats)


def scratch_bytes(plan: EncodePlan, n: int) -> int:
    """Device bytes an encode of ``n`` pairs allocates: buckets and their
    compaction scratch, a round's positions, the interleaved arrays and
    their two halves, km_back, the inserted flags, the rest buffers."""
    slots = plan.n_bits * plan.bucket_size
    buckets = slots * (40 + 4 * plan.n_hash)
    arrays = 4 * plan.n_bits * plan.km_byte_size + plan.byte_km_back
    return buckets + arrays + 13 * n + 12 * plan.n_bits + (1 << 20)


def _fits(device: torch.device, nbytes: int) -> bool:
    """Whether ``nbytes`` fit on ``device``: a CUDA device's free memory
    plus what the caching allocator holds unused."""
    if device.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(device)
    held = (torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return nbytes <= free + held


class DeviceArrayEncoder:
    """The encode of one build's coupled arrays on the card.  Lifecycle:

        enc = DeviceArrayEncoder(k, km, n_arr, table_keys, extra_bytes)
        enc.feed_table(keys, occs)   # the n_arr array-bound pairs first
        enc.dispatch()               # every launch, no sync
        rest = enc.into(km)          # arrays into km, rest pairs out

    ``km`` is the model the arrays are for (its ``n_bits``, ``n_hash``,
    OccuBin LUT), ``n_arr`` the pairs with counter >= ci + bf_num, which
    size its arrays; ``table_keys`` the finalized table, whose device
    decides.  Raises ValueError when that device is not a CUDA device or
    the scratch (plus ``extra_bytes`` the caller allocates for it) does not
    fit there, or past what the kernel takes."""

    def __init__(self, k: int, km, n_arr: int, table_keys: torch.Tensor,
                 extra_bytes: int = 0):
        from kmcex_tpu_torch.model.kmodel import BUCKET_SIZE, km_sizes

        km_byte_size, byte_km_back = km_sizes(n_arr, km.n_hash)
        self.plan = EncodePlan(
            int(k), km.n_bits, km.n_hash, km.km_back_num_hash, km_byte_size,
            byte_km_back, km.occu_bin.occ2bin_lut, BUCKET_SIZE,
            default_batch(km.n_hash, km_byte_size * 8))
        self.n = int(n_arr)
        self.device = table_keys.device
        if not 3 <= k <= 32 or km.n_hash > 32 or km.n_bits > 64:
            raise ValueError("k, n_hash or n_bits past what the kernel takes")
        if km_byte_size * 8 > 1 << 32:
            raise ValueError("array positions past 32 bits")
        need = scratch_bytes(self.plan, self.n) + int(extra_bytes)
        if not _fits(self.device, need):
            raise ValueError(f"the encode needs {need} bytes on "
                             f"{self.device}")
        self._table = None
        self._encoded = None

    def feed_table(self, keys: torch.Tensor, occs: torch.Tensor) -> None:
        """The array-bound pairs, in listing order: the first ``n_arr``
        entries of ``keys`` (int64) and ``occs`` (int32)."""
        self._table = (keys[: self.n], occs[: self.n])

    def dispatch(self) -> None:
        """Start the encode on the table's device."""
        if self._encoded is None:
            self._encoded = encode_arrays(*self._table, self.plan)
            self._table = None

    def into(self, km) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the encode, put ``bit1``, ``bit2`` and ``km_back`` into
        ``km`` (sized from the same ``n_arr``) and return the rest pairs
        (uint64 kmers, uint32 counts) in hand-off order.  Adds the counters
        ``encode.device_kmers``, ``encode.attempts`` and
        ``encode.serial_attempts`` to the current record."""
        p = self.plan
        if (km.km_byte_size, km.byte_km_back, km.n_bits) != (
                p.km_byte_size, p.byte_km_back, p.n_bits):
            raise ValueError("model sized from another table")
        self.dispatch()
        e = self._encoded
        rest_n, attempts, serial = (int(x) for x in e.stats.cpu())
        km.bit1 = e.bit1.cpu().numpy().reshape(p.n_bits, p.km_byte_size)
        km.bit2 = e.bit2.cpu().numpy().reshape(p.n_bits, p.km_byte_size)
        km.km_back = e.km_back.cpu().numpy()
        rk = e.rest_keys[:rest_n].cpu().numpy().view(np.uint64)
        ro = e.rest_occs[:rest_n].cpu().numpy().view(np.uint32)
        self._encoded = None
        timing.count("encode.device_kmers", self.n)
        timing.count("encode.attempts", attempts)
        timing.count("encode.serial_attempts", serial)
        return rk, ro
