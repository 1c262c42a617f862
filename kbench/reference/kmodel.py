"""The plain model build: the upstream kmcEx encoding of a (k-mer, count)
table, worked out in PyTorch, and its three files (``header``, ``km.bin``,
``rest.bin``) as bytes.

What the upstream encoder does (kmodel.hpp, rest.hpp, occu_bin.hpp), and so
what this file does, from the table in ascending k-mer order:

* counts under ``ci + bf_num`` (``bf_num`` = 1 when ci == 1, else 3) go to
  Bloom filter pairs, pair i holding the k-mers of count ci + i: a main
  filter over the k-mer's ASCII string (nh - 1 hashes, ``count / 5.5 *
  (nh - 1)`` bytes) and a back filter over its middle (k - 2)-mer (nh - 2
  hashes, ``(count >> 3) * (nh - 2)`` bytes);
* every other k-mer goes, in order, into n_bits buckets of 2^18 slots; when
  all are full, n_bits rounds follow, and in round t bucket i is inserted,
  slot by slot, into coupled array (i + t) % n_bits.  An insert writes the
  nh bits of the count's bin at the k-mer's nh hash positions of the value
  array and tags them in the tag array, and is refused when a tagged
  position holds the other bit.  A k-mer that goes in also sets the nh - 2
  hash positions of its middle in the ``km_back`` filter.  After each round
  the bucket's survivors are packed by the two-pointer swap of
  ``reorder_buffer`` (the j-th hole from the left takes the j-th survivor
  from the right); after the last round they go to the exact rest store.
  The tail flush runs the same rounds on the partly filled buckets; an
  empty bucket there keeps its slot 0 alive when that slot survived the
  previous flush (upstream reads ``a[0].occ`` with n == 0);
* the rest store is a CSR over 4^p prefix buckets (p the largest of 3..7
  with (k - p) % 4 == 0): ``hash2index``, ``pre_buffer``, the suffixes 4
  bases a byte, most significant first, and the counts as int32;
* a count becomes a bin by the OccuBin quantiser: identity below
  2^(nh-2), then 2^(nh-1) bins 3 wide, then 2^(nh-2) bins
  ``(max_counter - start) / 2^(nh-2)`` wide, the rest in the last bin.

Within one bucket-into-array pass the inserts are sequential.  Here they
are decided in waves: a k-mer is decided once every earlier undecided k-mer
that shares one of its positions is decided, which gives what the strict
order gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kbench.reference import murmur

BUCKET_SIZE = 1 << 18
_CHUNK = 1 << 21  # k-mers hashed per step


def occu_bin(max_counter: int, nh: int):
    """(occ -> bin [max_counter], bin -> mean [2^nh]) as int64 lists."""
    be3 = 1 << nh
    be1 = be3 // 4
    be2 = be1 + be3 // 2
    occ2bin = list(range(min(be1, max_counter))) + [0] * max(0, max_counter - be1)
    mean = [0] * max_counter
    start = be1
    for i in range(be3 // 2):                 # middle region, 3 wide
        for j in range(3):
            if start + j < max_counter:
                occ2bin[start + j], mean[start + j] = be1 + i, start + 1
        start += 3
    cap = (max_counter - start) // (be3 // 4)  # top region
    for i in range(be3 // 4):
        for j in range(cap):
            if 0 <= start + j < max_counter:
                occ2bin[start + j] = be2 + i
                mean[start + j] = (2 * start + cap) // 2
        start += cap
    for occ in range(max(start, 0), max_counter):  # leftover: last bin
        occ2bin[occ], mean[occ] = be3 - 1, (2 * start - cap) // 2
    bin2mean = [0] * be3
    seen = [False] * be3
    for occ in range(be1, max_counter):       # first insert wins
        b = occ2bin[occ]
        if 0 <= b < be3 and not seen[b]:
            bin2mean[b], seen[b] = mean[occ], True
    bin2mean[:be1] = list(range(be1))
    return occ2bin, bin2mean


def bloom_bytes(count: int, nh: int) -> tuple[int, int]:
    """Bytes of the (main, back) filter of a pair holding ``count`` k-mers;
    at least one byte each."""
    return (max(int(float(count) / 5.5 * (nh - 1)), 1),
            max((count >> 3) * (nh - 2), 1))


def hash_positions(v: torch.Tensor, length: int, seeds, nbits: int):
    """[n, len(seeds)] bit positions of the strings of ``v``."""
    out = torch.empty((v.numel(), len(seeds)), dtype=torch.int64,
                      device=v.device)
    for a in range(0, v.numel(), _CHUNK):
        prep = murmur.murmur_prepare(v[a : a + _CHUNK], length)
        for j, s in enumerate(seeds):
            out[a : a + _CHUNK, j] = murmur.umod(murmur.murmur_eval(prep, s),
                                                 nbits)
    return out


def pack_bits(bits: torch.Tensor) -> np.ndarray:
    """Bool bits (length a multiple of 8) as bytes, first bit highest."""
    b = bits.reshape(-1, 8).to(torch.int32)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=bits.device)
    return (b * w).sum(1).to(torch.uint8).cpu().numpy()


@dataclasses.dataclass
class RefModel:
    k: int
    nh: int
    nb: int
    ci: int
    cs: int
    bf_num: int
    occ2bin: torch.Tensor
    bin2mean: torch.Tensor
    bf: list          # per pair, bool bits of the main filter
    bf_back: list     # per pair, bool bits of the back filter
    km_back: torch.Tensor
    bit1: torch.Tensor  # [nb, km_bit_size] bool
    bit2: torch.Tensor
    rest_kmers: torch.Tensor  # ascending (a key may repeat)
    rest_counts: torch.Tensor
    files: dict       # name -> bytes

    @property
    def pre_len(self) -> int:
        return rest_prefix_len(self.k)


def rest_prefix_len(k: int) -> int:
    for p in range(7, 2, -1):
        if (k - p) % 4 == 0:
            return p
    raise ValueError(f"no rest-store prefix length for k={k}")


class _Encoder:
    """The coupled arrays and their bucket schedule (see the module text)."""

    def __init__(self, kmers, bins, k, nh, nb, bits, back_bits, device):
        self.nh, self.nb, self.bits = nh, nb, bits
        self.kmers, self.bins = kmers, bins
        n = kmers.numel()
        seeds = [murmur.SEEDS[(a * nh + j) % 128]
                 for a in range(nb) for j in range(nh)]
        self.pos = hash_positions(kmers, k, seeds, bits).view(n, nb, nh)
        self.bit1 = torch.zeros((nb, bits), dtype=torch.bool, device=device)
        self.bit2 = torch.zeros((nb, bits), dtype=torch.bool, device=device)
        self.first = torch.full((bits,), 1 << 62, dtype=torch.int64,
                                device=device)
        self.inserted = torch.zeros(n, dtype=torch.bool, device=device)
        self.slot = torch.full((nb, BUCKET_SIZE), -1, dtype=torch.int64,
                               device=device)
        self.live = torch.zeros((nb, BUCKET_SIZE), dtype=torch.bool,
                                device=device)
        self.rest: list[torch.Tensor] = []
        self.jbits = torch.arange(nh, device=device)

    def _insert(self, array: int, idx: torch.Tensor) -> torch.Tensor:
        """Insert k-mers ``idx`` in this order into ``array``; which went in."""
        n, nh = idx.numel(), self.nh
        P = self.pos[idx, array]                              # [n, nh]
        want = ((self.bins[idx, None] >> self.jbits) & 1).bool()
        b1, b2 = self.bit1[array], self.bit2[array]
        ok = torch.zeros(n, dtype=torch.bool, device=idx.device)
        pending = torch.arange(n, device=idx.device)
        while pending.numel():
            pp = P[pending]
            flat = pp.reshape(-1)
            self.first.scatter_reduce_(0, flat, pending.repeat_interleave(nh),
                                       "amin")
            ready = (self.first[pp] == pending[:, None]).all(1)
            self.first[flat] = 1 << 62
            r, pr, wr = pending[ready], pp[ready], want[pending[ready]]
            good = ~(b2[pr] & (b1[pr] != wr)).any(1)
            gp, gw = pr[good], wr[good]
            b1[gp[gw]] = True
            b2[gp.reshape(-1)] = True
            ok[r[good]] = True
            pending = pending[~ready]
        return ok

    def _round(self, bucket: int, array: int, n: int) -> int:
        live = self.live[bucket]
        if n == 0:
            return int(live[0])
        idx = self.slot[bucket, :n]
        ok = self._insert(array, idx)
        self.inserted[idx[ok]] = True
        live[:n] &= ~ok
        m = int(live[:n].sum())
        holes = torch.nonzero(~live[:m])[:, 0]
        movers = torch.nonzero(live[m:n])[:, 0].flip(0) + m
        self.slot[bucket, holes] = self.slot[bucket, movers]
        live[holes] = True
        live[movers] = False
        return m

    def _flush(self, n: list[int]) -> None:
        for t in range(self.nb):
            for i in range(self.nb):
                n[i] = self._round(i, (i + t) % self.nb, n[i])
        for i in range(self.nb):
            self.rest.append(self.slot[i, : n[i]].clone())

    def run(self) -> None:
        N, nb, bs = self.kmers.numel(), self.nb, BUCKET_SIZE
        cap = nb * bs
        dev = self.slot.device
        full = N // cap
        for c in range(full):
            self.slot.copy_(torch.arange(c * cap, (c + 1) * cap,
                                         device=dev).view(nb, bs))
            self.live.fill_(True)
            self._flush([bs] * nb)
        r = N - full * cap
        row, col = ((r - 1) // bs, (r - 1) % bs) if r else (0, -1)
        base = full * cap
        for i in range(row):
            self.slot[i] = base + i * bs + torch.arange(bs, device=dev)
            self.live[i] = True
        self.slot[row, : col + 1] = base + row * bs + torch.arange(col + 1,
                                                                  device=dev)
        self.live[row, : col + 1] = True
        self._flush([bs] * row + [col + 1] + [0] * (nb - row - 1))


def build(kmers: torch.Tensor, counts: torch.Tensor, k: int, ci: int,
          cs: int, nh: int, nb: int) -> RefModel:
    """The model of a table (int64 k-mers ascending, counts in [ci, cs])."""
    if not 3 <= k <= 31:
        raise ValueError(f"k must be 3..31, got {k}")
    dev = kmers.device
    bf_num = 1 if ci == 1 else 3
    o2b, b2m = occu_bin(cs + 1, nh)
    occ2bin = torch.tensor(o2b, dtype=torch.int64, device=dev)
    bin2mean = torch.tensor(b2m, dtype=torch.int64, device=dev)
    counts = counts.to(torch.int64)

    low_counts = [int((counts == ci + i).sum()) for i in range(bf_num)]
    bf, bf_back, bf_bytes = [], [], []
    for i in range(bf_num):
        nbytes, nback = bloom_bytes(low_counts[i], nh)
        keys = kmers[counts == ci + i]
        main = torch.zeros(8 * nbytes, dtype=torch.bool, device=dev)
        main[hash_positions(keys, k, murmur.SEEDS[: nh - 1], 8 * nbytes)
             .reshape(-1)] = True
        back = torch.zeros(8 * nback, dtype=torch.bool, device=dev)
        back[hash_positions(murmur.middle(keys, k), k - 2,
                            murmur.SEEDS[: nh - 2], 8 * nback)
             .reshape(-1)] = True
        bf.append(main)
        bf_back.append(back)
        bf_bytes += [pack_bits(main), pack_bits(back)]

    arr = counts >= ci + bf_num
    ak, ao = kmers[arr], counts[arr]
    km_count = int(ak.numel())
    unit = max(km_count, 16) >> 4
    km_bits, back_bits = 8 * unit * nh, 8 * unit * (nh - 2)
    enc = _Encoder(ak, occ2bin[ao], k, nh, nb, km_bits, back_bits, dev)
    enc.run()
    km_back = torch.zeros(back_bits, dtype=torch.bool, device=dev)
    km_back[hash_positions(murmur.middle(ak[enc.inserted], k), k - 2,
                           murmur.SEEDS[: nh - 2], back_bits)
            .reshape(-1)] = True
    rest_idx = (torch.cat(enc.rest) if enc.rest
                else torch.zeros(0, dtype=torch.int64, device=dev))
    rk, rc = ak[rest_idx], ao[rest_idx]
    order = torch.sort(rk, stable=True).indices
    rk, rc = rk[order], rc[order]

    km_bin = [np.array([km_count] + low_counts, dtype="<u8").tobytes()]
    km_bin += [b.tobytes() for b in bf_bytes]
    km_bin.append(pack_bits(km_back).tobytes())
    for a in range(nb):
        km_bin += [pack_bits(enc.bit1[a]).tobytes(),
                   pack_bits(enc.bit2[a]).tobytes()]
    files = {
        "header": (f"number_hash {nh}\nnumber_bit {nb}\nci {ci}\n"
                   f"cs {cs}\n").encode(),
        "km.bin": b"".join(km_bin),
        "rest.bin": rest_bin(rk, rc, k),
    }
    return RefModel(k, nh, nb, ci, cs, bf_num, occ2bin, bin2mean, bf,
                    bf_back, km_back, enc.bit1, enc.bit2, rk, rc, files)


def rest_bin(rk: torch.Tensor, rc: torch.Tensor, k: int) -> bytes:
    """The rest store's file: header ints, ``hash2index``, ``pre_buffer``,
    suffix bytes and counts."""
    p = rest_prefix_len(k)
    suf = k - p
    group = suf // 4
    map_size = 1 << (2 * p)
    keys = rk.cpu().numpy().astype(np.uint64)
    prefix = (keys >> np.uint64(2 * suf)).astype(np.int64)
    per = np.bincount(prefix, minlength=map_size)
    nonempty = per > 0
    h2i = np.full(map_size, -1, dtype="<i4")
    h2i[nonempty] = np.arange(int(nonempty.sum()))
    pre = np.zeros(int(nonempty.sum()) + 1, dtype="<i4")
    pre[1:] = np.cumsum(per[nonempty])
    sfx = keys & np.uint64((1 << (2 * suf)) - 1)
    sb = np.empty((len(keys), group), dtype=np.uint8)
    for j in range(group):
        sb[:, j] = (sfx >> np.uint64(8 * (group - 1 - j))) & np.uint64(255)
    return b"".join([
        np.array([k, p, map_size, len(pre)], dtype="<i4").tobytes(),
        np.array([len(keys) * group, len(keys)], dtype="<u8").tobytes(),
        h2i.tobytes(), pre.tobytes(), sb.tobytes(),
        rc.cpu().numpy().astype("<i4").tobytes(),
    ])
