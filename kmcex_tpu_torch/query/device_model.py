"""DeviceKModel — the KModel resident in device memory with a fully batched
``kmer_to_occ``.

This is the serving path (the reference's OpenMP query fan-out,
kmodel.hpp:90-98), the counterpart of the JAX package's
``query/device_model.py`` in PyTorch: every stage of the query decision tree
— exact rest-store lookup, back-filter membership, Bloom bank probes,
coupled bit-array probes, and the 8-neighbour disambiguation
(kmodel.hpp:100-116,286-359) — is computed for a whole tile of queries with
gathers and combined with masks.  No data-dependent control flow inside a
pass.

All hash probes are MurmurHash64A over the ASCII k-mer bytes (regenerated on
the device from the packed form) with the reference seed schedule, so the
answers equal ``KModel.kmer_to_occ_u64`` on every query, the rest store's
inclusive-high quirk included.

Two passes, as in the JAX module: the main pass answers every query and
marks the ambiguous ones; the resolve pass, which probes the 8 neighbours of
each k-mer and so costs about nine main passes a query, runs for the
ambiguous survivors only.

Left out of the JAX module, on purpose:

  * the 3/4-tile gate of the coupled-array probe with its host re-dispatch,
    the 16-bit answers and the bit-packed ambiguity mask: all three exist to
    spare a slow host link and a compiler that wants one fixed shape.  The
    main pass here is the JAX module's ungated program
    (``_build_main(gated=False)``), and the ambiguous queries are selected
    on the device and resolved there without a round trip;
  * fixed tile shapes and the zero padding of a short tile: torch runs
    eagerly, so a short tile is just a shorter tensor.  ``TILE``, ``GROUP``
    and ``RESOLVE_TILE`` stay as bounds on device memory;
  * ``sharding`` / ``in_sharding``: the multi-device server
    (``parallel/serve.py``) holds one ``DeviceKModel`` per device and
    slices the batch itself.
"""

from __future__ import annotations

import numpy as np
import torch

from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.core.murmur import (
    HASH_SEEDS,
    _signed,
    murmur_eval,
    murmur_pre,
    seeds_tensor,
)
from kmcex_tpu_torch.model.kmodel import KModel
from kmcex_tpu_torch.utils.device import resolve_device

_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)  # no canonical k-mer is all-ones


def _cuckoo_hashes(keys: np.ndarray, m1: int, m2: int, bits: int):
    with np.errstate(over="ignore"):
        h1 = (keys * np.uint64(m1)) >> np.uint64(64 - bits)
        h2 = (keys * np.uint64(m2)) >> np.uint64(64 - bits)
    return h1.astype(np.int64), h2.astype(np.int64)


def _build_cuckoo(keys: np.ndarray, vals: np.ndarray, seed: int = 0):
    """Two-table cuckoo hash of an exact (u64 key -> i32 value) map.

    Cuckoo guarantees each key sits in one of exactly TWO slots, so the
    lookup is 2 independent key gathers + 2 value gathers with no serial
    search chain.  Build is vectorized numpy (eviction rounds); load factor
    <=0.45 converges in a few dozen rounds, else rehash with fresh
    multipliers.  A copy of the JAX package's ``_build_cuckoo``: the same keys
    and seed give the same tables and multipliers."""
    n = len(keys)
    bits = max(4, int(np.ceil(np.log2(max(n * 1.1, 8)))))
    rng = np.random.default_rng(seed)
    for _attempt in range(16):
        S = 1 << bits
        m1 = int(rng.integers(1, 1 << 63)) * 2 + 1
        m2 = int(rng.integers(1, 1 << 63)) * 2 + 1
        t_k = [np.full(S, _EMPTY, np.uint64) for _ in range(2)]
        t_v = [np.zeros(S, np.int32) for _ in range(2)]
        cur_k, cur_v = keys.copy(), vals.copy()
        side = 0
        for _round in range(96):
            if not len(cur_k):
                break
            h1, h2 = _cuckoo_hashes(cur_k, m1, m2, bits)
            idx = h1 if side == 0 else h2
            tk, tv = t_k[side], t_v[side]
            uslots = np.unique(idx)
            orig_k = tk[uslots].copy()
            orig_v = tv[uslots].copy()
            tk[idx] = cur_k
            tv[idx] = cur_v
            placed = tk[idx] == cur_k
            changed = orig_k != tk[uslots]
            evict = changed & (orig_k != _EMPTY)
            cur_k = np.concatenate([cur_k[~placed], orig_k[evict]])
            cur_v = np.concatenate([cur_v[~placed], orig_v[evict]])
            side ^= 1
        else:
            bits += 1  # didn't converge: bigger tables, new multipliers
            continue
        return t_k[0], t_v[0], t_k[1], t_v[1], m1, m2, bits
    raise RuntimeError("cuckoo build failed to converge")


def _seed_matrix(n_bits: int, n_hash: int) -> np.ndarray:
    """seeds[i, j] = HashSeeds[(i*n_hash + j) % 128] (kmodel.hpp:450-453)."""
    idx = (np.arange(n_bits)[:, None] * n_hash + np.arange(n_hash)[None, :]) % 128
    return HASH_SEEDS[idx]


def _gather_bits(bits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MSB-first bit gather from a uint8 tensor (kmodel.hpp:584-588)."""
    shift = (7 - (pos & 7)).to(torch.uint8)
    return (bits[pos >> 3] >> shift) & 1


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1, keepdim=True)


class DeviceKModel:
    """Immutable device copy of a built/loaded KModel + batched query.
    ``device=None`` means the GPU and raises without one."""

    # Queries per main pass: the probe tensors scale with N x n_bits x
    # n_hash int64, about 3 KB a query while a pass runs.  A pass is ~450
    # small launches whatever its size, so a tile of 2^16 is bound by the
    # launches and one of 2^20 by its kernels
    # (kmcex_tpu_torch/tools/time_query.py).
    TILE = 1 << 20
    # Tiles uploaded, answered and downloaded together: bounds the device
    # and pinned memory a huge batch takes.
    GROUP = 64
    # Ambiguous queries per resolve pass (each brings 8 neighbours).
    RESOLVE_TILE = 1 << 15

    def __init__(self, km: KModel, device=None):
        self.device = dev = resolve_device(device)
        self.k = km.kmer_length
        self.n_hash = km.n_hash
        self.n_bits = km.n_bits
        self.ci = km.ci
        self.cs = km.cs
        self.bf_num = km.bf_num
        self.probe_order = km.bloom.probe_order
        self.bf_num_hash = km.bf_num_hash
        self.bf_back_num_hash = km.bf_back_num_hash
        self.km_back_num_hash = km.km_back_num_hash
        self.bin_end_index1 = km.occu_bin.bin_end_index1

        def put(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        # Bloom bank (zero-length filters stay host-side as static facts)
        self.bf_bits = [put(b) if len(b) else None for b in km.bloom.bit_bf]
        self.bf_back_bits = [put(b) if len(b) else None
                             for b in km.bloom.bit_bf_back]
        self.bf_len = [int(x) for x in km.bloom.length_bf]
        self.bf_back_len = [int(x) for x in km.bloom.length_bf_back]

        # coupled arrays + km_back.  bit1/bit2 are interleaved into one
        # 16-bit plane (low byte bit1, high byte bit2; int16 holds the
        # pattern) so each probe needs ONE gather for both the value bit and
        # the tag bit.  Stored flat, indexed as array * bytes + byte.
        self.bit12 = put((km.bit1.astype(np.uint16)
                          | (km.bit2.astype(np.uint16) << 8))
                         .reshape(-1).view(np.int16))
        self.km_bit_size = int(km.km_bit_size)
        self.km_back = put(km.km_back) if km.byte_km_back else None
        self.bit_km_back = int(km.bit_km_back)
        seed_flat = _seed_matrix(self.n_bits, self.n_hash).reshape(-1)
        # shared hash-state seed vectors: ONE murmur precompute + eval per
        # distinct string serves every probe family.  h_k = k-mer hashes for
        # (BF main ++ bit arrays); h_m = middle-(k-2)-mer hashes for
        # (km_back ++ BF back).
        self._seeds_k = seeds_tensor(
            np.concatenate([HASH_SEEDS[: self.bf_num_hash], seed_flat]), dev)
        n_seeds_m = max(self.bf_back_num_hash, self.km_back_num_hash)
        self._seeds_m = seeds_tensor(HASH_SEEDS[:n_seeds_m], dev)
        self._array_base = (torch.arange(self.n_bits, dtype=torch.int64,
                                         device=dev)[:, None]
                            * (self.km_bit_size >> 3))
        self._bin_weights = 1 << torch.arange(self.n_hash, dtype=torch.int64,
                                              device=dev)
        # the 4 bases in the lowest and in the highest pair of a k-mer
        # (shifted in NumPy: base << 62 reaches the sign bit at k = 32)
        bases = np.arange(4, dtype=np.uint64)
        self._bases_lo = put(bases.view(np.int64))
        self._bases_hi = put((bases << np.uint64(2 * (self.k - 1)))
                             .view(np.int64))

        # rest store: exact lookups go through a 2-table cuckoo hash.  The
        # table holds the real entries PLUS one "phantom" entry per bucket
        # boundary reproducing the reference's inclusive-high quirk
        # (rest.hpp:236-247: a key above its whole bucket that equals the
        # NEXT bucket's first suffix hits with that bucket's count) — so
        # answers stay identical to the host path, quirk included.
        kld = km.kld
        self.rest_n = kld.suffix_bin_count
        if self.rest_n:
            full = kld._full_kmer_sorted()
            counts = kld.count_bin.astype(np.int32)
            suf_bits = 2 * kld.suf_len
            suffix = kld._ensure_suffix_int()
            pre = kld.pre_buffer.astype(np.int64)
            p_all = np.flatnonzero(kld.hash2index >= 0).astype(np.uint64)
            pi = kld.hash2index[p_all.astype(np.int64)]
            lo = pre[pi]
            hi = pre[pi + 1]
            ok = hi < self.rest_n
            prev_s = suffix[np.maximum(hi - 1, 0)]
            above = (lo == hi) | (suffix[np.minimum(hi, self.rest_n - 1)]
                                  > prev_s)
            pm = ok & above
            phantom_k = ((p_all[pm] << np.uint64(suf_bits))
                         | suffix[hi[pm]])
            phantom_v = counts[hi[pm]]
            keys = np.concatenate([full, phantom_k])
            vals = np.concatenate([counts, phantom_v])
            t1k, t1v, t2k, t2v, m1, m2, bits = _build_cuckoo(keys, vals)
            # _EMPTY (all ones) is -1 as int64, which no canonical k-mer is
            self.rest_t1k = put(t1k.view(np.int64))
            self.rest_t1v = put(t1v)
            self.rest_t2k = put(t2k.view(np.int64))
            self.rest_t2v = put(t2v)
            self.rest_m1 = _signed(m1)
            self.rest_m2 = _signed(m2)
            self.rest_bits = int(bits)
        # occ decode LUTs
        self.bin2mean = put(km.occu_bin.bin2mean_lut.astype(np.int32))
        self.occ2bin = put(km.occu_bin.occ2bin_lut.astype(np.int32))
        # ambiguous queries the resolve pass took in the last kmer_to_occ
        self.n_resolved = 0

    def device_bytes(self) -> int:
        """Bytes of device memory the model's tables hold."""
        held = [t for v in vars(self).values()
                for t in (v if isinstance(v, list) else [v])
                if isinstance(t, torch.Tensor)]
        return sum(t.numel() * t.element_size() for t in held)

    # -- probe primitives ---------------------------------------------------
    def _middle(self, kmers):
        return codec.middle_kmer(kmers, self.k)

    def _hash_state(self, kmers):
        """Shared murmur state for one batch of canonical k-mers:
        (h_k [..., bf_num_hash + nb*nh], h_m [..., n_seeds_m]).  One ASCII
        regeneration + precompute + eval per distinct string; every probe
        family below takes positions as (h mod its table length)."""
        bl, tl = murmur_pre(codec.ascii_bytes(kmers, self.k))
        h_k = murmur_eval(bl, tl, self.k, self._seeds_k)
        blm, tlm = murmur_pre(codec.ascii_bytes(self._middle(kmers),
                                                self.k - 2))
        h_m = murmur_eval(blm, tlm, self.k - 2, self._seeds_m)
        return h_k, h_m

    def _check_back(self, kmers, h_m):
        """check_back_bloomfilter over km_back (kmodel.hpp:107)."""
        if self.km_back is None:
            return torch.zeros(kmers.shape, dtype=torch.bool,
                               device=kmers.device)
        pos = codec.umod(h_m[..., : self.km_back_num_hash], self.bit_km_back)
        return (_gather_bits(self.km_back, pos) == 1).all(dim=-1)

    def _check_all_bf(self, kmers, h_k, h_m):
        """check_all_bf (kmodel.hpp:361-371): first hit in probe order."""
        occ = torch.zeros(kmers.shape, dtype=torch.int32, device=kmers.device)
        for i in self.probe_order:
            if (self.bf_bits[i] is None or self.bf_len[i] == 0
                    or self.bf_back_bits[i] is None
                    or self.bf_back_len[i] == 0):
                continue  # an empty filter of the pair never hits
            pos = codec.umod(h_k[..., : self.bf_num_hash], self.bf_len[i])
            main = (_gather_bits(self.bf_bits[i], pos) == 1).all(dim=-1)
            pos = codec.umod(h_m[..., : self.bf_back_num_hash],
                             self.bf_back_len[i])
            back = (_gather_bits(self.bf_back_bits[i], pos) == 1).all(dim=-1)
            hit = main & back & (occ == 0)
            occ = torch.where(hit, i + self.ci, occ)
        return occ

    def _find_bitarray(self, kmers, h_k):
        """[..., n_bits] decoded bins (int64), -1 where tags miss
        (kmodel.hpp:625-646)."""
        pos = codec.umod(h_k[..., self.bf_num_hash :], self.km_bit_size)
        pos = pos.reshape(kmers.shape + (self.n_bits, self.n_hash))
        shift = 7 - (pos & 7)
        # one FLAT gather: low byte bit1, high byte bit2
        w = self.bit12[self._array_base + (pos >> 3)].to(torch.int64)
        v1 = (w >> shift) & 1
        v2 = (w >> (shift + 8)) & 1
        ok = (v2 == 1).all(dim=-1)
        bins = (v1 * self._bin_weights).sum(dim=-1)
        return torch.where(ok, bins, -1)

    def _check_rest(self, kmers):
        """Exact lookup via the 2-table cuckoo hash: 2 independent key
        gathers + 2 value gathers.  The index is (key * m) >> (64 - bits) on
        unsigned 64-bit values: a wrapping int64 multiply and a logical
        shift.  The phantom entries added at build time reproduce the
        reference's inclusive-high quirk exactly (rest.hpp:223-251)."""
        if self.rest_n == 0:
            return torch.zeros(kmers.shape, dtype=torch.int32,
                               device=kmers.device)
        sh = 64 - self.rest_bits
        i1 = codec._srl(kmers * self.rest_m1, sh)
        i2 = codec._srl(kmers * self.rest_m2, sh)
        hit1 = self.rest_t1k[i1] == kmers
        hit2 = self.rest_t2k[i2] == kmers
        return torch.where(hit1, self.rest_t1v[i1],
                           torch.where(hit2, self.rest_t2v[i2], 0))

    # -- the full decision tree --------------------------------------------
    def _neighbor_candidates(self, kmers):
        """get_neighbor_kmer_bin (kmodel.hpp:326-359): values + validity for
        the 8 shift neighbours of each k-mer."""
        k = self.k
        mask2k = (1 << (2 * k)) - 1 if k < 32 else -1
        fwd = ((kmers[..., None] << 2) & mask2k) | self._bases_lo
        bwd = codec._srl(kmers[..., None], 2) | self._bases_hi
        neigh = codec.canonical(torch.cat([fwd, bwd], dim=-1), k)  # [..., 8]

        rest_c = self._check_rest(neigh)
        rest_hit = rest_c > 0
        rest_val = self.occ2bin[rest_c.clamp(0, self.occ2bin.shape[0] - 1)
                                .to(torch.int64)]

        h_k, h_m = self._hash_state(neigh)
        bf = self._check_all_bf(neigh, h_k, h_m)
        bf_hit = bf != 0

        back = self._check_back(neigh, h_m)
        B = self._find_bitarray(neigh, h_k)  # [..., 8, nb]
        ok = B != -1
        any_ok = ok.any(dim=-1)
        nz = ok & (B != 0)
        first_nz = torch.gather(B, -1, _first_true(nz))[..., 0]
        one_val = torch.where(nz.any(dim=-1), first_nz, 0)
        one_hit = back & any_ok

        vals = torch.where(rest_hit, rest_val.to(torch.int64),
                           torch.where(bf_hit, bf.to(torch.int64), one_val))
        valid = rest_hit | bf_hit | one_hit
        return vals, valid

    def _decode_bin(self, bin_val):
        """OccuBin bin -> approximate count (identity below bin_end_index1)."""
        mean = self.bin2mean[bin_val.clamp(0, self.bin2mean.shape[0] - 1)]
        return torch.where(bin_val < self.bin_end_index1, bin_val,
                           mean.to(torch.int64))

    def _bins_of(self, kmers, h_k):
        """(B, pos_mask, nbin, first_bin) of the coupled-array probe: only
        bins > 0 enter v_bin (kmodel.hpp:641)."""
        B = self._find_bitarray(kmers, h_k)
        pos_mask = B > 0
        nbin = pos_mask.sum(dim=-1)
        first_bin = torch.where(
            nbin > 0, torch.gather(B, -1, _first_true(pos_mask))[..., 0], 0)
        return B, pos_mask, nbin, first_bin

    def _main(self, kmers: torch.Tensor):
        """Pass 1 (runs for every query): everything except the 8-neighbour
        disambiguation.  kmers: int64 [N] on the model's device, any
        orientation.  Returns (answers int32 [N], final wherever the
        neighbours are not needed; ambiguous bool [N])."""
        kmers = codec.canonical(kmers, self.k)
        rest_occ = self._check_rest(kmers)
        h_k, h_m = self._hash_state(kmers)
        is_back = self._check_back(kmers, h_m)
        bf_occ = self._check_all_bf(kmers, h_k, h_m)
        _, _, nbin, first_bin = self._bins_of(kmers, h_k)

        # kmer_to_bin without candidates (kmodel.hpp:286-302):
        # len==0 -> occ; len==1 & occ==0 -> first_bin; rest = ambiguous.
        bin_val = torch.where(nbin == 0, bf_occ.to(torch.int64), first_bin)
        bit_path = self._decode_bin(bin_val).to(torch.int32)
        out = torch.where(rest_occ != 0, rest_occ,
                          torch.where(is_back, bit_path, bf_occ))
        ambiguous = ((rest_occ == 0) & is_back
                     & (((nbin == 1) & (bf_occ != 0)) | (nbin >= 2)))
        return out, ambiguous

    def _resolve(self, kmers: torch.Tensor) -> torch.Tensor:
        """Pass 2 (ambiguous queries only): neighbour candidates + the
        reference's majority / nearest-bin rules (kmodel.hpp:292-322).
        Recomputes the probe state of its k-mers.  Returns int32 answers."""
        kmers = codec.canonical(kmers, self.k)
        h_k, h_m = self._hash_state(kmers)
        B, pos_mask, nbin, first_bin = self._bins_of(kmers, h_k)
        bf_occ = self._check_all_bf(kmers, h_k, h_m).to(torch.int64)
        cand_vals, cand_valid = self._neighbor_candidates(kmers)
        n_cand = cand_valid.sum(dim=-1)
        cnt_bf = (cand_valid & (cand_vals < self.ci + self.bf_num)).sum(dim=-1)
        # "if (cnt_bf >= v_candidates.size() / 2) return occ": integer
        # division; an empty candidate set satisfies 0 >= 0
        take_occ1 = (nbin == 1) & (bf_occ != 0) & (cnt_bf >= n_cand // 2)
        big = 1 << 21
        dist = (B[..., :, None] - cand_vals[..., None, :]).abs()
        dist = torch.where(cand_valid[..., None, :], dist, big)
        cur_min = dist.min(dim=-1).values
        cur_min = torch.where(pos_mask, cur_min, 2 * big)
        # the reference keeps the FIRST bin on ties; argmin returns the
        # first minimum
        best_multi = torch.gather(
            B, -1, torch.argmin(cur_min, dim=-1, keepdim=True))[..., 0]
        best_multi = torch.where(n_cand > 0, best_multi, 0)
        bin_val = torch.where(
            nbin == 1, torch.where(take_occ1, bf_occ, first_bin), best_multi)
        return self._decode_bin(bin_val).to(torch.int32)

    def query_tensor(self, q: torch.Tensor, tile: int | None = None):
        """Both passes on device-resident queries: q int64 [n] on the
        model's device -> int32 [n] answers on the device.  The main pass
        runs in ``tile``-sized steps; the ambiguous survivors are selected
        on the device and resolved in RESOLVE_TILE-sized steps."""
        tile = tile or self.TILE
        n = q.numel()
        out = torch.empty(n, dtype=torch.int32, device=q.device)
        amb = torch.empty(n, dtype=torch.bool, device=q.device)
        for a in range(0, n, tile):
            out[a : a + tile], amb[a : a + tile] = self._main(q[a : a + tile])
        idx = amb.nonzero()[:, 0]  # one sync: how many to resolve
        self.n_resolved += idx.numel()
        for a in range(0, idx.numel(), self.RESOLVE_TILE):
            sel = idx[a : a + self.RESOLVE_TILE]
            out[sel] = self._resolve(q[sel])
        return out

    def kmer_to_occ(self, kmers_u64, tile: int | None = None) -> np.ndarray:
        """Batched query; input packed uint64 (NumPy, any shape),
        canonicalized on the device; int32 answers of the same shape.

        Arbitrarily large batches run in groups of GROUP tiles: one upload,
        the two passes of ``query_tensor``, one download per group."""
        qa = np.asarray(kmers_u64, dtype=np.uint64)
        q = np.ascontiguousarray(qa.reshape(-1)).view(np.int64)
        tile = tile or self.TILE
        out = np.zeros(len(q), dtype=np.int32)
        self.n_resolved = 0
        step = tile * self.GROUP
        for a in range(0, len(q), step):
            qd = torch.from_numpy(q[a : a + step]).to(self.device)
            out[a : a + step] = self.query_tensor(qd, tile).cpu().numpy()
        return out.reshape(qa.shape)
