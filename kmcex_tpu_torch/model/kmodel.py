"""KModel — the coupled-bit-array k-mer frequency encoding.

Copy of the JAX package's ``model/kmodel.py``, a rebuild of the reference
model layer (kmodel.hpp:39-696): a two-pass build over a (k-mer, count) listing routes
each k-mer by count — low counts (counter < ci + bf_num) into the Bloom
bank, the rest through the coupled bit arrays with overflow into the exact
rest store — then serializes to the reference's ``header`` / ``km.bin`` /
``rest.bin`` layout.  The listing order is ascending packed k-mer value
(== KMC1 database order).  The Bloom bank is filled by the host insert or
from a ``model.device_bloom.DeviceBloomBuilder``.  Queries are batched
(NumPy + the native probes here, ``query.device_model`` on the device);
scalar string queries keep the reference API shape.  ``init`` builds from a
KMC database on disk through ``io.kmc_db.KMCReader``.
"""

from __future__ import annotations

import os
import pathlib
import queue
import threading
import time
import typing

import numpy as np

from kmcex_tpu_torch import native
from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.core.occu_bin import OccuBin
from kmcex_tpu_torch.model.bloom import BloomBank
from kmcex_tpu_torch.model.rest import KRestData

_U64 = np.uint64

BUCKET_SIZE = 1 << 18  # reference km insertion bucket (kmodel.hpp:276)


def _bloom_threads() -> int:
    """OMP team size for the streaming encode's Bloom worker.  It runs
    concurrently with the array feed (main thread) and the chunk-decode
    producer, so the default all-cores team oversubscribes the host; one
    thread measures best on the 2-core bench rig."""
    return int(os.environ.get("KMCEX_BLOOM_THREADS", "1"))


class PreSplitChunk(typing.NamedTuple):
    """A chunk already routed by counter (see split_chunk): the producer
    thread pays the numpy masking cost so the encode thread only feeds."""

    arr_kmers: np.ndarray
    arr_counts: np.ndarray
    lows: tuple  # bf_num arrays: k-mers with counter == ci + i


def split_chunk(kmers_u64: np.ndarray, counts: np.ndarray, ci: int,
                bf_num: int) -> PreSplitChunk:
    """Route one (kmers, counts) chunk by counter (kmodel.hpp:68-74's
    per-record branch, vectorized): low counters to the Bloom bank, the
    rest to the coupled arrays."""
    kmers_u64 = np.ascontiguousarray(kmers_u64, dtype=_U64)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    low_mask = counts < ci + bf_num
    lows = tuple(kmers_u64[counts == ci + i] for i in range(bf_num))
    return PreSplitChunk(kmers_u64[~low_mask], counts[~low_mask], lows)


class _BloomWorker:
    """The host Bloom insert on its own thread, fed through a bounded
    queue.  A raised insert must not kill the thread silently: the bounded
    queue would deadlock the producer and a "successful" build would miss
    inserts.  On failure the worker keeps draining (so ``put`` never
    blocks) and ``error`` holds what was raised, for the build thread to
    re-raise after ``join``."""

    def __init__(self, bloom: BloomBank, k: int):
        self.error: BaseException | None = None
        self._busy = 0.0
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self._thread = threading.Thread(target=self._run, args=(bloom, k),
                                        daemon=True)
        self._thread.start()

    def _run(self, bloom: BloomBank, k: int) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            if self.error is not None:
                continue  # drain so the producer never blocks
            i, kmers = item
            t = time.time()
            try:
                bloom.insert(i, kmers, k, n_threads=_bloom_threads())
            except BaseException as e:  # noqa: BLE001 — re-raised by the build
                self.error = e
            self._busy += time.time() - t

    def put(self, i: int, kmers: np.ndarray) -> None:
        self._q.put((i, kmers))

    def join(self) -> float:
        """Stop the worker; returns the seconds it spent inserting."""
        self._q.put(None)
        self._thread.join()
        return self._busy


class KModel:
    def __init__(self, occu_bin: OccuBin, n_bits: int, ci: int):
        self.occu_bin = occu_bin
        self.n_bits = int(n_bits)
        self.ci = int(ci)
        self.cs = occu_bin.get_max_counter() - 1
        self.bf_num = 1 if ci == 1 else 3
        self.n_hash = occu_bin.get_hash_number()
        self.km_back_num_hash = self.n_hash - 2
        self.bf_num_hash = self.n_hash - 1
        self.bf_back_num_hash = self.n_hash - 2

        self.kmer_length = 0
        self.total_kmer_count = 0
        self.km_kmercount = 0
        self.build_time_cost = 0.0

        self.bloom: BloomBank | None = None
        self.kld: KRestData | None = None
        # coupled arrays: [n_bits, km_byte_size] uint8 (contiguous per array)
        self.bit1: np.ndarray | None = None
        self.bit2: np.ndarray | None = None
        self.km_back: np.ndarray | None = None
        self.km_byte_size = 0
        self.km_bit_size = 0
        self.byte_km_back = 0
        self.bit_km_back = 0

    # ------------------------------------------------------------------ build
    def init_from_pairs(self, kmers_u64: np.ndarray, counts: np.ndarray, k: int) -> None:
        """Build the model from a (k-mer, count) listing.

        ``kmers_u64`` must be canonical k-mers in the listing order the model
        should be encoded with (ascending value == KMC1 order for our native
        counter); ``counts`` already clamped to [ci, cs].
        """
        kmers_u64 = np.ascontiguousarray(kmers_u64, dtype=_U64)
        counts = np.ascontiguousarray(counts, dtype=np.uint32)
        # Pass 1 (kmodel.hpp:423-434): histogram of low counters sizes the BFs.
        low_hist = np.zeros(3, dtype=np.uint64)
        for i in range(self.bf_num):
            low_hist[i] = np.count_nonzero(counts == self.ci + i)
        self.init_from_chunks(
            iter([(kmers_u64, counts)]), k, len(kmers_u64), low_hist
        )

    def init_from_chunks(self, chunk_iter, k: int, total_kmer_count: int,
                         low_hist: np.ndarray, device_bloom=None) -> None:
        """Streaming build: ``chunk_iter`` yields (kmers_u64, counts) chunks
        in listing order; ``total_kmer_count`` and ``low_hist`` (counts of
        counter==ci+i for i<3) must cover the whole stream (the reference's
        pass 1, computed on device by the counting pipeline).  Chunked
        feeding is bit-identical to a one-shot build — the encode schedule
        depends only on overall stream order — and lets device->host pulls
        overlap the encode.

        ``device_bloom`` (model.device_bloom.DeviceBloomBuilder, already
        fed with this stream's low-count keys) replaces the host Bloom
        insertion entirely: the finished filter bytes are pulled into the
        bank at the end (order-free scatter-OR makes the result
        bit-identical to the host build), and any low-count pairs still
        present in the chunks are NOT re-inserted."""
        t0 = time.time()
        self.kmer_length = int(k)
        self.total_kmer_count = int(total_kmer_count)
        kmer_counts = np.zeros(3, dtype=np.uint64)
        kmer_counts[: self.bf_num] = low_hist[: self.bf_num]
        self.bloom = BloomBank(kmer_counts, self.n_hash, self.ci)
        self.km_kmercount = self.total_kmer_count - self.bloom.bf_kmercount
        self._init_km_parameter(self.km_kmercount)
        self.kld = KRestData(k)

        ph = self.encode_phases = {
            "chunk_wait": 0.0, "array_feed": 0.0, "array_finish": 0.0,
            "rest_build": 0.0, "route_split": 0.0,
        }
        enc = native.BitArrayEncoder(
            k, self.n_bits, self.n_hash, self.occu_bin.occ2bin_lut,
            self.bit1.reshape(-1), self.bit2.reshape(-1), self.km_bit_size,
            self.km_back, self.bit_km_back, self.km_back_num_hash,
            bucket_size=BUCKET_SIZE,
        )
        if device_bloom is not None:
            rest_kmers, rest_occs = self._init_from_chunks_device_bloom(
                chunk_iter, enc, device_bloom, ph)
        else:
            # Pass 2: route. BF inserts are commutative scatter-ORs —
            # order-free, so they run on a worker thread (the native insert
            # releases the GIL) overlapping the order-dependent
            # coupled-array feed on this thread.
            worker = _BloomWorker(self.bloom, k)
            try:
                rest_kmers, rest_occs = self._feed_arrays(
                    chunk_iter, enc, ph, worker.put)
            finally:
                ph["bloom_insert"] = worker.join()
            if worker.error is not None:
                raise worker.error
        t = time.time()
        if len(rest_kmers):
            self.kld.push_back(rest_kmers, rest_occs)
        self.kld.build()
        ph["rest_build"] = time.time() - t
        self.build_time_cost = time.time() - t0

    def _feed_arrays(self, chunk_iter, enc, ph, put_low):
        """Feed the order-dependent coupled-array encoder from the chunk
        stream; every chunk's low-count k-mers go to ``put_low(i, kmers)``
        (None: they were inserted elsewhere).  Returns the rest pairs."""
        it = iter(chunk_iter)
        while True:
            t = time.time()
            item = next(it, None)
            ph["chunk_wait"] += time.time() - t
            if item is None:
                break
            if isinstance(item, PreSplitChunk):
                sp = item  # routing already paid on the producer thread
            else:
                t = time.time()
                sp = split_chunk(item[0], item[1], self.ci, self.bf_num)
                ph["route_split"] += time.time() - t
            if put_low is not None:
                for i, low in enumerate(sp.lows):
                    put_low(i, low)
            if len(sp.arr_kmers):
                t = time.time()
                enc.feed(sp.arr_kmers, sp.arr_counts)
                ph["array_feed"] += time.time() - t
        t = time.time()
        rest = enc.finish()
        ph["array_finish"] = time.time() - t
        return rest

    def _init_from_chunks_device_bloom(self, chunk_iter, enc, device_bloom,
                                       ph):
        """Encode loop when the Bloom bank was built on the device: no host
        Bloom worker — this thread only feeds the coupled-array encoder, and
        the finished filter bytes are pulled at the end (the copy has been
        in flight since the count finalize)."""
        rest = self._feed_arrays(chunk_iter, enc, ph, None)
        t = time.time()
        device_bloom.into(self.bloom)
        ph["bloom_pull"] = time.time() - t
        return rest

    def init(self, db_path: str) -> None:
        """Build from a KMC database on disk (reference KModel::init,
        kmodel.hpp:57-86); listing order is the database's storage order.

        Streams the database in bounded chunks, twice — exactly the
        reference's two passes (get_km_kmer_count then the encode loop,
        kmodel.hpp:57-86) — so host memory stays flat for genome-scale
        databases (the reference reads 32MB suffix windows,
        kmc_file.cpp:18,605-609)."""
        from kmcex_tpu_torch.io import kmc_db

        db = kmc_db.KMCReader(db_path)
        if db.mode != 0:
            # The reference feeds quake float bits straight into its integer
            # encode path (garbage); reject instead of building a broken model.
            raise ValueError("KModel requires an integer-counter (mode 0) database")
        # Pass 1 (kmodel.hpp:423-434): totals + low-counter histogram.
        total = 0
        low_hist = np.zeros(3, dtype=np.uint64)
        for _, counts in db.list_chunks():
            total += len(counts)
            for i in range(self.bf_num):
                low_hist[i] += np.count_nonzero(counts == self.ci + i)
        # Pass 2: stream the listing through the encoder.
        self.init_from_chunks(db.list_chunks(), db.kmer_length, total, low_hist)

    @classmethod
    def from_arrays(cls, *, n_hash: int, n_bits: int, ci: int, cs: int,
                    kmer_length: int, km_kmercount: int, kmer_counts,
                    bit_bf, bit_bf_back, km_back, bit1, bit2,
                    rest_hash2index, rest_pre_buffer, rest_suffix_bin,
                    rest_count_bin) -> "KModel":
        """A model from its arrays, with no file between: the header fields,
        the Bloom bank's filter bytes, the coupled arrays and the rest
        store's CSR arrays, as NumPy arrays (what ``save`` would write).
        Every array is copied."""
        km = get_model(ci, cs, n_hash, n_bits)
        km.kmer_length = int(kmer_length)
        km.km_kmercount = int(km_kmercount)
        counts = np.zeros(3, dtype=np.uint64)
        counts[: km.bf_num] = np.asarray(kmer_counts, dtype=np.uint64)[: km.bf_num]
        km.bloom = BloomBank(counts, km.n_hash, km.ci)
        for i in range(km.bf_num):
            for dst, src in ((km.bloom.bit_bf, bit_bf),
                             (km.bloom.bit_bf_back, bit_bf_back)):
                a = np.array(src[i], dtype=np.uint8)
                if a.shape != dst[i].shape:
                    raise ValueError(f"filter {i} has {a.shape[0]} bytes, "
                                     f"its count asks for {dst[i].shape[0]}")
                dst[i] = a
        km._init_km_parameter(km.km_kmercount)
        for name, src in (("bit1", bit1), ("bit2", bit2), ("km_back", km_back)):
            a = np.array(src, dtype=np.uint8)
            if a.shape != getattr(km, name).shape:
                raise ValueError(f"{name} has shape {a.shape}, the model "
                                 f"asks for {getattr(km, name).shape}")
            setattr(km, name, a)
        kld = KRestData(km.kmer_length)
        kld.hash2index = np.array(rest_hash2index, dtype=np.int32)
        kld.pre_buffer = np.array(rest_pre_buffer, dtype=np.int32)
        kld.suffix_bin = np.array(rest_suffix_bin, dtype=np.uint8)
        kld.count_bin = np.array(rest_count_bin, dtype=np.int32)
        kld.pre_buffer_size = len(kld.pre_buffer)
        kld.suffix_bin_count = len(kld.count_bin)
        km.kld = kld
        km.total_kmer_count = km.km_kmercount + km.bloom.bf_kmercount
        return km

    def _init_km_parameter(self, km_kmercount: int) -> None:
        # kmodel.hpp:436-456.  (km_kmercount>>4) is clamped to >=1: the
        # reference formula gives 0-byte arrays for <16 k-mers and then
        # SIGFPEs hashing modulo zero; the clamp only changes inputs the
        # reference cannot process (load recomputes with the same clamp).
        km_kmercount = max(km_kmercount, 16)
        self.km_byte_size = (km_kmercount >> 4) * self.n_hash
        self.km_bit_size = self.km_byte_size << 3
        self.byte_km_back = (km_kmercount >> 4) * self.km_back_num_hash
        self.bit_km_back = self.byte_km_back << 3
        self.bit1 = np.zeros((self.n_bits, self.km_byte_size), dtype=np.uint8)
        self.bit2 = np.zeros((self.n_bits, self.km_byte_size), dtype=np.uint8)
        self.km_back = np.zeros(self.byte_km_back, dtype=np.uint8)

    # ------------------------------------------------------------------ query
    def kmer_to_occ(self, kmer, t_num: int | None = None):
        """Approximate count lookup.  Accepts one k-mer string, a list of
        strings (reference batch API, kmodel.hpp:90-98), or a packed uint64
        array (fast path).  ``t_num``, when given, sets the native probe
        thread count for THIS call only (like the reference's per-call OMP
        fan-out); None keeps whatever the process configured."""
        prev = native._n_threads_override
        if t_num is not None:
            native.set_num_threads(t_num)
        try:
            if isinstance(kmer, str):
                return int(self.kmer_to_occ_u64(np.array([codec.string_to_u64(kmer)], dtype=_U64))[0])
            if isinstance(kmer, (list, tuple)):
                if not kmer:
                    return []
                packed = codec.strings_to_u64(list(kmer), self.kmer_length).astype(_U64)
                return [int(x) for x in self.kmer_to_occ_u64(packed)]
            return self.kmer_to_occ_u64(np.asarray(kmer, dtype=_U64))
        finally:
            if t_num is not None:
                native.set_num_threads(prev)

    def kmer_to_occ_u64(self, kmers: np.ndarray) -> np.ndarray:
        """Batched host query with exact reference semantics
        (kmodel.hpp:100-116 + kmer_to_bin:286-323)."""
        k = self.kmer_length
        kmers = codec.canonical_np(np.asarray(kmers, dtype=_U64), k)
        n = len(kmers)
        out = np.zeros(n, dtype=np.int32)

        # 1. exact rest store
        rest_occ = self.kld.check_kmer(kmers)
        done = rest_occ != 0
        out[done] = rest_occ[done]
        if done.all():
            return out

        # 2. km_back membership + 3. BF bank
        rem = ~done
        is_back = np.zeros(n, dtype=bool)
        is_back[rem] = native.check_bloom(
            kmers[rem], k, self.km_back, self.bit_km_back,
            self.km_back_num_hash, substr_mode=1,
        )
        bf_occ = np.zeros(n, dtype=np.int32)
        bf_occ[rem] = self.bloom.check_all(kmers[rem], k)
        # BF hit and not in back -> BF count; neither -> 0.
        take_bf = rem & (bf_occ != 0) & ~is_back
        out[take_bf] = bf_occ[take_bf]
        done |= take_bf | (rem & ~is_back)

        # 4. coupled bit arrays + neighbor disambiguation
        need = ~done
        if need.any():
            idx = np.flatnonzero(need)
            bins = self._kmer_to_bin(kmers[idx], bf_occ[idx])
            out[idx] = self.occu_bin.bin_to_mean_np(bins).astype(np.int32)
        return out

    def _find_bitarray(self, kmers: np.ndarray) -> np.ndarray:
        """[n, n_bits] int32 decoded bins; -1 where the array's tags miss."""
        return native.find_bitarray(
            kmers, self.kmer_length, self.n_bits, self.n_hash,
            self.bit1.reshape(-1), self.bit2.reshape(-1), self.km_bit_size,
        )

    def _kmer_to_bin(self, kmers: np.ndarray, occ: np.ndarray) -> np.ndarray:
        """Batched kmer_to_bin (kmodel.hpp:286-323). ``occ`` is the BF count."""
        k = self.kmer_length
        n = len(kmers)
        B = self._find_bitarray(kmers)  # [n, nb]
        pos_mask = B > 0  # only bins > 0 enter v_bin (kmodel.hpp:641)
        nbin = pos_mask.sum(axis=1)

        result = np.zeros(n, dtype=np.int32)

        # len==0: FP fallback -> occ (kmodel.hpp:289-291)
        zero = nbin == 0
        result[zero] = occ[zero]

        # Everything else needs neighbor candidates when (len==1 and occ) or
        # len>=2; compute them for the union.
        need_cand = ((nbin == 1) & (occ != 0)) | (nbin >= 2)
        cand_vals = np.zeros((n, 8), dtype=np.int32)
        cand_valid = np.zeros((n, 8), dtype=bool)
        if need_cand.any():
            ci_ = np.flatnonzero(need_cand)
            cv, cm = self._neighbor_candidates(kmers[ci_])
            cand_vals[ci_] = cv
            cand_valid[ci_] = cm

        first_bin = np.where(
            pos_mask.any(axis=1), B[np.arange(n), pos_mask.argmax(axis=1)], 0
        ).astype(np.int32)

        # len==1 (kmodel.hpp:292-302)
        one = nbin == 1
        n_cand = cand_valid.sum(axis=1)
        cnt_bf = (cand_valid & (cand_vals < self.ci + self.bf_num)).sum(axis=1)
        # "if (cnt_bf >= v_candidates.size() / 2) return occ" — int division;
        # empty candidate sets satisfy 0 >= 0.
        take_occ = one & (occ != 0) & (cnt_bf >= n_cand // 2)
        result[take_occ] = occ[take_occ]
        take_bin1 = one & ~take_occ
        result[take_bin1] = first_bin[take_bin1]

        # len>=2 (kmodel.hpp:304-322)
        multi = nbin >= 2
        if multi.any():
            mi = np.flatnonzero(multi)
            Bm = B[mi]  # [m, nb]
            pm = pos_mask[mi]
            cv = cand_vals[mi]  # [m, 8]
            cm = cand_valid[mi]
            none_cand = ~cm.any(axis=1)
            # per (query, bin): min distance to any candidate
            dist = np.abs(Bm[:, :, None] - cv[:, None, :])  # [m, nb, 8]
            dist = np.where(cm[:, None, :], dist, 1 << 21)
            cur_min = dist.min(axis=2)  # [m, nb]
            cur_min = np.where(pm, cur_min, 1 << 22)
            # reference keeps the FIRST bin on ties (strict > comparison,
            # best_bin initialized to v_bin[0]); argmin picks the first min.
            best = Bm[np.arange(len(mi)), cur_min.argmin(axis=1)]
            best = np.where(none_cand, 0, best)
            result[mi] = best.astype(np.int32)
        return result

    def _neighbor_candidates(self, kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """get_neighbor_kmer_bin (kmodel.hpp:326-359) batched: for each k-mer
        the 8 shift neighbors; value per candidate + validity mask."""
        k = self.kmer_length
        n = len(kmers)
        mask2k = (_U64(1) << _U64(2 * k)) - _U64(1) if k < 32 else _U64(0xFFFFFFFFFFFFFFFF)
        bases = np.arange(4, dtype=_U64)
        # shift forward: kmer[1:] + b ; shift back: b + kmer[:-1]
        fwd = ((kmers[:, None] << _U64(2)) & mask2k) | bases[None, :]
        bwd = (kmers[:, None] >> _U64(2)) | (bases[None, :] << _U64(2 * (k - 1)))
        neigh = np.concatenate([fwd, bwd], axis=1).reshape(-1)  # [n*8]
        neigh = codec.canonical_np(neigh, k)

        vals = np.zeros(n * 8, dtype=np.int32)
        valid = np.zeros(n * 8, dtype=bool)

        # 1. rest store -> occ_to_bin(count) (kmodel.hpp:328-332)
        rest_c = self.kld.check_kmer(neigh)
        hit = rest_c > 0
        vals[hit] = self.occu_bin.occ_to_bin_np(rest_c[hit]).astype(np.int32)
        valid |= hit

        # 2. BF bank -> count (kmodel.hpp:333-337)
        rem = ~valid
        if rem.any():
            bf = np.zeros(n * 8, dtype=np.int32)
            bf[rem] = self.bloom.check_all(neigh[rem], k)
            bhit = rem & (bf != 0)
            vals[bhit] = bf[bhit]
            valid |= bhit

        # 3. back BF + find_bitarray_one (kmodel.hpp:338-341)
        rem = ~valid
        if rem.any():
            ri = np.flatnonzero(rem)
            back = native.check_bloom(
                neigh[ri], k, self.km_back, self.bit_km_back,
                self.km_back_num_hash, substr_mode=1,
            )
            bi = ri[back]
            if len(bi):
                Bn = self._find_bitarray(neigh[bi])  # [m, nb]
                ok = Bn != -1
                any_ok = ok.any(axis=1)
                nz = ok & (Bn != 0)
                any_nz = nz.any(axis=1)
                first_nz = Bn[np.arange(len(bi)), nz.argmax(axis=1)]
                # find_bitarray_one: first ok array with bin!=0, else 0 if an
                # ok array existed, else -1 (not a candidate).
                v = np.where(any_nz, first_nz, 0)
                vals[bi] = np.where(any_ok, v, 0).astype(np.int32)
                valid[bi] = any_ok
        return vals.reshape(n, 8), valid.reshape(n, 8)

    # ---------------------------------------------------------------- save/load
    def save(self, save_dir: str | pathlib.Path) -> None:
        """Reference on-disk layout (kmodel.hpp:172-206)."""
        save_dir = pathlib.Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / "header", "w") as f:
            f.write(f"number_hash {self.n_hash}\n")
            f.write(f"number_bit {self.n_bits}\n")
            f.write(f"ci {self.ci}\n")
            f.write(f"cs {self.cs}\n")
        with open(save_dir / "km.bin", "wb") as f:
            np.array([self.km_kmercount], dtype=np.uint64).tofile(f)
            self.bloom.kmer_counts[: self.bf_num].astype(np.uint64).tofile(f)
            for i in range(self.bf_num):
                self.bloom.bit_bf[i].tofile(f)
                self.bloom.bit_bf_back[i].tofile(f)
            self.km_back.tofile(f)
            for i in range(self.n_bits):
                self.bit1[i].tofile(f)
                self.bit2[i].tofile(f)
        self.kld.save_file(save_dir / "rest.bin")

    def load(self, save_dir: str | pathlib.Path) -> None:
        """Reference loader (kmodel.hpp:209-235): array sizes are recomputed
        from the stored counts, then raw bytes are read back."""
        save_dir = pathlib.Path(save_dir)
        with open(save_dir / "km.bin", "rb") as f:
            self.km_kmercount = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
            kmer_counts = np.zeros(3, dtype=np.uint64)
            kmer_counts[: self.bf_num] = np.fromfile(f, dtype=np.uint64, count=self.bf_num)
            self.bloom = BloomBank(kmer_counts, self.n_hash, self.ci)
            for i in range(self.bf_num):
                self.bloom.bit_bf[i] = np.fromfile(
                    f, dtype=np.uint8, count=int(self.bloom.byte_bf[i])
                )
                self.bloom.bit_bf_back[i] = np.fromfile(
                    f, dtype=np.uint8, count=int(self.bloom.byte_bf_back[i])
                )
            self._init_km_parameter(self.km_kmercount)
            self.km_back = np.fromfile(f, dtype=np.uint8, count=self.byte_km_back)
            for i in range(self.n_bits):
                self.bit1[i] = np.fromfile(f, dtype=np.uint8, count=self.km_byte_size)
                self.bit2[i] = np.fromfile(f, dtype=np.uint8, count=self.km_byte_size)
        self.kld = KRestData.from_file(save_dir / "rest.bin")
        self.kmer_length = self.kld.k
        self.total_kmer_count = self.km_kmercount + self.bloom.bf_kmercount

    # ---------------------------------------------------------------- info
    def show_header_info(self) -> str:
        lines = [
            "KMCEX:",
            f"   kmodel number hash                 :     {self.n_hash}",
            f"   kmodel bit array                   :     {self.n_bits}",
            f"   total kmercount                    :     {self.total_kmer_count}",
            f"   kmercount in blommfilter           :     {self.bloom.bf_kmercount}",
            f"   kmercount in kmodel                :     {self.km_kmercount}",
        ]
        return "\n".join(lines)

    def show_kmodel_info(self) -> str:
        bf_byte = int(self.bloom.byte_bf.sum() + self.bloom.byte_bf_back.sum())
        km_byte = 2 * self.n_bits * self.km_byte_size
        map_byte = self.kld.get_all_byte_size()
        total = bf_byte + km_byte + map_byte + self.byte_km_back
        mb = 1024 * 1024
        lines = [
            f"   kmercount hash map                 :     {self.kld.get_rest_count()}",
            f"   memory bloomfilter                 :     {bf_byte // mb}MB",
            f"   memory bit array                   :     {km_byte // mb}MB",
            f"   memory rest map                    :     {map_byte // mb}MB",
            f"   total memory                       :     {total // mb}MB",
            f"   build time cost                    :     {self.build_time_cost}",
        ]
        return "\n".join(lines)

    def total_model_bytes(self) -> int:
        bf_byte = int(self.bloom.byte_bf.sum() + self.bloom.byte_bf_back.sum())
        km_byte = 2 * self.n_bits * self.km_byte_size
        return bf_byte + km_byte + self.kld.get_all_byte_size() + self.byte_km_back


def get_model(ci: int = 1, cs: int = 1023, num_hash: int = 7, num_bit: int = 5) -> KModel:
    """Factory matching the reference get_model(ci,cs,nh,nb) (kmodel.hpp:674)."""
    return KModel(OccuBin(cs + 1, num_hash), num_bit, ci)


def load_model(save_dir: str | pathlib.Path) -> KModel:
    """Factory matching get_model(save_dir) (kmodel.hpp:680-696)."""
    header = {}
    with open(pathlib.Path(save_dir) / "header") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                header[parts[0]] = int(parts[1])
    km = get_model(header["ci"], header["cs"], header["number_hash"], header["number_bit"])
    km.load(save_dir)
    return km
