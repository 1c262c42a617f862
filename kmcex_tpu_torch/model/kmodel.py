"""KModel — the coupled-bit-array k-mer frequency encoding (build half).

Copy of the build / save / load half of the JAX package's
``model/kmodel.py``, a rebuild of the reference model layer
(kmodel.hpp:39-696): a two-pass build over a (k-mer, count) listing routes
each k-mer by count — low counts (counter < ci + bf_num) into the Bloom
bank, the rest through the coupled bit arrays with overflow into the exact
rest store — then serializes to the reference's ``header`` / ``km.bin`` /
``rest.bin`` layout.  The listing order is ascending packed k-mer value
(== KMC1 database order).  The Bloom bank is built on the host here; the
query methods and the KMC-database input wait for later slices.
"""

from __future__ import annotations

import os
import pathlib
import time
import typing

import numpy as np

from kmcex_tpu_torch import native
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


class KModel:
    def __init__(self, occu_bin: OccuBin, n_bits: int, ci: int):
        self.occu_bin = occu_bin
        self.n_bits = int(n_bits)
        self.ci = int(ci)
        self.cs = occu_bin.get_max_counter() - 1
        self.bf_num = 1 if ci == 1 else 3
        self.n_hash = occu_bin.get_hash_number()
        self.km_back_num_hash = self.n_hash - 2

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
                         low_hist: np.ndarray) -> None:
        """Streaming build: ``chunk_iter`` yields (kmers_u64, counts) chunks
        in listing order; ``total_kmer_count`` and ``low_hist`` (counts of
        counter==ci+i for i<3) must cover the whole stream (the reference's
        pass 1, computed on device by the counting pipeline).  Chunked
        feeding is bit-identical to a one-shot build — the encode schedule
        depends only on overall stream order — and lets device->host pulls
        overlap the encode."""
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
            "chunk_wait": 0.0, "bloom_insert": 0.0, "array_feed": 0.0,
            "array_finish": 0.0, "rest_build": 0.0, "route_split": 0.0,
        }
        # Pass 2: route. BF inserts are commutative scatter-ORs — order-free,
        # so they run on a worker thread (the native insert releases the GIL)
        # overlapping the order-dependent coupled-array feed on this thread.
        enc = native.BitArrayEncoder(
            k, self.n_bits, self.n_hash, self.occu_bin.occ2bin_lut,
            self.bit1.reshape(-1), self.bit2.reshape(-1), self.km_bit_size,
            self.km_back, self.bit_km_back, self.km_back_num_hash,
            bucket_size=BUCKET_SIZE,
        )
        import queue
        import threading

        bloom_q: "queue.Queue" = queue.Queue(maxsize=8)
        worker_err: list[BaseException] = []

        def bloom_worker():
            # A raised insert must not kill the thread silently: the bounded
            # queue would deadlock the producer and a "successful" build
            # would silently miss BF inserts.  On failure the worker keeps
            # draining (so put() never blocks) and the error re-raises on
            # the build thread after join().
            t_busy = 0.0
            while True:
                item = bloom_q.get()
                if item is None:
                    break
                if worker_err:
                    continue  # drain so the producer never blocks
                i, kmers = item
                t = time.time()
                try:
                    self.bloom.insert(i, kmers, k, n_threads=_bloom_threads())
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    worker_err.append(e)
                t_busy += time.time() - t
            ph["bloom_insert"] = t_busy

        bw = threading.Thread(target=bloom_worker, daemon=True)
        bw.start()
        try:
            it = iter(chunk_iter)
            while True:
                t = time.time()
                item = next(it, None)
                ph["chunk_wait"] += time.time() - t
                if item is None:
                    break
                if isinstance(item, PreSplitChunk):
                    # routing already paid on the producer thread
                    arr_kmers, arr_counts = item.arr_kmers, item.arr_counts
                    for i, low in enumerate(item.lows):
                        bloom_q.put((i, low))
                else:
                    kmers_u64, counts = item
                    t = time.time()
                    sp = split_chunk(kmers_u64, counts, self.ci, self.bf_num)
                    arr_kmers, arr_counts = sp.arr_kmers, sp.arr_counts
                    for i, low in enumerate(sp.lows):
                        bloom_q.put((i, low))
                    ph["route_split"] += time.time() - t
                if len(arr_kmers):
                    t = time.time()
                    enc.feed(arr_kmers, arr_counts)
                    ph["array_feed"] += time.time() - t
            t = time.time()
            rest_kmers, rest_occs = enc.finish()
            ph["array_finish"] = time.time() - t
        finally:
            bloom_q.put(None)
            bw.join()
        if worker_err:
            raise worker_err[0]
        t = time.time()
        if len(rest_kmers):
            self.kld.push_back(rest_kmers, rest_occs)
        self.kld.build()
        ph["rest_build"] = time.time() - t
        self.build_time_cost = time.time() - t0

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
