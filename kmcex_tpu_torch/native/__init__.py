"""ctypes bindings for the host runtime (``native/src/kmcex_native.cpp``,
the port's copy of the JAX package's source, built by ``native.build``).

The native library owns the order-dependent sequential encode (coupled
bit-array insertion with the reference's rotating bucket schedule), the
Bloom insert and probe, the coupled-array probe of the host query, the FASTQ segmenters
and the two-pointer merge of the host LSM level.  Only the entry points
the port uses are bound.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from kmcex_tpu_torch.native.build import build_native

_lib = None
_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(str(build_native()))
            _declare(L)
            _lib = L
    return _lib


def _declare(L: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.kx_murmur64.restype = ctypes.c_uint64
    L.kx_murmur64.argtypes = [u8p, ctypes.c_int, ctypes.c_uint32]
    L.kx_merge_runs.restype = ctypes.c_int64
    L.kx_merge_runs.argtypes = [
        u64p, u32p, ctypes.c_int64, u64p, u32p, ctypes.c_int64, u64p, u32p,
    ]
    L.kx_segment_buffer.restype = ctypes.c_int64
    L.kx_segment_buffer.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int64, i64p, i64p, i64p,
    ]
    L.kx_check_bloom.restype = None
    L.kx_check_bloom.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
    ]
    L.kx_find_bitarray.restype = None
    L.kx_find_bitarray.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, u8p, ctypes.c_uint64, i32p, ctypes.c_int,
    ]
    L.kx_insert_bloom.restype = None
    L.kx_insert_bloom.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    L.kx_encoder_new.restype = ctypes.c_void_p
    L.kx_encoder_new.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u32p, ctypes.c_int64,
        u8p, u8p, ctypes.c_uint64,
        u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ]
    L.kx_encoder_feed.restype = None
    L.kx_encoder_feed.argtypes = [ctypes.c_void_p, u64p, u32p, ctypes.c_int64]
    L.kx_encoder_finish.restype = ctypes.c_int64
    L.kx_encoder_finish.argtypes = [ctypes.c_void_p]
    L.kx_encoder_take_rest.restype = None
    L.kx_encoder_take_rest.argtypes = [ctypes.c_void_p, u64p, u32p]
    L.kx_encoder_free.restype = None
    L.kx_encoder_free.argtypes = [ctypes.c_void_p]
    L.kx_segment_buffer_packed.restype = ctypes.c_int64
    L.kx_segment_buffer_packed.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int64, i64p, i64p, i64p,
    ]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


_n_threads_override = 0


def set_num_threads(n: int) -> None:
    """Host-thread count (the CLI's -t, main.cpp:77); 0 = all cores."""
    global _n_threads_override
    _n_threads_override = max(0, int(n))


def n_threads_default() -> int:
    if _n_threads_override:
        return _n_threads_override
    return max(1, os.cpu_count() or 1)


def murmur64(data: bytes, seed: int) -> int:
    """MurmurHash64A of a byte string (the host reference of core.murmur)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(lib().kx_murmur64(_ptr(buf, ctypes.c_uint8), len(data), seed))


def merge_runs(ka: np.ndarray, ca: np.ndarray, kb: np.ndarray, cb: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Merge two sorted (kmer, count) runs, summing duplicates
    (u32-saturating).  The inputs may be read-only memmaps (a restored
    checkpoint): ``np.ascontiguousarray`` hands ctypes a plain pointer to
    the mapped pages, and the library only reads them."""
    ka = np.ascontiguousarray(ka, dtype=np.uint64)
    kb = np.ascontiguousarray(kb, dtype=np.uint64)
    ca = np.ascontiguousarray(ca, dtype=np.uint32)
    cb = np.ascontiguousarray(cb, dtype=np.uint32)
    ko = np.zeros(len(ka) + len(kb), dtype=np.uint64)
    co = np.zeros(len(ka) + len(kb), dtype=np.uint32)
    n = lib().kx_merge_runs(
        _ptr(ka, ctypes.c_uint64), _ptr(ca, ctypes.c_uint32), len(ka),
        _ptr(kb, ctypes.c_uint64), _ptr(cb, ctypes.c_uint32), len(kb),
        _ptr(ko, ctypes.c_uint64), _ptr(co, ctypes.c_uint32),
    )
    return ko[:n], co[:n]


def insert_bloom(kmers: np.ndarray, k: int, bf: np.ndarray, bit_len: int,
                 num_hash: int, substr_mode: int = 0, n_threads: int = 0) -> None:
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    _require_u8(bf, "bloom filter")
    lib().kx_insert_bloom(
        _ptr(kmers, ctypes.c_uint64), len(kmers), k,
        _ptr(bf, ctypes.c_uint8), bit_len, num_hash, substr_mode,
        n_threads or n_threads_default(),
    )


def _require_u8(arr: np.ndarray, what: str) -> None:
    if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
        raise ValueError(f"{what} must be a contiguous uint8 array")


def check_bloom(kmers: np.ndarray, k: int, bf: np.ndarray, bit_len: int,
                num_hash: int, substr_mode: int = 0, n_threads: int = 0) -> np.ndarray:
    """bool [n]: every probe bit of the k-mer (``substr_mode=1``: of its
    middle (k-2)-mer) is set in ``bf``."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    _require_u8(bf, "bloom filter")
    if not 0 < bit_len <= 8 * bf.size:
        raise ValueError(f"bit_len {bit_len} outside a {bf.size}-byte filter")
    out = np.zeros(len(kmers), dtype=np.uint8)
    lib().kx_check_bloom(
        _ptr(kmers, ctypes.c_uint64), len(kmers), k,
        _ptr(bf, ctypes.c_uint8), bit_len, num_hash, substr_mode,
        _ptr(out, ctypes.c_uint8), n_threads or n_threads_default(),
    )
    return out.astype(bool)


def find_bitarray(kmers: np.ndarray, k: int, n_bits: int, n_hash: int,
                  bit1: np.ndarray, bit2: np.ndarray, km_bit_size: int,
                  n_threads: int = 0) -> np.ndarray:
    """[n, n_bits] int32: decoded bin per (kmer, array), -1 where tags miss."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    _require_u8(bit1, "bit1")
    _require_u8(bit2, "bit2")
    if not 0 < n_bits * km_bit_size <= 8 * min(bit1.size, bit2.size):
        raise ValueError(f"{n_bits} arrays of {km_bit_size} bits do not fit "
                         f"{bit1.size} and {bit2.size} bytes")
    out = np.zeros((len(kmers), n_bits), dtype=np.int32)
    lib().kx_find_bitarray(
        _ptr(kmers, ctypes.c_uint64), len(kmers), k, n_bits, n_hash,
        _ptr(bit1, ctypes.c_uint8), _ptr(bit2, ctypes.c_uint8), km_bit_size,
        _ptr(out, ctypes.c_int32), n_threads or n_threads_default(),
    )
    return out


class BitArrayEncoder:
    """Incremental coupled-bit-array encoder (the reference's buffered
    rotating schedule, kmodel.hpp:508-573).  Chunked ``feed`` is
    bit-identical to one-shot encoding of the concatenated stream — the
    schedule depends only on overall order — which lets device->host pulls
    overlap encoding.  ``finish`` returns (rest_kmers, rest_occs): the
    k-mers that overflowed into the rest store, in hand-off order."""

    def __init__(self, k: int, n_bits: int, n_hash: int, occ2bin: np.ndarray,
                 bit1: np.ndarray, bit2: np.ndarray, km_bit_size: int,
                 km_back: np.ndarray, back_bit_len: int, back_num_hash: int,
                 bucket_size: int = 1 << 18, n_threads: int = 0):
        for a in (bit1, bit2, km_back):
            _require_u8(a, "bit arrays")
        # keep referenced arrays alive for the encoder's lifetime
        self._occ2bin = np.ascontiguousarray(occ2bin, dtype=np.uint32)
        self._refs = (self._occ2bin, bit1, bit2, km_back)
        self._h = lib().kx_encoder_new(
            k, n_bits, n_hash,
            _ptr(self._occ2bin, ctypes.c_uint32), len(self._occ2bin),
            _ptr(bit1, ctypes.c_uint8), _ptr(bit2, ctypes.c_uint8),
            km_bit_size,
            _ptr(km_back, ctypes.c_uint8), back_bit_len, back_num_hash,
            bucket_size, n_threads or n_threads_default(),
        )

    def feed(self, kmers: np.ndarray, occs: np.ndarray) -> None:
        kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
        occs = np.ascontiguousarray(occs, dtype=np.uint32)
        lib().kx_encoder_feed(
            self._h, _ptr(kmers, ctypes.c_uint64),
            _ptr(occs, ctypes.c_uint32), len(kmers),
        )

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        n = int(lib().kx_encoder_finish(self._h))
        rk = np.zeros(max(n, 1), dtype=np.uint64)
        ro = np.zeros(max(n, 1), dtype=np.uint32)
        lib().kx_encoder_take_rest(
            self._h, _ptr(rk, ctypes.c_uint64), _ptr(ro, ctypes.c_uint32)
        )
        lib().kx_encoder_free(self._h)
        self._h = None
        return rk[:n], ro[:n]


def encode_bitarrays(
    kmers: np.ndarray, occs: np.ndarray, k: int, n_bits: int, n_hash: int,
    occ2bin: np.ndarray, bit1: np.ndarray, bit2: np.ndarray, km_bit_size: int,
    km_back: np.ndarray, back_bit_len: int, back_num_hash: int,
    bucket_size: int = 1 << 18, n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot encode; returns (rest_kmers, rest_occs)."""
    enc = BitArrayEncoder(
        k, n_bits, n_hash, occ2bin, bit1, bit2, km_bit_size, km_back,
        back_bit_len, back_num_hash, bucket_size, n_threads,
    )
    enc.feed(kmers, occs)
    return enc.finish()


def segment_buffer(
    data: np.ndarray, is_fasta: bool, phase: int, k: int, seg_len: int,
    out_rows: np.ndarray,
) -> tuple[int, int, int, int, int]:
    """Segment complete lines of ``data`` into ``out_rows`` [cap, seg_len]
    (one 2-bit code per byte, 255 = pad/N).  Returns (rows_written,
    consumed_bytes, reads, bases, new_phase)."""
    _require_u8(out_rows, "segment buffer")
    ph = ctypes.c_int(phase)
    consumed = np.zeros(1, dtype=np.int64)
    n_reads = np.zeros(1, dtype=np.int64)
    n_bases = np.zeros(1, dtype=np.int64)
    rows = lib().kx_segment_buffer(
        _ptr(data, ctypes.c_uint8), len(data), int(is_fasta),
        ctypes.byref(ph), k, seg_len,
        _ptr(out_rows, ctypes.c_uint8), out_rows.shape[0],
        _ptr(consumed, ctypes.c_int64), _ptr(n_reads, ctypes.c_int64),
        _ptr(n_bases, ctypes.c_int64),
    )
    return int(rows), int(consumed[0]), int(n_reads[0]), int(n_bases[0]), ph.value


def segment_buffer_packed(
    data: np.ndarray, is_fasta: bool, phase: int, k: int, seg_len: int,
    out_packed: np.ndarray, out_mask: np.ndarray,
) -> tuple[int, int, int, int, int]:
    """Packed segmenter: out_packed [cap, seg_len/4] 2-bit codes, out_mask
    [cap, seg_len/8] validity bits — the device transfer format, written
    directly from ASCII.  Returns (rows, consumed, reads, bases, phase)."""
    for a in (out_packed, out_mask):
        _require_u8(a, "segment buffers")
    ph = ctypes.c_int(phase)
    consumed = np.zeros(1, dtype=np.int64)
    n_reads = np.zeros(1, dtype=np.int64)
    n_bases = np.zeros(1, dtype=np.int64)
    rows = lib().kx_segment_buffer_packed(
        _ptr(data, ctypes.c_uint8), len(data), int(is_fasta),
        ctypes.byref(ph), k, seg_len,
        _ptr(out_packed, ctypes.c_uint8), _ptr(out_mask, ctypes.c_uint8),
        out_packed.shape[0],
        _ptr(consumed, ctypes.c_int64), _ptr(n_reads, ctypes.c_int64),
        _ptr(n_bases, ctypes.c_int64),
    )
    return int(rows), int(consumed[0]), int(n_reads[0]), int(n_bases[0]), ph.value
