"""FASTQ/FASTA ingestion: files -> fixed-shape 2-bit code batches.

Copy of the JAX package's ``io/fastq.py``: plain or gzipped
FASTQ/FASTA, a single file or an ``@list`` file of inputs.  Reads are cut
into fixed-length segments with k-1 overlap so every k-mer window appears in
exactly one segment row; non-ACGT bases are masked (KMC splits reads at N,
kmc_file.cpp:1008-1023).  FASTQ goes through the native C++ segmenter, which
writes the packed device format straight from ASCII; wrapped FASTA records
are joined per record by NumPy with a k-1 carry across parse chunks.

One uncompressed file can be split into record-aligned byte ranges
(``split_byte_ranges``), one per process of the multi-process runtime
(``parallel.distributed``); ``SegmentStream(byte_range=...)`` then parses
only that window.

One difference from the JAX module: no silent NumPy fallback.
``use_native=True`` raises if the native library does not load;
``use_native=False`` asks for the NumPy segmenter by name.
"""

from __future__ import annotations

import contextlib
import gzip
import mmap
import os
import pathlib
import stat
from typing import Iterator

import numpy as np

from kmcex_tpu_torch.core.codec import _BASE_LUT

DEFAULT_SEG_LEN = 256
# Batch granularity: ~2M windows per batch at 150bp reads.
DEFAULT_BATCH_SEGS = 16384


def resolve_inputs(input_spec: str) -> list[str]:
    """A path, or '@listfile' with one path per line (reference CLI surface)."""
    if input_spec.startswith("@"):
        paths = []
        for line in pathlib.Path(input_spec[1:]).read_text().splitlines():
            line = line.strip()
            if line:
                paths.append(line)
        return paths
    return [input_spec]


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


class _RangeFile:
    """Read-window view [start, end) of an uncompressed file: ``read`` clamps
    at ``end``.  Range bounds come from split_byte_ranges, i.e. they are
    record boundaries, so a consumer parsing this window never sees partial
    records."""

    def __init__(self, f, start: int, end: int):
        self._f = f
        self._end = end
        f.seek(start)

    def read(self, n: int = -1) -> bytes:
        remaining = self._end - self._f.tell()
        if remaining <= 0:
            return b""
        if n < 0 or n > remaining:
            n = remaining
        return self._f.read(n)

    def peek(self, n: int = 1) -> bytes:
        pos = self._f.tell()
        b = self.read(n)
        self._f.seek(pos)
        return b

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_input(path: str, byte_range: tuple[int, int] | None = None):
    """Open ``path`` for streaming; with ``byte_range`` (record-aligned, from
    split_byte_ranges) only that window is readable.  Gzipped inputs cannot
    be range-split (no random access) — resolve them whole-file upstream."""
    if byte_range is None:
        return _open_maybe_gzip(path)
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        raise ValueError(
            f"{path}: gzipped inputs cannot be split by byte range; "
            "assign whole files per host instead"
        )
    return _RangeFile(f, *byte_range)


# Bytes of a read into the reused buffer (inputs that cannot be mapped).
_READ_BYTES = 1 << 24
# Mapped pages are populated this far ahead of the segmenter, in steps of
# half of it: one madvise a step, not a page fault a 4 KiB page.
_POPULATE_AHEAD = 1 << 25
_MADV_POPULATE_READ = 22  # Linux 5.14+; not in Python's mmap module


@contextlib.contextmanager
def _mapping(fd: int, lo: int, hi: int):
    base = lo - lo % mmap.ALLOCATIONGRANULARITY
    mm = mmap.mmap(fd, hi - base, access=mmap.ACCESS_READ, offset=base)
    try:
        yield mm, lo - base, hi - base
    finally:
        mm.close()


def _mapped_window(f, byte_range: tuple[int, int] | None):
    """A context giving (read-only mapping, lo, hi) of a plain regular
    file's bytes to parse, ``byte_range`` or all, with [lo, hi) their
    offsets in the mapping; None for a gzip stream or a file that is not
    regular.  An empty window maps nothing and gives an empty buffer."""
    raw = f._f if isinstance(f, _RangeFile) else f
    if isinstance(raw, gzip.GzipFile) or not hasattr(raw, "fileno"):
        return None
    st = os.fstat(raw.fileno())
    if not stat.S_ISREG(st.st_mode):
        return None
    lo, hi = byte_range if byte_range is not None else (0, st.st_size)
    if hi <= lo:
        return contextlib.nullcontext((b"", 0, 0))
    return _mapping(raw.fileno(), lo, hi)


class _Populate:
    """Populates a read-only mapping ahead of the parse offset
    (``MADV_POPULATE_READ``; where the kernel lacks it, ``MADV_WILLNEED``
    reads ahead and the segmenter's threads take the faults)."""

    def __init__(self, mm: mmap.mmap):
        self.mm = mm
        self.done = 0
        self.advice = _MADV_POPULATE_READ

    def __call__(self, off: int) -> None:
        size = len(self.mm)
        if self.done >= min(size, off + _POPULATE_AHEAD // 2):
            return
        start = self.done - self.done % mmap.PAGESIZE
        stop = min(size, off + _POPULATE_AHEAD)
        try:
            self.mm.madvise(self.advice, start, stop - start)
        except OSError:
            if self.advice == mmap.MADV_WILLNEED:
                raise
            self.advice = mmap.MADV_WILLNEED
            self.mm.madvise(self.advice, start, stop - start)
        self.done = stop


def _record_start_at_or_after(f, pos: int, size: int, is_fasta: bool) -> int:
    """Absolute offset of the first record start at or after byte ``pos``.

    FASTA: the next line starting with '>'.  FASTQ: the next line starting
    with '@' whose line-after-next starts with '+' — quality lines may begin
    with '@' too, but then the line two later is a sequence line, which never
    begins with '+' (the 4-line record structure disambiguates).  Returns
    ``size`` when no further record exists.

    Streams forward from ``pos`` keeping the invariant that every line start
    inside the scan buffer is preceded by its '\\n' inside the buffer (the
    buffer begins at pos-1), so starts are never missed at chunk seams; the
    buffer is trimmed to the last newline (or to the first still-unresolved
    candidate) each round, bounding memory even for genome-long FASTA lines."""
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    base = pos - 1  # absolute offset of buf[0]
    f.seek(base)
    buf = b""
    eof = False
    marker = ord(">") if is_fasta else ord("@")
    while True:
        if not eof:
            chunk = f.read(1 << 20)
            eof = not chunk
            buf += chunk
        arr = np.frombuffer(buf, dtype=np.uint8)
        nls = np.flatnonzero(arr == 10)
        starts = nls + 1
        starts = starts[starts < len(arr)]
        cand = starts[arr[starts] == marker]
        if is_fasta:
            if len(cand):
                return base + int(cand[0])
        else:
            unresolved = -1
            for c in cand:
                c = int(c)
                j1 = buf.find(b"\n", c)
                j2 = buf.find(b"\n", j1 + 1) if j1 >= 0 else -1
                if j1 < 0 or j2 < 0 or j2 + 1 >= len(buf):
                    if eof:
                        continue  # truncated record at EOF: not a start
                    unresolved = c
                    break
                if buf[j2 + 1] == ord("+"):
                    return base + c
            if unresolved >= 0:
                keep = unresolved - 1  # keep the '\n' preceding the candidate
                base += keep
                buf = buf[keep:]
                continue
        if eof:
            return size
        if len(nls):  # drop fully-scanned lines; keep the final newline
            keep = int(nls[-1])
            base += keep
            buf = buf[keep:]
        elif len(buf) > 1:  # giant line, no newline yet: keep one byte
            base += len(buf) - 1
            buf = buf[-1:]


def split_byte_ranges(path: str, n_parts: int) -> list[tuple[int, int]]:
    """Split one UNCOMPRESSED FASTQ/FASTA file into ``n_parts`` byte ranges
    aligned to record starts (every range begins exactly at a record header,
    ranges cover the file disjointly).  This is how one genome-scale input
    file is divided across hosts without any host parsing the whole thing
    (the reference feeds one file to kmc, main.cpp:137; multi-host data
    parallelism over reads is SURVEY.md §5's design).  Gzip → ValueError."""
    size = os.path.getsize(path)
    n_parts = max(1, int(n_parts))
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            raise ValueError(f"{path}: cannot byte-range split gzipped input")
        f.seek(0)
        head = f.read(1)
        is_fasta = head == b">"
        bounds = [0]
        for i in range(1, n_parts):
            target = size * i // n_parts
            pos = _record_start_at_or_after(f, target, size, is_fasta)
            bounds.append(max(pos, bounds[-1]))
        bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(n_parts)]


def _join_fasta_records(block: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray, tail: bytes, k: int):
    """Concatenate a chunk's FASTA sequence lines per record into one
    contiguous buffer (wrapped 60-80 column genomes are the normal case;
    round-3 treated every line as its own read, silently losing every
    k-mer spanning a line break — ~40% of windows at 70 cols, k=31).

    ``tail`` is the open record's last k-1 bases from the previous chunk;
    it is prepended when the chunk's first sequence lines continue that
    record, so no window is lost at the chunk seam.  Returns (joined,
    rec_starts, rec_ends, n_records, n_bases, new_tail); n_bases excludes
    the prepended tail (no double counting)."""
    hdr = block[starts] == ord(">")
    seq = ~hdr
    lens = (ends - starts)[seq]
    s_seq = starts[seq]
    n_bases = int(lens.sum())
    rec_of_line = np.cumsum(hdr)[seq]  # 0 = continuation of the open record
    n_records = int(hdr.sum())
    cont = len(rec_of_line) > 0 and rec_of_line[0] == 0
    lead = np.frombuffer(tail if cont else b"", dtype=np.uint8)
    total = len(lead) + n_bases
    joined = np.empty(total, dtype=np.uint8)
    joined[: len(lead)] = lead
    if n_bases:
        # one fancy gather moves every sequence byte (vectorized join)
        line_of_byte = np.repeat(np.arange(len(lens)), lens)
        cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
        idx = s_seq[line_of_byte] + (np.arange(n_bases) - cum[line_of_byte])
        joined[len(lead):] = block[idx]
    if len(rec_of_line) == 0:
        empty = np.zeros(0, dtype=np.int64)
        return joined, empty, empty, n_records, 0, b"" if n_records else tail
    cumlens = np.concatenate([[0], np.cumsum(lens)]) + len(lead)
    new_rec = np.concatenate([[True], rec_of_line[1:] != rec_of_line[:-1]])
    rec_starts = cumlens[:-1][new_rec]
    rec_ends = np.concatenate([rec_starts[1:], [total]]).astype(np.int64)
    rec_starts = rec_starts.astype(np.int64)
    if cont:
        rec_starts[0] = 0  # include the carried k-1 prefix
    # open iff the chunk's LAST line belongs to a sequence (not a header)
    if hdr[-1]:
        new_tail = b""
    else:
        lo = max(int(rec_starts[-1]), total - (k - 1))
        new_tail = joined[lo:total].tobytes()
    return joined, rec_starts, rec_ends, n_records, n_bases, new_tail


def _iter_seq_spans(path: str, chunk_bytes: int = 1 << 24,
                    byte_range: tuple[int, int] | None = None, k: int = 1):
    """Yield (block_bytes, starts, ends, n_reads, n_bases) sequence spans.

    FASTQ: every 4th line starting from line 1, one span per read.
    FASTA: sequence lines JOINED per record (see _join_fasta_records) —
    wrapped multi-line records lose no k-mers; a record continuing across
    a chunk seam reappears as a new span carrying its previous k-1 bases,
    so n_reads/n_bases (records by header / bases excluding carry) are the
    accurate statistics, not len(starts)/sum(ends-starts).
    ``byte_range`` restricts parsing to a record-aligned window (see
    split_byte_ranges).
    """
    with _open_input(path, byte_range) as f:
        head = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if not head:
            head = b"@"
        is_fasta = head == b">"
        carry = b""      # incomplete trailing line
        fa_tail = b""    # FASTA: open record's last k-1 bases
        fastq_phase = 0
        eof = False
        while not eof:
            chunk = f.read(chunk_bytes)
            if not chunk:
                eof = True
                if not carry:
                    break
                data = carry + b"\n"  # flush a final unterminated line
                carry = b""
            else:
                data = carry + chunk
                last_nl = data.rfind(b"\n")
                if last_nl < 0:
                    carry = data
                    continue
                carry = data[last_nl + 1 :]
                data = data[: last_nl + 1]
            block = np.frombuffer(data, dtype=np.uint8)
            nl = np.flatnonzero(block == 10)
            starts = np.empty_like(nl)
            starts[0] = 0
            starts[1:] = nl[:-1] + 1
            ends = nl
            # strip \r for CRLF input
            crlf = (ends > starts) & (block[np.maximum(ends - 1, 0)] == 13)
            ends = ends - crlf.astype(ends.dtype)
            if is_fasta:
                joined, js, je, n_rec, n_b, fa_tail = _join_fasta_records(
                    block, starts, ends, fa_tail, k)
                if len(js) or n_rec:
                    yield joined, js, je, n_rec, n_b
            else:
                n = len(starts)
                keep = (np.arange(n) + fastq_phase) % 4 == 1
                fastq_phase = (fastq_phase + n) % 4
                s, e = starts[keep], ends[keep]
                yield block, s, e, len(s), int((e - s).sum())


def _segment_spans(
    block: np.ndarray, starts: np.ndarray, ends: np.ndarray, k: int, seg_len: int
) -> np.ndarray:
    """Vectorized: cut all sequence spans into overlapping segments and gather
    one [n_segs, seg_len] 2-bit code matrix (255 = pad/N)."""
    stride = seg_len - (k - 1)
    lens = (ends - starts).astype(np.int64)
    ok = lens >= k
    starts, ends, lens = starts[ok], ends[ok], lens[ok]
    if len(starts) == 0:
        return np.zeros((0, seg_len), dtype=np.uint8)
    nseg = (lens - k) // stride + 1
    total = int(nseg.sum())
    read_of_seg = np.repeat(np.arange(len(starts)), nseg)
    cum = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    j = np.arange(total) - cum[read_of_seg]  # segment index within read
    abs_start = starts[read_of_seg] + j * stride
    pos = abs_start[:, None] + np.arange(seg_len)[None, :]
    limit = ends[read_of_seg][:, None]
    safe = np.minimum(pos, len(block) - 1)
    codes = _BASE_LUT[block[safe]]
    return np.where(pos < limit, codes, np.uint8(255))


class SegmentStream:
    """Iterates batches over the input files, tracking read/base
    statistics.  ``packed=False``: [batch_segs, seg_len] uint8 codes, one
    base per byte (255 = pad/N), for ``extract_canonical``.
    ``packed=True``: (packed [batch_segs, seg_len/4], maskbits [batch_segs,
    seg_len/8]) uint8 tuples (seg_len % 8 == 0), the device transfer format
    ``count.extract.extract_canonical_packed`` takes; the native segmenter
    writes it straight from ASCII.  ``byte_range`` (one input file only)
    restricts parsing to a record-aligned window from
    ``split_byte_ranges``.  ``use_native=False`` selects the NumPy
    segmenter, the reference the native one is tested against."""

    def __init__(self, input_spec: str, k: int, seg_len: int = DEFAULT_SEG_LEN,
                 batch_segs: int = DEFAULT_BATCH_SEGS, use_native: bool = True,
                 packed: bool = False,
                 byte_range: tuple[int, int] | None = None):
        if packed and seg_len % 8:
            raise ValueError("packed batches need seg_len % 8 == 0")
        if byte_range is not None and len(resolve_inputs(input_spec)) != 1:
            raise ValueError("byte_range applies to a single input file")
        self.input_spec = input_spec
        self.k = k
        self.seg_len = seg_len
        self.batch_segs = batch_segs
        self.use_native = use_native
        self.packed = packed
        self.byte_range = byte_range
        self.reads = 0
        self.bases = 0
        # bases segmented by a native call whose fill ran on more than one
        # thread (the native segmenter's threads are -t)
        self.parallel_bases = 0

    def __iter__(self) -> Iterator:
        if self.use_native:
            from kmcex_tpu_torch import native

            native.lib()  # raises if the library cannot be built or loaded
            yield from self._iter_native(native)
        elif self.packed:
            from kmcex_tpu_torch.count.extract import pack_codes_np

            for codes in self._iter_numpy():
                yield pack_codes_np(codes)
        else:
            yield from self._iter_numpy()

    def _new_buf(self):
        """A batch buffer; the segmenter writes every byte of its rows, and
        ``_sealed`` pads the rows it left."""
        if self.packed:
            return (
                np.empty((self.batch_segs, self.seg_len // 4), dtype=np.uint8),
                np.empty((self.batch_segs, self.seg_len // 8), dtype=np.uint8),
            )
        return np.empty((self.batch_segs, self.seg_len), dtype=np.uint8)

    def _sealed(self, buf, row: int):
        """The batch with its rows from ``row`` on padded (no base)."""
        if self.packed:
            buf[0][row:] = 0
            buf[1][row:] = 0
        else:
            buf[row:] = 255
        return buf

    def _iter_native(self, native) -> Iterator:
        buf = self._new_buf()
        row = 0
        for path in resolve_inputs(self.input_spec):
            with _open_input(path, self.byte_range) as f:
                head = f.peek(1)[:1] if hasattr(f, "peek") else b""
                if head == b">":
                    # FASTA goes through the NumPy record-joiner: the native
                    # segmenter is line-at-a-time, so wrapped (60-80 col)
                    # records would lose every k-mer spanning a line break.
                    # Rows still fill the shared native batch buffer so
                    # mixed FASTQ/FASTA @lists batch seamlessly.
                    buf, row = yield from self._fasta_into_buf(path, buf, row)
                    continue
                window = _mapped_window(f, self.byte_range)
                if window is None:  # gzip or not a regular file
                    buf, row = yield from self._read_into_buf(
                        native, f, buf, row)
                    continue
                with window as (mm, lo, hi):
                    off, phase, buf, row = yield from self._window_into_buf(
                        native, mm, lo, hi, 0, buf, row, _Populate(mm))
                    tail = mm[off:hi]
                if tail:  # a last line with no newline
                    tail += b"\n"
                    _, _, buf, row = yield from self._window_into_buf(
                        native, tail, 0, len(tail), phase, buf, row)
        if row:
            yield self._sealed(buf, row)

    def _window_into_buf(self, native, data, off: int, end: int, phase: int,
                         buf, row: int, populate=None):
        """Generator: segment the complete lines of ``data[off:end]`` (a
        buffer with ``find``) into the batch buffer; yields full batches,
        returns (offset of the first byte not consumed, phase, buf, row).
        ``populate(off)`` runs before each segmenter call."""
        arr = np.frombuffer(data, dtype=np.uint8, count=end)
        while off < end:
            if populate is not None:
                populate(off)
            if self.packed:
                r = native.segment(arr[off:], False, phase, self.k,
                                   self.seg_len, buf[0][row:], buf[1][row:])
            else:
                r = native.segment(arr[off:], False, phase, self.k,
                                   self.seg_len, buf[row:])
            phase = r.phase
            row += r.rows
            self.reads += r.reads
            self.bases += r.bases
            self.parallel_bases += r.parallel_bases
            off += r.consumed
            stalled = r.consumed == 0 and r.rows == 0
            if stalled and data.find(b"\n", off, end) == -1:
                break  # incomplete tail line -> the caller carries it
            if stalled and row == 0:
                raise ValueError(
                    "single sequence line needs more than "
                    f"batch_segs={self.batch_segs} segment rows; "
                    "raise batch_segs (whole-genome FASTA lines)"
                )
            if row == self.batch_segs or stalled:
                # buffer full (exactly, or the next read needs more rows
                # than remain): flush and keep going
                yield self._sealed(buf, row)
                buf = self._new_buf()
                row = 0
        return off, phase, buf, row

    def _read_into_buf(self, native, f, buf, row: int):
        """Generator: segment a stream that cannot be mapped (gzip) from a
        reused buffer: ``readinto`` after the carried incomplete line,
        which moves to the front.  Returns (buf, row)."""
        store = bytearray(_READ_BYTES)
        n = phase = 0
        while True:
            if n == len(store):  # one line longer than the buffer
                store.extend(bytes(len(store)))
            with memoryview(store) as mv:
                got = f.readinto(mv[n:])
            if not got:
                if not n:
                    return buf, row
                if n == len(store):
                    store.append(10)
                else:
                    store[n] = 10  # flush a final unterminated line
                got = 1
            n += got
            off, phase, buf, row = yield from self._window_into_buf(
                native, store, 0, n, phase, buf, row)
            store[: n - off] = store[off:n]
            n -= off

    def _fasta_into_buf(self, path: str, buf, row: int):
        """Generator: segment one FASTA file (record-joined spans) into the
        shared native batch buffer; yields full buffers, returns the final
        (buf, row)."""
        from kmcex_tpu_torch.count.extract import pack_codes_np

        for block, starts, ends, n_reads, n_bases in _iter_seq_spans(
                path, byte_range=self.byte_range, k=self.k):
            self.reads += n_reads
            self.bases += n_bases
            segs = _segment_spans(block, starts, ends, self.k, self.seg_len)
            off = 0
            while off < len(segs):
                take = min(len(segs) - off, self.batch_segs - row)
                part = segs[off : off + take]
                if self.packed:
                    p, mbits = pack_codes_np(part)
                    buf[0][row : row + take] = p
                    buf[1][row : row + take] = mbits
                else:
                    buf[row : row + take] = part
                row += take
                off += take
                if row == self.batch_segs:
                    yield buf
                    buf = self._new_buf()
                    row = 0
        return buf, row

    def _iter_numpy(self) -> Iterator[np.ndarray]:
        pend: list[np.ndarray] = []
        pend_rows = 0
        for path in resolve_inputs(self.input_spec):
            for block, starts, ends, n_reads, n_bases in _iter_seq_spans(
                    path, byte_range=self.byte_range, k=self.k):
                self.reads += n_reads
                self.bases += n_bases
                segs = _segment_spans(block, starts, ends, self.k, self.seg_len)
                if len(segs) == 0:
                    continue
                pend.append(segs)
                pend_rows += len(segs)
                while pend_rows >= self.batch_segs:
                    cat = pend[0] if len(pend) == 1 else np.concatenate(pend)
                    yield cat[: self.batch_segs]
                    rest = cat[self.batch_segs :]
                    pend = [rest] if len(rest) else []
                    pend_rows = len(rest)
        if pend_rows:
            cat = pend[0] if len(pend) == 1 else np.concatenate(pend)
            pad = np.full((self.batch_segs - pend_rows, self.seg_len), 255, dtype=np.uint8)
            yield np.concatenate([cat, pad])


def segment_batches(input_spec: str, k: int, seg_len: int = DEFAULT_SEG_LEN,
                    batch_segs: int = DEFAULT_BATCH_SEGS) -> SegmentStream:
    """The unpacked code-batch stream (the host accumulator's input)."""
    return SegmentStream(input_spec, k, seg_len, batch_segs)


def sniff_read_length(input_spec: str, max_reads: int = 10000) -> int:
    """Median sequence length over the first reads (to pick a segment length
    that wastes no window slots on padding)."""
    lens: list[np.ndarray] = []
    seen = 0
    for path in resolve_inputs(input_spec):
        for _, starts, ends, n_reads, _b in _iter_seq_spans(
                path, chunk_bytes=1 << 22):
            lens.append(ends - starts)
            seen += n_reads
            if seen >= max_reads:
                break
        break
    if not lens:
        return DEFAULT_SEG_LEN
    return int(np.median(np.concatenate(lens)))
