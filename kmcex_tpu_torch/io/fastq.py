"""FASTQ/FASTA ingestion: files -> fixed-shape 2-bit code batches.

Copy of the JAX package's ``io/fastq.py``: plain or gzipped
FASTQ/FASTA, a single file or an ``@list`` file of inputs.  Reads are cut
into fixed-length segments with k-1 overlap so every k-mer window appears in
exactly one segment row; non-ACGT bases are masked (KMC splits reads at N,
kmc_file.cpp:1008-1023).  FASTQ goes through the native C++ segmenter, which
writes the packed device format straight from ASCII; wrapped FASTA records
are joined per record by NumPy with a k-1 carry across parse chunks.

Differences from the JAX module: packed batches are the default, no
byte-range splitting (multi-host input), and no silent NumPy fallback — if the native
library does not load, iteration raises.
"""

from __future__ import annotations

import gzip
import pathlib
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


def _iter_seq_spans(path: str, chunk_bytes: int = 1 << 24, k: int = 1):
    """Yield (block_bytes, starts, ends, n_reads, n_bases) sequence spans.

    FASTQ: every 4th line starting from line 1, one span per read.
    FASTA: sequence lines JOINED per record (see _join_fasta_records) —
    wrapped multi-line records lose no k-mers; a record continuing across
    a chunk seam reappears as a new span carrying its previous k-1 bases,
    so n_reads/n_bases (records by header / bases excluding carry) are the
    accurate statistics, not len(starts)/sum(ends-starts).
    """
    with _open_maybe_gzip(path) as f:
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
    statistics.  ``packed=True``: (packed [batch_segs, seg_len/4], maskbits
    [batch_segs, seg_len/8]) uint8 tuples (seg_len % 8 == 0), the format
    ``count.extract.extract_canonical_packed`` takes.  ``packed=False``:
    [batch_segs, seg_len] uint8 codes, one base per byte (255 = pad/N), for
    ``extract_canonical``."""

    def __init__(self, input_spec: str, k: int, seg_len: int = DEFAULT_SEG_LEN,
                 batch_segs: int = DEFAULT_BATCH_SEGS, packed: bool = True):
        if packed and seg_len % 8:
            raise ValueError("packed batches need seg_len % 8 == 0")
        self.packed = packed
        self.input_spec = input_spec
        self.k = k
        self.seg_len = seg_len
        self.batch_segs = batch_segs
        self.reads = 0
        self.bases = 0

    def __iter__(self) -> Iterator:
        from kmcex_tpu_torch import native

        native.lib()  # raises if the native library cannot be built/loaded
        yield from self._iter_native(native)

    def _new_buf(self):
        if self.packed:
            return (
                np.zeros((self.batch_segs, self.seg_len // 4), dtype=np.uint8),
                np.zeros((self.batch_segs, self.seg_len // 8), dtype=np.uint8),
            )
        return np.full((self.batch_segs, self.seg_len), 255, dtype=np.uint8)

    def _segment(self, native, arr, is_fasta, phase, buf, row):
        if self.packed:
            return native.segment_buffer_packed(
                arr, is_fasta, phase, self.k, self.seg_len,
                buf[0][row:], buf[1][row:],
            )
        return native.segment_buffer(
            arr, is_fasta, phase, self.k, self.seg_len, buf[row:]
        )

    def _iter_native(self, native) -> Iterator:
        buf = self._new_buf()
        row = 0
        for path in resolve_inputs(self.input_spec):
            with _open_maybe_gzip(path) as f:
                head = f.peek(1)[:1] if hasattr(f, "peek") else b""
                is_fasta = head == b">"
                if is_fasta:
                    # FASTA goes through the NumPy record-joiner: the native
                    # segmenter is line-at-a-time, so wrapped (60-80 col)
                    # records would lose every k-mer spanning a line break.
                    # Rows still fill the shared native batch buffer so
                    # mixed FASTQ/FASTA @lists batch seamlessly.
                    buf, row = yield from self._fasta_into_buf(path, buf, row)
                    continue
                phase = 0
                carry = b""
                eof = False
                while not eof:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        eof = True
                        if not carry:
                            break
                        data = carry + b"\n"  # flush a final unterminated line
                        carry = b""
                    else:
                        data = carry + chunk if carry else chunk
                    arr = np.frombuffer(data, dtype=np.uint8)
                    off = 0
                    while off < len(arr):
                        rows, consumed, nr, nb, phase = self._segment(
                            native, arr[off:], is_fasta, phase, buf, row
                        )
                        row += rows
                        self.reads += nr
                        self.bases += nb
                        off += consumed
                        stalled = consumed == 0 and rows == 0
                        if stalled and data.find(b"\n", off) == -1:
                            break  # incomplete tail line -> carry
                        if stalled and row == 0:
                            raise ValueError(
                                "single sequence line needs more than "
                                f"batch_segs={self.batch_segs} segment rows; "
                                "raise batch_segs (whole-genome FASTA lines)"
                            )
                        if row == self.batch_segs or stalled:
                            # buffer full (exactly, or the next read needs
                            # more rows than remain): flush and keep going
                            yield buf
                            buf = self._new_buf()
                            row = 0
                    carry = data[off:] if off < len(data) else b""
        if row:
            yield buf

    def _fasta_into_buf(self, path: str, buf, row: int):
        """Generator: segment one FASTA file (record-joined spans) into the
        shared native batch buffer; yields full buffers, returns the final
        (buf, row)."""
        from kmcex_tpu_torch.count.extract import pack_codes_np

        for block, starts, ends, n_reads, n_bases in _iter_seq_spans(
                path, k=self.k):
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


def segment_batches(input_spec: str, k: int, seg_len: int = DEFAULT_SEG_LEN,
                    batch_segs: int = DEFAULT_BATCH_SEGS) -> SegmentStream:
    """The unpacked code-batch stream (the host accumulator's input)."""
    return SegmentStream(input_spec, k, seg_len, batch_segs, packed=False)


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
