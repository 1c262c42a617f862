"""K-mer extraction and sort-count: code batches -> canonical packed k-mers.

The counterpart of the JAX package's ``count/extract.py``, in PyTorch.  For
a [B, L] batch of 2-bit codes all L-k+1 windows are packed with a static
k-step shift ladder, windows holding an invalid base are masked with a
cumulative sum of invalid flags, and the canonical form comes from the
bit-parallel reverse complement of ``core.codec``.  Masked windows hold
SENTINEL (``-1`` as int64), which sorts last in unsigned order.

Cites: window walk kmc_file.cpp:991-1133 (GetCountersForRead), canonical
min tools.hpp:146-167.

The sort and compaction steps dispatch to ``count.sort`` and
``count.compact``: the CUDA kernels for a CUDA tensor, the plain PyTorch
versions for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.count.compact import compact_pairs
from kmcex_tpu_torch.count.sort import sort_u64

SENTINEL = -1


def _extract_core(codes: torch.Tensor, invalid: torch.Tensor, k: int):
    """codes [B, L] uint8 in 0..3, invalid [B, L] bool -> (kmers [B*W]
    canonical int64 with SENTINEL at invalid windows, n_valid)."""
    B, L = codes.shape
    W = L - k + 1
    csum = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=codes.device),
         torch.cumsum(invalid.to(torch.int32), dim=1, dtype=torch.int32)],
        dim=1)
    win_ok = (csum[:, k:] - csum[:, :-k]) == 0  # [B, W]
    c = codes.to(torch.int64)
    kmer = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    for t in range(k):  # static ladder
        kmer |= c[:, t : t + W] << (2 * (k - 1 - t))
    kmer = codec.canonical(kmer, k)
    kmer = torch.where(win_ok, kmer, SENTINEL)
    return kmer.reshape(-1), win_ok.sum()


def extract_canonical(codes: torch.Tensor, k: int):
    """[B, L] uint8 codes (0..3 valid, else invalid) -> (kmers [B*W] int64
    canonical with SENTINEL at invalid windows, n_valid). W = L-k+1."""
    invalid = codes > 3
    return _extract_core(torch.where(invalid, 0, codes), invalid, k)


def extract_canonical_packed(packed: torch.Tensor, maskbits: torch.Tensor,
                             k: int):
    """Packed variant: ``packed`` [B, L/4] uint8 holds 4 bases/byte
    (little-endian 2-bit fields), ``maskbits`` [B, L/8] uint8 holds validity
    bits (little-endian) — the native segmenter's transfer format, 4x fewer
    host->device bytes than raw codes."""
    B, P4 = packed.shape
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(B, P4 * 4)
    mshifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    vbits = ((maskbits[:, :, None] >> mshifts) & 1).reshape(B, -1)
    return _extract_core(codes, vbits == 0, k)


def pack_codes_np(codes: np.ndarray):
    """Host-side pack: [B, L] uint8 codes (255 = invalid), L % 8 == 0 ->
    (packed [B, L/4], maskbits [B, L/8]) — used for FASTA input, which the
    NumPy record joiner segments."""
    B, L = codes.shape
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint8).reshape(B, L // 4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    maskbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, maskbits


def sorted_u64(x: torch.Tensor) -> torch.Tensor:
    """Ascending unsigned sort of a flat int64 key vector."""
    return sort_u64(x)


def sorted_u64_with_payload(k: torch.Tensor, c: torch.Tensor):
    """Ascending (int64 key, int32 payload) sort."""
    return sort_u64(k, c)


def segment_compact(s: torch.Tensor):
    """Segment-count duplicates of an already-sorted k-mer array and compact.

    Returns (unique_sorted [N] with SENTINEL padding at the tail, counts [N]
    int32 aligned, n_unique scalar tensor).  SENTINEL entries (masked
    windows) are dropped.  Each run boundary carries its ORIGINAL POSITION
    through the compaction; run lengths are then diffs of consecutive
    compacted positions (the last run ends at n_real: sentinels sort last).
    No host sync."""
    n = s.numel()
    idxs = torch.arange(n, dtype=torch.int32, device=s.device)
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    real = s != SENTINEL
    valid = first & real
    n_real = real.sum(dtype=torch.int32)
    key = torch.where(valid, s, SENTINEL)
    pos = torch.where(valid, idxs, 0)  # run-start position
    n_unique = valid.sum()
    uniq_c, pos_c = compact_pairs(key, pos)
    nu32 = n_unique.to(torch.int32)
    shifted = torch.cat([pos_c[1:], pos_c.new_zeros(1)])
    next_pos = torch.where(idxs + 1 < nu32, shifted, n_real)
    counts_c = torch.where(idxs < nu32, next_pos - pos_c, 0)
    return uniq_c, counts_c.to(torch.int32), n_unique


def sort_count_unique(kmers: torch.Tensor):
    """Sort a flat int64 k-mer array and segment-count duplicates (see
    segment_compact for the return value)."""
    return segment_compact(sorted_u64(kmers))
