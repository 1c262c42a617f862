"""The plain count: every canonical k-mer of every fully-ACGT window of the
reads, counted exactly, in PyTorch on whatever device the reads are on.

The canonical k-mer is the smaller of the forward word and its reverse
complement, 2 bits a base (A=0, C=1, G=2, T=3), first base highest.  A
window that holds any other byte is not counted.  k is at most 31, so every
key fits a non-negative int64 and signed order is unsigned order.
"""

from __future__ import annotations

import torch

_BLOCK = 1 << 18  # reads per step


def _codes(ascii_reads: torch.Tensor) -> torch.Tensor:
    lut = torch.full((256,), 4, dtype=torch.uint8, device=ascii_reads.device)
    for code, ch in enumerate(b"ACGT"):
        lut[ch] = code
    return lut[ascii_reads.long()]


def canonical_windows(ascii_reads: torch.Tensor, k: int) -> torch.Tensor:
    """int64 canonical k-mers of the valid windows of a block of reads."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be 1..31, got {k}")
    n, length = ascii_reads.shape
    w = length - k + 1
    if n == 0 or w <= 0:
        return torch.zeros(0, dtype=torch.int64, device=ascii_reads.device)
    codes = _codes(ascii_reads)
    bad = codes > 3
    c = torch.where(bad, 0, codes).long()
    fwd = torch.zeros((n, w), dtype=torch.int64, device=c.device)
    rc = torch.zeros((n, w), dtype=torch.int64, device=c.device)
    for t in range(k):
        fwd = (fwd << 2) | c[:, t : t + w]
        rc |= (3 - c[:, t : t + w]) << (2 * t)
    nbad = torch.cat([torch.zeros((n, 1), dtype=torch.int32, device=c.device),
                      torch.cumsum(bad.int(), 1, dtype=torch.int32)], 1)
    ok = (nbad[:, k:] - nbad[:, :-k]) == 0
    return torch.minimum(fwd, rc)[ok]


def count_table(ascii_reads: torch.Tensor, k: int, ci: int, cs: int,
                key_bits: int = 62):
    """(kmers ascending, counts, windows): the distinct canonical k-mers with
    their counts, those under ``ci`` left out and the rest clamped at
    ``cs``, and the number of valid windows.

    ``key_bits`` < 2k is the control: keys compared in ``key_bits`` bits
    only, so the k-mers that agree in those bits are counted together (each
    keeps its own key and takes the count of its group)."""
    parts = [canonical_windows(ascii_reads[a : a + _BLOCK], k)
             for a in range(0, ascii_reads.shape[0], _BLOCK)]
    keys = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    windows = keys.numel()
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    del keys
    if key_bits < 2 * k:
        low = uniq & ((1 << key_bits) - 1)
        groups, inv = torch.unique(low, return_inverse=True)
        summed = torch.zeros(groups.numel(), dtype=torch.int64,
                             device=uniq.device).index_add_(0, inv, counts)
        counts = summed[inv]
    keep = counts >= ci
    return uniq[keep], counts[keep].clamp(max=cs), windows
