"""Host accumulation of per-batch k-mer counts (the NumPy LSM).

The counterpart of the JAX package's ``count/counter.py``: per batch the
device extracts, sorts and dedupes (``count.extract``); the host keeps the
per-batch (unique, count) runs and merges them LSM-style (binary merge of
similar-size sorted runs), so total merge work stays O(N log R).  The
result is the information content of a KMC database: sorted canonical
(k-mer, count) pairs with [ci, cs] filtering and clamping (KMC -ci/-cs
semantics, main.cpp:137).  ``count.device_lsm`` keeps the runs on the
device instead and is the default; this one is ``accumulator="host"``.
"""

from __future__ import annotations

import numpy as np
import torch

from kmcex_tpu_torch.count import extract
from kmcex_tpu_torch.utils.device import resolve_device


def merge_runs(
    a: tuple[np.ndarray, np.ndarray], b: tuple[np.ndarray, np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Merge two sorted (kmers, counts) runs, summing duplicate counts."""
    ka, ca = a
    kb, cb = b
    k = np.concatenate([ka, kb])
    c = np.concatenate([ca, cb])
    order = np.argsort(k, kind="stable")
    k = k[order]
    c = c[order]
    if len(k) == 0:
        return k, c
    first = np.empty(len(k), dtype=bool)
    first[0] = True
    np.not_equal(k[1:], k[:-1], out=first[1:])
    idx = np.flatnonzero(first)
    sums = np.add.reduceat(c.astype(np.uint64), idx)
    return k[idx], sums


class CountAccumulator:
    def __init__(self, k: int, device=None):
        self.k = k
        self.device = resolve_device(device)
        self.runs: list[tuple[np.ndarray, np.ndarray]] = []
        self.total_windows = 0

    def add_kmer_run(self, kmers: np.ndarray, counts: np.ndarray) -> None:
        """Push one sorted unique run and rebalance (binary-counter merge)."""
        self.runs.append((kmers, counts.astype(np.uint64)))
        while len(self.runs) >= 2 and len(self.runs[-2][0]) < 2 * len(self.runs[-1][0]):
            b = self.runs.pop()
            a = self.runs.pop()
            self.runs.append(merge_runs(a, b))

    def add_batch(self, codes: np.ndarray) -> None:
        """Extract + count one [B, L] code batch (tensor or NumPy array) on
        the device, absorb on the host."""
        codes = torch.as_tensor(codes).to(self.device)
        kmers, _ = extract.extract_canonical(codes, self.k)
        uniq, counts, n_unique = extract.sort_count_unique(kmers)
        n = int(n_unique)
        self.total_windows += int(kmers.shape[0])
        if n:
            self.add_kmer_run(uniq[:n].cpu().numpy().view(np.uint64),
                              counts[:n].cpu().numpy().view(np.uint32))

    def finalize(self, ci: int = 1, cs: int = 0xFFFFFFFF) -> tuple[np.ndarray, np.ndarray]:
        """Merge all runs; apply KMC -ci (drop) and -cs (clamp) semantics."""
        while len(self.runs) >= 2:
            b = self.runs.pop()
            a = self.runs.pop()
            self.runs.append(merge_runs(a, b))
        if not self.runs:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32)
        kmers, counts = self.runs[0]
        keep = counts >= ci
        kmers, counts = kmers[keep], counts[keep]
        counts = np.minimum(counts, cs).astype(np.uint32)
        return kmers, counts


def count_codes_batches(batches, k: int, ci: int = 1, cs: int = 0xFFFFFFFF,
                        device=None):
    acc = CountAccumulator(k, device=device)
    for codes in batches:
        acc.add_batch(codes)
    return acc.finalize(ci, cs)
