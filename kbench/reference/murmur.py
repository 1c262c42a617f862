"""MurmurHash64A over the ASCII string of a 2-bit packed k-mer, in plain
PyTorch on int64 tensors (the bits of a uint64), and the hash seed table.

The upstream model hashes the k-mer's ASCII string (A, C, G, T; first base
first) with MurmurHash64A, seeded from a table of 128 primes
(``HashSeeds``, kmcEx tools.hpp:9 and 16-50): the 128 consecutive primes
from 46757.  Multiplication wraps in int64 as it does in uint64; right
shifts are made logical with a mask.
"""

from __future__ import annotations

import torch

_M = -0x395B586CA42E166B          # 0xc6a4a7935bd1e995 as a signed int64
_R = 47
_ASCII = (65, 67, 71, 84)          # A C G T


def hash_seeds(n: int = 128, first: int = 46757) -> list[int]:
    """The first ``n`` primes from ``first`` on."""
    out, x = [], first
    while len(out) < n:
        if x > 1 and all(x % d for d in range(2, int(x ** 0.5) + 1)):
            out.append(x)
        x += 1
    return out


SEEDS = hash_seeds()


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def ascii_words(v: torch.Tensor, length: int):
    """(full little-endian 8-byte words [n, length // 8], tail word [n])
    of the ASCII strings of k-mers ``v`` of ``length`` bases."""
    lut = torch.tensor(_ASCII, dtype=torch.int64, device=v.device)
    chars = [lut[(v >> (2 * (length - 1 - i))) & 3] for i in range(length)]
    nfull = length // 8
    words = []
    for w in range(nfull):
        acc = torch.zeros_like(v)
        for t in range(8):
            acc |= chars[8 * w + t] << (8 * t)
        words.append(acc)
    tail = torch.zeros_like(v)
    for t in range(length & 7):
        tail |= chars[8 * nfull + t] << (8 * t)
    full = (torch.stack(words, 1) if words
            else torch.zeros((v.numel(), 0), dtype=torch.int64, device=v.device))
    return full, tail


def murmur_prepare(v: torch.Tensor, length: int):
    """The seed-free part of the hash of each string: its mixed blocks."""
    full, tail = ascii_words(v, length)
    mixed = []
    for i in range(full.shape[1]):
        x = full[:, i] * _M
        x = x ^ _shr(x, _R)
        mixed.append(x * _M)
    return mixed, tail, length


def murmur_eval(prep, seed: int) -> torch.Tensor:
    """MurmurHash64A of each prepared string with ``seed``."""
    mixed, tail, length = prep
    h0 = (seed ^ ((length * 0xC6A4A7935BD1E995) & (2 ** 64 - 1)))
    if h0 >= 1 << 63:
        h0 -= 1 << 64
    h = torch.full_like(tail, h0)
    for x in mixed:
        h = (h ^ x) * _M
    if length & 7:
        h = (h ^ tail) * _M
    h = h ^ _shr(h, _R)
    h = h * _M
    return h ^ _shr(h, _R)


def umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h`` read as unsigned 64 bits, modulo ``m`` (0 < m < 2**62)."""
    r = torch.remainder(h, m)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % m, m), r)


def middle(v: torch.Tensor, k: int) -> torch.Tensor:
    """The middle (k-2)-mer: the k-mer without its first and last base."""
    return (v >> 2) & ((1 << (2 * (k - 2))) - 1)
