"""MurmurHash64A with the reference's fixed seed table.

Bit-exact port of ``Tools::murmur_hash64`` (tools.hpp:16-50): the hash runs
over the **ASCII byte string** of the k-mer (not its packed bits), consuming
little-endian 8-byte words then a 1-7 byte tail, with the standard murmur64A
mixing constants.  ``HASH_SEEDS`` is the reference's fixed table of 128
primes (tools.hpp:9) — every Bloom filter and coupled bit array derives its
probe positions from these seeds, so hash parity here is the root of all
model parity.

Three implementations:
  * ``murmur64_py`` — scalar Python ints, for golden tests / tiny inputs.
  * ``murmur64_np`` — batched NumPy over [N, len] ASCII byte arrays (the host
    oracle).
  * ``murmur_pre`` + ``murmur_eval`` — the two-stage device hash on torch
    int64 tensors that hold the uint64 bit pattern.  int64 ``*`` wraps like
    the unsigned product on the CPU and on CUDA; every constant enters as
    its signed two's-complement value (a Python int above 2^63 raises), and
    ``>> 47`` is the masked logical shift of ``core.codec``.
"""

from __future__ import annotations

import numpy as np
import torch

from kmcex_tpu_torch.core.codec import _srl

# Reference HashSeeds table (tools.hpp:9): 128 consecutive primes.
HASH_SEEDS = np.array(
    [
        46757, 46769, 46771, 46807, 46811, 46817, 46819, 46829, 46831, 46853,
        46861, 46867, 46877, 46889, 46901, 46919, 46933, 46957, 46993, 46997,
        47017, 47041, 47051, 47057, 47059, 47087, 47093, 47111, 47119, 47123,
        47129, 47137, 47143, 47147, 47149, 47161, 47189, 47207, 47221, 47237,
        47251, 47269, 47279, 47287, 47293, 47297, 47303, 47309, 47317, 47339,
        47351, 47353, 47363, 47381, 47387, 47389, 47407, 47417, 47419, 47431,
        47441, 47459, 47491, 47497, 47501, 47507, 47513, 47521, 47527, 47533,
        47543, 47563, 47569, 47581, 47591, 47599, 47609, 47623, 47629, 47639,
        47653, 47657, 47659, 47681, 47699, 47701, 47711, 47713, 47717, 47737,
        47741, 47743, 47777, 47779, 47791, 47797, 47807, 47809, 47819, 47837,
        47843, 47857, 47869, 47881, 47903, 47911, 47917, 47933, 47939, 47947,
        47951, 47963, 47969, 47977, 47981, 48017, 48023, 48029, 48049, 48073,
        48079, 48091, 48109, 48119, 48121, 48131, 48157, 48163,
    ],
    dtype=np.uint64,
)

_M = 0xC6A4A7935BD1E995
_R = 47
_MASK = 0xFFFFFFFFFFFFFFFF


def _signed(x: int) -> int:
    """A uint64 value as the int64 with the same bit pattern."""
    x &= _MASK
    return x - (1 << 64) if x >> 63 else x


_M_I64 = _signed(_M)


def murmur64_py(data: bytes, seed: int) -> int:
    """Scalar reference implementation over a raw byte string."""
    m, r = _M, _R
    n = len(data)
    h = (seed ^ ((n * m) & _MASK)) & _MASK
    nfull = n // 8
    for w in range(nfull):
        k = int.from_bytes(data[8 * w : 8 * w + 8], "little")
        k = (k * m) & _MASK
        k ^= k >> r
        k = (k * m) & _MASK
        h ^= k
        h = (h * m) & _MASK
    tail = data[8 * nfull :]
    if tail:
        t = int.from_bytes(tail, "little")
        h ^= t
        h = (h * m) & _MASK
    h ^= h >> r
    h = (h * m) & _MASK
    h ^= h >> r
    return h


def murmur64_np(ascii_bytes: np.ndarray, seed) -> np.ndarray:
    """Batched host murmur: ascii_bytes [..., len] uint8, seed scalar/array.
    Returns uint64 [...] (broadcast of the batch dims with the seeds)."""
    u = np.uint64
    m, r = u(_M), u(_R)
    n = ascii_bytes.shape[-1]
    b = ascii_bytes.astype(np.uint64)
    with np.errstate(over="ignore"):
        h = np.asarray(seed, dtype=np.uint64) ^ (u(n) * m)
        nfull = n // 8
        for w in range(nfull):
            k = u(0)
            for j in range(8):
                k = k | (b[..., 8 * w + j] << u(8 * j))
            k = k * m
            k = k ^ (k >> r)
            k = k * m
            h = h ^ k
            h = h * m
        if n & 7:
            t = u(0)
            for j in range(n & 7):
                t = t | (b[..., 8 * nfull + j] << u(8 * j))
            h = h ^ t
            h = h * m
        h = h ^ (h >> r)
        h = h * m
        h = h ^ (h >> r)
    return h


def seeds_tensor(seeds, device) -> torch.Tensor:
    """uint64 seeds (NumPy) as an int64 tensor on ``device``."""
    s = np.ascontiguousarray(seeds, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(s).to(device)


def murmur_pre(ascii_bytes: torch.Tensor):
    """Seed-independent half of murmur64: the per-8-byte-block mixes and the
    assembled tail.  The block mix (k*=m; k^=k>>r; k*=m) never sees the
    seed, so for S seed evaluations of the same string (nh probes x n_bits
    arrays on the query path) it runs once instead of S times.

    ascii_bytes [..., n] uint8 -> (blocks [..., n // 8] int64, tail [...]
    int64; the tail is 0 when n is a multiple of 8).

    The little-endian 8-byte words are not assembled byte by byte: each row
    is zero-padded to whole words and re-read as int64 (host and device are
    little-endian), so all blocks and the tail come out of one view, and
    the mix runs over all blocks at once."""
    n = ascii_bytes.shape[-1]
    nfull, nw = n // 8, -(-n // 8)
    if n & 7:
        padded = ascii_bytes.new_zeros(ascii_bytes.shape[:-1] + (8 * nw,))
        padded[..., :n] = ascii_bytes
    else:
        padded = ascii_bytes.contiguous()
    words = padded.view(torch.int64)  # [..., nw]
    k = words[..., :nfull] * _M_I64
    k = k ^ _srl(k, _R)
    blocks = k * _M_I64
    if n & 7:
        tail = words[..., nfull]
    else:
        tail = torch.zeros(ascii_bytes.shape[:-1], dtype=torch.int64,
                           device=ascii_bytes.device)
    return blocks, tail


def murmur_eval(blocks: torch.Tensor, tail: torch.Tensor, n: int,
                seeds: torch.Tensor) -> torch.Tensor:
    """Fold precomputed blocks under each seed: blocks [..., n // 8], tail
    [...], seeds [S] int64 (see ``seeds_tensor``) -> hashes [..., S] int64,
    bit-identical to ``murmur64_np`` of the same string."""
    h = seeds ^ _signed(n * _M)  # [S]
    h = h.expand(blocks.shape[:-1] + seeds.shape)
    for w in range(blocks.shape[-1]):
        h = (h ^ blocks[..., w, None]) * _M_I64
    if n & 7:
        h = (h ^ tail[..., None]) * _M_I64
    h = h ^ _srl(h, _R)
    h = h * _M_I64
    return h ^ _srl(h, _R)
