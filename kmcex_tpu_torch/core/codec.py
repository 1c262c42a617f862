"""2-bit k-mer codec: base LUT, reverse complement, canonicalization.

Semantics of the reference utilities (tools.hpp): A=0 C=1 G=2 T=3,
MSB-first packing (the first base in the highest bit pair, tools.hpp:63-76),
reverse complement on the packed word (tools.hpp:130-139), canonical k-mer
= min(kmer, revcomp(kmer)) as an UNSIGNED compare (tools.hpp:141-167).

Host half: NumPy (``_BASE_LUT`` for the FASTQ path).  Device half: PyTorch
on ``int64`` tensors that hold the raw uint64 bit pattern — torch's uint64
lacks ``>>``, ``<`` and ``minimum`` on the CPU.  Two things differ from the
uint64 formulas of the JAX package and are handled here:

  * ``>>`` on int64 is arithmetic; ``_srl`` masks it into a logical shift.
    The revcomp starts from ``~v``, so an arithmetic shift would smear ones
    into the result even for k <= 31.
  * ``<`` on int64 is signed; ``umin`` compares under the order-preserving
    bias ``x ^ (1 << 63)``, which matters for k = 32 keys with bit 63 set.
"""

from __future__ import annotations

import numpy as np
import torch

# Map ASCII byte -> 2-bit code; 255 marks non-ACGT (N etc.).
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE_LUT[_c] = _i

# x ^ BIAS maps unsigned order onto signed int64 order.
BIAS = -(1 << 63)

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a static 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def revcomp(v: torch.Tensor, k: int) -> torch.Tensor:
    """Bit-parallel reverse complement of 2-bit packed k-mers (int64):
    complement every base, reverse the 2-bit groups of the whole 64-bit
    word with a mask ladder, then right-align to k bases."""
    x = ~v
    # every masked shift below already clears the bits an arithmetic shift
    # smears in (each mask's top group is zero); only the last two need _srl
    x = ((x & _M2) << 2) | ((x >> 2) & _M2)
    x = ((x & _M4) << 4) | ((x >> 4) & _M4)
    x = ((x & _M8) << 8) | ((x >> 8) & _M8)
    x = ((x & _M16) << 16) | ((x >> 16) & _M16)
    x = (x << 32) | _srl(x, 32)
    return _srl(x, 64 - 2 * k)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum of int64 bit patterns."""
    return torch.where((a ^ BIAS) < (b ^ BIAS), a, b)


def canonical(v: torch.Tensor, k: int) -> torch.Tensor:
    """min(kmer, revcomp(kmer)) under unsigned order (tools.hpp:146-167)."""
    return umin(v, revcomp(v, k))
