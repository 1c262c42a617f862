"""2-bit k-mer codec: base LUT, reverse complement, canonicalization.

Semantics of the reference utilities (tools.hpp): A=0 C=1 G=2 T=3,
MSB-first packing (the first base in the highest bit pair, tools.hpp:63-76),
reverse complement on the packed word (tools.hpp:130-139), canonical k-mer
= min(kmer, revcomp(kmer)) as an UNSIGNED compare (tools.hpp:141-167).

Host half: NumPy (``_BASE_LUT`` for the FASTQ path, the string and uint64
helpers of the query API).  Device half: PyTorch
on ``int64`` tensors that hold the raw uint64 bit pattern — torch's uint64
lacks ``>>``, ``<`` and ``minimum`` on the CPU.  These things differ from the
uint64 formulas of the JAX package and are handled here:

  * ``>>`` on int64 is arithmetic; ``_srl`` masks it into a logical shift.
    The revcomp starts from ``~v``, so an arithmetic shift would smear ones
    into the result even for k <= 31.
  * ``<`` on int64 is signed; ``umin`` compares under the order-preserving
    bias ``x ^ (1 << 63)``, which matters for k = 32 keys with bit 63 set.
  * torch has no unsigned ``%``; ``umod`` builds it from a halved dividend
    (hash values use all 64 bits, so half of them are negative as int64).
  * counts are uint32 bit patterns in int32 tensors (they saturate at
    2^32-1 as the JAX package's do); ``u32`` widens them before any compare
    and ``u32_bits`` narrows a sum back.
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

# ASCII codes for the 2-bit alphabet, index = 2-bit code.
ACGT_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)

_U64 = np.uint64

# x ^ BIAS maps unsigned order onto signed int64 order.
BIAS = -(1 << 63)

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


# ------------------------------------------------------------ host (NumPy)
def encode_bases(ascii_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 array -> 2-bit codes (255 for non-ACGT). Any shape."""
    return _BASE_LUT[ascii_bytes]


def string_to_codes(s: str) -> np.ndarray:
    return encode_bases(np.frombuffer(s.encode(), dtype=np.uint8))


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes [..., k] into uint64 [...], MSB-first (tools.hpp:63-76)."""
    k = codes.shape[-1]
    shifts = (2 * (k - 1 - np.arange(k))).astype(_U64)
    return np.bitwise_or.reduce(codes.astype(_U64) << shifts, axis=-1)


def string_to_u64(s: str) -> int:
    """Reference Tools::kmers2uint64 (tools.hpp:63-76)."""
    return int(pack_codes_np(string_to_codes(s)))


def u64_to_string(v: int, k: int) -> str:
    """Reference Tools::uint64_to_string (tools.hpp:90-100)."""
    out = bytearray(k)
    v = int(v)
    for i in range(k - 1, -1, -1):
        out[i] = ACGT_BYTES[v & 3]
        v >>= 2
    return out.decode()


def strings_to_u64(kmers: list[str], k: int) -> np.ndarray:
    """Vectorized kmers2uint64 for a batch of equal-length k-mer strings."""
    buf = np.frombuffer("".join(kmers).encode(), dtype=np.uint8)
    return pack_codes_np(encode_bases(buf.reshape(len(kmers), k)))


def unpack_u64_np(v: np.ndarray, k: int) -> np.ndarray:
    """uint64 [...] -> 2-bit codes [..., k], MSB-first."""
    shifts = (2 * (k - 1 - np.arange(k))).astype(_U64)
    return ((v[..., None] >> shifts) & _U64(3)).astype(np.uint8)


def revcomp_np(v: np.ndarray, k: int) -> np.ndarray:
    """Reference Tools::get_complementation(uint64, len) (tools.hpp:130-139)."""
    u = _U64
    x = ~np.asarray(v, dtype=_U64)
    x = ((x & u(_M2)) << u(2)) | ((x >> u(2)) & u(_M2))
    x = ((x & u(_M4)) << u(4)) | ((x >> u(4)) & u(_M4))
    x = ((x & u(_M8)) << u(8)) | ((x >> u(8)) & u(_M8))
    x = ((x & u(_M16)) << u(16)) | ((x >> u(16)) & u(_M16))
    x = (x << u(32)) | (x >> u(32))
    return x >> u(64 - 2 * k)


def canonical_np(v: np.ndarray, k: int) -> np.ndarray:
    """Reference Tools::get_min_kmer / get_min_com_kmer_uint (tools.hpp:146-167)."""
    v = np.asarray(v, dtype=_U64)
    return np.minimum(v, revcomp_np(v, k))


def ascii_bytes_np(v: np.ndarray, k: int) -> np.ndarray:
    """uint64 [...] -> ASCII uint8 [..., k] (the string form the hashes run over)."""
    return ACGT_BYTES[unpack_u64_np(np.asarray(v, dtype=_U64), k)]


def middle_kmer_np(v: np.ndarray, k: int) -> np.ndarray:
    """The (k-2)-mer kmer[1:k-1] of a packed k-mer (back Bloom filters hash it;
    kmodel.hpp:386-390,475,548)."""
    v = np.asarray(v, dtype=_U64)
    mask = (_U64(1) << _U64(2 * (k - 1))) - _U64(1)
    return (v & mask) >> _U64(2)


# --------------------------------------------------- device (int64 tensors)
def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a static 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def u32(c: torch.Tensor) -> torch.Tensor:
    """int32 tensors holding uint32 bit patterns (the count column) -> their
    values as int64.  Every compare or clamp of counts on the device reads
    them through this."""
    return c.to(torch.int64) & 0xFFFFFFFF


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same 32 bits as int32 (the inverse
    of ``u32``)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


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


def umod(h: torch.Tensor, m) -> torch.Tensor:
    """``h % m`` with ``h`` read as UNSIGNED 64-bit (int64 bit patterns) and
    0 < m < 2^62 (a Python int or a broadcastable int64 tensor).  Exact:
    h = 2 * (h >> 1) + (h & 1), and every intermediate stays below 2^63."""
    return ((_srl(h, 1) % m) * 2 + (h & 1)) % m


def ascii_bytes(v: torch.Tensor, k: int) -> torch.Tensor:
    """int64 packed k-mers [...] -> ASCII uint8 [..., k], the string form the
    hashes run over.  The codes 0..3 map to "ACGT" (65, 67, 71, 84) by
    arithmetic, so no index tensor is made."""
    shifts = torch.arange(2 * (k - 1), -1, -2, dtype=torch.int64,
                          device=v.device)
    # an arithmetic shift is enough: only the two lowest bits are kept
    c = ((v[..., None] >> shifts) & 3).to(torch.uint8)
    return 65 + 2 * c + (c >> 1) * (2 + 11 * (c & 1))


def middle_kmer(v: torch.Tensor, k: int) -> torch.Tensor:
    """The (k-2)-mer kmer[1:k-1] of packed k-mers (the back filters hash it)."""
    return (v & ((1 << (2 * (k - 1))) - 1)) >> 2
