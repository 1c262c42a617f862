"""Stable compaction of (key, count) pairs: CUDA kernel and plain version.

The counterpart of the JAX package's ``count/compact_pallas.py`` (K4,
``_shift_compact`` + the ``compact_pairs`` stitch).  ``compact_pairs``
moves every pair whose key is not SENTINEL (``-1`` as int64) to the front
in input order and fills the tail with (SENTINEL, 0); the output is as long
as the input.  A CPU tensor goes to the plain version (boolean-mask select
+ pad); a CUDA tensor goes to ``csrc/compact.cu`` (one pass with decoupled
look-back, then the tail fill), or the wrapper raises.  Every call, on either
device, adds its pairs to the current ``utils.timing`` record
(``compact_pairs.pairs``).
"""

from __future__ import annotations

import torch

from kmcex_tpu_torch.native import kernels
from kmcex_tpu_torch.utils import timing

SENTINEL = -1
# tiles that kx_compact_pairs takes (it refuses more)
MAX_TILES = (1 << 31) - 1


def compact_pairs_plain(keys: torch.Tensor, counts: torch.Tensor):
    live = keys != SENTINEL
    n, m = keys.numel(), int(live.sum())
    out_k = torch.full((n,), SENTINEL, dtype=keys.dtype, device=keys.device)
    out_c = torch.zeros(n, dtype=counts.dtype, device=counts.device)
    out_k[:m] = keys[live]
    out_c[:m] = counts[live]
    return out_k, out_c


def _check_tiles(n: int, tile: int) -> int:
    """The number of tiles of ``n`` pairs; raises, before any launch, where
    the C entry point would refuse them."""
    tiles = -(-n // tile)
    if tiles > MAX_TILES:
        raise ValueError(f"compact_pairs takes at most {MAX_TILES * tile} "
                         f"pairs on the card, got {n}")
    return tiles


def compact_pairs(keys: torch.Tensor, counts: torch.Tensor):
    """(int64 keys, int32 counts) -> (keys, counts) with the non-SENTINEL
    pairs first, in order, and a (SENTINEL, 0) tail."""
    timing.count("compact_pairs.pairs", keys.numel())
    if keys.device.type == "cpu" and counts.device.type == "cpu":
        return compact_pairs_plain(keys, counts)
    kernels.require_cuda(keys, torch.int64, "keys")
    kernels.require_cuda(counts, torch.int32, "counts")
    if keys.dim() != 1 or keys.shape != counts.shape:
        raise ValueError("keys and counts must be 1-D and of one length")
    n = keys.numel()
    out_k = torch.empty(n, dtype=torch.int64, device=keys.device)
    out_c = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return out_k, out_c
    lib = kernels.lib()
    _check_tiles(n, lib.kx_compact_tile())
    scratch = torch.zeros(lib.kx_compact_scratch_words(n), dtype=torch.int64,
                          device=keys.device)
    kernels.check(lib.kx_compact_pairs(keys.data_ptr(), counts.data_ptr(), n,
                                       out_k.data_ptr(), out_c.data_ptr(),
                                       scratch.data_ptr(),
                                       kernels.stream_ptr(keys)),
                  "kx_compact_pairs")
    kernels.LAUNCHES["compact_pairs"] += 1
    return out_k, out_c
