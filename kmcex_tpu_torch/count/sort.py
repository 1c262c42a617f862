"""Sort and merge of 64-bit k-mer keys: CUDA kernels and their plain versions.

The counterpart of the JAX package's ``count/sort_pallas.py``.  Keys are
``int64`` tensors holding the raw uint64 bit pattern (SENTINEL
``0xFFFF_FFFF_FFFF_FFFF`` is ``-1``); payloads are ``int32``.  Order is
always UNSIGNED, so SENTINEL sorts last.

* ``sort_u64(keys[, payload])`` — the K1 + K2 contract
  (``_block_sort`` / ``_hbm_step`` over ``_merge_tree``), kernel in
  ``csrc/sort.cu``.
* ``merge_sorted_u64(a, ca, b, cb)`` — the K2-with-``asc_override`` and K3
  (``_bitonic_finish_single``) contract, kernel in ``csrc/merge.cu``.

A CPU tensor goes to the plain PyTorch version (``*_plain``); a CUDA tensor
goes to the kernel, or the wrapper raises.  Unlike the TPU entry points the
results are exactly as long as the input (no power-of-two padding).
"""

from __future__ import annotations

import torch

from kmcex_tpu_torch.core.codec import BIAS
from kmcex_tpu_torch.native import kernels

SENTINEL = -1
_TILE = 2048  # csrc/sort.cu tile: the padded length is a power of two >= it


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def sort_u64_plain(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """``torch.sort`` on the biased keys; the payload follows by the
    returned indices (ties unstable)."""
    vals, idx = torch.sort(keys ^ BIAS)
    out = vals ^ BIAS
    if payload is None:
        return out
    return out, payload[idx]


def merge_sorted_u64_plain(a, ca, b, cb):
    """Concatenate + sort (ties unstable)."""
    return sort_u64_plain(torch.cat([a, b]), torch.cat([ca, cb]))


def _is_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def sort_u64(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """Ascending unsigned sort of int64 keys, with an optional int32 payload
    that follows its key.  Returns keys, or (keys, payload)."""
    ts = (keys,) if payload is None else (keys, payload)
    if _is_cpu(*ts):
        return sort_u64_plain(keys, payload)
    kernels.require_cuda(keys, torch.int64, "keys")
    if payload is not None:
        kernels.require_cuda(payload, torch.int32, "payload")
        if payload.shape != keys.shape:
            raise ValueError("payload must match keys")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    n = keys.numel()
    if n == 0:
        return keys.clone() if payload is None else (keys.clone(),
                                                     payload.clone())
    lib = kernels.lib()
    N = max(_TILE, _next_pow2(n))
    buf = torch.empty(N, dtype=torch.int64, device=keys.device)
    buf[:n].copy_(keys)
    buf[n:].fill_(SENTINEL)
    pbuf = None
    if payload is not None:
        pbuf = torch.empty(N, dtype=torch.int32, device=keys.device)
        pbuf[:n].copy_(payload)
        pbuf[n:].fill_(-1)  # (SENTINEL, 0xFFFFFFFF) sorts behind any input
    rc = lib.kx_sort_u64(buf.data_ptr(),
                         None if pbuf is None else pbuf.data_ptr(), N,
                         kernels.stream_ptr(buf))
    kernels.check(rc, "kx_sort_u64")
    kernels.LAUNCHES["sort_u64"] += 1
    if pbuf is None:
        return buf[:n]
    return buf[:n], pbuf[:n]


def merge_sorted_u64(a: torch.Tensor, ca: torch.Tensor, b: torch.Tensor,
                     cb: torch.Tensor):
    """Merge two ascending (int64 key, int32 payload) runs into one ascending
    run of length len(a) + len(b).  Any run lengths; SENTINEL-padded runs
    merge their padding to the tail."""
    if _is_cpu(a, ca, b, cb):
        return merge_sorted_u64_plain(a, ca, b, cb)
    for t, dt, name in ((a, torch.int64, "a"), (ca, torch.int32, "ca"),
                        (b, torch.int64, "b"), (cb, torch.int32, "cb")):
        kernels.require_cuda(t, dt, name)
    if a.shape != ca.shape or b.shape != cb.shape:
        raise ValueError("payloads must match their runs")
    lib = kernels.lib()
    n = a.numel() + b.numel()
    ok = torch.empty(n, dtype=torch.int64, device=a.device)
    oc = torch.empty(n, dtype=torch.int32, device=a.device)
    rc = lib.kx_merge_u64(a.data_ptr(), ca.data_ptr(), a.numel(),
                          b.data_ptr(), cb.data_ptr(), b.numel(),
                          ok.data_ptr(), oc.data_ptr(), kernels.stream_ptr(ok))
    kernels.check(rc, "kx_merge_u64")
    kernels.LAUNCHES["merge_sorted_u64"] += 1
    return ok, oc
