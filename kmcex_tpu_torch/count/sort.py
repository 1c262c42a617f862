"""Sort and merge of 64-bit k-mer keys: CUDA kernels and their plain versions.

The counterpart of the JAX package's ``count/sort_pallas.py``.  Keys are
``int64`` tensors holding the raw uint64 bit pattern (SENTINEL
``0xFFFF_FFFF_FFFF_FFFF`` is ``-1``); payloads are ``int32``.  Order is
always UNSIGNED, so SENTINEL sorts last, and always stable.

* ``sort_u64(keys[, payload])`` — the K1 + K2 contract
  (``_block_sort`` / ``_hbm_step`` over ``_merge_tree``), kernel in
  ``csrc/sort.cu`` (one-sweep LSD radix sort).  Equal keys keep their input
  order.
* ``merge_sorted_u64(a, ca, b, cb)`` — the K2-with-``asc_override`` and K3
  (``_bitonic_finish_single``) contract, kernel in ``csrc/merge.cu`` (a
  tiled merge path through shared memory).  On equal keys, ``a``'s entries
  come first.

A CPU tensor goes to the plain PyTorch version (``*_plain``); a CUDA tensor
goes to the kernel, or the wrapper raises.  Every call, on either device,
adds its element counts to the current ``utils.timing`` record:
``sort_u64.keys`` and ``sort_u64.payload``, ``merge_sorted_u64.a`` and
``merge_sorted_u64.b``.  Unlike the TPU entry points the
results are exactly as long as the input (no power-of-two padding).
"""

from __future__ import annotations

import torch

from kmcex_tpu_torch.core.codec import BIAS
from kmcex_tpu_torch.native import kernels
from kmcex_tpu_torch.utils import timing

# csrc/sort.cu status words hold a 30-bit count
MAX_SORT_N = 1 << 30


def sort_u64_plain(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """Stable ``torch.sort`` on the biased keys; the payload follows by the
    returned indices, equal keys in input order."""
    vals, idx = torch.sort(keys ^ BIAS, stable=True)
    out = vals ^ BIAS
    if payload is None:
        return out
    return out, payload[idx]


def merge_sorted_u64_plain(a, ca, b, cb):
    """Concatenate + stable sort: on equal keys ``a``'s entries come first,
    as in the kernel."""
    return sort_u64_plain(torch.cat([a, b]), torch.cat([ca, cb]))


def _is_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_sort_n(n: int) -> None:
    if n >= MAX_SORT_N:
        raise ValueError(f"sort_u64 takes fewer than {MAX_SORT_N} keys on the "
                         f"card, got {n}")


def sort_u64(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """Stable ascending unsigned sort of int64 keys, with an optional int32
    payload that follows its key.  Returns keys, or (keys, payload), in new
    tensors; the inputs are not written.  On the card n < ``MAX_SORT_N``."""
    ts = (keys,) if payload is None else (keys, payload)
    timing.count("sort_u64.keys", keys.numel())
    timing.count("sort_u64.payload", 0 if payload is None else payload.numel())
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
    _check_sort_n(n)
    if n == 0:
        return keys.clone() if payload is None else (keys.clone(),
                                                     payload.clone())
    lib = kernels.lib()
    dev = keys.device
    # ping-pong scratch: eight radix passes end in the second buffer
    ka = torch.empty(n, dtype=torch.int64, device=dev)
    kb = torch.empty(n, dtype=torch.int64, device=dev)
    pa = pb = None
    if payload is not None:
        pa = torch.empty(n, dtype=torch.int32, device=dev)
        pb = torch.empty(n, dtype=torch.int32, device=dev)
    ws = torch.empty(lib.kx_sort_workspace_bytes(n), dtype=torch.uint8,
                     device=dev)
    rc = lib.kx_sort_u64(keys.data_ptr(),
                         None if payload is None else payload.data_ptr(), n,
                         ka.data_ptr(), kb.data_ptr(),
                         None if pa is None else pa.data_ptr(),
                         None if pb is None else pb.data_ptr(), ws.data_ptr(),
                         kernels.stream_ptr(keys))
    kernels.check(rc, "kx_sort_u64")
    kernels.LAUNCHES["sort_u64"] += 1
    return kb if payload is None else (kb, pb)


def merge_sorted_u64(a: torch.Tensor, ca: torch.Tensor, b: torch.Tensor,
                     cb: torch.Tensor):
    """Merge two ascending (int64 key, int32 payload) runs into one ascending
    run of length len(a) + len(b), in new tensors; the inputs are not
    written.  Unsigned order, ``a``'s entries first on equal keys.  Any run
    lengths; SENTINEL-padded runs merge their padding to the tail."""
    timing.count("merge_sorted_u64.a", a.numel())
    timing.count("merge_sorted_u64.b", b.numel())
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
    if n == 0:
        return ok, oc
    rc = lib.kx_merge_u64(a.data_ptr(), ca.data_ptr(), a.numel(),
                          b.data_ptr(), cb.data_ptr(), b.numel(),
                          ok.data_ptr(), oc.data_ptr(), kernels.stream_ptr(ok))
    kernels.check(rc, "kx_merge_u64")
    kernels.LAUNCHES["merge_sorted_u64"] += 1
    return ok, oc
