"""ctypes bindings for the hand-written CUDA kernels of ``csrc/``.

The library is built by nvcc at first use (``native.build.build_kernels``);
nothing here runs at import.  Every C entry point takes raw device pointers
plus the CUDA stream and returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception.

``LAUNCHES`` counts, per wrapper, the calls that went to a CUDA kernel (a
CPU tensor goes to the plain PyTorch version and is not counted), so a run
can show that the main path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from kmcex_tpu_torch.native.build import build_kernels

LAUNCHES: dict[str, int] = {"sort_u64": 0, "merge_sorted_u64": 0,
                            "compact_pairs": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(str(build_kernels()))
            _declare(L)
            _lib = L
    return _lib


def _declare(L: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    L.kx_sort_u64.restype = i32
    L.kx_sort_u64.argtypes = [p, p, i64, p, p, p, p, p, p]
    L.kx_sort_workspace_bytes.restype = i64
    L.kx_sort_workspace_bytes.argtypes = [i64]
    L.kx_merge_u64.restype = i32
    L.kx_merge_u64.argtypes = [p, p, i64, p, p, i64, p, p, p]
    L.kx_merge_tile.restype = i32
    L.kx_merge_tile.argtypes = []
    L.kx_compact_pairs.restype = i32
    L.kx_compact_pairs.argtypes = [p, p, i64, p, p, p, p]
    L.kx_compact_tile.restype = i32
    L.kx_compact_tile.argtypes = []
    L.kx_compact_scratch_words.restype = i64
    L.kx_compact_scratch_words.argtypes = [i64]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
