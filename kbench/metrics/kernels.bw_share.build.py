"""Share of the memory-bandwidth bound that the three kernel operations of
the traced build reach together: the bytes their calls need, over the
device's peak bandwidth, over the device time of their kernels.

Bytes count each input byte read once and each output byte written once
(int64 keys, int32 counts or payload):

* ``sort_u64``: keys in and out, 16 bytes a key, 8 more with a payload;
* ``merge_sorted_u64``: both runs in, the merged run out, 24 bytes an entry;
* ``compact_pairs``: the pairs in, as many slots out, 24 bytes a pair.

The element counts come from the benchmark's wrappers around the three
operations, the times from the trace, by the kernel names below; so the
share reads the same work whatever kernel implements an operation.
"""

from kbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "kernels: csrc/sort.cu, csrc/merge.cu, csrc/compact.cu"
MOVES = "build_mreads_per_s"

KERNELS = {
    "sort_u64": ("digit_histograms", "bin_starts", "onesweep_pass"),
    "merge_sorted_u64": ("merge_tiles",),
    "compact_pairs": ("compact_pass", "fill_tail"),
}


def sort_bytes(c: dict) -> int:
    return 16 * c["keys"] + 8 * c["payload"]


def merge_bytes(c: dict) -> int:
    return 24 * (c["a"] + c["b"])


def compact_bytes(c: dict) -> int:
    return 24 * c["pairs"]


BYTES = {"sort_u64": sort_bytes, "merge_sorted_u64": merge_bytes,
         "compact_pairs": compact_bytes}


def read(ctx, ops=tuple(KERNELS)):
    peak = hbm_bytes_per_s(ctx.device_kind)
    if ctx.trace is None or peak is None:
        return None
    nbytes = sum(BYTES[op](c) for op in ops for c in ctx.calls[op])
    secs = ctx.trace.kernel_seconds({n for op in ops for n in KERNELS[op]})
    if nbytes == 0 or secs <= 0:
        return None
    return 100.0 * nbytes / peak / secs
