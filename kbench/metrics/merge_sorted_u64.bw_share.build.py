"""Share of the memory-bandwidth bound that `merge_sorted_u64` reaches in the
traced build: `kernels.bw_share.build` over this one operation (that file's
kernel names and byte functions), its element counts from the program's
per-call counters (`merge_sorted_u64.a`, `merge_sorted_u64.b`) and its time
from the trace."""

from kbench import spans

UNIT = "%"
LAYER = "kernels: csrc/sort.cu, csrc/merge.cu, csrc/compact.cu"
MOVES = "build_mreads_per_s"


def read(ctx):
    return spans.kernel_share(ctx, "merge_sorted_u64")
