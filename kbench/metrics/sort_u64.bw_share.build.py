"""Share of the memory-bandwidth bound that ``sort_u64`` reaches in the
traced build: ``kernels.bw_share.build`` over this one operation, with that
file's kernel names and byte function."""

import os

from kbench.harness import load_metric

UNIT = "%"
LAYER = "kernels: csrc/sort.cu, csrc/merge.cu, csrc/compact.cu"
MOVES = "build_mreads_per_s"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read(ctx):
    return load_metric(_ROOT, "kernels.bw_share.build").read(
        ctx, ops=("sort_u64",))
