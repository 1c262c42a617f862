"""Run configuration for the kmcEx-compatible pipeline.

Mirrors the reference CLI parameter surface (``KParams`` struct,
the reference main.cpp:16-27) with the same defaults: k=31, t=4, ci=1,
cs=1023, nh=7, nb=5.  ``t`` sets the host thread count of the native
encoder; device parallelism is the GPU's own.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class KParams:
    k: int = 31  # k-mer length (2 <= k <= 32: k-mers are 2-bit packed in uint64)
    num_hash: int = 7  # nh: hash functions per coupled bit array
    num_bit: int = 5  # nb: number of coupled bit-array pairs
    ci: int = 1  # exclude k-mers occurring < ci times
    cs: int = 1023  # counter cap (counts clamp to cs)
    t: int = 4  # thread count (reference compat; used by the native encoder)
    input_file_name: str = ""
    output_file_name: str = ""
    working_directory: str = "/tmp"
    # counting backend (CLI flag -acc): "device" = one GPU; "sharded" = the
    # hash-routed mesh of parallel/ (every visible card, or several processes)
    accumulator: str = "device"
    # checkpoint directory for a resumable count phase (CLI flag -ckpt).
    # Empty = no checkpointing.  A run killed mid-count resumes from the
    # last checkpoint when rerun with the same arguments.
    ckpt_dir: str = ""

    def __post_init__(self) -> None:
        if not (2 <= self.k <= 32):
            raise ValueError(f"k must be in [2, 32], got {self.k}")
        if not (2 <= self.num_hash <= 30):
            raise ValueError(f"num_hash must be in [2, 30], got {self.num_hash}")
        if self.num_bit < 1:
            raise ValueError(f"num_bit must be >= 1, got {self.num_bit}")
        if self.ci < 1:
            raise ValueError(f"ci must be >= 1, got {self.ci}")
        if self.cs < self.ci:
            raise ValueError(f"cs must be >= ci, got cs={self.cs} ci={self.ci}")
        if self.accumulator not in ("device", "sharded"):
            raise ValueError(
                f"accumulator must be device|sharded, got "
                f"{self.accumulator!r}")

    @property
    def max_counter(self) -> int:
        # Reference: OccuBin(max_counter=cs+1, ...) (kmodel.hpp:675).
        return self.cs + 1

    @property
    def bf_num(self) -> int:
        # Number of Bloom-filter pairs (kmodel.hpp:50): 1 when ci==1 else 3.
        return 1 if self.ci == 1 else 3
