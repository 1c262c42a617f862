"""OccuBin — the count -> bin quantizer.

Bit-exact port of the reference OccuBin (occu_bin.hpp:16-111).
Counts map to nh-bit bins in three regions ("[1/4, 1/2, 1/4]"):
  * identity region: occ < 2^(nh-2)            -> bin = occ
  * middle region: 2^(nh-1) bins of width 3    -> mean = block_start + 1
  * top region: 2^(nh-2) bins of width
    (max_counter - middle_end) / 2^(nh-2)      -> mean = (2*start + cap) / 2
  * leftover counts snap to the last bin.

The quirks preserved from the reference, because serialized queries depend on
them: integer divisions throughout; ``bin2mean`` uses first-insert-wins (an
``unordered_map::insert``), so the last bin's mean comes from the top region's
final block, not the leftover block; unknown bins decode to 0 (``operator[]``
default-construction).

Implemented as two NumPy LUTs so quantize / decode is a single gather.
"""

from __future__ import annotations

import numpy as np


class OccuBin:
    def __init__(self, max_counter: int, n_hash: int = 7):
        self.max_counter = int(max_counter)
        self.n_hash = int(n_hash)
        be3 = 1 << self.n_hash
        be1 = be3 // 4
        be2 = be1 + be3 // 2
        self.bin_end_index1 = be1
        self.bin_end_index2 = be2
        self.bin_end_index3 = be3

        # occ -> (mean, bin) tables, defaults mirror the uninitialized
        # OccuBinMeta fields (= uint32 -1), though occs < be1 never read them.
        occ_mean = np.full(self.max_counter, np.uint32(0xFFFFFFFF), dtype=np.uint32)
        occ_bin = np.full(self.max_counter, np.uint32(0xFFFFFFFF), dtype=np.uint32)

        def _set(idx: int, mean: int, b: int) -> None:
            # The reference writes unconditionally (out-of-bounds UB for tiny
            # max_counter); we clip, which only diverges where the reference
            # scribbles outside its own array.
            if 0 <= idx < self.max_counter:
                occ_mean[idx] = mean
                occ_bin[idx] = b

        # Middle region: be3/2 bins of capacity 3 (occu_bin.hpp:35-44).
        bin2_num = be3 // 2
        bin2_capacity = 3
        start = be1
        for i in range(bin2_num):
            for j in range(bin2_capacity):
                _set(start + j, start + 1, be1 + i)
            start += bin2_capacity

        # Top region: be3/4 bins of capacity (mc - start)/num (occu_bin.hpp:45-54).
        bin3_num = be3 // 4
        bin3_capacity = (self.max_counter - start) // bin3_num
        for i in range(bin3_num):
            for j in range(bin3_capacity):
                _set(start + j, (2 * start + bin3_capacity) // 2, be2 + i)
            start += bin3_capacity

        # Leftover snaps to the last bin (occu_bin.hpp:56-59).
        for i in range(start, self.max_counter):
            occ_mean[i] = (2 * start - bin3_capacity) // 2
            occ_bin[i] = be3 - 1

        self._occ_mean = occ_mean
        self._occ_bin = occ_bin

        # bin -> mean decode LUT. First-insert-wins over ascending occ
        # (occu_bin.hpp:61-63); unseen bins decode to 0.
        bin2mean = np.zeros(be3, dtype=np.uint32)
        seen = np.zeros(be3, dtype=bool)
        for occ in range(be1, self.max_counter):
            b = int(occ_bin[occ])
            if 0 <= b < be3 and not seen[b]:
                bin2mean[b] = occ_mean[occ]
                seen[b] = True
        # Identity region decodes to itself.
        bin2mean[:be1] = np.arange(be1, dtype=np.uint32)
        self._bin2mean = bin2mean

    # -- scalar API (reference parity) --------------------------------------
    def occ_to_bin(self, occ: int) -> int:
        if occ < self.bin_end_index1:
            return int(occ)
        return int(self._occ_bin[occ])

    def bin_to_mean(self, b: int) -> int:
        if b < self.bin_end_index1:
            return int(b)
        return int(self._bin2mean[b])

    # -- batched API --------------------------------------------------------
    def occ_to_bin_np(self, occ: np.ndarray) -> np.ndarray:
        """Vectorized occ->bin. occ must be < max_counter (counters are
        clamped to cs = max_counter-1 upstream)."""
        occ = np.asarray(occ)
        idx = np.minimum(occ, self.max_counter - 1)
        return np.where(occ < self.bin_end_index1, occ.astype(np.uint32), self._occ_bin[idx])

    def bin_to_mean_np(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b)
        return self._bin2mean[np.clip(b, 0, self.bin_end_index3 - 1)] * (
            b < self.bin_end_index3
        ).astype(np.uint32)

    @property
    def bin2mean_lut(self) -> np.ndarray:
        """[2^nh] uint32 decode LUT."""
        return self._bin2mean

    @property
    def occ2bin_lut(self) -> np.ndarray:
        """[max_counter] uint32 quantize LUT (identity region included)."""
        lut = self._occ_bin.copy()
        be1 = self.bin_end_index1
        lut[:be1] = np.arange(min(be1, self.max_counter), dtype=np.uint32)
        return lut

    def get_hash_number(self) -> int:
        return self.n_hash

    def get_max_counter(self) -> int:
        return self.max_counter

    def get_bin_end_index1(self) -> int:
        return self.bin_end_index1
