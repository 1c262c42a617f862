"""Comparisons that decide ``correct``: all exact, so each number is a count
of what differs and its limit is 0."""

from __future__ import annotations

import numpy as np


def model_files(km) -> dict:
    """A model the program built, as the bytes of its three files in the
    upstream layout (kmodel.hpp:172-206, rest.hpp:163-221), read from the
    model's arrays."""
    bloom, kld = km.bloom, km.kld
    km_bin = [np.array([km.km_kmercount], dtype="<u8").tobytes(),
              np.asarray(bloom.kmer_counts[: km.bf_num], dtype="<u8").tobytes()]
    for i in range(km.bf_num):
        km_bin += [np.asarray(bloom.bit_bf[i], np.uint8).tobytes(),
                   np.asarray(bloom.bit_bf_back[i], np.uint8).tobytes()]
    km_bin.append(np.asarray(km.km_back, np.uint8).tobytes())
    for a in range(km.n_bits):
        km_bin += [np.asarray(km.bit1[a], np.uint8).tobytes(),
                   np.asarray(km.bit2[a], np.uint8).tobytes()]
    rest = b"".join([
        np.array([kld.k, kld.pre_len, kld.map_size, kld.pre_buffer_size],
                 dtype="<i4").tobytes(),
        np.array([kld.suffix_bin_count * kld.suff_group, kld.suffix_bin_count],
                 dtype="<u8").tobytes(),
        np.asarray(kld.hash2index, "<i4").tobytes(),
        np.asarray(kld.pre_buffer, "<i4").tobytes(),
        np.asarray(kld.suffix_bin, np.uint8).tobytes(),
        np.asarray(kld.count_bin, "<i4").tobytes(),
    ])
    header = (f"number_hash {km.n_hash}\nnumber_bit {km.n_bits}\nci {km.ci}\n"
              f"cs {km.cs}\n").encode()
    return {"header": header, "km.bin": b"".join(km_bin), "rest.bin": rest}


def bytes_differ(a: bytes, b: bytes) -> int:
    """Bytes that differ, a missing or extra byte counting as one."""
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, count=n)
    y = np.frombuffer(b, np.uint8, count=n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def files_differ(got: dict | None, want: dict) -> int:
    """Summed ``bytes_differ`` over the files; a missing file counts all of
    its bytes."""
    if got is None:
        return sum(len(v) for v in want.values())
    return sum(bytes_differ(got.get(name, b""), data)
               for name, data in want.items())


def pairs_differ(got, want) -> int:
    """Positions at which two (k-mers, counts) listings differ, plus the
    difference of their lengths; all of ``want`` when ``got`` is None."""
    if got is None:
        return len(want[0])
    n = min(len(got[0]), len(want[0]))
    bad = ((got[0][:n] != want[0][:n]) | (got[1][:n] != want[1][:n]))
    return int(np.count_nonzero(bad)) + abs(len(got[0]) - len(want[0]))
