"""The generator copy and the plain reference, on the CPU: each against a
brute-force version or against the program at a tiny size."""

import os

import numpy as np
import pytest
import torch

from kbench import gen
from kbench.reference import count, kmc1, kmodel, murmur, query


def test_generator_bytes_equal_the_repository_generator(tmp_path):
    from kmcex_tpu_torch.tools import workload

    for seed, n in ((0, 500), (2025, 3000), (2 ** 31 + 11, 700)):
        want = workload.make_reads(20000, n, seed, 0.005)
        got = gen.make_reads(20000, n, seed, 0.005, read_len=150,
                             n_rate=0.0005)
        assert np.array_equal(got, want)
        workload.write_fastq(tmp_path / "a.fq", want)
        gen.write_fastq(tmp_path / "b.fq", got)
        assert (tmp_path / "a.fq").read_bytes() == (tmp_path / "b.fq").read_bytes()


def test_fresh_stream_keeps_the_genome():
    a = gen.make_reads(5000, 200, 9, 0.0, read_len=101, n_rate=0.0)
    b = gen.make_reads(5000, 200, 9, 0.0, read_len=101, n_rate=0.0, stream=1)
    assert not np.array_equal(a, b)
    genome_words = {bytes(r[i : i + 40]) for r in a for i in range(0, 61, 20)}
    hits = sum(bytes(r[i : i + 40]) in genome_words
               for r in b for i in range(0, 61, 20))
    assert hits > 0


def _brute(reads: np.ndarray, k: int):
    comp = {ord("A"): "T", ord("C"): "G", ord("G"): "C", ord("T"): "A"}
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    seen = {}
    for r in reads:
        s = bytes(r).decode()
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            if any(ch not in code for ch in w):
                continue
            rc = "".join(comp[ord(ch)] for ch in reversed(w))
            v = min(sum(code[ch] << 2 * (k - 1 - j) for j, ch in enumerate(x))
                    for x in (w, rc))
            seen[v] = seen.get(v, 0) + 1
    keys = sorted(seen)
    return keys, [seen[x] for x in keys]


@pytest.mark.parametrize("k", [5, 21, 31])
def test_count_equals_brute_force(k):
    reads = gen.make_reads(300, 60, k, 0.02, read_len=40, n_rate=0.01)
    keys, counts = _brute(reads, k)
    kk, cc, windows = count.count_table(torch.from_numpy(reads), k, 1, 10 ** 6)
    assert kk.tolist() == keys and cc.tolist() == counts
    assert windows == sum(counts)
    kk2, cc2, _ = count.count_table(torch.from_numpy(reads), k, 2, 3)
    want = [(x, min(c, 3)) for x, c in zip(keys, counts) if c >= 2]
    assert list(zip(kk2.tolist(), cc2.tolist())) == want


def test_control_counts_keys_in_fewer_bits():
    reads = gen.make_reads(5000, 400, 3, 0.01, read_len=60)
    kk, cc, _ = count.count_table(torch.from_numpy(reads), 31, 1, 1023)
    ck, c2, _ = count.count_table(torch.from_numpy(reads), 31, 1, 1023,
                                  key_bits=16)
    assert torch.equal(kk, ck) and (c2 >= cc).all() and (c2 > cc).any()


def test_seeds_and_murmur_equal_the_program():
    from kmcex_tpu_torch.core import codec
    from kmcex_tpu_torch.core import murmur as pm

    assert murmur.SEEDS == [int(x) for x in pm.HASH_SEEDS]
    v = torch.tensor([0, 1, 12345678901, (1 << 62) - 1, 987654321987654321],
                     dtype=torch.int64)
    for k in (31, 29, 8, 7):
        vk = v & ((1 << (2 * k)) - 1)
        prep = murmur.murmur_prepare(vk, k)
        for s in (murmur.SEEDS[0], murmur.SEEDS[127]):
            got = murmur.murmur_eval(prep, s).numpy().view(np.uint64)
            want = [pm.murmur64_py(codec.u64_to_string(int(x), k).encode(), s)
                    for x in vk.tolist()]
            assert [int(x) for x in got] == want
    h = torch.tensor([-1, -(1 << 63), 5, (1 << 63) - 1], dtype=torch.int64)
    for m in (7, 1 << 31, (1 << 40) + 3):
        want = [(int(x) % (1 << 64)) % m for x in h.tolist()]
        assert murmur.umod(h, m).tolist() == want


def _two_pointer(live: list[bool]) -> tuple[list[int], int]:
    """``reorder_buffer`` (kmodel.hpp:529-540) on slot numbers."""
    a = list(range(len(live)))
    occ = list(live)
    il, ir = 0, len(a) - 1
    while il < ir:
        while il < ir and not occ[ir]:
            ir -= 1
        while il < ir and occ[il]:
            il += 1
        if il < ir:
            a[il], occ[il] = a[ir], occ[ir]
            occ[ir] = False
    m = il + 1 if (a and occ[il]) else 0
    return a[:m], m


@pytest.mark.parametrize("seed", range(40))
def test_survivor_packing_equals_the_two_pointer_loop(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    live = rng.random(n) < rng.random()
    want, m = _two_pointer(live.tolist())
    enc = kmodel._Encoder.__new__(kmodel._Encoder)
    enc.slot = torch.arange(n).view(1, n).clone()
    enc.live = torch.tensor(live).view(1, n).clone()
    enc.inserted = torch.zeros(n, dtype=torch.bool)
    enc._insert = lambda array, idx: torch.zeros(idx.numel(), dtype=torch.bool)
    got_m = enc._round(0, 0, n)
    assert got_m == m
    assert enc.slot[0, :m].tolist() == want


def _program_build(tmp_path, reads, bucket, monkeypatch):
    from kmcex_tpu_torch.config import KParams
    from kmcex_tpu_torch.count import pipeline
    from kmcex_tpu_torch.model import kmodel as pk

    monkeypatch.setattr(pk, "BUCKET_SIZE", bucket)
    fq = str(tmp_path / "r.fq")
    gen.write_fastq(fq, reads)
    params = KParams(input_file_name=fq, output_file_name=str(tmp_path / "db"),
                     working_directory=str(tmp_path))
    km, _ = pipeline.run(params, save_dir=str(tmp_path / "model"),
                         device="cpu")
    return km


@pytest.mark.parametrize("bucket", [16, 200, 1 << 18])
def test_model_database_and_answers_equal_the_program(tmp_path, monkeypatch,
                                                      bucket):
    reads = gen.make_reads(20000, 2500, bucket, 0.005, read_len=101)
    km = _program_build(tmp_path, reads, bucket, monkeypatch)
    monkeypatch.setattr(kmodel, "BUCKET_SIZE", bucket)
    kk, cc, _ = count.count_table(torch.from_numpy(reads), 31, 1, 1023)
    db = kmc1.read(str(tmp_path / "db"))
    assert np.array_equal(db["kmers"], kk.numpy().astype(np.uint64))
    assert np.array_equal(db["counts"], cc.numpy().astype(np.uint64))
    assert db["min_count"] == 1 and db["max_count"] == 1023
    ref = kmodel.build(kk, cc, 31, 1, 1023, 7, 5)
    for name, data in ref.files.items():
        assert (tmp_path / "model" / name).read_bytes() == data, name
    q = gen.forward_kmers(gen.make_reads(20000, 300, bucket, 0.005,
                                         read_len=101, stream=1), 31)
    q = np.concatenate([q, np.random.default_rng(0).integers(
        0, 1 << 62, 3000, dtype=np.uint64)])
    want = km.kmer_to_occ_u64(q)
    got = query.answer(ref, torch.from_numpy(q.view(np.int64))).numpy()
    assert np.array_equal(got, want)
    ctl = query.answer(ref, torch.from_numpy(q.view(np.int64)),
                       resolve=False).numpy()
    assert not np.array_equal(ctl, want)


def test_occu_bin_equals_the_program():
    from kmcex_tpu_torch.core.occu_bin import OccuBin

    for mc, nh in ((1024, 7), (256, 7), (1024, 5), (4096, 9)):
        o2b, b2m = kmodel.occu_bin(mc, nh)
        ob = OccuBin(mc, nh)
        assert o2b == [int(x) for x in ob.occ2bin_lut]
        assert b2m == [int(x) for x in ob.bin2mean_lut]
