"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them (the
decision is made in a fixture, never at import).  Run on a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the repo's conftest imports JAX, which the GPU machine
need not have; this file imports only torch, numpy and the port.)
"""

import numpy as np
import pytest
import torch

from kmcex_tpu_torch.count import compact, sort
from kmcex_tpu_torch.native import kernels

pytestmark = pytest.mark.cuda

S = -1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(rng, n, sent_frac=0.1):
    x = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    x[rng.random(n) < sent_frac] = S
    return x


def _u(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint64)


@pytest.mark.parametrize("n", [1000, 4096, (1 << 16) + 5])
def test_sort_u64_payload_follows_key(dev, n):
    rng = np.random.default_rng(n + 1)
    x = _keys(rng, n)
    p = np.arange(n, dtype=np.int32)
    k, pay = sort.sort_u64(torch.from_numpy(x).to(dev),
                           torch.from_numpy(p).to(dev))
    k, pay = k.cpu().numpy(), pay.cpu().numpy()
    assert np.array_equal(_u(k), np.sort(_u(x)))
    assert np.array_equal(np.sort(pay), p)  # a permutation of the input
    assert np.array_equal(x[pay], k)


# keys per onesweep_pass tile: THREADS * ITEMS = TILE in csrc/sort.cu
SORT_TILE = 256 * 16


def _check_sort_exact(dev, x: np.ndarray):
    """sort_u64 on the card, with and without an int32 payload of input
    positions, equals the stable plain version exactly and numpy's stable
    argsort; the inputs are left as they were."""
    n = len(x)
    t = torch.from_numpy(x).to(dev)
    p = torch.arange(n, dtype=torch.int32, device=dev)
    t0, p0 = t.clone(), p.clone()
    got = sort.sort_u64(t)
    gk, gp = sort.sort_u64(t, p)
    torch.cuda.synchronize()
    assert torch.equal(t, t0) and torch.equal(p, p0)
    wk, wp = sort.sort_u64_plain(t.cpu(), p.cpu())
    assert torch.equal(got.cpu(), wk)
    assert torch.equal(gk.cpu(), wk) and torch.equal(gp.cpu(), wp)
    order = np.argsort(_u(x), kind="stable")
    assert np.array_equal(gp.cpu().numpy(), order.astype(np.int32))


@pytest.mark.parametrize("n", [0, 1, 31, SORT_TILE - 1, SORT_TILE,
                               SORT_TILE + 1, 1000, 2048, 5000, 1 << 16,
                               (1 << 17) + 3, (1 << 20) + 7, 5 << 20])
def test_sort_u64_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    x = _keys(rng, n)
    x[rng.random(n) < 0.3] = x[0] if n else 0  # runs of equal keys
    before = kernels.LAUNCHES["sort_u64"]
    _check_sort_exact(dev, x)
    assert kernels.LAUNCHES["sort_u64"] == before + (2 if n else 0)


def _pattern(name: str, n: int, rng) -> np.ndarray:
    r = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    if name == "all_equal":
        return np.full(n, 0x0123456789ABCDEF, np.int64)
    if name == "all_sentinel":
        return np.full(n, S, np.int64)
    if name == "bit63_only":
        return np.where(r < 0, np.int64(-(1 << 63)), np.int64(5))
    if name == "low_byte_only":
        return (r & 0xFF) | 0x7700000000000000
    if name == "high_byte_only":
        return (r & -(1 << 56)) | 0x42
    if name == "sorted":
        return np.sort(_u(r)).view(np.int64)
    if name == "reverse_sorted":
        return np.sort(_u(r))[::-1].view(np.int64).copy()
    raise ValueError(name)


@pytest.mark.parametrize("name", ["all_equal", "all_sentinel", "bit63_only",
                                  "low_byte_only", "high_byte_only", "sorted",
                                  "reverse_sorted"])
def test_sort_u64_patterns(dev, name):
    """Inputs where an unstable rank or a wrong digit shows: keys that
    differ in one byte only, all equal, already in order or reversed."""
    n = 3 * (1 << 16) + 5
    _check_sort_exact(dev, _pattern(name, n, np.random.default_rng(3)))


def test_sort_u64_rejects_too_many_keys(dev):
    """n >= 2^30 is refused by the wrapper's size check and by the C entry
    point, which returns before it touches a pointer (no 8 GiB tensor is
    needed to reach either)."""
    with pytest.raises(ValueError):
        sort._check_sort_n(sort.MAX_SORT_N)
    sort._check_sort_n(sort.MAX_SORT_N - 1)
    lib = kernels.lib()
    for n in (sort.MAX_SORT_N, 0):
        assert lib.kx_sort_u64(None, None, n, None, None, None, None, None,
                               None) != 0


def _check_merge_exact(dev, a: np.ndarray, b: np.ndarray, ca=None, cb=None):
    """merge_sorted_u64 on the card equals the stable plain version exactly,
    keys and payloads.  By default the payloads are unique indices (a's
    below b's), so they must also equal numpy's stable argsort of a ++ b;
    the inputs are left as they were."""
    la, lb = len(a), len(b)
    unique = ca is None
    if unique:
        ca = np.arange(la, dtype=np.int32)
        cb = np.arange(la, la + lb, dtype=np.int32)
    ts = [torch.from_numpy(v).to(dev) for v in (a, ca, b, cb)]
    before = [t.clone() for t in ts]
    launches = kernels.LAUNCHES["merge_sorted_u64"]
    k, c = sort.merge_sorted_u64(*ts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_sorted_u64"] == launches + (la + lb > 0)
    assert all(torch.equal(t, t0) for t, t0 in zip(ts, before))
    wk, wc = sort.merge_sorted_u64_plain(*[t.cpu() for t in ts])
    assert k.dtype == torch.int64 and c.dtype == torch.int32
    assert torch.equal(k.cpu(), wk)
    assert torch.equal(c.cpu(), wc)
    if unique:
        order = np.argsort(_u(np.concatenate([a, b])), kind="stable")
        assert np.array_equal(c.cpu().numpy(), order.astype(np.int32))


def _size(spec, tile: int) -> int:
    """An int, or (m, d) for m tiles of csrc/merge.cu plus d."""
    return spec if isinstance(spec, int) else spec[0] * tile + spec[1]


def _sorted_run(rng, n: int) -> np.ndarray:
    return np.sort(_u(_keys(rng, n))).view(np.int64)


@pytest.mark.parametrize("la,lb", [
    (0, 5), (1, 1), (1000, 500), (1500, 500), (1 << 16, 3), (40000, 70000),
    (0, 0), (5, 0), (0, (1, 0)), ((1, 0), 0), ((0, 700), (1, -701)),
    ((0, 700), (1, -700)), ((0, 700), (1, -699)), ((1, -1), (2, 6)),
    ((3, 5), 1), (1, (3, 4)), ((2, 0), (2, 0)), (5 * (1 << 20) + 3, 1 << 20)])
def test_merge_sorted_matches_plain(dev, la, lb):
    """Random runs (10% SENTINEL at the tails) with random payloads, at
    sizes around the kernel's tile: TILE - 1, TILE, TILE + 1, 3 * TILE + 5
    in total, empty runs, one element against several tiles."""
    tile = kernels.lib().kx_merge_tile()
    la, lb = _size(la, tile), _size(lb, tile)
    rng = np.random.default_rng(la * 7 + lb)
    a, b = _sorted_run(rng, la), _sorted_run(rng, lb)
    ca = rng.integers(0, 1 << 30, la).astype(np.int32)
    cb = rng.integers(0, 1 << 30, lb).astype(np.int32)
    _check_merge_exact(dev, a, b, ca, cb)
    _check_merge_exact(dev, a, b)


def _merge_pattern(name: str, la: int, lb: int, rng):
    r = np.sort(rng.integers(0, 1 << 64, la + lb, dtype=np.uint64))
    if name == "all_equal":
        return (np.full(la, 0x0123456789ABCDEF, np.int64),
                np.full(lb, 0x0123456789ABCDEF, np.int64))
    if name == "all_sentinel":
        return np.full(la, S, np.int64), np.full(lb, S, np.int64)
    if name == "a_below_b":
        return r[:la].view(np.int64), r[la:].view(np.int64)
    if name == "a_above_b":
        return r[lb:].view(np.int64), r[:lb].view(np.int64)
    if name == "bit63_only":
        top = np.int64(-(1 << 63))
        return (np.sort(rng.integers(0, 2, la)).astype(np.int64) * top,
                np.sort(rng.integers(0, 2, lb)).astype(np.int64) * top)
    if name == "few_values":
        return (np.sort(rng.integers(0, 1 << 8, la, dtype=np.int64)),
                np.sort(rng.integers(0, 1 << 8, lb, dtype=np.int64)))
    if name == "padded_tails":
        a, b = r[:la].view(np.int64).copy(), r[la:].view(np.int64).copy()
        a[la // 2:] = S
        b[lb // 3:] = S
        return a, b
    raise ValueError(name)


@pytest.mark.parametrize("name", ["all_equal", "all_sentinel", "a_below_b",
                                  "a_above_b", "bit63_only", "few_values",
                                  "padded_tails"])
@pytest.mark.parametrize("la,lb", [((2, 5), (1, 0)), ((1, -3), (4, 1)),
                                   (300, 500)])
def test_merge_sorted_patterns(dev, name, la, lb):
    """Inputs where a wrong tie rule at a tile or thread boundary shows:
    long stretches of equal keys across both runs, windows that hold only
    ``a`` or only ``b``, keys that differ only in bit 63."""
    tile = kernels.lib().kx_merge_tile()
    la, lb = _size(la, tile), _size(lb, tile)
    a, b = _merge_pattern(name, la, lb, np.random.default_rng(la + lb))
    _check_merge_exact(dev, a, b)


def test_merge_rejects_negative_length(dev):
    lib = kernels.lib()
    assert lib.kx_merge_tile() > 0
    assert lib.kx_merge_u64(None, None, -1, None, None, 5, None, None,
                            None) != 0
    assert lib.kx_merge_u64(None, None, 0, None, None, 0, None, None,
                            None) == 0


# pairs per compact_pass tile: THREADS * ITEMS = TILE in csrc/compact.cu
COMPACT_TILE = 256 * 32


def _check_compact_exact(dev, keys: np.ndarray, counts: np.ndarray,
                         calls: int = 1):
    """compact_pairs on the card equals the plain version exactly, call
    after call on the same inputs (fresh scratch every call)."""
    tk, tc = torch.from_numpy(keys).to(dev), torch.from_numpy(counts).to(dev)
    wk, wc = compact.compact_pairs_plain(tk.cpu(), tc.cpu())
    for _ in range(calls):
        gk, gc = compact.compact_pairs(tk, tc)
        torch.cuda.synchronize()
        assert torch.equal(gk.cpu(), wk) and torch.equal(gc.cpu(), wc)


@pytest.mark.parametrize("n,frac", [
    (1, 0.0), (1000, 0.5), (1024, 1.0), (5000, 0.8), ((1 << 17) + 9, 0.3),
    (COMPACT_TILE - 1, 0.5), (COMPACT_TILE, 0.5), (COMPACT_TILE + 1, 0.5),
    (3 * COMPACT_TILE + 3, 0.4), (COMPACT_TILE + 2, 0.0),
    (40 * COMPACT_TILE + 5, 0.0), (40 * COMPACT_TILE + 7, 1.0),
    ((1 << 20) + 9, 0.6)])
def test_compact_matches_plain(dev, n, frac):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 62, n, dtype=np.int64)
    counts = rng.integers(1, 1 << 30, n).astype(np.int32)
    holes = rng.random(n) < frac
    keys[holes] = S
    _check_compact_exact(dev, keys, counts)


def _compact_pattern(name: str):
    """Inputs whose survivors sit where the look-back and the tail fill
    turn: whole tiles of holes between full ones, one survivor at the end,
    alternating live and empty tiles over more than a look-back window."""
    t = COMPACT_TILE
    if name == "hole_tiles_between_full":
        n = 70 * t + 13
        live = np.ones(n, bool)
        live[2 * t:45 * t] = False  # 43 tiles of zero aggregate
    elif name == "last_element_only":
        n = 9 * t + 1
        live = np.zeros(n, bool)
        live[-1] = True
    elif name == "last_of_full_tile_only":
        n = 9 * t
        live = np.zeros(n, bool)
        live[-1] = True
    elif name == "alternating_tiles":
        n = 100 * t + 77
        live = (np.arange(n) // t) % 2 == 1
    else:  # "first_element_only"
        n = 5 * t + 3
        live = np.zeros(n, bool)
        live[0] = True
    rng = np.random.default_rng(n)
    keys = np.where(live, rng.integers(0, 1 << 62, n, dtype=np.int64), S)
    counts = np.where(live, rng.integers(1, 1 << 30, n), 0).astype(np.int32)
    return keys, counts


@pytest.mark.parametrize("name", ["hole_tiles_between_full",
                                  "last_element_only",
                                  "last_of_full_tile_only",
                                  "alternating_tiles", "first_element_only"])
def test_compact_patterns(dev, name):
    _check_compact_exact(dev, *_compact_pattern(name))


def test_compact_twice_and_on_a_side_stream(dev):
    """Two calls in a row on the same inputs (a stale tile counter or stale
    status words would show), then one on a non-default stream."""
    rng = np.random.default_rng(5)
    n = 300 * COMPACT_TILE + 11
    keys = rng.integers(0, 1 << 62, n, dtype=np.int64)
    keys[rng.random(n) < 0.7] = S
    counts = rng.integers(1, 1 << 30, n).astype(np.int32)
    _check_compact_exact(dev, keys, counts, calls=2)
    tk, tc = torch.from_numpy(keys).to(dev), torch.from_numpy(counts).to(dev)
    wk, wc = compact.compact_pairs_plain(tk.cpu(), tc.cpu())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gk, gc = compact.compact_pairs(tk, tc)
    side.synchronize()
    assert torch.equal(gk.cpu(), wk) and torch.equal(gc.cpu(), wc)


@pytest.mark.parametrize("tiles", [1, 63, 64, 127, 300])
def test_compact_writes_no_word_past_its_buffers(dev, tiles):
    """The scratch the kernel asks for (kx_compact_scratch_words) is all it
    touches, and the outputs only their own n slots: guard words on both
    sides of each stay as they were."""
    lib = kernels.lib()
    n = tiles * COMPACT_TILE - 5
    rng = np.random.default_rng(tiles)
    keys = rng.integers(0, 1 << 62, n, dtype=np.int64)
    keys[rng.random(n) < 0.6] = S
    counts = rng.integers(1, 1 << 30, n).astype(np.int32)
    tk, tc = torch.from_numpy(keys).to(dev), torch.from_numpy(counts).to(dev)
    g, guard = 64, 0x5A5A5A5A
    words = lib.kx_compact_scratch_words(n)
    bufs = {"scratch": torch.full((words + 2 * g,), guard, dtype=torch.int64,
                                  device=dev),
            "keys": torch.full((n + 2 * g,), guard, dtype=torch.int64,
                               device=dev),
            "counts": torch.full((n + 2 * g,), guard, dtype=torch.int32,
                                 device=dev)}
    scratch = bufs["scratch"][g:g + words]
    scratch.zero_()
    ok, oc = bufs["keys"][g:g + n], bufs["counts"][g:g + n]
    assert lib.kx_compact_pairs(tk.data_ptr(), tc.data_ptr(), n,
                                ok.data_ptr(), oc.data_ptr(),
                                scratch.data_ptr(),
                                kernels.stream_ptr(tk)) == 0
    torch.cuda.synchronize()
    for name, b in bufs.items():
        size = b.numel() - 2 * g
        assert bool((b[:g] == guard).all()), name
        assert bool((b[g + size:] == guard).all()), name
    wk, wc = compact.compact_pairs_plain(tk, tc)
    assert torch.equal(ok, wk) and torch.equal(oc, wc)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_compact_tile_and_unaligned_inputs(dev, shift):
    """The tile the tests assume is the kernel's; inputs that do not start
    on a 16-byte boundary (views one to three elements in) take the scalar
    loads and still equal the plain version."""
    assert kernels.lib().kx_compact_tile() == COMPACT_TILE
    n = 5 * COMPACT_TILE + 21
    rng = np.random.default_rng(shift)
    keys = rng.integers(0, 1 << 62, n + shift, dtype=np.int64)
    keys[rng.random(n + shift) < 0.5] = S
    counts = rng.integers(1, 1 << 30, n + shift).astype(np.int32)
    tk = torch.from_numpy(keys).to(dev)[shift:]
    tc = torch.from_numpy(counts).to(dev)[shift:]
    assert tk.data_ptr() % 16 or tc.data_ptr() % 16
    gk, gc = compact.compact_pairs(tk, tc)
    wk, wc = compact.compact_pairs_plain(tk.cpu(), tc.cpu())
    assert torch.equal(gk.cpu(), wk) and torch.equal(gc.cpu(), wc)


def test_wrappers_reject_wrong_dtype(dev):
    with pytest.raises(TypeError):
        sort.sort_u64(torch.zeros(10, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        compact.compact_pairs(torch.zeros(10, dtype=torch.int64, device=dev),
                              torch.zeros(10, dtype=torch.int64, device=dev))


def test_cli_cuda_equals_cpu(dev, tmp_path, monkeypatch):
    """The whole CLI build on the card writes the same bytes as the plain
    versions on the CPU, and goes through every kernel (run-LSM merges
    forced by a small raw tier)."""
    from kmcex_tpu_torch.cli import main

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 20000)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for i, s in enumerate(rng.integers(0, len(genome) - 100, 6000)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[genome[s:s + 100]].tobytes(),
                                           b"I" * 100))
    outs = {}
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        wd = tmp_path / name
        wd.mkdir()
        kernels.reset_launches()
        # small batches and raw tier: several collapses, then LSM merges
        monkeypatch.setenv("KMCEX_BATCH_SEGS", "1024")
        monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "100000")
        assert main(["kmcex", "-k31", str(fq), str(wd / "o.res"), str(wd)],
                    device=d) == 0
        outs[name] = dict(kernels.LAUNCHES)
        for fn in ("o.res.kmc_pre", "o.res.kmc_suf", "o.res/header",
                   "o.res/km.bin", "o.res/rest.bin"):
            outs[name, fn] = (wd / fn).read_bytes()
    assert all(v == 0 for v in outs["cpu"].values())
    assert all(v > 0 for v in outs["cuda"].values()), outs["cuda"]
    for fn in ("o.res.kmc_pre", "o.res.kmc_suf", "o.res/header",
               "o.res/km.bin", "o.res/rest.bin"):
        assert outs["cpu", fn] == outs["cuda", fn], fn


# ---- device murmur, device Bloom build, low-key drop, DeviceKModel --------
def _canonical_table(rng, n, k=31, max_c=9):
    from kmcex_tpu_torch.core import codec

    kmers = np.unique(codec.canonical_np(
        rng.integers(0, 1 << (2 * k), n, dtype=np.uint64), k))
    counts = rng.integers(1, max_c, len(kmers)).astype(np.uint32)
    return kmers, counts


def test_murmur_cuda_equals_numpy(dev):
    """The two-stage hash and the unsigned modulo on the card: int64
    products wrap there as on the CPU."""
    from kmcex_tpu_torch.core import codec, murmur

    rng = np.random.default_rng(1)
    for k in (31, 32, 29, 30):
        v = rng.integers(0, 1 << 63, 50000, dtype=np.uint64) * np.uint64(2) + 1
        if k < 32:
            v &= np.uint64((1 << (2 * k)) - 1)
        want = murmur.murmur64_np(codec.ascii_bytes_np(v, k)[:, None, :],
                                  murmur.HASH_SEEDS[None, :35])
        t = torch.from_numpy(v.view(np.int64)).to(dev)
        bl, tl = murmur.murmur_pre(codec.ascii_bytes(t, k))
        h = murmur.murmur_eval(bl, tl, k,
                               murmur.seeds_tensor(murmur.HASH_SEEDS[:35], dev))
        assert np.array_equal(h.cpu().numpy().view(np.uint64), want)
        for m in (8, 119_283_432, (1 << 40) - 3):
            assert np.array_equal(
                codec.umod(h, m).cpu().numpy().astype(np.uint64),
                want % np.uint64(m))


@pytest.mark.parametrize("ci,n,tile", [(1, 300_000, 1 << 16),
                                       (2, 300_000, 100_003),
                                       (1, 2_600_000, None)])
def test_device_bloom_cuda_equals_cpu_and_host(dev, ci, n, tile, monkeypatch):
    """Filter bytes built on the card equal the CPU run's and the host
    insert's, on tables that cross TILE (the last case the real TILE), fed
    in one call and in two."""
    from kmcex_tpu_torch.model import device_bloom
    from kmcex_tpu_torch.model.bloom import BloomBank

    if tile:
        monkeypatch.setattr(device_bloom, "TILE", tile)
    k, nh, cs = 31, 7, 1023
    bf_num = 1 if ci == 1 else 3
    rng = np.random.default_rng(n + ci)
    kmers, counts = _canonical_table(rng, n)
    assert len(kmers) > device_bloom.TILE
    hist = np.array([np.count_nonzero(counts == ci + i) for i in range(3)])
    host = BloomBank(hist, nh, ci)
    for i in range(bf_num):
        host.insert(i, kmers[counts == ci + i], k)
    u = torch.from_numpy(kmers.view(np.int64))
    c = torch.from_numpy(counts.astype(np.int32))
    banks = []
    for d, cuts in (("cpu", 1), (dev, 1), (dev, 2)):
        b = device_bloom.DeviceBloomBuilder(k, ci, cs, nh, hist, device=d)
        ud, cd = u.to(d), c.to(d)
        step = -(-len(kmers) // cuts)
        for a in range(0, len(kmers), step):
            b.feed_table(ud[a : a + step], cd[a : a + step], step)
        bank = BloomBank(hist, nh, ci)
        b.into(bank)
        banks.append(bank)
    for bank in banks:
        for i in range(bf_num):
            assert np.array_equal(bank.bit_bf[i], host.bit_bf[i])
            assert np.array_equal(bank.bit_bf_back[i], host.bit_bf_back[i])


@pytest.mark.parametrize("ci", [1, 2])
def test_drop_compact_cuda_equals_cpu(dev, ci):
    from kmcex_tpu_torch.count import device_lsm

    rng = np.random.default_rng(30 + ci)
    kmers, counts = _canonical_table(rng, 500_000)
    pad = 12345
    u = torch.cat([torch.from_numpy(kmers.view(np.int64)),
                   torch.full((pad,), S, dtype=torch.int64)])
    c = torch.cat([torch.from_numpy(counts.astype(np.int32)),
                   torch.zeros(pad, dtype=torch.int32)])
    thresh = ci + (1 if ci == 1 else 3)
    wu, wc, wstats = device_lsm._drop_compact(u, c, thresh)
    before = kernels.LAUNCHES["compact_pairs"]
    gu, gc, gstats = device_lsm._drop_compact(u.to(dev), c.to(dev), thresh)
    assert kernels.LAUNCHES["compact_pairs"] == before + 1
    assert torch.equal(gu.cpu(), wu) and torch.equal(gc.cpu(), wc)
    assert np.array_equal(gstats, wstats)
    assert int(gstats[4]) == np.count_nonzero(counts >= thresh)


@pytest.fixture(scope="module")
def host_model():
    """A model of ~400,000 k-mers built by the port's host encoder."""
    from kmcex_tpu_torch.model.kmodel import get_model

    rng = np.random.default_rng(77)
    kmers, _ = _canonical_table(rng, 400_000)
    counts = np.clip(rng.zipf(1.5, len(kmers)), 1, 1023).astype(np.uint32)
    km = get_model(1, 1023, 7, 5)
    km.init_from_pairs(kmers, counts, 31)
    return km, kmers


def test_device_kmodel_cuda_equals_cpu_and_host(dev, host_model):
    """1,300,000 queries (half present) cross TILE; a small RESOLVE_TILE
    makes the resolve pass run in many steps.  Card answers equal the CPU run of
    the same tensor code and the host query."""
    from kmcex_tpu_torch.query.device_model import DeviceKModel

    km, kmers = host_model
    rng = np.random.default_rng(8)
    q = np.concatenate([rng.choice(kmers, 650_000),
                        rng.integers(0, 1 << 62, 650_000, dtype=np.uint64)])
    rng.shuffle(q)
    want = km.kmer_to_occ_u64(q)
    dm = DeviceKModel(km, device=dev)
    assert len(q) > dm.TILE
    dm.RESOLVE_TILE = 100
    got = dm.kmer_to_occ(q)
    assert dm.n_resolved > dm.RESOLVE_TILE
    assert np.array_equal(got, want)
    assert np.array_equal(dm.kmer_to_occ(q, tile=70_001), want)
    cpu = DeviceKModel(km, device="cpu").kmer_to_occ(q[:50_000])
    assert np.array_equal(cpu, want[:50_000])
    qd = torch.from_numpy(q.view(np.int64)).to(dev)
    assert np.array_equal(dm.query_tensor(qd).cpu().numpy(), want)


def test_count_encode_model_only_cuda_equals_cpu(dev, tmp_path, monkeypatch):
    """The model-only path on the card (device Bloom + drop, one more
    compaction launch than with the DB) saves the same model as the CPU run
    and as the host-insert configuration."""
    from kmcex_tpu_torch.count.pipeline import count_encode

    rng = np.random.default_rng(6)
    genome = rng.integers(0, 4, 30000)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for i, s in enumerate(rng.integers(0, len(genome) - 100, 3000)):
            r = genome[s : s + 100].copy()
            err = rng.random(100) < 0.01
            r[err] = (r[err] + 1) % 4
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[r].tobytes(), b"I" * 100))
    saved = {}
    runs = (("cpu", "cpu", {}, "1"), ("cuda", dev, {}, "1"),
            ("cuda_db", dev, {"db_path": str(tmp_path / "o.res")}, "1"),
            ("cuda_host", dev, {}, "0"))
    launches = {}
    for name, d, kwargs, env in runs:
        monkeypatch.setenv("KMCEX_DEVICE_BLOOM", env)
        kernels.reset_launches()
        km, _, _, stats = count_encode(str(fq), k=31, ci=2, device=d,
                                       keep_pairs=False, **kwargs)
        launches[name] = kernels.LAUNCHES["compact_pairs"]
        km.save(tmp_path / name)
        saved[name] = [(tmp_path / name / fn).read_bytes()
                       for fn in ("header", "km.bin", "rest.bin")]
        if name in ("cpu", "cuda"):
            assert "finalize.drop_low" in stats.phases
    assert launches["cuda"] == launches["cuda_db"] + 1
    assert saved["cuda"] == saved["cpu"] == saved["cuda_db"] == saved["cuda_host"]


@pytest.mark.parametrize("route,disk_bytes", [("host", 0), ("disk", 60_000)])
def test_forced_spill_cuda_equals_unspilled(dev, tmp_path, route, disk_bytes):
    """A forced host spill and a forced disk spill on the card: the run LSM
    merges on the device (merge + compaction kernels), the runs leave it,
    and the table, the sizing stats and the totals equal the unspilled
    build's.  The disk tier leaves no file behind."""
    from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator

    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    batches = []
    for _ in range(12):
        starts = rng.integers(0, len(genome) - 96, 256)
        codes = genome[starts[:, None] + np.arange(96)[None, :]]
        codes[rng.random(codes.shape) < 0.01] = 255
        batches.append(codes)
    plain = DeviceCountAccumulator(21, device=dev)
    kernels.reset_launches()
    # two batches a collapse (38,912 windows, padded to 2^16); two such runs
    # merge on the card to 2^17 and leave it
    acc = DeviceCountAccumulator(21, raw_tier_elems=30_000,
                                 spill_threshold=1 << 17,
                                 disk_spill_bytes=disk_bytes,
                                 disk_dir=str(tmp_path / "lsm"), device=dev)
    for codes in batches:
        plain.add_batch(codes)
        acc.add_batch(codes)
    ev = acc.tier_events
    assert ev["raw_collapses"] > 0 and ev["host_spills"] > 0
    assert (ev["disk_spills"] > 0) == (route == "disk")
    wt, wh, wchunks = plain.finalize_stream(2, 9)
    gt, gh, gchunks = acc.finalize_stream(2, 9)
    assert ev["device_merges"] > 0
    assert kernels.LAUNCHES["merge_sorted_u64"] > 0
    assert kernels.LAUNCHES["compact_pairs"] > 0
    want, got = list(wchunks), list(gchunks)
    assert gt == wt > 0 and np.array_equal(gh, wh)
    for j in (0, 1):
        assert np.array_equal(np.concatenate([p[j] for p in got]),
                              np.concatenate([p[j] for p in want]))
    assert acc.spill_stats["copy_bytes"] > 0
    if route == "disk":
        assert list((tmp_path / "lsm").iterdir()) == []


def test_merge_runs_unique_cuda_equals_cpu(dev):
    """device_lsm._merge_runs on the card equals its CPU run on sorted
    unique runs with ties, pads and counts whose sums pass 2^31 (the count
    column holds uint32 bit patterns and saturates at 2^32-1)."""
    from kmcex_tpu_torch.core.codec import u32
    from kmcex_tpu_torch.count import device_lsm

    rng = np.random.default_rng(4)

    def run(n, pad):
        k = np.sort(rng.choice(3 * n, n, replace=False)).astype(np.int64)
        c = rng.integers(1, 1 << 30, n).astype(np.int32)
        c[::97] = (1 << 31) - 1
        return (torch.from_numpy(np.concatenate([k, np.full(pad, S)])),
                torch.from_numpy(np.concatenate([c, np.zeros(pad, np.int32)])))

    a, b = run(200_000, 62_144), run(150_000, 0)
    want = device_lsm._merge_runs(*a, *b)
    got = device_lsm._merge_runs(*(t.to(dev) for t in a + b))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    top = int(u32(got[1]).max())
    assert (1 << 31) <= top <= 0xFFFFFFFF


# ----------------------------------------------------- the multi-shard package
def _mesh_batches(seed=5, n=6, rows=64, L=96):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = rng.integers(0, 4, size=(rows, L)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.02] = 255
        out.append(codes)
    return out


@pytest.mark.parametrize("tiers", ["one_tier", "forced"])
def test_sharded_mesh_on_the_card_equals_cpu_mesh(dev, tiers):
    """Four logical shards on the one card against four CPU shards: the
    same table; with the tiers forced every kernel is launched, per
    shard."""
    from kmcex_tpu_torch.parallel import sharded

    k, rows, L = 21, 64, 96
    kw = ({} if tiers == "one_tier" else
          dict(raw_tier_elems=3000, spill_threshold=1 << 13,
               disk_spill_bytes=0))
    tables = {}
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        mesh = sharded.make_mesh(devices=[d] * 4)
        acc = sharded.ShardedCountAccumulator(mesh, k, rows // 4, L, **kw)
        kernels.reset_launches()
        for codes in _mesh_batches():
            acc.add_batch(codes)
        tables[name] = acc.finalize(ci=1, cs=1023)
        if name == "cuda":
            assert kernels.LAUNCHES["sort_u64"] >= 4
            assert kernels.LAUNCHES["compact_pairs"] >= 4
            if tiers == "forced":
                assert kernels.LAUNCHES["merge_sorted_u64"] >= 4
                assert acc.tier_events["host_spills"] > 0
        else:
            assert sum(kernels.LAUNCHES.values()) == 0
    assert np.array_equal(tables["cpu"][0], tables["cuda"][0])
    assert np.array_equal(tables["cpu"][1], tables["cuda"][1])
    assert len(tables["cuda"][0]) > 10000


def test_sharded_bloom_and_server_on_the_card(dev, tmp_path):
    """count_encode(accumulator="sharded") on a 4-shard mesh of the card:
    the mesh Bloom build runs, the model equals the CPU mesh's, and the
    sharded server's answers equal the host's."""
    from kmcex_tpu_torch.count.pipeline import count_encode
    from kmcex_tpu_torch.parallel import sharded
    from kmcex_tpu_torch.parallel.serve import make_server

    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 30000)
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for i, s in enumerate(rng.integers(0, len(genome) - 100, 3000)):
            f.write(b"@r%d\n%s\n+\n%s\n"
                    % (i, acgt[genome[s : s + 100]].tobytes(), b"I" * 100))
    saved = {}
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        km, kk, cc, st = count_encode(
            str(fq), k=31, batch_segs=512, accumulator="sharded",
            mesh=sharded.make_mesh(devices=[d] * 4))
        assert "encode.bloom_insert" not in st.phases
        km.save(tmp_path / name)
        saved[name] = [(tmp_path / name / fn).read_bytes()
                       for fn in ("header", "km.bin", "rest.bin")]
    assert saved["cpu"] == saved["cuda"]
    q = np.concatenate([kk[::7], rng.integers(0, 1 << 62, 5000,
                                              dtype=np.uint64)])
    srv = make_server(km, devices=[dev] * 4)
    assert np.array_equal(srv.kmer_to_occ(q), km.kmer_to_occ_u64(q))


def test_uint32_counts_on_the_card(dev):
    """The merge step on the card carries counts as 32 unsigned bits: sums
    cross 2^31 and saturate at 2^32-1, equal to the CPU's."""
    from kmcex_tpu_torch.count import device_lsm

    ka = np.array([1, 2, 3, 4, -1, -1], np.int64)
    ca = np.array([0xFFFFFFF0, 1 << 31, 0x7FFFFFFF, 5, 0, 0], np.uint32)
    kb = np.array([1, 2, 3, 9, -1, -1], np.int64)
    cb = np.array([0x20, 1 << 31, 1, 7, 0, 0], np.uint32)
    out = {}
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        t = [torch.from_numpy(x).to(d) for x in
             (ka, ca.view(np.int32), kb, cb.view(np.int32))]
        u, c, nu = device_lsm._merge_runs(*t)
        out[name] = (u.cpu().numpy(), c.cpu().numpy().view(np.uint32), int(nu))
    assert out["cuda"][2] == out["cpu"][2] == 5
    assert np.array_equal(out["cuda"][0], out["cpu"][0])
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][1][:5].tolist() == [0xFFFFFFFF, 0xFFFFFFFF, 1 << 31,
                                           5, 7]
