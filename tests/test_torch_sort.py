"""The port's sort and merge (count/sort.py, CPU = plain PyTorch versions)
against the JAX package's Pallas bitonic kernels (count/sort_pallas.py) in
interpret mode with shrunken blocks, on the same numpy-seeded inputs.
Everything is integer, so keys compare exactly.  The Pallas sorts are not
stable, so payloads compare with them as a multiset of (key, payload) pairs;
the port's sorts are stable, which the last tests check against numpy's
stable argsort."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcex_tpu.count import sort_pallas as sp
from kmcex_tpu_torch.count import sort
from kmcex_tpu_torch.native import kernels

S = np.uint64(0xFFFFFFFFFFFFFFFF)
# outputs per block of csrc/merge.cu (THREADS * ITEMS; kx_merge_tile() on the
# card): the sizes below put run ends and equal keys on its tile boundaries
MERGE_TILE = 256 * 15


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(sp, "BLK", 1 << 10)
    monkeypatch.setattr(sp, "INTERPRET", True)


def _t(x: np.ndarray) -> torch.Tensor:
    """uint64 -> int64 tensor (bit pattern), uint32 -> int32 tensor."""
    return torch.from_numpy(x.view(np.int64 if x.dtype == np.uint64
                                   else np.int32).copy())


def _np(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint64 if a.dtype == np.int64 else np.uint32)


def _keys(rng, n, sent_frac=0.1, top_bit=True):
    x = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    if top_bit:  # k=32 keys use bit 63
        x |= rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63)
    x[rng.random(n) < sent_frac] = S
    return x


def _multiset(k, p):
    return collections.Counter(zip(k.tolist(), p.tolist()))


@pytest.mark.parametrize("n", [1000, 1 << 10, 3000, (1 << 12) - 7])
def test_sort_u64_equals_pallas(n):
    x = _keys(np.random.default_rng(n), n)
    want = np.asarray(sp.sort_u64(jnp.asarray(x)))[:n]
    before = dict(kernels.LAUNCHES)
    got = _np(sort.sort_u64(_t(x)))
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))
    assert got[-1] == S  # SENTINEL sorts last


@pytest.mark.parametrize("n", [1000, 3000])
def test_sort_u64_with_payload_equals_pallas(n):
    rng = np.random.default_rng(n + 1)
    x = _keys(rng, n)
    p = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    wk, wp = sp.sort_u64_with_payload(jnp.asarray(x), jnp.asarray(p))
    wk, wp = np.asarray(wk)[:n], np.asarray(wp)[:n]
    gk, gp = sort.sort_u64(_t(x), _t(p))
    gk, gp = _np(gk), _np(gp)
    np.testing.assert_array_equal(gk, wk)
    real = gk != S  # JAX pads with (SENTINEL, 0), which can displace an
    # input SENTINEL's payload past n; real keys are unaffected
    assert _multiset(gk[real], gp[real]) == _multiset(wk[real], wp[real])
    assert _multiset(gk, gp) == _multiset(x, p)


@pytest.mark.parametrize("la,lb,pad_a,pad_b", [
    (1000, 500, 0, 0), (1 << 10, 1 << 10, 0, 0), (3000, 1700, 0, 0),
    (1, 1, 0, 0), (900, 700, 124, 300), (0, 600, 0, 40),
    (MERGE_TILE - 701, 700, 0, 0), (MERGE_TILE - 700, 700, 0, 0),
    (MERGE_TILE - 700, 701, 0, 0), (MERGE_TILE, MERGE_TILE, 0, 0),
    (2 * MERGE_TILE, MERGE_TILE + 5, 0, 0), (MERGE_TILE - 100, 300, 100, 84),
    (MERGE_TILE, 0, 0, 0), (0, MERGE_TILE + 1, 0, 0),
])
def test_merge_sorted_equals_pallas(la, lb, pad_a, pad_b):
    rng = np.random.default_rng(la * 31 + lb)
    a = np.concatenate([np.sort(_keys(rng, la, 0.0)), np.full(pad_a, S)])
    b = np.concatenate([np.sort(_keys(rng, lb, 0.0)), np.full(pad_b, S)])
    _check_merge_equals_pallas(rng, a, b)


def _merge_pattern(name: str, la: int, lb: int, rng):
    """Two ascending uint64 runs that put long stretches of equal keys, or
    none of one run, into a tile of the card's merge."""
    r = np.sort(_keys(rng, la + lb, 0.0, top_bit=False))
    if name == "all_equal":
        v = np.uint64(0x0123456789ABCDEF)
        return np.full(la, v), np.full(lb, v)
    if name == "all_sentinel":
        return np.full(la, S), np.full(lb, S)
    if name == "a_below_b":
        return r[:la], r[la:]
    if name == "a_above_b":
        return r[lb:], r[:lb]
    if name == "bit63_only":
        top = np.uint64(1 << 63)
        return (np.sort(rng.integers(0, 2, la, dtype=np.uint64) * top),
                np.sort(rng.integers(0, 2, lb, dtype=np.uint64) * top))
    if name == "few_values":
        return (np.sort(rng.integers(0, 1 << 8, la, dtype=np.uint64)),
                np.sort(rng.integers(0, 1 << 8, lb, dtype=np.uint64)))
    raise ValueError(name)


MERGE_PATTERNS = ["all_equal", "all_sentinel", "a_below_b", "a_above_b",
                  "bit63_only", "few_values"]


@pytest.mark.parametrize("name", MERGE_PATTERNS)
def test_merge_sorted_patterns_equal_pallas(name):
    rng = np.random.default_rng(len(name))
    a, b = _merge_pattern(name, MERGE_TILE + 5, MERGE_TILE - 7, rng)
    _check_merge_equals_pallas(rng, a, b)


def _check_merge_equals_pallas(rng, a, b):
    ca = rng.integers(0, 1000, len(a)).astype(np.uint32)
    cb = rng.integers(0, 1000, len(b)).astype(np.uint32)
    n = len(a) + len(b)
    wk, wc = sp.merge_sorted_u64(jnp.asarray(a), jnp.asarray(ca),
                                 jnp.asarray(b), jnp.asarray(cb))
    wk, wc = np.asarray(wk)[:n], np.asarray(wc)[:n]
    gk, gc = sort.merge_sorted_u64(_t(a), _t(ca), _t(b), _t(cb))
    gk, gc = _np(gk), _np(gc)
    assert len(gk) == n
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gk, np.sort(np.concatenate([a, b])))
    real = gk != S
    assert _multiset(gk[real], gc[real]) == _multiset(wk[real], wc[real])


@pytest.mark.parametrize("n,distinct", [(1, 1), (1000, 1000), (3000, 7),
                                        ((1 << 12) + 1, 3), (5000, 1)])
def test_sort_u64_plain_is_stable(n, distinct):
    """Equal keys keep their input order: the payload (input positions)
    comes out as numpy's stable argsort of the unsigned keys."""
    rng = np.random.default_rng(n * 13 + distinct)
    x = rng.choice(_keys(rng, distinct), n)  # heavy duplicates
    p = np.arange(n, dtype=np.uint32)
    gk, gp = sort.sort_u64(_t(x), _t(p))
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(_np(gk), x[order])
    np.testing.assert_array_equal(_np(gp), order.astype(np.uint32))


@pytest.mark.parametrize("la,lb,pad", [
    (500, 700, 0), (1000, 1000, 50), (1, 3000, 10),
    (MERGE_TILE - 701, 700, 0), (MERGE_TILE - 700, 700, 0),
    (MERGE_TILE - 700, 701, 0), (2 * MERGE_TILE, MERGE_TILE + 5, 0),
    (MERGE_TILE - 100, MERGE_TILE - 100, 100), (0, 0, 0), (0, 900, 0),
    (900, 0, 0), (0, 0, MERGE_TILE)])
def test_merge_plain_ties_take_a_first(la, lb, pad):
    """On equal keys (SENTINEL padding included) every entry of ``a`` comes
    before every entry of ``b``, as in csrc/merge.cu."""
    rng = np.random.default_rng(la + lb + pad)
    pool = _keys(rng, 20, 0.0)
    a = np.concatenate([np.sort(rng.choice(pool, la)), np.full(pad, S)])
    b = np.concatenate([np.sort(rng.choice(pool, lb)), np.full(pad, S)])
    _check_merge_stable(a, b)


@pytest.mark.parametrize("name", MERGE_PATTERNS)
def test_merge_plain_patterns_take_a_first(name):
    """The stable order on the patterns the card tests use: all keys equal,
    all SENTINEL, disjoint ranges, keys that differ only in bit 63, few
    distinct values."""
    rng = np.random.default_rng(len(name) + 100)
    _check_merge_stable(*_merge_pattern(name, 2 * MERGE_TILE + 5,
                                        MERGE_TILE, rng))


def _check_merge_stable(a, b):
    ca = np.arange(len(a), dtype=np.uint32)  # a's payloads < b's
    cb = np.arange(len(a), len(a) + len(b), dtype=np.uint32)
    gk, gc = sort.merge_sorted_u64(_t(a), _t(ca), _t(b), _t(cb))
    gk, gc = _np(gk), _np(gc)
    allk = np.concatenate([a, b])
    order = np.argsort(allk, kind="stable")
    np.testing.assert_array_equal(gk, allk[order])
    np.testing.assert_array_equal(gc, order.astype(np.uint32))


@pytest.mark.parametrize("n,ok", [(0, True), ((1 << 30) - 1, True),
                                  (1 << 30, False), (1 << 33, False)])
def test_sort_u64_size_limit(n, ok):
    """The card's sort takes fewer than 2^30 keys (a status word of
    csrc/sort.cu holds a 30-bit count); the wrapper refuses more."""
    assert sort.MAX_SORT_N == 1 << 30
    if ok:
        sort._check_sort_n(n)
    else:
        with pytest.raises(ValueError):
            sort._check_sort_n(n)
