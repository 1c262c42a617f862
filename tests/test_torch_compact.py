"""The port's compaction (count/compact.py, CPU = plain PyTorch version)
against the JAX package's Pallas shift-compaction kernel
(count/compact_pallas.py) in interpret mode with shrunken blocks, on the
same numpy-seeded inputs.  Exact comparison: everything is integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcex_tpu.count import compact_pallas as cp
from kmcex_tpu.count import sort_pallas as sp
from kmcex_tpu_torch.count import compact

S = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(sp, "BLK", 1 << 10)
    monkeypatch.setattr(sp, "INTERPRET", True)


def _check(keys: np.ndarray, counts: np.ndarray) -> None:
    n = len(keys)
    wk, wc = cp.compact_pairs(jnp.asarray(keys), jnp.asarray(counts))
    wk, wc = np.asarray(wk)[:n], np.asarray(wc)[:n]
    gk, gc = compact.compact_pairs(torch.from_numpy(keys.view(np.int64)),
                                   torch.from_numpy(counts.view(np.int32)))
    gk, gc = gk.numpy().view(np.uint64), gc.numpy().view(np.uint32)
    assert len(gk) == n
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    m = int(np.count_nonzero(keys != S))
    assert (gk[m:] == S).all() and (gc[m:] == 0).all()


@pytest.mark.parametrize("n,frac,seed", [
    (1 << 10, 0.5, 0), (1 << 12, 0.1, 1), (1 << 12, 0.9, 2),
    (3000, 0.3, 3), ((1 << 12) - 7, 0.5, 4), (1000, 0.0, 5), (2048, 1.0, 6),
])
def test_compact_random_equals_pallas(n, frac, seed):
    """The contract both hold: valid keys ascending + distinct, holes
    anywhere; k=32 keys (bit 63 set) included."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 62, size=n, replace=False).astype(np.uint64)
                   | (np.uint64(1) << np.uint64(63)) * (np.arange(n) > n // 2))
    counts = rng.integers(0, 1 << 31, n).astype(np.uint32)
    holes = rng.random(n) < frac
    keys[holes] = S
    counts[holes] = 0
    _check(keys, counts)


def test_compact_sorted_with_dup_holes_equals_pallas():
    """The pipeline's shape: ascending keys, duplicate slots holed."""
    rng = np.random.default_rng(42)
    base = np.sort(rng.integers(0, 1 << 62, 4096, dtype=np.uint64))
    s = np.repeat(base, rng.integers(1, 5, 4096))[: 1 << 12]
    first = np.concatenate([[True], s[1:] != s[:-1]])
    keys = np.where(first, s, S)
    counts = np.where(first, rng.integers(1, 100, len(s)), 0).astype(np.uint32)
    _check(keys, counts)


@pytest.mark.parametrize("first_half", [True, False])
def test_compact_hole_runs_equals_pallas(first_half):
    """A whole half of holes: maximal and zero displacement."""
    n = 1 << 12
    keys = np.arange(n, dtype=np.uint64)
    counts = np.ones(n, dtype=np.uint32)
    half = slice(0, n // 2) if first_half else slice(n // 2, n)
    keys[half] = S
    counts[half] = 0
    _check(keys, counts)


@pytest.mark.parametrize("n,ok", [(1, True), (1024 * ((1 << 31) - 1), True),
                                  (1024 * ((1 << 31) - 1) + 1, False),
                                  (1 << 42, False)])
def test_compact_pairs_size_limit(n, ok):
    """One block a tile of 1024 pairs, and a grid's first dimension holds
    2^31 - 1 blocks: the wrapper refuses more before it launches."""
    from kmcex_tpu_torch.count import compact

    if ok:
        assert compact._check_tiles(n, 1024) == -(-n // 1024)
    else:
        with pytest.raises(ValueError, match="at most"):
            compact._check_tiles(n, 1024)
