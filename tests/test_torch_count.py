"""The port's counting engine (count/extract.py, count/device_lsm.py) on
the CPU against the JAX package's, on the same numpy-seeded inputs: the
fused extract for every k the model layer takes a word for, and the device
accumulator by its finalize_stream output, single-tier and through the run
LSM (small raw tier -> collapses + pairwise merges).  Exact comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcex_tpu.count import extract as jx
from kmcex_tpu.count.device_lsm import DeviceCountAccumulator as JaxAcc
from kmcex_tpu_torch.count import extract as tx
from kmcex_tpu_torch.count.device_lsm import DeviceCountAccumulator as TorchAcc


def _codes(rng, rows, L, genome_len=400, n_frac=0.02):
    """Reads drawn from a small genome (so k-mers repeat), some bases N."""
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - L, rows)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[rng.random(codes.shape) < n_frac] = 255
    return codes


@pytest.mark.parametrize("k", [21, 25, 31, 32])
def test_extract_canonical_packed_equals_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (64, 72)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 255
    packed, maskbits = jx.pack_codes_np(codes)
    wk, wn = jx.extract_canonical_packed(jnp.asarray(packed),
                                         jnp.asarray(maskbits), k)
    gk, gn = tx.extract_canonical_packed(torch.from_numpy(packed),
                                         torch.from_numpy(maskbits), k)
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), np.asarray(wk))
    assert int(gn) == int(wn)
    # the unpacked entry point agrees too
    uk, _ = tx.extract_canonical(torch.from_numpy(codes), k)
    assert torch.equal(uk, gk)


def _finalize(acc, ci, cs):
    total, hist, chunks = acc.finalize_stream(ci, cs)
    parts = list(chunks)
    ks = (np.concatenate([p[0] for p in parts]) if parts
          else np.zeros(0, np.uint64))
    cs_ = (np.concatenate([p[1] for p in parts]) if parts
           else np.zeros(0, np.uint32))
    return total, np.asarray(hist), ks, cs_.astype(np.uint32)


@pytest.mark.parametrize("raw_tier", [None, 2000])
@pytest.mark.parametrize("ci,cs", [(1, 1023), (2, 1023), (2, 3)])
def test_accumulator_equals_jax(raw_tier, ci, cs):
    k = 21
    rng = np.random.default_rng(ci * 10 + cs + (raw_tier or 0))
    jacc = JaxAcc(k, raw_tier_elems=raw_tier)
    tacc = TorchAcc(k, raw_tier_elems=raw_tier, device="cpu")
    for _ in range(12):
        packed, maskbits = jx.pack_codes_np(_codes(rng, 16, 48))
        jacc.add_batch_packed(jnp.asarray(packed), jnp.asarray(maskbits))
        tacc.add_batch_packed(torch.from_numpy(packed),
                              torch.from_numpy(maskbits))
    if raw_tier:
        assert tacc.tier_events["device_merges"] > 0  # the run LSM ran
    assert tacc.total_windows == jacc.total_windows
    jt, jh, jk, jc = _finalize(jacc, ci, cs)
    tt, th, tk, tc = _finalize(tacc, ci, cs)
    assert tt == jt and tt == len(tk)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    assert (tc >= ci).all() and (tc <= cs).all()


def test_accumulator_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAcc(21)
