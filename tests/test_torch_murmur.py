"""The port's device hash primitives on the CPU against the JAX package:
the two-stage murmur on int64 tensors, the ASCII regeneration, the middle
(k-2)-mer, the unsigned modulo, and the host helpers of the query API.
Integers throughout: every comparison is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcex_tpu.core import codec as jcodec
from kmcex_tpu.core import murmur as jmurmur
from kmcex_tpu.query.device_model import _seed_matrix as j_seed_matrix
from kmcex_tpu_torch.core import codec, murmur
from kmcex_tpu_torch.query.device_model import _seed_matrix

KS = [21, 19, 25, 23, 31, 29, 32, 30]  # each k and its middle k-2


def _kmers(rng, n, k):
    """Random packed k-mers; for k = 32 half of them have bit 63 set."""
    v = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, n, dtype=np.uint64)
    if k < 32:
        v &= np.uint64((1 << (2 * k)) - 1)
    return v


def _t(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_seed_tables_equal():
    np.testing.assert_array_equal(murmur.HASH_SEEDS, jmurmur.HASH_SEEDS)
    np.testing.assert_array_equal(_seed_matrix(5, 7), j_seed_matrix(5, 7))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("seeds", ["bank7", "matrix35"])
def test_murmur_pre_eval_matches_jax(k, seeds):
    rng = np.random.default_rng(100 + k)
    v = _kmers(rng, 2000, k)
    s = (murmur.HASH_SEEDS[:7] if seeds == "bank7"
         else _seed_matrix(5, 7).reshape(-1))
    ascii_np = jcodec.ascii_bytes_np(v, k)
    want = jmurmur.murmur64_np(ascii_np[:, None, :], s[None, :])
    bl, tl = murmur.murmur_pre(codec.ascii_bytes(_t(v), k))
    got = murmur.murmur_eval(bl, tl, k, murmur.seeds_tensor(s, "cpu"))
    np.testing.assert_array_equal(_u(got), want)
    jbl, jtl = jmurmur.murmur_pre_jnp(jnp.asarray(ascii_np))
    np.testing.assert_array_equal(_u(bl), np.asarray(jbl))
    np.testing.assert_array_equal(_u(tl), np.asarray(jtl))
    jh = jmurmur.murmur_eval_jnp(jbl, jtl, k, s)
    np.testing.assert_array_equal(_u(got), np.asarray(jh))
    # the port's own host oracle and the scalar version agree too
    np.testing.assert_array_equal(
        murmur.murmur64_np(ascii_np[:, None, :], s[None, :]), want)
    assert int(want[0, 0]) == murmur.murmur64_py(ascii_np[0].tobytes(),
                                                 int(s[0]))


def test_murmur_wraps_at_top_bit_keys():
    """Blocks, tails and hashes whose top bit is set: int64 products must
    wrap like the unsigned ones and the >> 47 must be logical."""
    k = 32
    v = np.array([0xFFFFFFFFFFFFFFFF, 0x8000000000000000, 0xC6A4A7935BD1E995,
                  0xFFFFFFFFFFFFFFFE, 0x8000000000000001], dtype=np.uint64)
    ascii_np = jcodec.ascii_bytes_np(v, k)
    s = murmur.HASH_SEEDS[:7]
    want = jmurmur.murmur64_np(ascii_np[:, None, :], s[None, :])
    assert (want >> np.uint64(63)).any()  # some hashes have bit 63 set
    bl, tl = murmur.murmur_pre(codec.ascii_bytes(_t(v), k))
    assert (bl < 0).any()  # and some block mixes
    got = murmur.murmur_eval(bl, tl, k, murmur.seeds_tensor(s, "cpu"))
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("k", KS)
def test_ascii_bytes_and_middle_kmer_match_jax(k):
    rng = np.random.default_rng(200 + k)
    v = _kmers(rng, 3000, k).reshape(30, 100)
    got = codec.ascii_bytes(_t(v), k)
    assert got.dtype == torch.uint8 and got.shape == (30, 100, k)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcodec.ascii_bytes_jnp(jnp.asarray(v), k)))
    np.testing.assert_array_equal(got.numpy(), codec.ascii_bytes_np(v, k))
    np.testing.assert_array_equal(
        _u(codec.middle_kmer(_t(v), k)),
        np.asarray(jcodec.middle_kmer_jnp(jnp.asarray(v), k)))
    np.testing.assert_array_equal(codec.middle_kmer_np(v, k),
                                  jcodec.middle_kmer_np(v, k))


@pytest.mark.parametrize("m", [8, 9, 1000, 119_283_432, (1 << 31) + 7,
                               1 << 40, (1 << 40) - 3, (1 << 62) - 1])
def test_umod_matches_numpy_uint64(m):
    rng = np.random.default_rng(m % 1000)
    h = _kmers(rng, 20000, 32)
    h[:10000] |= np.uint64(1 << 63)  # top bit set: negative as int64
    h[-3:] = [0, 0xFFFFFFFFFFFFFFFF, 0x8000000000000000]
    got = codec.umod(_t(h), m)
    assert int(got.min()) >= 0
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  h % np.uint64(m))


def test_umod_tensor_modulus():
    rng = np.random.default_rng(5)
    h = _kmers(rng, 4000, 32).reshape(1000, 4)
    m = rng.integers(8, 1 << 40, 1000, dtype=np.int64)
    got = codec.umod(_t(h), torch.from_numpy(m)[:, None])
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  h % m.astype(np.uint64)[:, None])


@pytest.mark.parametrize("k", [21, 31, 32])
def test_host_codec_helpers_match_jax(k):
    rng = np.random.default_rng(300 + k)
    v = _kmers(rng, 500, k)
    np.testing.assert_array_equal(codec.canonical_np(v, k),
                                  jcodec.canonical_np(v, k))
    np.testing.assert_array_equal(_u(codec.canonical(_t(v), k)),
                                  jcodec.canonical_np(v, k))
    strings = [codec.u64_to_string(int(x), k) for x in v[:50]]
    assert strings == [jcodec.u64_to_string(int(x), k) for x in v[:50]]
    np.testing.assert_array_equal(codec.strings_to_u64(strings, k), v[:50])
    assert codec.string_to_u64(strings[0]) == jcodec.string_to_u64(strings[0])
    np.testing.assert_array_equal(codec.string_to_codes("ACGTNacgt"),
                                  jcodec.string_to_codes("ACGTNacgt"))
