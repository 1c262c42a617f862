"""Sharded serving in the port (parallel/serve.py) on CPU meshes of 1, 3 and
4 shards: every answer equals the host query of both packages and the JAX
package's sharded server, for batch lengths that do not divide the mesh.
Integer answers: exact."""

import numpy as np
import pytest

from kmcex_tpu.model.kmodel import get_model as j_get_model
from kmcex_tpu.parallel import sharded as jsharded
from kmcex_tpu.parallel.serve import ShardedKModelServer as JServer
from kmcex_tpu_torch.core import codec
from kmcex_tpu_torch.model.kmodel import get_model
from kmcex_tpu_torch.parallel import sharded
from kmcex_tpu_torch.parallel.serve import ShardedKModelServer, make_server
from kmcex_tpu_torch.query.device_model import DeviceKModel


@pytest.fixture(scope="module")
def served():
    """The model and query mix of tests/test_sharded.py:309."""
    rng = np.random.default_rng(42)
    k = 31
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, size=40000, dtype=np.uint64) & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), 1, 1023).astype(np.uint32)
    km = get_model(1, 1023, 7, 5)
    km.init_from_pairs(can, counts, k)
    jkm = j_get_model(1, 1023, 7, 5)
    jkm.init_from_pairs(can, counts, k)
    q = np.concatenate([
        can[:: max(1, len(can) // 4000)],
        rng.integers(0, 1 << 62, size=3000, dtype=np.uint64) & mask,
        can[:7] ^ np.uint64(0b1100),  # near-miss neighbours
    ])
    return km, jkm, q, km.kmer_to_occ_u64(q)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_sharded_query_matches_host(served, n):
    km, jkm, q, want = served
    np.testing.assert_array_equal(want, jkm.kmer_to_occ_u64(q))
    srv = make_server(km, devices=["cpu"] * n, tile=1 << 11)
    assert len(srv.models) == 1  # one copy per distinct device
    got = srv.kmer_to_occ(q)
    assert got.dtype == np.int32 and got.shape == q.shape
    np.testing.assert_array_equal(got, want)
    assert srv.n_resolved > 0
    # lengths that do not divide the mesh, shorter than the mesh, empty
    for m in (13, 7001, n - 1, 1, 0):
        np.testing.assert_array_equal(srv.kmer_to_occ(q[:m]), want[:m])
    # any shape, the caller's order
    two_d = q[:7000].reshape(70, 100)
    np.testing.assert_array_equal(srv.kmer_to_occ(two_d),
                                  want[:7000].reshape(70, 100))
    np.testing.assert_array_equal(
        srv.kmer_to_occ(q), DeviceKModel(km, device="cpu").kmer_to_occ(q))


def test_sharded_query_matches_jax_server(served):
    km, jkm, q, want = served
    jsrv = JServer(jkm, jsharded.make_mesh(4), tile=1 << 13)
    srv = ShardedKModelServer(km, sharded.make_mesh(devices=["cpu"] * 4),
                              tile=1 << 13)
    np.testing.assert_array_equal(srv.kmer_to_occ(q), jsrv.kmer_to_occ(q))
    np.testing.assert_array_equal(srv.kmer_to_occ(q[:13]),
                                  jsrv.kmer_to_occ(q[:13]))


def test_server_takes_any_mesh_size_and_tile(served):
    """The JAX server refuses a mesh of 3 and a tile the mesh does not
    divide (XLA pads fixed tiles); a torch slice may be any length."""
    km, jkm, q, want = served
    with pytest.raises(ValueError):
        JServer(jkm, jsharded.make_mesh(3))
    srv = make_server(km, devices=["cpu"] * 3, tile=1000)
    np.testing.assert_array_equal(srv.kmer_to_occ(q[:2501]), want[:2501])


def test_make_server_needs_a_card_or_devices(served, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(served[0])
