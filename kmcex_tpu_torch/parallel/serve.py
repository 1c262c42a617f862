"""Multi-shard serving: data-parallel kmer_to_occ over a shard mesh.

The counterpart of the JAX package's ``parallel/serve.py``.  The KModel's
probe tables (Bloom bank, coupled bit arrays, rest store — tens of MB even
at genome scale) are copied once to every distinct device of the mesh; a
query batch is cut into one contiguous slice per shard, each shard answers
its slice against its device's copy with the two passes of
``query.device_model.DeviceKModel`` (the ungated main pass, then the
resolve pass on the ambiguous survivors), and the answers return in the
caller's order.  No collective: with a mesh that spans processes each
process serves its own batches on its own shards.

Left out of the JAX module, on purpose: its mesh size must be a power of
two and its tile a multiple of the mesh size (serve.py:30-31, 39-45),
because XLA shards fixed tiles over the batch axis and pads only short
tails.  A torch slice may have any length, so any mesh size and any tile
are taken; ``tile=`` stays as the bound on the queries of one main pass.

Answers equal the single-device and host paths on every query.
"""

from __future__ import annotations

import numpy as np

from kmcex_tpu_torch.query.device_model import DeviceKModel


class ShardedKModelServer:
    """The model on every device of ``mesh``, queries split over its local
    shards.  Same call as DeviceKModel: ``kmer_to_occ(packed_u64_array)``."""

    def __init__(self, km, mesh, tile: int | None = None):
        self.mesh = mesh
        self.tile = tile
        self.models = {}
        for dev in mesh.devices:
            if dev not in self.models:
                self.models[dev] = DeviceKModel(km, device=dev)
        self.n_resolved = 0

    def kmer_to_occ(self, kmers_u64, tile: int | None = None) -> np.ndarray:
        """Batched query; packed uint64 in (NumPy, any shape), int32 answers
        of the same shape out."""
        qa = np.asarray(kmers_u64, dtype=np.uint64)
        q = qa.reshape(-1)
        out = np.zeros(len(q), dtype=np.int32)
        self.n_resolved = 0
        L = self.mesh.local
        step = -(-len(q) // L)
        for l, dev in enumerate(self.mesh.devices):
            part = q[l * step : (l + 1) * step]
            if len(part):
                dm = self.models[dev]
                out[l * step : (l + 1) * step] = dm.kmer_to_occ(
                    part, tile or self.tile)
                self.n_resolved += dm.n_resolved
        return out.reshape(qa.shape)


def make_server(km, n_devices: int | None = None, devices=None,
                tile: int | None = None) -> ShardedKModelServer:
    """Convenience: mesh over all (or the first n, or the given) devices +
    server."""
    from kmcex_tpu_torch.parallel.sharded import make_mesh

    return ShardedKModelServer(km, make_mesh(n_devices, devices), tile=tile)
