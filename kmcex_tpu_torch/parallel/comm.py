"""The collectives of the multi-process runtime, over ``torch.distributed``.

The JAX package gets its exchanges from ``shard_map`` (``all_to_all``,
``psum``) and ``multihost_utils.process_allgather``; the port's processes
are ``torch.distributed`` ranks, and everything they say to each other goes
through the few functions here: the key exchange of a count step, SUM and
MAX reductions, a gather of small Python objects, a gather of sorted runs,
and a barrier.

Backends.  gloo moves host tensors only (it has no CUDA ``all_to_all``), so
under gloo a CUDA tensor is staged through the host: copied down, exchanged,
copied back.  NCCL takes device tensors as they are.  The branch is chosen
by the group's backend NAME, never by trying one and catching the error.
The NCCL branch is written and has run nowhere: the machines this package
was built on have one card or none.
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist


def stages_through_host(group) -> bool:
    """True when the group's backend moves host tensors only (gloo)."""
    return dist.get_backend(group) == "gloo"


def _stage(device: torch.device, group) -> torch.device:
    return torch.device("cpu") if stages_through_host(group) else device


def _global_rank(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


def exchange_keys(send: torch.Tensor, counts: np.ndarray, group,
                  device: torch.device):
    """The cross-process half of a count step's exchange.

    ``send``: flat int64 keys ordered by destination rank; ``counts``: int64
    [world, ...] with the number of keys in each sub-group bound for each
    rank (the receiver needs the sub-group sizes to take its chunk apart).
    The sizes travel first (``all_to_all_single``, equal splits), then the
    keys with their real split sizes.  Returns (recv, recv_counts): the keys
    from every rank in rank order, on ``device`` for NCCL and on the host
    for gloo, and the sizes of their sub-groups, [world, ...] like
    ``counts``."""
    stage = _stage(device, group)
    sc = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64))
    world = sc.shape[0]
    sc_flat = sc.reshape(-1).to(stage)
    rc_flat = torch.empty_like(sc_flat)
    dist.all_to_all_single(rc_flat, sc_flat, group=group)
    rc = rc_flat.cpu().reshape(sc.shape)
    in_splits = sc.reshape(world, -1).sum(dim=1).tolist()
    out_splits = rc.reshape(world, -1).sum(dim=1).tolist()
    recv = torch.empty(sum(out_splits), dtype=torch.int64, device=stage)
    dist.all_to_all_single(recv, send.to(stage).contiguous(), out_splits,
                           in_splits, group=group)
    return recv, rc.numpy()


def all_reduce_sum(values, group, device: torch.device) -> np.ndarray:
    """SUM of a small int64 vector over the ranks; returns int64 numpy."""
    t = torch.as_tensor(np.asarray(values, dtype=np.int64)).to(
        _stage(device, group))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu().numpy()


def all_reduce_max_(bitmap: torch.Tensor, group) -> torch.Tensor:
    """Elementwise MAX of a uint8 tensor over the ranks, in place (the OR
    of 0/1 bitmaps)."""
    if bitmap.device.type == "cuda" and stages_through_host(group):
        host = bitmap.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
        bitmap.copy_(host)
    else:
        dist.all_reduce(bitmap, op=dist.ReduceOp.MAX, group=group)
    return bitmap


def gather_objects(obj, group) -> list:
    """Every rank's small picklable ``obj``, in rank order, on every rank
    (metadata only: sizes, names, flags)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group) -> None:
    dist.barrier(group=group)


def hostname() -> str:
    return socket.gethostname()


def _bcast_array(arr, n: int, np_dtype, src: int, group, stage):
    """Broadcast one numpy vector of ``n`` elements of an unsigned dtype
    from group rank ``src``; ``arr`` is None on the other ranks."""
    signed = {np.uint64: (np.int64, torch.int64),
              np.uint32: (np.int32, torch.int32)}[np_dtype]
    if arr is not None:
        t = torch.from_numpy(np.array(arr, dtype=np_dtype).view(signed[0]))
        t = t.to(stage)
    else:
        t = torch.empty(n, dtype=signed[1], device=stage)
    dist.broadcast(t, src=_global_rank(group, src), group=group)
    return t.cpu().numpy().view(np_dtype)


def gather_runs(host_runs, disk_paths, group, device: torch.device):
    """Every rank's sorted (kmers uint64, counts uint32) runs on every rank.

    ``host_runs``: this rank's runs in RAM (arrays or memmaps);
    ``disk_paths``: this rank's run files.  Runs in RAM travel by content,
    one broadcast each.  Run files travel BY PATH when every rank reports
    the same host name — one machine, so one file system — and by content
    otherwise; a cluster whose ranks share a file system across machines is
    not recognised and pays the copy.  Returns (runs, paths): the other
    ranks' runs as arrays plus this rank's own as given, and the run files
    to open (this rank's own included)."""
    from kmcex_tpu_torch.count.device_lsm import open_run_file

    stage = _stage(device, group)
    rank = dist.get_rank(group)
    own_disk = [open_run_file(p) for p in disk_paths]
    meta = gather_objects(
        {"host": hostname(), "disk": list(disk_paths),
         "lens": [len(k) for k, _ in host_runs],
         "disk_lens": [len(k) for k, _ in own_disk]}, group)
    by_path = len({m["host"] for m in meta}) == 1
    send = list(host_runs) + ([] if by_path else own_disk)
    runs = list(host_runs)
    paths = []
    for r, m in enumerate(meta):
        mine = r == rank
        lens = m["lens"] + ([] if by_path else m["disk_lens"])
        for i, n in enumerate(lens):
            ku = _bcast_array(send[i][0] if mine else None, n, np.uint64, r,
                              group, stage)
            kc = _bcast_array(send[i][1] if mine else None, n, np.uint32, r,
                              group, stage)
            if not mine:
                runs.append((ku, kc))
        if by_path or mine:
            paths += m["disk"]
    return runs, paths
