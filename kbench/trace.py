"""What the traced run reads: a ``torch.profiler`` trace of one stretch of
the timed work, and, around the program's calls, the element counts of its
three kernel operations and spans that name the host's work.

The spans and counts are the benchmark's own: it wraps program functions
where their callers look them up, for the traced stretch only, and puts
every function back afterwards.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_union(intervals) -> float:
    """Length of the union of (start, duration) intervals.  A frozen copy of
    the arithmetic of the program's ``utils/timing.trace_device_busy``."""
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    return busy


def short_name(name: str) -> str:
    """A kernel's or copy's name without return type, namespaces, template
    arguments or argument list: ``onesweep_pass``, ``Memcpy HtoD``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    for cut in ("(", "<"):
        i = n.find(cut)
        if i > 0:
            n = n[:i]
    return n.rsplit("::", 1)[-1].strip() or name


class Trace:
    """The events of a Chrome trace that ``torch.profiler`` wrote (times in
    microseconds)."""

    def __init__(self, events: list[dict]):
        self.events = [e for e in events if e.get("ph") == "X" and "ts" in e]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in self.events
                     if e.get("cat") == "user_annotation"]
        if self.events:
            self.t0 = min(e["ts"] for e in self.events)
            self.t1 = max(e["ts"] + e.get("dur", 0) for e in self.events)
        else:
            self.t0 = self.t1 = 0.0

    @property
    def span_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_union((e["ts"], e.get("dur", 0)) for e in self.device) / 1e6

    def kernel_seconds(self, prefixes=None) -> float:
        """Summed device time of the kernels whose short name is in
        ``prefixes`` (all kernels when None)."""
        return sum(e.get("dur", 0) for e in self.kernels
                   if prefixes is None or short_name(e["name"]) in prefixes) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the device summed by the benchmark's span that covers most of each
        gap (the shortest of equals)."""
        by_op: dict[str, float] = {}
        for e in self.device:
            key = short_name(e["name"])
            by_op[key] = by_op.get(key, 0.0) + e.get("dur", 0) / 1e6
        gaps, end = [], self.t0
        for e in sorted(self.device, key=lambda e: e["ts"]):
            if e["ts"] > end:
                gaps.append((end, e["ts"]))
            end = max(end, e["ts"] + e.get("dur", 0))
        if self.t1 > end:
            gaps.append((end, self.t1))
        spans = sorted(self.host, key=lambda e: e["ts"])
        by_gap: dict[str, float] = {}
        for a, b in gaps:
            best, best_cover, best_dur = "host outside any span", 0.0, 0
            for e in spans:
                if e["ts"] >= b:
                    break
                cover = min(b, e["ts"] + e.get("dur", 0)) - max(a, e["ts"])
                if cover > best_cover or (cover == best_cover and cover > 0
                                          and e.get("dur", 0) < best_dur):
                    best, best_cover, best_dur = e["name"], cover, e.get("dur", 0)
            by_gap[best] = by_gap.get(best, 0.0) + (b - a) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(by_gap)]}


def profile(fn, path: str):
    """Run ``fn()`` under ``torch.profiler``; (its result, the Trace).  The
    trace file is read back and deleted."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return out, Trace(events)


def _span(label: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


class Instruments:
    """Element counts of ``sort_u64``, ``merge_sorted_u64`` and
    ``compact_pairs`` per call, and spans around the calls into each layer,
    patched in while the context is open."""

    def __init__(self):
        self.calls: dict[str, list[dict]] = {
            "sort_u64": [], "merge_sorted_u64": [], "compact_pairs": []}

    def _count(self, op: str, fn, sizes):
        def wrapped(*args, **kwargs):
            self.calls[op].append(sizes(*args, **kwargs))
            with torch.profiler.record_function(f"kbench.{op}"):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def patched(self):
        from kmcex_tpu_torch import native
        from kmcex_tpu_torch.count import device_lsm, extract
        from kmcex_tpu_torch.io import kmc_db
        from kmcex_tpu_torch.model import kmodel
        from kmcex_tpu_torch.query import device_model

        def sort_sizes(keys, payload=None):
            return {"keys": keys.numel(),
                    "payload": 0 if payload is None else payload.numel()}

        def merge_sizes(a, ca, b, cb):
            return {"a": a.numel(), "b": b.numel()}

        def compact_sizes(keys, counts):
            return {"pairs": keys.numel()}

        plan = [
            (extract, "sort_u64", self._count("sort_u64", extract.sort_u64,
                                              sort_sizes)),
            (extract, "compact_pairs",
             self._count("compact_pairs", extract.compact_pairs, compact_sizes)),
            (device_lsm, "compact_pairs",
             self._count("compact_pairs", device_lsm.compact_pairs,
                         compact_sizes)),
            (device_lsm, "merge_sorted_u64",
             self._count("merge_sorted_u64", device_lsm.merge_sorted_u64,
                         merge_sizes)),
        ]
        acc = device_lsm.DeviceCountAccumulator
        for owner, name, label in [
            (acc, "add_batch_packed", "kbench.count.add_batch"),
            (acc, "finalize_stream", "kbench.count.finalize"),
            (kmodel.KModel, "init_from_chunks", "kbench.encode"),
            (kmodel.KModel, "save", "kbench.model_save"),
            (native.BitArrayEncoder, "feed", "kbench.encode.array_feed"),
            (native.BitArrayEncoder, "finish", "kbench.encode.array_finish"),
            (kmc_db.KMC1StreamWriter, "write_chunk", "kbench.db_spool"),
            (device_model.DeviceKModel, "kmer_to_occ", "kbench.query.batch"),
            (device_model.DeviceKModel, "_resolve", "kbench.query.resolve"),
        ]:
            plan.append((owner, name, _span(label, getattr(owner, name))))
        saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in plan]
        try:
            for owner, name, fn in plan:
                setattr(owner, name, fn)
            yield self
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
