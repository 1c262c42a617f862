"""The program's own records (``kmcex_tpu_torch.utils.timing``: spans and
counters of every thread of a build, or of one query batch) mapped onto the
clock of the traced stretch's ``torch.profiler`` trace.

A record begun under the profiler leaves one ``kmcex.clock`` marker in the
trace; the k-th marker belongs to the k-th such record, and the marker's
time beside the record's own time of it gives the offset of every span of
the record.  A record is kept when its mapped root lies inside the trace.

On a program without these records every function here returns nothing.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

OPS = {"sort_u64": ("keys", "payload"), "merge_sorted_u64": ("a", "b"),
       "compact_pairs": ("pairs",)}


class Mapped:
    """One record on the trace's clock (microseconds)."""

    def __init__(self, rec, offset_us: float):
        self.rec, self.offset = rec, offset_us
        self.root = next(s for s in rec.spans if s.id == 0)

    def at(self, ns: int) -> float:
        return ns / 1e3 + self.offset

    def spans(self, *names: str, main: bool = False) -> list[tuple]:
        """(start, end) in µs of the spans called ``names``; with ``main``
        only the root's thread's."""
        return [(self.at(s.start_ns), self.at(s.end_ns))
                for s in self.rec.spans
                if s.name in names and (not main or s.thread == self.rec.thread)]

    def seconds(self, *names: str) -> float:
        return sum(s.end_ns - s.start_ns for s in self.rec.spans
                   if s.name in names) / 1e9

    def counter(self, name: str) -> int:
        return self.rec.counters.get(name, 0)


def records(ctx) -> list[Mapped]:
    """The program's records that ran in the traced stretch, mapped by the
    program's own pairing of markers and records
    (``timing.clock_offsets``)."""
    t = ctx.trace
    if t is None:
        return []
    try:
        from kmcex_tpu_torch.utils import timing

        pairs = timing.clock_offsets(t.host, timing.records())
    except (ImportError, AttributeError):
        return []
    out = [Mapped(rec, offset) for rec, offset in pairs]
    return [mp for mp in out if t.t0 <= mp.at(mp.root.start_ns)
            and mp.at(mp.root.end_ns) <= t.t1]


def calls(recs: list[Mapped]) -> dict[str, list[dict]]:
    """The element counts of each call of the three kernel operations, from
    the program's per-call counters, in the form of ``Instruments.calls``."""
    out: dict[str, list[dict]] = {op: [] for op in OPS}
    for mp in recs:
        for op, fields in OPS.items():
            cols = [[c.value for c in mp.rec.counts if c.name == f"{op}.{f}"]
                    for f in fields]
            out[op] += [dict(zip(fields, vals)) for vals in zip(*cols)]
    return out


def kernel_share(ctx, op: str):
    """``kernels.bw_share.build`` over one operation, its bytes from the
    program's per-call counters (that file's kernel names and byte
    functions)."""
    from kbench.harness import load_metric

    recs = records(ctx)
    if not recs:
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proxy = SimpleNamespace(trace=ctx.trace, device_kind=ctx.device_kind,
                            calls=calls(recs))
    return load_metric(root, "kernels.bw_share.build").read(proxy, ops=(op,))


def device_idle_within(trace, intervals) -> float:
    """Seconds of ``intervals`` (µs pairs, not overlapping each other) in
    which no kernel, copy or memset ran on the device."""
    busy, end = [], float("-inf")
    for e in sorted(trace.device, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if busy and a <= end:
            busy[-1][1] = end = max(end, b)
        else:
            busy.append([a, b])
            end = b
    idle = 0.0
    for a, b in intervals:
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy
                      if x < b and y > a)
        idle += (b - a) - covered
    return idle / 1e6


def query_ms_per_mq(ctx, *names: str):
    """Seconds in the spans ``names`` of the traced query batches, in ms per
    10^6 queries."""
    recs = [r for r in records(ctx) if r.rec.kind == "query"]
    queries = sum(r.counter("query.queries") for r in recs)
    if not queries:
        return None
    return 1e3 * sum(r.seconds(*names) for r in recs) / (queries / 1e6)
