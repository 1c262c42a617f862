"""Observability: the port's one tracer.

A **record** is one ``count_encode`` call or one ``DeviceKModel.kmer_to_occ``
call (``record``).  Inside it, work is timed as **spans**, on whatever
thread does it: a name, a start and an end (``time.perf_counter_ns``), the
thread, the enclosing span on that thread (on a worker thread the record's
root) and the record's id.  A **counter** is a name and an integer added at
the same boundaries.  The thread that starts a record owns its ``Tracer``;
worker threads receive it from there (``adopt``), so the parse, copy and
table threads of a build record into the same place as the main thread.

Always on, for every record: per-name sums of span seconds (``seconds``)
and counter totals (``counters``); a build puts them on
``PipelineStats.phases`` and ``PipelineStats.counters``.

The full record, every span and counter event, is kept only when a
``torch.profiler`` is active on the calling thread as the record starts,
when ``KMCEX_TRACE_DIR`` is set, or inside ``record_spans()``.  Finished
full records stay in memory, the last ``KEEP`` of them (``records()``).
Under a profiler the record also leaves one ``record_function`` marker,
``kmcex.clock``, whose trace time and the tracer's own time of it map every
span of the record onto the trace's clock: the k-th marker of a trace
belongs to the k-th record begun under that profiler.

``device_trace`` (``KMCEX_TRACE_DIR``) writes a ``torch.profiler`` Chrome
trace of a call with the program's spans merged in: one track per program
thread, spans as ``X`` events of category ``kmcex``, counters as ``C``
events, all on the trace's clock.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import typing

MARKER = "kmcex.clock"
CATEGORY = "kmcex"
KEEP = 64          # finished full records kept in memory

_now = time.perf_counter_ns
_local = threading.local()
_record_ids = itertools.count(1)
_thread_keys = itertools.count(1)
_records: collections.deque = collections.deque(maxlen=KEEP)
_records_lock = threading.Lock()
_END = object()


class Span(typing.NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int        # key of the thread that ran it (Tracer.threads)
    parent: int        # enclosing span's id; the root's is -1
    record: int        # the record's id


class Count(typing.NamedTuple):
    name: str
    value: int
    at_ns: int
    thread: int


class Tracer:
    """One record: the always-on sums, and with ``full`` every span and
    counter event.  Safe to record into from several threads."""

    def __init__(self, kind: str = "build", full: bool = False):
        self.id = next(_record_ids)
        self.kind = kind
        self.seconds: dict[str, float] = {}
        self.counters: dict[str, int] = {}
        self.spans: list[Span] | None = [] if full else None
        self.counts: list[Count] | None = [] if full else None
        self.threads: dict[int, str] = {}       # thread key -> thread name
        self.thread = _thread_key()             # the root's thread
        self.clock_ns: int | None = None        # tracer time of the marker
        self.start_ns = self.end_ns = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def add(self, name: str, secs: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + secs

    def count(self, name: str, n: int) -> None:
        n = int(n)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if self.counts is not None:
            self.counts.append(Count(name, n, _now(), self._this_thread()))

    def _this_thread(self) -> int:
        key = _thread_key()
        if key not in self.threads:
            self.threads[key] = threading.current_thread().name
        return key

    def _opened(self) -> int:
        stack = _stack()
        sid = next(self._ids)
        stack.append(sid)
        return sid

    def _closed(self, sp: "_Span", end: int) -> None:
        self.add(sp.name, (end - sp.start) / 1e9)
        if self.spans is not None:
            stack = _stack()
            stack.pop()
            self.spans.append(Span(sp.sid, sp.name, sp.start, end,
                                   self._this_thread(),
                                   stack[-1] if stack else -1, self.id))


class _Span:
    """A span's context manager; ``seconds`` holds its length once closed.
    Without a tracer it only measures."""

    __slots__ = ("tracer", "name", "start", "sid", "seconds")

    def __init__(self, tracer: Tracer | None, name: str):
        self.tracer, self.name, self.seconds = tracer, name, 0.0

    def __enter__(self) -> "_Span":
        tr = self.tracer
        if tr is not None and tr.spans is not None:
            self.sid = tr._opened()
        self.start = _now()
        return self

    def __exit__(self, *exc) -> None:
        end = _now()
        self.seconds = (end - self.start) / 1e9
        if self.tracer is not None:
            self.tracer._closed(self, end)


def _thread_key() -> int:
    """A key of this thread that no other thread of the process gets (thread
    idents are reused once a thread ends)."""
    key = getattr(_local, "key", None)
    if key is None:
        key = _local.key = next(_thread_keys)
    return key


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Tracer | None:
    """The tracer of the record this thread works for, if any."""
    return getattr(_local, "tracer", None)


def adopt(tracer: Tracer | None) -> None:
    """Make this (worker) thread record into ``tracer``: its spans take the
    record's root as parent."""
    _local.tracer = tracer
    _local.stack = [0] if tracer is not None else []


def span(name: str) -> _Span:
    """A span in the current record (only measured outside any)."""
    return _Span(current(), name)


def count(name: str, n: int) -> None:
    tr = current()
    if tr is not None:
        tr.count(name, n)


def add(name: str, secs: float) -> None:
    """Add seconds to a sum of the current record without a span (0.0 makes
    the name present)."""
    tr = current()
    if tr is not None:
        tr.add(name, secs)


def timed(it, name: str):
    """The items of ``it``; each wait for the next one is a span ``name`` on
    the consuming thread."""
    it = iter(it)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def _profiler_on() -> bool:
    import torch

    return torch.autograd._profiler_enabled()


@contextlib.contextmanager
def record_spans():
    """Keep the full record of every record this thread starts inside."""
    _local.switch = getattr(_local, "switch", 0) + 1
    try:
        yield
    finally:
        _local.switch -= 1


@contextlib.contextmanager
def record(kind: str):
    """One record on this thread, its root span named ``kind`` (the root's
    seconds stay out of the sums).  Yields the Tracer."""
    profiled = _profiler_on()
    full = (profiled or getattr(_local, "switch", 0) > 0
            or bool(os.environ.get("KMCEX_TRACE_DIR")))
    tr = Tracer(kind, full)
    saved = (current(), getattr(_local, "stack", []))
    adopt(tr)
    tr.start_ns = _now()
    try:
        yield tr
    finally:
        if profiled and _profiler_on():
            # at the record's end: in a build's first idle gap the marker
            # would be the only annotation, and a trace reader that names
            # idle gaps by the annotation covering them would name that gap
            # after the marker
            import torch

            a = _now()
            with torch.profiler.record_function(MARKER):
                pass
            tr.clock_ns = (a + _now()) // 2
        tr.end_ns = _now()
        if full:
            tr.threads.setdefault(tr.thread, threading.current_thread().name)
            tr.spans.append(Span(0, kind, tr.start_ns, tr.end_ns, tr.thread,
                                 -1, tr.id))
            with _records_lock:
                _records.append(tr)
        _local.tracer, _local.stack = saved


def records() -> list[Tracer]:
    """The finished full records still kept, oldest first."""
    with _records_lock:
        return list(_records)


def clock_offsets(events: list[dict], recs: list[Tracer]) -> list[tuple]:
    """(record, offset in µs) for each record begun under the profiler that
    wrote the Chrome trace ``events``: the k-th ``kmcex.clock`` marker
    belongs to the k-th such record.  A span's trace time is its
    ``start_ns / 1e3 + offset``."""
    marks = sorted((e for e in events
                    if e.get("ph") == "X" and e.get("name") == MARKER),
                   key=lambda e: e["ts"])
    timed_recs = sorted((r for r in recs if r.clock_ns is not None),
                        key=lambda r: r.clock_ns)
    n = min(len(marks), len(timed_recs))   # the newest of each
    return [(r, m["ts"] + m.get("dur", 0) / 2 - r.clock_ns / 1e3)
            for r, m in zip(timed_recs[len(timed_recs) - n:],
                            marks[len(marks) - n:])]


def chrome_events(rec: Tracer, offset_us: float, pid: int) -> list[dict]:
    """The record's spans and counters as Chrome trace events on the trace's
    clock: a thread-name event and a track per program thread, spans as
    ``X`` (``args``: record, span and parent ids), counters as ``C`` (each
    addition's value; ``id`` the record's)."""
    tids = {t: (1 << 30) + i for i, t in enumerate(rec.threads)}
    names = {t: n if n.startswith(CATEGORY) else f"{CATEGORY} {n}"
             for t, n in rec.threads.items()}
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": names[t]}} for t, tid in tids.items()]
    for s in rec.spans:
        out.append({"ph": "X", "cat": CATEGORY, "name": s.name, "pid": pid,
                    "tid": tids[s.thread], "ts": s.start_ns / 1e3 + offset_us,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"record": rec.id, "span": s.id,
                             "parent": s.parent}})
    for c in rec.counts:
        out.append({"ph": "C", "cat": CATEGORY, "name": c.name, "id": rec.id,
                    "pid": pid, "tid": tids[c.thread],
                    "ts": c.at_ns / 1e3 + offset_us, "args": {"value": c.value}})
    return out


@contextlib.contextmanager
def device_trace(label: str = "kmcex"):
    """torch.profiler trace of the enclosed work (host ops, and CUDA kernels
    when a card is present) written as ``$KMCEX_TRACE_DIR/<label>.json``, a
    Chrome trace, with the spans and counters of the records begun inside
    merged in; a no-op when the variable is unset."""
    trace_dir = os.environ.get("KMCEX_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    first = next(_record_ids)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"{label}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    mine = [r for r in records() if r.id > first]
    for rec, offset in clock_offsets(events, mine):
        events += chrome_events(rec, offset, os.getpid())
    with open(path, "w") as f:
        json.dump(trace, f)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_busy(path: str | os.PathLike) -> tuple[float, float]:
    """(busy seconds, span seconds) of a Chrome trace that ``device_trace``
    wrote: busy is the union of the intervals in which a kernel, a device
    copy or a memset ran (overlapping streams count once), span runs from
    the first event of the trace to the end of the last, host events
    included and the program's merged spans left out.  The device's idle
    share of the traced call is ``1 - busy / span``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e
                  and e.get("cat") != CATEGORY]
    if not events:
        return 0.0, 0.0
    span = (max(e["ts"] + e.get("dur", 0) for e in events)
            - min(e["ts"] for e in events))
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e.get("dur", 0)) for e in events
                          if e.get("cat") in _DEVICE_CATS):
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    return busy / 1e6, span / 1e6


def verbose() -> bool:
    return os.environ.get("KMCEX_VERBOSE", "") not in ("", "0")
