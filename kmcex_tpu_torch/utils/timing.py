"""Observability: per-phase wall timers and optional device traces.

Every pipeline run fills a ``Phases`` breakdown (exposed on PipelineStats
and printed by the CLI under KMCEX_VERBOSE=1), and ``device_trace`` captures
a ``torch.profiler`` trace (Chrome trace format) when KMCEX_TRACE_DIR is set.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class Phases:
    """Accumulating named wall-clock phase timers."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.time() - t0

    def add(self, name: str, secs: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + secs

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [
            f"   {name:<28s}: {secs:8.3f}s"
            for name, secs in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        ]
        lines.append(f"   {'(sum of phases)':<28s}: {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(label: str = "kmcex"):
    """torch.profiler trace of the enclosed work (host ops, and CUDA kernels
    when a card is present) written as ``$KMCEX_TRACE_DIR/<label>.json``, a
    Chrome trace; a no-op when the variable is unset."""
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
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_busy(path: str | os.PathLike) -> tuple[float, float]:
    """(busy seconds, span seconds) of a Chrome trace that ``device_trace``
    wrote: busy is the union of the intervals in which a kernel, a device
    copy or a memset ran (overlapping streams count once), span runs from
    the first event of the trace to the end of the last, host events
    included.  The device's idle share of the traced call is
    ``1 - busy / span``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
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
