"""Observability: per-phase wall timers.

Every pipeline run fills a ``Phases`` breakdown (exposed on PipelineStats
and printed by the CLI under KMCEX_VERBOSE=1).
"""

from __future__ import annotations

import contextlib
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


def verbose() -> bool:
    return os.environ.get("KMCEX_VERBOSE", "") not in ("", "0")
