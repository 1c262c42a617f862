"""Background-thread prefetch for host->device pipelines.

The host-side FASTQ parse and the device compute are independent stages; a
producer thread with a small bounded queue overlaps them (CUDA work is
enqueued asynchronously, so the consumer loop is cheap).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")

_STOP = object()


def prefetch_iterator(
    it: Iterable[T], depth: int = 3, transform: Callable[[T], T] | None = None
) -> Iterator[T]:
    """``transform`` (e.g. a host->device ``Tensor.to``) runs in the producer thread so
    host->device copies overlap the consumer's dispatch work."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker() -> None:
        try:
            for item in it:
                if transform is not None:
                    item = transform(item)
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_STOP)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _STOP:
            break
        yield item
    t.join()
    if err:
        raise err[0]
