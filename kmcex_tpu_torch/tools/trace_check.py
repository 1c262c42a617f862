"""Checks of a build's merged trace: the program's spans against the device
events of the same ``torch.profiler`` trace (a ``KMCEX_TRACE_DIR`` file, or
any trace with ``utils.timing.chrome_events`` laid in).

    python3 -m kmcex_tpu_torch.tools.trace_check <trace.json>

prints, for each build record of the file, as JSON:

* ``threads``: the program threads that recorded spans;
* ``main_coverage``: the share of the ``build`` root's wall time that the
  root thread's other spans cover;
* ``h2d_inside``: of the host-to-device copies of a batch's array sizes,
  the share that start inside an ``ingest.h2d`` span, ``SLACK_US`` allowed;
* ``dtoh_before``: of the table chunks' device-to-host copies, the share
  that end before their chunk's ``table.pull_wait`` span ends (the k-th
  span waits for the k-th chunk, whose pairs the k-th ``table.pairs``
  counter gives), and ``dtoh_margin_us``, the least such margin.
"""

from __future__ import annotations

import json
import sys

SLACK_US = 50.0
CATEGORY = "kmcex"


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _copies(events, kind: str, a: float, b: float) -> list[dict]:
    """The device copies of direction ``kind`` that start in [a, b]."""
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "gpu_memcpy" and kind in e["name"]
                   and a <= e["ts"] <= b), key=lambda e: e["ts"])


def _nbytes(e: dict):
    return e.get("args", {}).get("bytes")


def check(events: list[dict]) -> list[dict]:
    """One result per ``build`` record among the Chrome trace ``events``."""
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    mine = [e for e in events if e.get("cat") == CATEGORY]
    out = []
    for root in [e for e in mine if e["ph"] == "X" and e["name"] == "build"]:
        rid = root["args"]["record"]
        spans = [e for e in mine if e["ph"] == "X"
                 and e["args"]["record"] == rid]
        counts = [e for e in mine if e["ph"] == "C" and e["id"] == rid]
        a, b = root["ts"], root["ts"] + root["dur"]
        main = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                if e["tid"] == root["tid"] and e is not root]
        res = {"record": rid,
               "threads": sorted({names.get(e["tid"], "?") for e in spans}),
               "main_coverage": _union(main) / max(b - a, 1e-9)}

        # a batch is a packed array and a mask array of half its size
        sizes = set()
        for e in counts:
            if e["name"] == "ingest.h2d.bytes":
                sizes |= {e["args"]["value"] // 3, 2 * e["args"]["value"] // 3}
        h2d = [(e["ts"] - SLACK_US, e["ts"] + e["dur"] + SLACK_US)
               for e in spans if e["name"] == "ingest.h2d"]
        htod = [e for e in _copies(events, "HtoD", a, b) if _nbytes(e) in sizes]
        inside = sum(any(x <= e["ts"] <= y for x, y in h2d) for e in htod)
        res["h2d_copies"] = len(htod)
        res["h2d_inside"] = inside / len(htod) if htod else None

        pairs = [e["args"]["value"] for e in counts
                 if e["name"] == "table.pairs"]
        ends = sorted(e["ts"] + e["dur"] for e in spans
                      if e["name"] == "table.pull_wait")
        dtoh = _copies(events, "DtoH", a, b)
        margins = []
        for m, end in zip(pairs, ends):
            # the chunk's keys (8 bytes a pair) and counts (4): the first
            # copies of those sizes that no earlier chunk took
            for want in (8 * m, 4 * m):
                e = next((e for e in dtoh if _nbytes(e) == want), None)
                if e is not None:
                    dtoh.remove(e)
                    margins.append(end - (e["ts"] + e["dur"]))
        res["dtoh_copies"] = len(margins)
        res["dtoh_before"] = (sum(m >= 0 for m in margins) / len(margins)
                              if margins else None)
        res["dtoh_margin_us"] = min(margins) if margins else None
        out.append(res)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        events = json.load(f)["traceEvents"]
    print(json.dumps(check(events), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
