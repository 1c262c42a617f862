"""Seconds of the traced build in which the device was idle while the main
thread waited for a batch from the ingest: the program's `count.batch_wait`
spans on the trace's clock, less the time a kernel, copy or memset ran."""

from kbench import spans

UNIT = "s"
LAYER = "host ingest: io/fastq.py and the native segmenter, the device extract behind it"
MOVES = "build_mreads_per_s"


def read(ctx):
    recs = [r for r in spans.records(ctx) if r.rec.kind == "build"]
    if not recs or not ctx.trace.device:
        return None
    waits = [iv for r in recs for iv in r.spans("count.batch_wait", main=True)]
    return spans.device_idle_within(ctx.trace, waits)
