"""Seconds the parse thread spent parsing and 2-bit packing the build's batches
(span `ingest.parse`, one a batch, on stage A of the ingest); mean over the
window's builds (`PipelineStats.phases["ingest.parse"]`)."""

UNIT = "s"
LAYER = "host ingest: io/fastq.py and the native segmenter, the device extract behind it"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("ingest.parse")
