"""Seconds the copy thread spent copying the build's batches to the device
(span `ingest.h2d`, one a batch, on stage B of the ingest); mean over the
window's builds (`PipelineStats.phases["ingest.h2d"]`)."""

UNIT = "s"
LAYER = "host ingest: io/fastq.py and the native segmenter, the device extract behind it"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("ingest.h2d")
