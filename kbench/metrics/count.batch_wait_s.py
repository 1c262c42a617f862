"""Seconds the main thread waited for the next batch from the copy thread (span
`count.batch_wait`): the count waiting on its ingest; mean over the window's
builds (`PipelineStats.phases["count.batch_wait"]`)."""

UNIT = "s"
LAYER = "host ingest: io/fastq.py and the native segmenter, the device extract behind it"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("count.batch_wait")
