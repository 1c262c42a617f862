"""The `stream+extract` phase of a build: parse, pack, copy to the device and
count batch by batch; mean over the window's builds."""

UNIT = "s"
LAYER = "host ingest: io/fastq.py and the native segmenter, the device extract behind it"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("stream+extract")
