"""Seconds the table thread waited for a chunk's copy from the device (span
`table.pull_wait`, the chunk's event); mean over the window's builds
(`PipelineStats.phases["table.pull_wait"]`)."""

UNIT = "s"
LAYER = "table transfer and DB spool: device_lsm._stream_table and the producer thread in count_encode"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("table.pull_wait")
