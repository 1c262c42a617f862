"""Seconds the table thread spent writing the KMC1 database chunk by chunk
(span `spool.db_write`); mean over the window's builds
(`PipelineStats.phases["spool.db_write"]`)."""

UNIT = "s"
LAYER = "table transfer and DB spool: device_lsm._stream_table and the producer thread in count_encode"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("spool.db_write")
