"""Seconds the table thread spent on a chunk's host work before the encode
takes it: the ci filter and the split by counter (span `table.host_prep`);
mean over the window's builds (`PipelineStats.phases["table.host_prep"]`)."""

UNIT = "s"
LAYER = "table transfer and DB spool: device_lsm._stream_table and the producer thread in count_encode"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("table.host_prep")
