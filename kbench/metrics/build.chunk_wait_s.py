"""The `encode.chunk_wait` phase: the encoder waiting for the next chunk of the
table (its copy from the device, the database spool and the counter split on
the producer thread); mean over the window's builds."""

UNIT = "s"
LAYER = "table transfer and DB spool: device_lsm._stream_table and the producer thread in count_encode"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("encode.chunk_wait")
