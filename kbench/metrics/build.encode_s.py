"""Seconds of a build's encode (`PipelineStats.encode_seconds`), mean over the
window's builds."""

UNIT = "s"
LAYER = "CLI and pipeline: cli.py, count/pipeline.py"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.stat_mean("encode_seconds")
