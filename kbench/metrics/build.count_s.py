"""Seconds from the start of a build to the end of its count
(`PipelineStats.count_seconds`), mean over the window's builds."""

UNIT = "s"
LAYER = "CLI and pipeline: cli.py, count/pipeline.py"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.stat_mean("count_seconds")
