"""The `encode.array_feed` phase: the native coupled-array encode on the host;
mean over the window's builds."""

UNIT = "s"
LAYER = "host encode: model/kmodel.py and the native encoder"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("encode.array_feed")
