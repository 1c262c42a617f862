"""The `merge+stats` phase of a build: the last collapse and merges, the drop,
the sizing stats and the Bloom feed; mean over the window's builds."""

UNIT = "s"
LAYER = "device count: count/device_lsm.py"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.phase_mean("merge+stats")
