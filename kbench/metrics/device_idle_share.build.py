"""Share of the traced build in which no kernel, copy or memset ran on the
device: 100 * (1 - busy / span), busy the union of the device intervals,
span the trace from its first to its last event."""

UNIT = "%"
LAYER = "device"
MOVES = "build_mreads_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
