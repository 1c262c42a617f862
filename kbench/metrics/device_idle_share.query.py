"""Share of the traced stretch of query batches in which no kernel, copy or
memset ran on the device: 100 * (1 - busy / span)."""

UNIT = "%"
LAYER = "device"
MOVES = "query_mq_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
