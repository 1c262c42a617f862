"""Summed kernel time of the traced stretch of query batches, per 10^6 queries."""

UNIT = "ms"
LAYER = "device query: query/device_model.py"
MOVES = "query_mq_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not ctx.queries:
        return None
    return 1e3 * t.kernel_seconds() / (ctx.queries / 1e6)
