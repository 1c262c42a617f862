"""Host time the traced query batches spent waiting on the device, per 10^6
queries: the program's `query.select` spans (the count of ambiguous queries,
one sync) and `query.download` spans (the answers' copy back)."""

from kbench import spans

UNIT = "ms"
LAYER = "device query: query/device_model.py"
MOVES = "query_mq_per_s"


def read(ctx):
    return spans.query_ms_per_mq(ctx, "query.select", "query.download")
