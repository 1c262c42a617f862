"""Host time the traced query batches spent launching the main and resolve
passes, per 10^6 queries: the program's `query.main` and `query.resolve`
spans, one a tile."""

from kbench import spans

UNIT = "ms"
LAYER = "device query: query/device_model.py"
MOVES = "query_mq_per_s"


def read(ctx):
    return spans.query_ms_per_mq(ctx, "query.main", "query.resolve")
