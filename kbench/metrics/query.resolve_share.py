"""Share of the traced batches' queries that the resolve pass answered (the
ambiguous ones, each with its 8 neighbours): the program's counters
`query.resolved` over `query.queries`."""

from kbench import spans

UNIT = "%"
LAYER = "device query: query/device_model.py"
MOVES = "query_mq_per_s"


def read(ctx):
    recs = [r for r in spans.records(ctx) if r.rec.kind == "query"]
    queries = sum(r.counter("query.queries") for r in recs)
    if not queries:
        return None
    return 100.0 * sum(r.counter("query.resolved") for r in recs) / queries
