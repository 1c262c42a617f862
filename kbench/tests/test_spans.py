"""The readers of the program's own spans and counters (``kbench/spans.py``
and the metrics that use it) on the tiny CPU runs of ``test_harness.py``,
and the program's per-call element counts against the benchmark's own
wrappers (``trace.Instruments``)."""

import os

import pytest

from kbench import harness, spans, trace
from test_harness import SEED, run, tiny_root

NEW = {
    "tiny.cli_build": ["ingest.parse_s", "ingest.h2d_s", "count.batch_wait_s",
                       "table.pull_wait_s", "table.host_prep_s",
                       "spool.db_write_s"],
    "tiny.model_build": ["ingest.parse_s", "ingest.h2d_s",
                         "count.batch_wait_s", "table.pull_wait_s",
                         "table.host_prep_s"],
    "tiny.query_tiny": ["query.sync_wait_ms_per_mq",
                        "query.dispatch_ms_per_mq", "query.resolve_share"],
}
# a peak or a card is needed: no device events, no bandwidth on the CPU
NEEDS_CARD = ["build.idle_on_ingest_s", "merge_sorted_u64.bw_share.build",
              "compact_pairs.bw_share.build"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("kbench_spans"))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reads_the_new_metrics(root, cell):
    r = run(root, cell, trace=True)
    assert r["correct"], r["checks"]
    spec = harness.resolve(root, harness.load_manifest(root), cell)
    listed = {m["name"] for m in spec["per_layer"]}
    assert set(NEW[cell]) <= listed
    for name in NEW[cell]:
        v = r["metrics"][name]["value"]
        assert isinstance(v, float) and v >= 0, (name, v)
    for name in NEEDS_CARD:
        if cell != "tiny.query_tiny":
            assert name in listed and name not in r["metrics"]
    if cell == "tiny.query_tiny":
        assert 0 < r["metrics"]["query.resolve_share"]["value"] < 100


def _traced(root, cell, device="cpu"):
    m = harness.load_manifest(root)
    spec = harness.resolve(root, m, cell)
    from importlib import import_module

    drv_mod = import_module("kbench.drivers." + spec["traffic"]["driver"])
    wd = os.path.join(root, ".kbench_work", cell)
    os.makedirs(wd, exist_ok=True)
    drv = drv_mod.Driver(spec["config"], spec["traffic"], SEED, wd, device)
    drv.setup()
    inst = trace.Instruments()
    rec, trc = trace.profile(lambda: drv.traced(inst),
                             os.path.join(wd, "trace.json"))
    return harness.LayerContext([], trc, inst.calls, rec.get("queries", 0),
                                "cpu"), inst


@pytest.mark.parametrize("cell", ["tiny.cli_build", "tiny.model_build"])
def test_program_counts_equal_the_instruments(root, cell, monkeypatch):
    """Each call of sort_u64, merge_sorted_u64 and compact_pairs, in the
    program's counters, is the call the benchmark's wrappers saw, element
    count for element count; on the CLI path with run merges forced (small
    batches and raw tier), on the model path with the low-key drop."""
    monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "20000")
    monkeypatch.setenv("KMCEX_BATCH_SEGS", "256")
    ctx, inst = _traced(root, cell)
    recs = spans.records(ctx)
    assert len(recs) == 1 and recs[0].rec.kind == "build"
    got = spans.calls(recs)
    assert len(inst.calls["compact_pairs"]) >= 2
    if cell == "tiny.cli_build":
        assert len(inst.calls["merge_sorted_u64"]) >= 2
    assert got == inst.calls
    t = ctx.trace
    root_span = recs[0].spans("build")[0]
    assert t.t0 <= root_span[0] < root_span[1] <= t.t1


def test_query_records_map_into_the_traced_stretch(root):
    ctx, inst = _traced(root, "tiny.query_tiny")
    recs = spans.records(ctx)
    assert [r.rec.kind for r in recs] == ["query", "query"]
    assert sum(r.counter("query.queries") for r in recs) == ctx.queries
    assert spans.calls(recs) == inst.calls
    for r in recs:
        (a, b), = r.spans("query")
        for x, y in r.spans("query.main", "query.resolve", "query.download"):
            assert a <= x <= y <= b


def test_without_the_programs_records_the_readers_return_none(root,
                                                              monkeypatch):
    ctx, _ = _traced(root, "tiny.cli_build")
    from kmcex_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "records")
    assert spans.records(ctx) == []
    for name in ["build.idle_on_ingest_s", "merge_sorted_u64.bw_share.build",
                 "compact_pairs.bw_share.build", "query.sync_wait_ms_per_mq",
                 "query.dispatch_ms_per_mq", "query.resolve_share"]:
        assert harness.load_metric(root, name).read(ctx) is None


def test_device_idle_within_the_spans():
    t = trace.Trace([
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 120, "dur": 60},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 300, "dur": 10},
    ])
    # busy 100-180 and 300-310
    assert spans.device_idle_within(t, [(0, 100)]) == pytest.approx(100e-6)
    assert spans.device_idle_within(t, [(90, 200), (305, 400)]) == \
        pytest.approx((10 + 20 + 90) * 1e-6)
    assert spans.device_idle_within(t, []) == 0
