"""The port's tracer (``kmcex_tpu_torch.utils.timing``): records, spans from
every thread of a build, counters, the clock that maps spans onto a
``torch.profiler`` trace, and the merged ``KMCEX_TRACE_DIR`` trace."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmcex_tpu_torch.count.pipeline import count_encode
from kmcex_tpu_torch.utils import prefetch_iterator, timing

# the phase keys a CPU build of the model-only path had before the tracer
OLD_KEYS = {"sniff_read_length", "stream+extract", "merge+stats",
            "transfer+encode", "finalize.drop_low", "finalize.copy_dispatch",
            "finalize.bloom_feed_dispatch", "encode.chunk_wait",
            "encode.array_feed", "encode.array_finish", "encode.rest_build",
            "encode.route_split", "encode.bloom_pull"}
NEW_SUMS = {"ingest.parse", "ingest.h2d", "count.batch_wait",
            "count.add_batch", "table.pull_wait", "table.host_prep"}


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("fq")
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    fq = d / "r.fastq"
    with open(fq, "w") as f:
        for i in range(600):
            s = int(rng.integers(0, len(genome) - 100))
            r = genome[s : s + 100]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return fq


def _build(fastq, **kw):
    return count_encode(str(fastq), k=21, device="cpu", batch_segs=64, **kw)


def _last_record():
    return timing.records()[-1]


def test_recorded_build_has_spans_from_every_thread(fastq, tmp_path):
    with timing.record_spans():
        _, _, _, stats = _build(fastq, keep_pairs=False,
                                db_path=str(tmp_path / "db"))
    rec = _last_record()
    assert rec.kind == "build" and rec.spans is not None
    by_thread: dict[str, set] = {}
    for s in rec.spans:
        by_thread.setdefault(rec.threads[s.thread], set()).add(s.name)
    assert by_thread["kmcex.parse"] == {"ingest.parse"}
    assert by_thread["kmcex.h2d"] == {"ingest.h2d"}
    assert by_thread["kmcex.table"] == {"table.pull_wait", "table.host_prep",
                                        "spool.db_write"}
    main = by_thread[rec.threads[rec.thread]]
    assert {"build", "count.batch_wait", "count.add_batch", "stream+extract",
            "merge+stats", "transfer+encode", "encode.chunk_wait"} <= main
    ids = {s.id for s in rec.spans}
    assert len(ids) == len(rec.spans)
    for s in rec.spans:
        assert s.record == rec.id
        assert s.parent in ids or (s.id == 0 and s.parent == -1)
        assert s.start_ns <= s.end_ns
    root = next(s for s in rec.spans if s.id == 0)
    for s in rec.spans:
        if rec.threads[s.thread].startswith("kmcex."):
            assert s.parent == 0          # a worker's spans hang off the root
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    # the extract dispatch nests in the stream phase
    parent = {s.id: s for s in rec.spans}
    add = next(s for s in rec.spans if s.name == "count.add_batch")
    assert parent[add.parent].name == "stream+extract"
    # the always-on sums are the record's span sums
    for name in ("ingest.parse", "table.pull_wait", "count.batch_wait"):
        total = sum(s.end_ns - s.start_ns for s in rec.spans
                    if s.name == name) / 1e9
        assert stats.phases[name] == pytest.approx(total)
    assert stats.counters["spool.pairs"] == stats.distinct_kmers


def test_unrecorded_build_keeps_sums_only(fastq):
    before = [r.id for r in timing.records()]
    _, _, _, stats = _build(fastq, keep_pairs=False)
    assert [r.id for r in timing.records()] == before
    assert set(stats.phases) == OLD_KEYS | NEW_SUMS
    c = stats.counters
    assert c["ingest.reads"] == stats.reads == 600
    assert c["ingest.bases"] == stats.bases
    assert c["count.windows"] == stats.windows
    assert c["sort_u64.keys"] == c["count.windows"]
    assert c["ingest.h2d.bytes"] > 0 and c["table.pairs"] > 0


def test_counters_count_each_kernel_operation_call(fastq, monkeypatch):
    """Per-call element counts of the three kernel operations, in the
    recorded build's counter events, one pair per call."""
    monkeypatch.setenv("KMCEX_RAW_TIER_ELEMS", "4000")
    with timing.record_spans():
        _, _, _, stats = _build(fastq, keep_pairs=False)
    rec = _last_record()
    assert stats.tiers["device_merges"] >= 2
    ev = {}
    for c in rec.counts:
        ev.setdefault(c.name, []).append(c.value)
    assert len(ev["merge_sorted_u64.a"]) == stats.tiers["device_merges"]
    assert len(ev["sort_u64.keys"]) == len(ev["sort_u64.payload"])
    collapses = [s for s in rec.spans if s.name == "count.collapse"]
    assert len(ev["sort_u64.keys"]) == len(collapses) == len(
        ev["count.collapse.keys"])
    assert sum(ev["count.collapse.keys"]) == stats.windows
    assert ev["count.merge.keys"] == [a + b for a, b in zip(
        ev["merge_sorted_u64.a"], ev["merge_sorted_u64.b"])]
    assert sum(ev["compact_pairs.pairs"]) == stats.counters["compact_pairs.pairs"]
    spans = {s.name for s in rec.spans}
    assert {"count.collapse", "count.merge"} <= spans


def _warm_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):
            pass


def test_clock_maps_a_main_thread_span_onto_its_profiler_event(tmp_path):
    _warm_profiler()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.record("build") as tr:
            with timing.span("probe"):
                with torch.profiler.record_function("probe"):
                    time.sleep(0.002)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert tr.clock_ns is not None
    [(rec, offset)] = timing.clock_offsets(events, [tr])
    assert rec is tr
    probe = next(e for e in events if e.get("name") == "probe")
    span = next(s for s in tr.spans if s.name == "probe")
    # the span wraps the event, so their middles meet
    mid = (span.start_ns + span.end_ns) / 2e3 + offset
    assert abs(mid - (probe["ts"] + probe["dur"] / 2)) < 50
    assert span.start_ns / 1e3 + offset <= probe["ts"] + 50


def test_worker_span_after_a_main_thread_event_maps_after_it(tmp_path):
    _warm_profiler()
    go = threading.Event()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.record("build") as tr:
            def worker():
                timing.adopt(tr)
                go.wait()
                with timing.span("after"):
                    time.sleep(0.001)

            t = threading.Thread(target=worker, name="kmcex.worker")
            t.start()
            with torch.profiler.record_function("before"):
                time.sleep(0.002)
            go.set()
            t.join()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    [(_, offset)] = timing.clock_offsets(events, [tr])
    before = next(e for e in events if e.get("name") == "before")
    after = next(s for s in tr.spans if s.name == "after")
    assert tr.threads[after.thread] == "kmcex.worker" and after.parent == 0
    assert after.start_ns / 1e3 + offset > before["ts"] + before["dur"]


def test_trace_dir_merges_program_spans_on_named_tracks(fastq, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("KMCEX_TRACE_DIR", str(tmp_path / "tr"))
    _build(fastq, keep_pairs=False, db_path=str(tmp_path / "db"))
    path = tmp_path / "tr" / "count_encode.json"
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == timing.CATEGORY]
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"
              and e["args"]["name"].startswith("kmcex")}
    assert {"kmcex.parse", "kmcex.h2d", "kmcex.table"} <= set(tracks.values())
    spans = [e for e in mine if e["ph"] == "X"]
    assert {e["tid"] for e in spans} == set(tracks)
    assert {e["name"] for e in spans} >= {"build", "ingest.parse",
                                          "ingest.h2d", "table.pull_wait"}
    assert any(e["ph"] == "C" for e in mine)
    # the build's root lies inside the profiler's own stretch
    prof = next(e for e in events if e.get("cat") == "Trace")
    root = next(e for e in spans if e["name"] == "build")
    assert prof["ts"] <= root["ts"]
    assert root["ts"] + root["dur"] <= prof["ts"] + prof["dur"]
    # trace_device_busy reads the merged file as the profiler's alone
    alone = tmp_path / "alone.json"
    alone.write_text(json.dumps({"traceEvents": [
        e for e in events if e.get("cat") != timing.CATEGORY]}))
    assert timing.trace_device_busy(path) == timing.trace_device_busy(alone)


def test_record_spans_is_the_calling_threads_switch(fastq):
    out = []
    before = [r.id for r in timing.records()]
    with timing.record_spans():
        t = threading.Thread(target=lambda: out.append(
            _build(fastq, keep_pairs=False)[3]))
        t.start()
        t.join()
    assert out and out[0].phases["ingest.parse"] > 0
    assert [r.id for r in timing.records()] == before
    with timing.record_spans(), timing.record("query") as tr:
        pass
    assert tr.spans is not None
    with timing.record("query") as tr:
        pass
    assert tr.spans is None and tr.counts is None


def test_records_keep_the_newest(monkeypatch):
    monkeypatch.setattr(timing, "_records",
                        timing.collections.deque(maxlen=3))
    ids = []
    with timing.record_spans():
        for _ in range(5):
            with timing.record("query") as tr:
                pass
            ids.append(tr.id)
    assert [r.id for r in timing.records()] == ids[-3:]


def test_prefetch_workers_record_into_the_consumers_record():
    with timing.record_spans(), timing.record("build") as tr:
        def slow(x):
            with timing.span("work"):
                return x + 1

        assert list(prefetch_iterator(iter(range(5)), depth=2,
                                      transform=slow, name="kmcex.w")) == [
            1, 2, 3, 4, 5]
        assert list(prefetch_iterator(iter(range(2)))) == [0, 1]
    work = [s for s in tr.spans if s.name == "work"]
    assert len(work) == 5
    assert {tr.threads[s.thread] for s in work} == {"kmcex.w"}
    assert tr.seconds["work"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in work) / 1e9)


def test_spans_outside_a_record_only_measure():
    assert timing.current() is None
    with timing.span("x") as sp:
        time.sleep(0.001)
    assert sp.seconds >= 0.001
    timing.count("x", 3)
    timing.add("x", 1.0)
    assert timing.current() is None


def test_query_record(fastq):
    from kmcex_tpu_torch.query.device_model import DeviceKModel

    km, kmers, _, _ = _build(fastq, keep_pairs=True)
    dm = DeviceKModel(km, device="cpu")
    q = np.concatenate([kmers[:3000], kmers[:500] ^ np.uint64(1)])
    with timing.record_spans():
        ans = dm.kmer_to_occ(q, tile=1024)
    rec = _last_record()
    assert rec.kind == "query"
    assert np.array_equal(ans, km.kmer_to_occ_u64(q))
    names = [s.name for s in rec.spans]
    assert names.count("query.main") == -(-len(q) // 1024)
    assert {"query", "query.upload", "query.select",
            "query.download"} <= set(names)
    assert rec.counters["query.queries"] == len(q)
    assert rec.counters["query.resolved"] == dm.n_resolved
    assert names.count("query.resolve") == -(-dm.n_resolved
                                             // dm.RESOLVE_TILE)


def test_trace_check_reads_a_merged_trace(fastq, tmp_path, monkeypatch):
    """tools/trace_check on a CPU build's merged trace, with hand-made device
    copies laid in: one batch copy inside an ``ingest.h2d`` span and one
    outside, a chunk's two copies ending before and after its wait."""
    from kmcex_tpu_torch.tools import trace_check

    monkeypatch.setenv("KMCEX_TRACE_DIR", str(tmp_path / "tr"))
    _build(fastq, keep_pairs=False)
    events = json.loads((tmp_path / "tr" / "count_encode.json").read_text())[
        "traceEvents"]
    mine = [e for e in events if e.get("cat") == timing.CATEGORY]
    h2d = [e for e in mine if e["name"] == "ingest.h2d"]
    nbytes = next(e["args"]["value"] for e in mine
                  if e["name"] == "ingest.h2d.bytes")
    pairs = next(e["args"]["value"] for e in mine
                 if e["name"] == "table.pairs")
    wait = min((e for e in mine if e["name"] == "table.pull_wait"),
               key=lambda e: e["ts"])
    end = wait["ts"] + wait["dur"]

    def copy(kind, ts, n, dur=1.0):
        return {"ph": "X", "cat": "gpu_memcpy", "name": f"Memcpy {kind}",
                "ts": ts, "dur": dur, "args": {"bytes": n}}

    gaps = [(x["ts"] + x["dur"], y["ts"]) for x, y in zip(h2d, h2d[1:])
            if y["ts"] - x["ts"] - x["dur"] > 4 * trace_check.SLACK_US]
    assert gaps
    events += [copy("HtoD", h2d[0]["ts"] + 1, 2 * nbytes // 3),
               copy("HtoD", (gaps[0][0] + gaps[0][1]) / 2, nbytes // 3),
               copy("HtoD", h2d[0]["ts"] + 1, 12345),       # not a batch
               copy("DtoH", end - 10, 8 * pairs, 5),
               copy("DtoH", end - 3, 4 * pairs, 5)]
    [res] = trace_check.check(events)
    assert res["threads"] == ["kmcex MainThread", "kmcex.h2d", "kmcex.parse",
                              "kmcex.table"]
    assert 0.5 < res["main_coverage"] <= 1
    assert res["h2d_copies"] == 2 and res["h2d_inside"] == 0.5
    assert res["dtoh_copies"] == 2 and res["dtoh_before"] == 0.5
    assert res["dtoh_margin_us"] == pytest.approx(-2)
