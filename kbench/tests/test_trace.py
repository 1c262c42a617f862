"""The trace arithmetic and the bytes of the kernel operations, on
hand-made inputs."""

import importlib.util
import os

import pytest

from kbench import harness, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_union_counts_overlaps_once():
    assert trace.busy_union([]) == 0
    assert trace.busy_union([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20
    assert trace.busy_union([(10, 0), (10, 5), (0, 100)]) == 100


def test_trace_reads_busy_span_kernels_and_breakdown():
    events = [
        _ev("user_annotation", "kbench.encode", 0, 1000),
        _ev("user_annotation", "kbench.count.add_batch", 0, 300),
        _ev("cpu_op", "aten::sort", 10, 50),
        _ev("kernel", "void (anonymous namespace)::onesweep_pass<false>(int)",
            100, 100),
        _ev("kernel", "merge_tiles(unsigned long const*)", 150, 100),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 600, 50),
        {"ph": "i", "name": "instant", "ts": 5000},
    ]
    t = trace.Trace(events)
    assert t.span_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(200e-6)
    assert t.kernel_seconds() == pytest.approx(200e-6)
    assert t.kernel_seconds({"onesweep_pass"}) == pytest.approx(100e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["onesweep_pass", pytest.approx(100e-6)]
    gaps = dict(b["idle_gaps"])
    # 0-100 under the add_batch span (the shorter of two covering it)
    assert gaps["kbench.count.add_batch"] == pytest.approx(100e-6)
    # 250-600 and 650-1000 under the encode span only
    assert gaps["kbench.encode"] == pytest.approx(700e-6)


def _metric(name):
    return harness.load_metric(ROOT, name)


def test_bytes_functions():
    m = _metric("kernels.bw_share.build")
    assert m.sort_bytes({"keys": 10, "payload": 0}) == 160
    assert m.sort_bytes({"keys": 10, "payload": 10}) == 240
    assert m.merge_bytes({"a": 3, "b": 5}) == 192
    assert m.compact_bytes({"pairs": 7}) == 168


class _Ctx:
    def __init__(self, trace_, calls, kind="NVIDIA H100 80GB HBM3",
                 queries=0):
        self.trace, self.calls, self.device_kind = trace_, calls, kind
        self.queries = queries


def test_bandwidth_shares_from_a_hand_made_trace():
    # 64M keys sorted in 1 ms: 2^26 * 16 bytes / 3.35e12 / 1e-3
    t = trace.Trace([_ev("kernel", "onesweep_pass", 0, 900),
                     _ev("kernel", "digit_histograms", 900, 100),
                     _ev("kernel", "compact_pass", 2000, 500),
                     _ev("kernel", "other", 3000, 500)])
    calls = {"sort_u64": [{"keys": 1 << 26, "payload": 0}],
             "merge_sorted_u64": [], "compact_pairs": [{"pairs": 1 << 20}]}
    sort = _metric("sort_u64.bw_share.build").read(_Ctx(t, calls))
    assert sort == pytest.approx(100 * (16 << 26) / 3.35e12 / 1e-3)
    both = _metric("kernels.bw_share.build").read(_Ctx(t, calls))
    assert both == pytest.approx(
        100 * ((16 << 26) + (24 << 20)) / 3.35e12 / 1.5e-3)
    assert _metric("kernels.bw_share.build").read(
        _Ctx(t, calls, kind="cpu")) is None
    empty = {"sort_u64": [], "merge_sorted_u64": [], "compact_pairs": []}
    assert _metric("kernels.bw_share.build").read(_Ctx(t, empty)) is None


def test_query_and_idle_readers():
    t = trace.Trace([_ev("user_annotation", "kbench.query.batch", 0, 4000),
                     _ev("kernel", "a", 0, 1000), _ev("kernel", "b", 500, 1000),
                     _ev("gpu_memset", "Memset", 3000, 1000)])
    ctx = _Ctx(t, {}, queries=2_000_000)
    assert _metric("query.launches_per_mq").read(ctx) == pytest.approx(1.0)
    assert _metric("query.kernel_ms_per_mq").read(ctx) == pytest.approx(1.0)
    assert _metric("device_idle_share.query").read(ctx) == pytest.approx(37.5)
    assert _metric("device_idle_share.build").read(
        _Ctx(trace.Trace([]), {})) is None
