"""One run of one cell: load the cell from ``BENCHMARK.json`` and its files,
set up, run the window, read the metrics, check the outputs, and build the
result line.

Everything a cell needs is found by name: its configuration
(``configs[].file``), its traffic mix (``kbench/traffic/<traffic>.json``,
whose ``driver`` names a module of ``kbench/drivers``), and each per-layer
metric (``kbench/metrics/<name>.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import time

BENCH_DIR = "kbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "kmcex_tpu")


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(root: str, manifest: dict, name: str) -> dict:
    """The cell ``name``: its entry, configuration, traffic mix and the
    manifest entries of the metrics it reports."""
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


def load_metric(root: str, name: str):
    """The reader module of a per-layer metric, ``kbench/metrics/<name>.py``."""
    path = os.path.join(root, BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "kbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class LayerContext:
    """What a per-layer metric reads: the window's phase timers (mean per
    build), the traced stretch's trace and element counts."""

    def __init__(self, stats, trace, calls, queries, device_kind):
        self.stats, self.trace, self.calls = stats, trace, calls
        self.queries, self.device_kind = queries, device_kind

    def stat_mean(self, attr: str):
        vals = [getattr(s, attr) for s in self.stats]
        return statistics.fmean(vals) if vals else None

    def phase_mean(self, name: str):
        vals = [s.phases[name] for s in self.stats if name in s.phases]
        return statistics.fmean(vals) if vals else None


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             log=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    import torch

    from kbench import trace as tr

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    manifest = load_manifest(root)
    spec = resolve(root, manifest, name)
    drv_mod = importlib.import_module("kbench.drivers."
                                      + spec["traffic"]["driver"])
    workdir = os.path.join(root, ".kbench_work", name)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        drv = drv_mod.Driver(spec["config"], spec["traffic"], seed, workdir,
                             device)
        drv.setup()
        setup_s = time.time() - t_start
        log(f"[kbench] {name} seed {seed}: set-up {setup_s:.3f} s")
        records, t0 = [], time.perf_counter()
        while True:
            records.append(drv.step())
            if time.perf_counter() - t0 >= seconds:
                break
        e2e = drv.end_to_end(records)
        e2e["setup_s"] = setup_s
        attempted = len(records)
        log(f"[kbench] window: {attempted} x {drv.unit}, "
            + ", ".join(f"{k} {v:.6g}" for k, v in e2e.items()))
        log(f"[kbench] {drv.describe(records)}")
        on_gpu = device == "cuda"
        result_device = {
            "platform": "gpu" if on_gpu else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
            "count": int(spec["cell"]["chips"]),
        }
        metrics, breakdown = {}, None
        if trace:
            inst = tr.Instruments()
            rec, trc = tr.profile(lambda: drv.traced(inst),
                                  os.path.join(workdir, "trace.json"))
            attempted += 1
            ctx = LayerContext([r["stats"] for r in records if "stats" in r],
                               trc, inst.calls, rec.get("queries", 0),
                               result_device["kind"])
            for m in spec["per_layer"]:
                value = load_metric(root, m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result_device["busy_s"] = trc.busy_s
            result_device["window_s"] = trc.span_s
            breakdown = trc.breakdown()
        else:
            for m in spec["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        result_device["memory_peak_bytes"] = (
            int(torch.cuda.max_memory_allocated()) if on_gpu else 0)
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"[kbench] modules that must not load: {bad}")
        drv.release()
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
        t_ref = time.time()
        checks, failed = drv.check(control=control)
        log(f"[kbench] check {time.time() - t_ref:.3f} s"
            + (" (control in the program's place)" if control else ""))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ok = all((v <= lim) if op == "<=" else (v >= lim)
             for _, v, op, lim in checks)
    result = {"correct": bool(ok), "attempted": attempted,
              "failed": int(failed) if ok else max(int(failed), 1),
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": f"{op} {lim}"}
                        for n, v, op, lim in checks}
    return result
