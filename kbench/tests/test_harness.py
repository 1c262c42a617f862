"""Whole runs of the harness on the CPU at a tiny size (the look for a chip
skipped): sound runs come out correct, the control and each fault that a
cell can have come out not correct, and a cell, a configuration, a traffic
mix and a per-layer metric are added by new files and entries alone."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from kbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SEED = 2 ** 31 + 12345
CELLS = {"cli_build": "tiny.cli_build", "model_build": "tiny.model_build",
         "query_tiny": "tiny.query_tiny"}
NEW_METRIC = '''"""Reads a build reads: a metric added by a file of its own."""

UNIT = "count"
LAYER = "CLI and pipeline: cli.py, count/pipeline.py"
MOVES = "build_mreads_per_s"


def read(ctx):
    return ctx.stat_mean("reads")
'''


def tiny_root(tmp_path) -> str:
    """A copy of the benchmark with a tiny configuration, a tiny query mix,
    a new per-layer metric and their cells, made by adding files and
    entries only."""
    root = str(tmp_path / "bench")
    os.makedirs(root)
    shutil.copytree(os.path.join(ROOT, "kbench"), os.path.join(root, "kbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = harness.load_manifest(ROOT)
    with open(os.path.join(ROOT, "kbench/configs/sa_k31.json")) as f:
        cfg = json.load(f)
    cfg.update(genome_len=20000, n_reads=2500, coverage=12)
    with open(os.path.join(root, "kbench/configs/tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "kbench/traffic/query_reads.json")) as f:
        mix = json.load(f)
    mix.update(batch=4096, pool_batches=3, sample_batches=2, profile_batches=2)
    with open(os.path.join(root, "kbench/traffic/query_tiny.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "kbench/metrics/test.reads_per_build.py"),
              "w") as f:
        f.write(NEW_METRIC)
    m["configs"].append({"name": "tiny", "source": "a tiny read set",
                         "file": "kbench/configs/tiny.json", "reduced": [],
                         "why": "test"})
    for traffic, cell in CELLS.items():
        m["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": traffic, "chips": 1, "why": "test"})
    twin = {"sa_k31.cli_build": ["tiny.cli_build"],
            "sa_k31.model_build": ["tiny.model_build"],
            "sa_k31.query_reads": ["tiny.query_tiny"]}
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            e["workloads"] += [t for w in e["workloads"] for t in twin.get(w, [])]
    m["per_layer"].append({"name": "test.reads_per_build", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "CLI and pipeline: cli.py, count/pipeline.py",
                           "moves": "build_mreads_per_s",
                           "workloads": ["tiny.model_build"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("kbench"))


def run(root, cell, trace=False, control=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.2, trace, time.time(),
                            device="cpu", control=control,
                            log=lambda msg: None)


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_sound_run_is_correct(root, cell):
    r = run(root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"]
    assert not os.path.exists(os.path.join(root, ".kbench_work", cell))


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_control_is_not_correct(root, cell):
    r = run(root, cell, control=True)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def test_traced_run_reads_the_new_metric(root):
    r = run(root, "tiny.model_build", trace=True)
    assert r["correct"]
    assert r["metrics"]["test.reads_per_build"]["value"] == 2500
    assert "build.count_s" in r["metrics"] and "build_mreads_per_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _state_unchanged(monkeypatch):
    from kmcex_tpu_torch.count import device_lsm

    monkeypatch.setattr(device_lsm.DeviceCountAccumulator, "add_batch_packed",
                        lambda self, packed, maskbits: None)


def _half_batch(monkeypatch):
    from kmcex_tpu_torch.count import device_lsm

    real = device_lsm.DeviceCountAccumulator.add_batch_packed

    def half(self, packed, maskbits):  # every other read of the batch
        return real(self, packed[::2].contiguous(),
                    maskbits[::2].contiguous())

    monkeypatch.setattr(device_lsm.DeviceCountAccumulator, "add_batch_packed",
                        half)


def _count_altered(monkeypatch):
    from kmcex_tpu_torch.count import device_lsm

    real = device_lsm.DeviceCountAccumulator.finalize_stream

    def altered(self, *a, **kw):
        total, hist, chunks = real(self, *a, **kw)

        def gen():
            for i, (ku, kc) in enumerate(chunks):
                if i == 0 and len(kc):
                    kc = kc.copy()
                    kc[len(kc) // 2] += 1
                yield ku, kc
        return total, hist, gen()

    monkeypatch.setattr(device_lsm.DeviceCountAccumulator, "finalize_stream",
                        altered)


def _previous_answer(monkeypatch):
    """Each build hands back the model of the build before it."""
    from kmcex_tpu_torch.count import pipeline

    real, last = pipeline.count_encode, []

    def stale(*a, **kw):
        out = real(*a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(pipeline, "count_encode", stale)


def _answer_altered(monkeypatch):
    from kmcex_tpu_torch.query import device_model

    real = device_model.DeviceKModel.kmer_to_occ

    def altered(self, kmers, tile=None):
        out = real(self, kmers, tile)
        out[len(out) // 3] += 1
        return out

    monkeypatch.setattr(device_model.DeviceKModel, "kmer_to_occ", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.cli_build", _state_unchanged),
    ("tiny.cli_build", _half_batch),
    ("tiny.cli_build", _count_altered),
    ("tiny.model_build", _state_unchanged),
    ("tiny.model_build", _half_batch),
    ("tiny.model_build", _count_altered),
    ("tiny.model_build", _previous_answer),
    ("tiny.cli_build", _previous_answer),
    ("tiny.query_tiny", _answer_altered),
])
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run(root, cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def test_builds_alternate_read_sets_and_count_the_reads_written(root):
    r = run(root, "tiny.model_build")
    assert r["correct"] and r["checks"]["reads_miscounted"]["value"] == 0
    from kbench import gen

    a = gen.make_reads(20000, 50, SEED, 0.005, read_len=101)
    b = gen.make_reads(20000, 50, SEED, 0.005, read_len=101, stream=1)
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_query_batches_start_at_drawn_offsets(root):
    from kbench import harness as h
    from kbench.drivers import query

    spec = h.resolve(root, h.load_manifest(root), "tiny.query_tiny")
    drv = query.Driver(spec["config"], spec["traffic"], SEED, str(root),
                       "cpu")
    drv.pool = np.arange(3 * drv.batch, dtype=np.uint64)
    drv.dkm = type("Echo", (), {"kmer_to_occ": lambda self, q: q.copy()})()
    n = int(spec["traffic"]["sample_batches"])
    for _ in range(n):
        drv.step()
    starts = [int(ans[0]) for _, ans in drv.kept]
    assert [at for at, _ in drv.kept] == starts
    assert len(set(starts)) == n
    assert all(0 <= s <= 2 * drv.batch for s in starts)


def test_seed_sets_the_inputs():
    from kbench import gen

    a = gen.make_reads(20000, 50, SEED, 0.005, read_len=101)
    b = gen.make_reads(20000, 50, SEED, 0.005, read_len=101)
    c = gen.make_reads(20000, 50, SEED + 1, 0.005, read_len=101)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_no_jax_and_no_program_in_the_reference():
    code = (
        "import sys\n"
        "import kbench.harness, kbench.trace, kbench.gen, kbench.compare\n"
        "import kbench.drivers.build, kbench.drivers.query\n"
        "import kbench.reference.count, kbench.reference.kmodel\n"
        "import kbench.reference.query, kbench.reference.kmc1\n"
        "bad = {'jax', 'jaxlib', 'flax', 'kmcex_tpu', 'kmcex_tpu_torch'}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"
    m = harness.load_manifest(ROOT)
    for cell in m["workloads"]:
        for metric in harness.resolve(ROOT, m, cell["name"])["per_layer"]:
            harness.load_metric(ROOT, metric["name"])
    assert not harness.forbidden_modules()


def test_without_a_card_the_command_prints_nothing():
    p = subprocess.run([sys.executable, "kbench/run.py", "--workload",
                        "sa_k31.cli_build", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, text=True,
                       capture_output=True, env={**os.environ,
                                                 "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_alone_the_benchmark_exits_without_a_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "kbench"), tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "kbench/run.py", "--workload",
                        "sa_k31.cli_build", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, text=True,
                       capture_output=True)
    assert p.returncode != 0 and p.stdout == ""
