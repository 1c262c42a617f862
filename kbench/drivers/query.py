"""The query driver: one client asks ``DeviceKModel.kmer_to_occ`` (numpy
in, numpy out) batch after batch, each as soon as the last is answered.

Set-up builds the configuration's model from its read set (the library's
model-only path) and puts it on the device.  The queries are the forward
k-mers of a fresh read set of the same genome (stream 1 of the seed):
a pool of ``pool_batches`` batches of ``batch`` k-mers.  Each batch of the
window starts at an offset into the pool drawn from the seed, so no two
batches are alike and no answer can be reused.  ``sample_batches``
answered batches, drawn from the seed, are kept and checked against the
plain model's answers; ``profile_batches`` more run in the traced stretch.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kbench import gen

QUERY_STREAM = 1


class Driver:
    unit = "batch"

    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str,
                 device: str):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.workdir, self.device = workdir, device
        self.batch = int(traffic["batch"])
        self.fastq = os.path.join(workdir, "reads.fq")
        self._rng = np.random.default_rng([gen.rng_seed(seed), 11])
        self._offsets = np.random.default_rng([gen.rng_seed(seed), 12])
        self.kept: list[tuple[int, np.ndarray]] = []
        self._n = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from kmcex_tpu_torch import native
        from kmcex_tpu_torch.count import pipeline
        from kmcex_tpu_torch.query.device_model import DeviceKModel

        c = self.cfg
        native.set_num_threads(c["t"])   # the deployment's -t
        with ThreadPoolExecutor(1) as ex:  # the pool is made meanwhile
            pool = ex.submit(self._pool,
                             int(self.traffic["pool_batches"]) * self.batch)
            self.reads = gen.make_reads(c["genome_len"], c["n_reads"],
                                        self.seed, c["err_rate"],
                                        c["read_len"], c["n_rate"])
            gen.write_fastq(self.fastq, self.reads)
            km, _, _, _ = pipeline.count_encode(
                self.fastq, c["k"], c["ci"], c["cs"], c["nh"], c["nb"],
                keep_pairs=False, db_path=None, device=self.device)
            os.unlink(self.fastq)
            self.dkm = DeviceKModel(km, device=self.device)
            del km
            self.pool = pool.result()
        for a in (0, self.batch):        # warm-up: both passes, every shape
            self.dkm.kmer_to_occ(self.pool[a: a + self.batch])

    def _pool(self, need: int) -> np.ndarray:
        c = self.cfg
        per_read = c["read_len"] - c["k"] + 1
        n_reads = int(need / per_read / (1 - 4 * c["n_rate"] * c["k"])) + 1000
        q = np.zeros(0, np.uint64)
        while len(q) < need:
            reads = gen.make_reads(c["genome_len"], n_reads, self.seed,
                                   c["err_rate"], c["read_len"], c["n_rate"],
                                   stream=QUERY_STREAM)
            q = gen.forward_kmers(reads, c["k"])
            n_reads *= 2
        return q[:need]

    def _batch(self, at: int) -> np.ndarray:
        return self.pool[at: at + self.batch]

    # ------------------------------------------------------------ window
    def step(self) -> dict:
        at = int(self._offsets.integers(0, len(self.pool) - self.batch + 1))
        q = self._batch(at)
        t0 = time.perf_counter()
        ans = self.dkm.kmer_to_occ(q)
        t1 = time.perf_counter()
        self._n += 1
        self._keep(at, ans)
        return {"t0": t0, "t1": t1, "queries": len(ans)}

    def _keep(self, at: int, ans: np.ndarray) -> None:
        """Reservoir of ``sample_batches`` answered batches."""
        s = int(self.traffic["sample_batches"])
        if len(self.kept) < s:
            self.kept.append((at, ans))
        else:
            j = int(self._rng.integers(0, self._n))
            if j < s:
                self.kept[j] = (at, ans)

    @staticmethod
    def end_to_end(records: list[dict]) -> dict:
        t = records[-1]["t1"] - records[0]["t0"]
        lat = np.array([r["t1"] - r["t0"] for r in records]) * 1e3
        return {"query_mq_per_s": sum(r["queries"] for r in records) / t / 1e6,
                "query_batch_ms_p95": float(np.percentile(lat, 95))}

    def describe(self, records: list[dict]) -> str:
        """One line on the window, for the log."""
        lat = sorted(r["t1"] - r["t0"] for r in records)
        return (f"batch latency min {lat[0] * 1e3:.3f} ms, median "
                f"{lat[len(lat) // 2] * 1e3:.3f} ms, max {lat[-1] * 1e3:.3f} ms")

    def traced(self, instruments):
        with instruments.patched():
            recs = [self.step()
                    for _ in range(int(self.traffic["profile_batches"]))]
        return {"t0": recs[0]["t0"], "t1": recs[-1]["t1"],
                "queries": sum(r["queries"] for r in recs)}

    # ------------------------------------------------------------ check
    def release(self) -> None:
        self.dkm = None

    def check(self, control: bool = False) -> tuple[list, int]:
        """([(name, value, "<=" or ">=", limit)], batches that failed)."""
        from kbench.reference import count, kmodel, query

        c = self.cfg
        reads = torch.from_numpy(self.reads).to(self.device)
        kk, cc, _ = count.count_table(reads, c["k"], c["ci"], c["cs"])
        del reads
        ref = kmodel.build(kk, cc, c["k"], c["ci"], c["cs"], c["nh"], c["nb"])
        diffs = []
        for at, ans in self.kept:
            q = torch.from_numpy(self._batch(at).view(np.int64)).to(self.device)
            want = query.answer(ref, q)
            got = (query.answer(ref, q, resolve=False) if control
                   else torch.from_numpy(ans.astype(np.int64)).to(self.device))
            diffs.append(int((got != want).sum()))
        return ([("answers_differ", sum(diffs), "<=", 0),
                 ("batches_compared", len(diffs), ">=", 1)],
                sum(d > 0 for d in diffs))
