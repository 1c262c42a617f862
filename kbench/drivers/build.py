"""The build driver: two read sets made from the seed, each written once as
FASTQ, then whole builds back to back, alternating between the two sets.

Traffic keys:

* ``path``: ``"cli"`` is ``count.pipeline.run`` with the KMC1 database and
  ``KModel.save`` (what the kmcEx command does); ``"model"`` is
  ``count.pipeline.count_encode(keep_pairs=False, db_path=None)``, the
  library's model-only path.

The two sets are fresh reads of one genome (streams 0 and 1 of the seed):
the same sizes, so the same work, but different tables, so a build that
hands back an earlier build's answer is seen.  Every build in the window is
checked: its model against the plain model of the plain count of its own
set, byte for byte.  On the CLI path the files of one build of each set,
drawn from the seed, are checked too: the database against the plain count
and the saved model against the plain model.  The reads of a build are the
reads written; the program's own count of them is checked against that.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kbench import compare, gen

READ_SETS = 2


class Driver:
    unit = "build"

    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str,
                 device: str):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.workdir, self.device = workdir, device
        self.path = traffic["path"]
        if self.path not in ("cli", "model"):
            raise ValueError(f"unknown build path {self.path!r}")
        self.fastqs = [os.path.join(workdir, f"reads{s}.fq")
                       for s in range(READ_SETS)]
        self.models: list = []           # (read set, model) of the window
        self.kept: dict = {}             # read set -> its build whose files are kept
        self.miscounted = 0              # reads the program counted wrongly
        self._rng = np.random.default_rng([gen.rng_seed(seed), 7])
        self._builds = [0] * READ_SETS
        self._n = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from kmcex_tpu_torch import native

        c = self.cfg
        native.set_num_threads(c["t"])   # the deployment's -t, on both paths
        with ThreadPoolExecutor(READ_SETS) as ex:   # numpy frees the GIL
            self.reads = list(ex.map(self._make_set, range(READ_SETS)))
        for s in range(READ_SETS):       # warm-up: every shape, every kernel
            self._build(s)
        torch.cuda.synchronize() if self.device == "cuda" else None

    def _make_set(self, s: int) -> np.ndarray:
        c = self.cfg
        reads = gen.make_reads(c["genome_len"], c["n_reads"], self.seed,
                               c["err_rate"], c["read_len"], c["n_rate"],
                               stream=s)
        gen.write_fastq(self.fastqs[s], reads)
        return reads

    def _build(self, s: int):
        from kmcex_tpu_torch.count import pipeline

        c = self.cfg
        if self.path == "model":
            km, _, _, stats = pipeline.count_encode(
                self.fastqs[s], c["k"], c["ci"], c["cs"], c["nh"], c["nb"],
                keep_pairs=False, db_path=None, device=self.device)
            return km, stats
        from kmcex_tpu_torch.config import KParams

        params = KParams(k=c["k"], num_hash=c["nh"], num_bit=c["nb"],
                         ci=c["ci"], cs=c["cs"], t=c["t"],
                         input_file_name=self.fastqs[s],
                         output_file_name=os.path.join(self.workdir, "db"),
                         working_directory=self.workdir)
        return pipeline.run(params, save_dir=os.path.join(self.workdir,
                                                          "model"),
                            device=self.device)

    # ------------------------------------------------------------ window
    def step(self) -> dict:
        s = self._n % READ_SETS
        t0 = time.perf_counter()
        km, stats = self._build(s)
        if self.device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        written = len(self.reads[s])
        self.miscounted += abs(stats.reads - written)
        self._keep(s, km)
        return {"t0": t0, "t1": t1, "reads": written, "stats": stats}

    def _keep(self, s: int, km) -> None:
        """Hold the model; on the CLI path keep the files of one build of
        each set, drawn from the seed (the set's first build is kept with
        chance 1, its n-th replaces it with chance 1/n)."""
        self.models.append((s, km))
        self._n += 1
        self._builds[s] += 1
        if self.path != "cli" or self._rng.random() * self._builds[s] >= 1:
            return
        dst = os.path.join(self.workdir, f"kept{s}")
        shutil.rmtree(dst, ignore_errors=True)
        os.makedirs(dst)
        for name in ("db.kmc_pre", "db.kmc_suf", "model"):
            os.replace(os.path.join(self.workdir, name),
                       os.path.join(dst, name))
        self.kept[s] = self._n

    @staticmethod
    def end_to_end(records: list[dict]) -> dict:
        t = records[-1]["t1"] - records[0]["t0"]
        return {"build_mreads_per_s": sum(r["reads"] for r in records)
                / t / 1e6}

    def describe(self, records: list[dict]) -> str:
        """One line on the first build of the window, for the log."""
        s = records[0]["stats"]
        secs = [round(r["t1"] - r["t0"], 3) for r in records]
        waits = [round(r["stats"].phases.get("encode.chunk_wait", 0), 3)
                 for r in records]
        out = (f"distinct {s.distinct_kmers}, window slots {s.windows}, "
               f"tiers {s.tiers}, table bytes to host "
               f"{s.table_bytes_to_host}; build seconds {secs}, "
               f"chunk_wait {waits}")
        kept = os.path.join(self.workdir, "kept0")
        if os.path.isdir(kept):
            size = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(kept) for f in fs)
            out += f", files of a build {size} bytes"
        return out

    def traced(self, instruments):
        """One build under the instruments; its record (the trace is taken
        by the caller)."""
        with instruments.patched():
            return self.step()

    # ------------------------------------------------------------ check
    def release(self) -> None:
        """Nothing of the program stays on the device after a build."""

    def _count(self, s: int, key_bits: int = 64):
        from kbench.reference import count

        c = self.cfg
        reads = torch.from_numpy(self.reads[s]).to(self.device)
        kk, cc, _ = count.count_table(reads, c["k"], c["ci"], c["cs"],
                                      key_bits=key_bits)
        return kk, cc

    def check(self, control: bool = False) -> tuple[list, int]:
        """([(name, value, "<=" or ">=", limit)], builds that failed).  Each
        read set that the window built is checked against its own plain
        count and model."""
        from kbench.reference import kmc1, kmodel

        c = self.cfg
        model_diff = db_diff = file_diff = compared = failed = 0
        for s in sorted({t for t, _ in self.models}):
            kk, cc = self._count(s)
            ref = kmodel.build(kk, cc, c["k"], c["ci"], c["cs"], c["nh"],
                               c["nb"])
            if control:
                # the reference in the program's place, with keys in 32 bits
                ck, cc2 = self._count(s, key_bits=32)
                got_models = [kmodel.build(ck, cc2, c["k"], c["ci"], c["cs"],
                                           c["nh"], c["nb"]).files]
                got_table = (ck.cpu().numpy().astype(np.uint64),
                             cc2.cpu().numpy().astype(np.uint64))
                saved = got_models[0]
            else:
                got_models = [compare.model_files(km)
                              for t, km in self.models if t == s]
                got_table = saved = None
                if s in self.kept:
                    d = os.path.join(self.workdir, f"kept{s}")
                    db = kmc1.read(os.path.join(d, "db"))
                    got_table = (db["kmers"], db["counts"])
                    saved = {n: open(os.path.join(d, "model", n), "rb").read()
                             for n in ref.files}
            diffs = [compare.files_differ(m, ref.files) for m in got_models]
            model_diff = max([model_diff] + diffs)
            compared += len(diffs)
            failed += sum(d > 0 for d in diffs)
            if self.path == "cli":
                want = (kk.cpu().numpy().astype(np.uint64),
                        cc.cpu().numpy().astype(np.uint64))
                d_db = compare.pairs_differ(got_table, want)
                d_file = compare.files_differ(saved, ref.files)
                db_diff, file_diff = max(db_diff, d_db), max(file_diff, d_file)
                failed += int((d_db > 0 or d_file > 0) and not any(diffs))
            del kk, cc, ref
        checks = [("model_bytes_differ", model_diff, "<=", 0),
                  ("builds_compared", compared, ">=", 1),
                  ("reads_miscounted", self.miscounted, "<=", 0)]
        if self.path == "cli":
            checks += [("db_pairs_differ", db_diff, "<=", 0),
                       ("saved_model_bytes_differ", file_diff, "<=", 0)]
        return checks, failed
