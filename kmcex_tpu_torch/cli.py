"""kmcEx-compatible command line entry point (PyTorch / CUDA port).

The same flags and printout as the JAX package's ``cli.py``, which follows
the reference CLI (main.cpp:37-54,64-112): ``kmcex [-kN] [-tN] [-ciN]
[-csN] [-nhN] [-nbN] <input> <output> <workdir>`` with single-dash prefix
flags, a single FASTQ path or ``@list`` input, the KMC1 database written to
``<output>`` and the model saved under ``<workdir>/<basename(output)>``.
Counting runs on the GPU; ``main(argv, device="cpu")`` runs the plain
PyTorch versions instead (tests).  Run: ``python -m kmcex_tpu_torch.cli``.
"""

from __future__ import annotations

import sys

from kmcex_tpu_torch.config import KParams

USAGE = """\
----------------------------------------------------------------------
   kmcex-tpu-torch: counted k-mer encoding & decoding (PyTorch/CUDA)
----------------------------------------------------------------------
1. USAGE
     kmcex [options] <input_file_name> <output_file_name> <working_directory>
     kmcex [options] <@input_file_names> <output_file_name> <working_directory>
2. OPTIONS
     1) REQUIRED
        input_file_name    - single file in FASTQ format (gziped or not)
        @input_file_names  - file name with list of input files in FASTQ format (gziped or not)
        working_directory  - save temporary files
     2) OPTIONAL
        -k<len>            - k-mer length (default: 31)
        -t<value>          - total number of threads (default: 4)
        -ci<value>         - exclude k-mers occurring less than <value> times (default: 1)
        -cs<value>         - maximal value of a counter (default: 1023)
        -nh<value>         - number of hash (default: 7)
        -nb<value>         - number of bit array (default: 5)
        -acc<kind>         - counting backend: device (one GPU) | sharded
                             (hash-routed mesh: every visible GPU, or
                             several processes, see KMCEX_NUM_PROCESSES)
        -ckpt<dir>         - checkpoint the count phase into <dir>
                             (rerunning the same command after a crash
                             resumes from the last checkpoint)
3. EXAMPLES
     kmcex -k31 -nh7 -nb5  rs.fastq rs.res /tmp
     kmcex -k31 -nh7 -nb5  @rs.lst rs.res /tmp
"""


def parse_parameters(argv: list[str]) -> KParams | None:
    """Reference parser semantics (main.cpp:64-112): prefix-matched single-dash
    flags, then the last three positionals."""
    if len(argv) < 4:
        return None
    params = KParams()
    i = 1
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            break
        if a.startswith("-acc"):
            params.accumulator = a[4:]
        elif a.startswith("-ckpt"):
            params.ckpt_dir = a[5:]
        elif a.startswith("-t"):
            params.t = int(a[2:])
        elif a.startswith("-k"):
            params.k = int(a[2:])
        elif a.startswith("-nh"):
            params.num_hash = int(a[3:])
        elif a.startswith("-nb"):
            params.num_bit = int(a[3:])
        elif a.startswith("-ci"):
            params.ci = int(a[3:])
        elif a.startswith("-cs"):
            params.cs = int(a[3:])
        i += 1
    if len(argv) - i < 3:
        return None
    params.input_file_name = argv[len(argv) - 3]
    params.output_file_name = argv[len(argv) - 2]
    params.working_directory = argv[len(argv) - 1]
    params.__post_init__()
    return params


def main(argv: list[str] | None = None, device=None) -> int:
    """``device=None`` means the GPU; it raises when CUDA is absent."""
    argv = list(sys.argv if argv is None else argv)
    params = parse_parameters(argv)
    if params is None:
        print(USAGE)
        return 255
    from kmcex_tpu_torch.count.pipeline import run

    km, stats = run(params, device=device)
    print(km.show_header_info())
    print(km.show_kmodel_info())
    rate = stats.reads / max(stats.count_seconds + stats.encode_seconds, 1e-9)
    print(f"   reads                              :     {stats.reads}")
    print(f"   count+encode reads/s               :     {rate:.0f}")
    from kmcex_tpu_torch.utils.timing import verbose

    if verbose() and stats.phases:
        print("   --- phase breakdown (KMCEX_VERBOSE) ---")
        for name, secs in sorted(stats.phases.items(), key=lambda kv: -kv[1]):
            print(f"   {name:<28s}       :     {secs:.3f}s")
    import os

    stats_path = os.environ.get("KMCEX_STATS_JSON")
    if stats_path:
        # machine-readable run telemetry (the reference prints text only)
        import dataclasses
        import json
        import resource

        peak_rss_mb = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024
        with open(stats_path, "w") as f:
            json.dump({**dataclasses.asdict(stats),
                       "reads_per_s": rate,
                       "peak_rss_mb": peak_rss_mb}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
