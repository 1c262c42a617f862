"""Run one cell of the benchmark once, on this machine's GPU:

    python3 kbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the read set from the seed, a warm-up of every shape and kernel),
then the window: whole units of work (builds or query batches) back to back
until ``--seconds`` have passed, each one started finishing.  Then the
plain reference checks what the window produced.  The last line of the
standard output is the result as JSON; the numbers compared, each beside
its limit, are the last lines of the standard error and the result's last
key.  ``--trace 1`` reports the per-layer metrics, read from one more unit
under ``torch.profiler``.  ``--control 1`` puts the reference, with a
guarantee broken, in the program's place for the check (it must come out
not correct).

Exits 2 without a result when there is no CUDA device or fewer than the
cell asks for, and 3 when JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cache at a fixed path inside the checkout
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".kbench_cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from kbench import harness

    spec = harness.resolve(ROOT, harness.load_manifest(ROOT), args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[kbench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START,
                              control=bool(args.control))
    bad = harness.forbidden_modules()
    if bad:
        print(f"[kbench] modules that must not load: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[kbench] check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
