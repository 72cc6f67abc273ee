"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1
    python3 benchmark/run.py --list

From the root of a checkout. Set-up (imports, their bytecode cached under
`build/benchmark_cache/pycache/`, the port's kernels built into
`build/kernels/` or found there, weights and data made on the card from the
seed, the cell's shapes warmed up) is timed from the start of this process
to the first timed batch. Then the window runs for `--seconds`. With
`--trace 0` the result holds the cell's end-to-end metrics; with `--trace 1`
a profiled sub-window follows and it holds the per-layer metrics, the
device's busy and window seconds and a breakdown. Last, the plain reference
decides `correct`.

The last line of standard output is the result object; everything else goes
to standard error, whose last lines are each compared number beside its
limit. Without a CUDA card, or with fewer cards than the cell asks for, the
run exits 2 and prints no result; so it does when a module of JAX or of the
JAX package is loaded once the window has closed, or anything fails.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "build", "benchmark_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true", help="list the cells and what they are made of")
    return p.parse_args(argv)


def main(argv=None) -> int:
    # Python's bytecode too, before torch is imported: where the environment
    # turns its writing off and the installed packages carry none, every run
    # would compile torch's modules from source again (about 20 s of set-up:
    # importing torch, and the lazy imports of the port's first custom-op call)
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
    args = parse(argv)
    from benchmark import harness

    if args.list:
        for cell in harness.list_cells(ROOT):
            print(json.dumps(cell))
        return 0
    if not args.workload:
        print("--workload is required", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
