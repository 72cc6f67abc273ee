#!/usr/bin/env python3
"""Compare the SASS of one kernel between two checkouts of the port, on a
machine with the CUDA toolkit.

    python3 tools_torch/sass_compare.py ROOT_A ROOT_B --source nb1d_train \
        --kernel fwd_pair_mma_kernel

Builds `csrc/<source>.cu` of each root's `mdilss_tpu_torch` with that root's
own `ops/_build.py` (in a subprocess started in the root), disassembles both
libraries with `cuobjdump -sass`, and for each function whose name contains
`--kernel` prints its instruction count in A and B and whether the two
instruction streams are identical (the offsets in the `/*0000*/` comments
left out). Names are matched with the anonymous namespace's per-file hash
(`_GLOBAL__N__<hash>_`) left out. Exits 1 if a function differs or is missing
on one side.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path


def build(root: Path, source: str) -> Path:
    code = ("from mdilss_tpu_torch.ops import _build; "
            f"print(_build.build([{source!r}])[{source!r}])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def functions(lib: Path, kernel: str) -> dict[str, list[str]]:
    """mangled name -> its SASS instructions, for the functions matching `kernel`."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
            name = name if kernel in name else None
            if name is not None:
                out[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a", type=Path)
    ap.add_argument("root_b", type=Path)
    ap.add_argument("--source", required=True, help="csrc/<source>.cu")
    ap.add_argument("--kernel", required=True, help="substring of the kernel's name")
    args = ap.parse_args(argv)
    a = functions(build(args.root_a.resolve(), args.source), args.kernel)
    b = functions(build(args.root_b.resolve(), args.source), args.kernel)
    same = bool(a) and a.keys() == b.keys()
    for name in sorted(a.keys() | b.keys()):
        fa, fb = a.get(name), b.get(name)
        if fa is None or fb is None:
            print(f"{name}: only in {'A' if fb is None else 'B'}")
            continue
        diff = sum(x != y for x, y in zip(fa, fb)) + abs(len(fa) - len(fb))
        same &= diff == 0
        print(f"{name}: {len(fa)} / {len(fb)} instructions, "
              + ("identical" if diff == 0 else f"{diff} lines differ"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
