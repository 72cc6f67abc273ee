#!/usr/bin/env python3
"""K1's bf16 kernel (nb1d_pair_mma_kernel, csrc/nb1d_infer.cu) against variants
of its own source, on one NVIDIA card: device time per forward and accuracy
against the plain version.

    python3 tools_torch/k1_variants.py [--out build/k1_variants.json] [--only NAME ...]

Variants, each a text substitution of the committed sources (nb1d_infer.cu,
and sm90_async.cuh for the ring depth) built into build/k1_variants/<name>/
and run in its own process:
  as_built     the source as it is (run first and last);
  stages4      a cp.async ring 4 deep instead of 3;
  kc64         K chunks of 64 input channels instead of 32 (C = 64, 128);
  narrow       4 warps per CTA instead of 8: tiles of 32 / 64 / 128 output
               columns at C = 128 / 64 / 16 instead of 64 / 128 / 256, so
               256 CTAs instead of 128 on the 64x128 map at batch 1.
Times: torch.profiler device ms of the kernel for the 7 block shapes of one
512x1024 forward (chip_smoke's blocks), at batch 1 and 6, summed over the 17
blocks; CUDA events over back-to-back calls beside them. Accuracy: worst
relative L2 against the bf16 plain version over the same calls.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "mdilss_tpu_torch"
WORK = ROOT / "build" / "k1_variants"
SOURCE, RING = "nb1d_infer.cu", "sm90_async.cuh"


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} x {old!r} in the K1 sources")
    return text.replace(old, new)


def variants(src: str, ring: str) -> dict[str, dict[str, str]]:
    """name -> {file in csrc/: its text} for each file the variant changes."""
    kc = "static constexpr int KC = C < 32 ? C : 32;        // input channels per staged chunk"
    narrow = _sub(src, "static constexpr int THREADS = 256;", "static constexpr int THREADS = 128;")
    narrow = _sub(narrow, "static constexpr int MTA = 3;", "static constexpr int MTA = C == 128 ? 4 : 3;")
    return {
        "as_built": {},
        "stages4": {RING: _sub(ring, "constexpr int kStages = 3;", "constexpr int kStages = 4;")},
        "kc64": {SOURCE: _sub(src, kc, kc.replace("C < 32 ? C : 32", "C < 64 ? C : 64"))},
        "narrow": {SOURCE: narrow},
    }


def measure(root: Path, name: str) -> dict:
    sys.path[:0] = [str(root), str(ROOT)]
    import torch

    import chip_smoke as cs
    from mdilss_tpu_torch.ops import nb1d_infer as K

    if not Path(K.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {K.__file__}, not the variant under {root}")
    dev = torch.device("cuda")
    totals, blocks, worst = {}, [], 0.0
    for i, spec in enumerate(cs.BLOCKS):
        block, c, d, rap, h, w, count = spec
        blk = cs.make_block(spec, 10 * i, dev)
        ops = K.prepare_operands(blk, 2 if rap else None, torch.bfloat16)
        for n in cs.BATCHES:
            gen = torch.Generator().manual_seed(10 * i + n)
            x = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, torch.bfloat16))

            def fn(x=x, ops=ops, d=d):
                return K.nb1d_infer(x, ops, d)

            worst = max(worst, cs.rel_l2(fn(), K.nb1d_infer_plain(x, ops, d)))
            dev_ms = cs.device_ms_by_kind(fn, {"k1": cs.K1_KERNEL["bf16"]})["k1"]
            event_ms = cs.time_ms(fn)
            blocks.append({"block": block, "batch": n, "device_ms": dev_ms, "event_ms": event_ms})
            t = totals.setdefault(f"batch{n}", {"device_ms": 0.0, "event_ms": 0.0})
            t["device_ms"] = cs.add_ms(t["device_ms"], None if dev_ms is None else count * dev_ms)
            t["event_ms"] += count * event_ms
    return {"variant": name, "card": cs.card_line(), "k1_bf16_per_forward": totals,
            "blocks": blocks, "worst_rel_l2_vs_plain": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k1_variants.json")
    ap.add_argument("--only", nargs="*", help="variants to run beside as_built")
    ap.add_argument("--measure", nargs=2, metavar=("ROOT", "NAME"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(Path(args.measure[0]), args.measure[1])))
        return 0
    csrc = PACKAGE / "csrc"
    table = variants((csrc / SOURCE).read_text(), (csrc / RING).read_text())
    names = [n for n in table if n != "as_built" and (not args.only or n in args.only)]
    for name in ["as_built", *names]:
        root = WORK / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE, root / PACKAGE.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        for fname, text in table[name].items():
            (root / PACKAGE.name / "csrc" / fname).write_text(text)
    results = []
    for name in ["as_built", *names, "as_built"]:
        proc = subprocess.run([sys.executable, __file__, "--measure", str(WORK / name), name],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(rec)
        print(f"{name:9s} K1 bf16 per 17-block forward: "
              + ", ".join(f"{b} device {v['device_ms']:.4f} ms (events {v['event_ms']:.4f})"
                          if v["device_ms"] is not None else f"{b} device not measured"
                          for b, v in rec["k1_bf16_per_forward"].items())
              + f"; worst rel L2 vs plain {rec['worst_rel_l2_vs_plain']:.2e}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
