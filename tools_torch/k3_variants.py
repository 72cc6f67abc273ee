#!/usr/bin/env python3
"""K3 (the training conv pair's backward, csrc/nb1d_train.cu) against variants of
its own source, on one NVIDIA card: time per student backward and accuracy.

    python3 tools_torch/k3_variants.py [--dtype f32|bf16] [--only NAME ...]
                                       [--out build/k3_variants_<dtype>.json]

Variants, each a text substitution of the committed sources (csrc/nb1d_train.cu,
csrc/tf32_pair.cuh for the 3xTF32 products K3 shares with K2 and K1's fp32
kernel, csrc/sm90_async.cuh for the ring depth) built into
build/k3_variants/<name>/ and run in its own process. float32 (`--dtype f32`):
  as_built      the source as it is (run first and last);
  one_level     the products summed straight in the mma accumulator, with no
                second, round-to-nearest accumulator per K chunk;
  lo_truncated  lo = x - hi handed to the tensor cores as it is (they read its
                top 19 bits) instead of rounded to TF32;
  stages2, stages4   a cp.async ring 2 or 4 deep instead of 3.
bfloat16 (`--dtype bf16`, the knobs of K3 bf16's launches):
  as_built           as above;
  bf16_kc_pair       the conv launches' chunk of input channels as the pair's
                     (32 at C >= 64) instead of 64: twice the stages per tile;
  bf16_dc_no_halo    launch 1's gy taken as three shifted tiles, a stage per
                     column tap, instead of once with its +-d halo;
  bf16_wgrad_no_halo the weight gradients' gy taken as three shifted tiles
                     instead of once with its halo;
  bf16_wgrad_walkers_half  half the weight-gradient walkers (16 at C = 128,
                     64 at C = 16 / 64): fewer partials, fewer CTAs;
  bf16_conv_cta256   conv CTAs of 256 threads (the pair's warps, half the
                     pixels per tile and per weight chunk) instead of 512;
  bf16_wgrad_by_matrix  the weight gradients' A fragments of u and c loaded
                     again before each of the 6 products of a k16 step instead
                     of once for all (the staging stays shared).
K2 bf16 walks the same conv tiles (ConvTiles), so bf16_kc_pair and
bf16_conv_cta256 change K2 bf16 too (tools_torch/k2_variants.py measures K2's
knobs); this tool times K3 only.
Times: CUDA events over bwd_pair for the two pairs of each of the 7 block
shapes at 6x512x1024 (chip_smoke's inputs and timing), summed over the blocks
of one student backward; device ms per launch kind from torch.profiler, also
per block. Accuracy: float32: du (at the pixels no relu within float32
rounding of its kink reaches), dw13 and drap against chip_smoke's float64
gradient; bfloat16: every output against the plain bf16 version; at the 7
shapes and the ragged one, RAP and pre-stage on.
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
WORK = ROOT / "build" / "k3_variants"
ORDER = {"f32": ("as_built", "one_level", "lo_truncated", "stages2", "stages4", "as_built"),
         "bf16": ("as_built", "bf16_kc_pair", "bf16_conv_cta256", "bf16_dc_no_halo",
                  "bf16_wgrad_no_halo", "bf16_wgrad_walkers_half", "bf16_wgrad_by_matrix",
                  "as_built")}


# the files a variant may change, relative to the package
SOURCE, PAIR, RING = "csrc/nb1d_train.cu", "csrc/tf32_pair.cuh", "csrc/sm90_async.cuh"
FILES = (SOURCE, PAIR, RING)
# ConvStages::multiply (f.acc += one K chunk's product, through the fresh accumulator f.loc) and
# its one-level replacement (the products summed straight into f.acc)
MULTIPLY = """    product<AM>(a, buf, f.loc, live);
    f.flush();
"""
MULTIPLY_ONE_LEVEL = """    const int warp = threadIdx.x >> 5, wm = warp % L::WM, wn = warp / L::WM;
    const float* A = a + wm * L::WROWS * AM;
    const float* B = smem + buf * L::STAGE + L::B_OFF + wn * L::NT * 8;
#pragma unroll
    for (int ks = 0; ks < L::KC / 8; ++ks)
      mma_k8<L::MT, L::NT, AM, 1, L::LDB, false, L::TROWS, L::LDSM>(
          A + ks * 8, B + ks * 8 * L::LDB, f.acc, live);
"""
# the weight-gradient kernel's B fragments of one product; by matrix, the A fragments of u and c
# are loaded again before each product instead of once per k16 step for all of them
A_RELOAD = """        uint32_t bf[K::NT][2];
        load_b_frags<K::NT, K::LDB>(bf, B + brow * K::LDB, k0);"""
A_RELOAD_BY_MATRIX = """        uint32_t bf[K::NT][2];
        load_b_frags<K::NT, K::LDB>(bf, B + brow * K::LDB, k0);
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt) {
          const bf16* a = st + (k0 + (j >> 1) * 8 + r8) * K::LDA + wm * K::MT * 16 + mt * 16 +
                          (j & 1) * 8;
          ldsm_x4_trans(au[mt], a);
          ldsm_x4_trans(ac[mt], a + K::C_OFF);
        }"""


def _sub(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} x {old!r} in the K3 sources")
    return text.replace(old, new)


def variants(files: dict[str, str]) -> dict[str, dict[str, str]]:
    """name -> {file (relative to the package): its text} for each file the
    variant changes; `files` holds the committed text of FILES."""
    src, pair, ring = (files[f] for f in FILES)
    one = _sub(src, "f.loc);", "f.acc);", 2)  # the weight gradients
    one = _sub(one, "true>(", "false>(", 1)
    one = _sub(one, "f.flush();", "", 1)
    stages = "constexpr int kStages = 3;"
    conv_kc = "  static constexpr int KC = C >= 64 ? 64 : C;"
    return {
        "as_built": {},
        "one_level": {SOURCE: one, PAIR: _sub(pair, MULTIPLY, MULTIPLY_ONE_LEVEL, 1)},
        "lo_truncated": {PAIR: _sub(pair, "lo = tf32_rna(x - __uint_as_float(hi));",
                                    "lo = __float_as_uint(x - __uint_as_float(hi));", 1)},
        "stages2": {RING: _sub(ring, stages, "constexpr int kStages = 2;", 1)},
        "stages4": {RING: _sub(ring, stages, "constexpr int kStages = 4;", 1)},
        "bf16_kc_pair": {SOURCE: _sub(src, conv_kc, conv_kc.replace("C >= 64 ? 64", "C >= 32 ? 32"),
                                      1)},
        "bf16_dc_no_halo": {SOURCE: _sub(src, "static constexpr int DMAX = 16;",
                                         "static constexpr int DMAX = 0;", 1)},
        "bf16_wgrad_no_halo": {SOURCE: _sub(src, "const bool halo = d <= K::TP;",
                                            "const bool halo = false;", 1)},
        "bf16_wgrad_walkers_half": {SOURCE: _sub(
            src, "WALKERS = C >= 128 ? 32 : 128;", "WALKERS = C >= 128 ? 16 : 64;", 1)},
        "bf16_conv_cta256": {SOURCE: _sub(src, "static constexpr int THREADS = 512;",
                                          "static constexpr int THREADS = 256;", 1)},
        "bf16_wgrad_by_matrix": {SOURCE: _sub(src, A_RELOAD, A_RELOAD_BY_MATRIX, 1)},
    }


def measure(root: Path, name: str, dt: str) -> dict:
    sys.path[:0] = [str(root), str(ROOT)]
    import torch

    import chip_smoke as cs
    from mdilss_tpu_torch.ops import nb1d_train as T

    if not Path(T.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {T.__file__}, not the variant under {root}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    kinds, dtype = cs.PAIR_KINDS["bwd", dt], cs.DTYPES[dt]
    n = cs.TRAIN_BATCH
    total = {"ms": 0.0, **dict.fromkeys(kinds, 0.0)}
    blocks = []
    for i, (block, c, d, rap, h, w, count) in enumerate(cs.BLOCKS):
        gen = torch.Generator().manual_seed(100 * i)
        x = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, dtype))
        gy = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, dtype))
        row = {"block": block, **dict.fromkeys(kinds, 0.0)}
        for dd, pre in ((1, False), (d, True)):
            args = cs.pair_args(gen, c, rap, pre, dev)

            def fn(args=args, dd=dd):
                return T.bwd_pair(x, gy, *args, dd)

            total["ms"] += count * cs.time_ms(fn, iters=10, warmup=2)
            for k, v in cs.device_ms_by_kind(fn, kinds).items():
                total[k] = cs.add_ms(total[k], None if v is None else count * v)
                row[k] = cs.add_ms(row[k], v)
        blocks.append(row)
    worst: dict[str, float] = {}
    for i, (_, c, d, _, h, w, _) in enumerate(cs.BLOCKS + (cs.RAGGED,)):
        gen = torch.Generator().manual_seed(7 + i)
        w31, b31, w13, rapw, pre_ab = cs.pair_args(gen, c, True, True, dev)
        x = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, dtype))
        gy = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, dtype))
        names = ("du", "dw31", "db31", "dw13", "drap")
        got = dict(zip(names, T.bwd_pair(x, gy, w31, b31, w13, rapw, pre_ab, d)))
        if dt == "f32":
            ref = cs.pair_bwd_f64(x, gy, w31, b31, w13, rapw, pre_ab, d)
            clear = ref["du_clear"]
            errs = {"du": cs.rel_l2(got["du"] * clear, ref["mid"]["du"] * clear),
                    "dw13": cs.rel_l2(got["dw13"], ref["dw13"]),
                    "drap": cs.rel_l2(got["drap"], ref["drap"])}
            del ref
        else:
            plain = dict(zip(names, T.bwd_pair_plain(x, gy, w31, b31, w13, rapw, pre_ab, d)))
            errs = {k: cs.rel_l2(got[k], plain[k]) for k in names}
            del plain
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del got
    return {"variant": name, "dtype": dt, "card": cs.card_line(),
            "k3_ms_per_backward": total, "device_ms_per_block": blocks,
            "worst_rel_l2": worst,
            "against": "float64" if dt == "f32" else "the plain bf16 version"}


def committed() -> dict[str, str]:
    return {f: (PACKAGE / f).read_text() for f in FILES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--only", nargs="+", metavar="NAME", help="run these variants (and as_built)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", nargs=2, metavar=("ROOT", "NAME"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(Path(args.measure[0]), args.measure[1], args.dtype)))
        return 0
    order = [v for v in ORDER[args.dtype] if v == "as_built" or not args.only or v in args.only]
    table = variants(committed())
    for name in dict.fromkeys(order):
        root = WORK / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE, root / PACKAGE.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        for fname, text in table[name].items():
            (root / PACKAGE.name / fname).write_text(text)
    results = []
    for name in order:
        proc = subprocess.run([sys.executable, __file__, "--dtype", args.dtype, "--measure",
                               str(WORK / name), name], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(rec)
        t, e = rec["k3_ms_per_backward"], rec["worst_rel_l2"]
        print(f"{name:24s} K3 {args.dtype} {t['ms']:.3f} ms per backward (device "
              + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured"
                          for k, v in t.items() if k != "ms")
              + f"); worst rel L2 vs {rec['against']} "
              + ", ".join(f"{k} {v:.2e}" for k, v in e.items()), flush=True)
        for row in rec["device_ms_per_block"]:
            print(f"{'':24s}   {row['block']:16s} "
                  + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                              for k, v in row.items() if k != "block"), flush=True)
    out = Path(args.out or f"build/k3_variants_{args.dtype}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
