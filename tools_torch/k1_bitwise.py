#!/usr/bin/env python3
"""K1's kernels (csrc/nb1d_infer.cu), K2's fp32 and bf16 kernels and K3's bf16
kernels (csrc/nb1d_train.cu) of two checkouts of the port, bit for bit, on one
NVIDIA card.

    python3 tools_torch/k1_bitwise.py ROOT_A ROOT_B [--seed 0]

Builds `csrc/nb1d_infer.cu` and `csrc/nb1d_train.cu` of each root with that
root's own `ops/_build.py` (tools_torch/sass_compare.py `build`), loads the
libraries with ctypes and calls, on the same random inputs, K1's C entry
`nb1d_pair` (one conv pair of each of the 7 nb1d block shapes of a 512x1024
forward at batch 1 and 6, in float32 and bfloat16, without and with the
residual), K2's `nb1d_train_fwd` and `nb1d_train_fwd_bf16` (the same shapes
at batch 6, with and without the pre-stage: y and the [2, C] stats; a
checkout whose K2 takes a stats window, `row0, row1`, is called with the
whole height) and K3's `nb1d_train_bwd_bf16` on the bf16 inputs (du and the
weight gradients). Prints, per case, whether the two outputs are equal bit
for bit, and exits 1 if any differs. K2's stats are float32 sums in the
design's order; against a checkout of another order (K2 bf16 before its
walker design) they differ, and the line gives the largest difference
relative to the largest value of each row (sum, sum of squares). Use it when
a change moves K1's, K2's or K3's code, or a header they share, without
meaning to change their results.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from sass_compare import build  # noqa: E402

# (name, C, dilation, rap, H, W) of chip_smoke.py's BLOCKS
BLOCKS = (
    ("enc64_d1_rap", 64, 1, True, 128, 256),
    ("enc128_d2_rap", 128, 2, True, 64, 128),
    ("enc128_d4_rap", 128, 4, True, 64, 128),
    ("enc128_d8_rap", 128, 8, True, 64, 128),
    ("enc128_d16_rap", 128, 16, True, 64, 128),
    ("dec64_d1", 64, 1, False, 128, 256),
    ("dec16_d1", 16, 1, False, 256, 512),
)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nb1d_pair.argtypes = [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.nb1d_pair.restype = i
    return lib


def has_window(root: Path) -> bool:
    """Whether the checkout's K2 entries take a stats window (row0, row1)."""
    src = (root / "mdilss_tpu_torch" / "csrc" / "nb1d_train.cu").read_text()
    return "int d, int row0, int row1, void* stream" in src


def load_train(path: Path, window: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window = window
    for sfx in ("", "_bf16"):
        fwd = getattr(lib, "nb1d_train_fwd" + sfx)
        fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i] + [i, i] * window + [p]
        fwd.restype = i
        getattr(lib, f"nb1d_train_fwd{sfx}_scratch").argtypes = [i, i, i, i]
        getattr(lib, f"nb1d_train_fwd{sfx}_scratch").restype = ctypes.c_longlong
    lib.nb1d_train_bwd_bf16.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.nb1d_train_bwd_bf16.restype = i
    lib.nb1d_train_bwd_bf16_scratch.argtypes = [i, i, i, i, i]
    lib.nb1d_train_bwd_bf16_scratch.restype = ctypes.c_longlong
    lib.nb1d_train_grad_len.argtypes = [i, i]
    lib.nb1d_train_grad_len.restype = ctypes.c_longlong
    return lib


def train_cases(libs, gen, dev) -> bool:
    """K2's y and stats (fp32 and bf16) and K3 bf16's du and weight gradients
    of both libraries, each block shape at batch 6, with and without the
    pre-stage; True if every output is bit for bit equal."""
    import torch

    same = True
    for name, c, d, rap, h, w in BLOCKS:
        n = 6
        for pre in (False, True):
            same &= fwd_f32_case(libs, gen, dev, name, c, d, rap, h, w, n, pre)

            def mk(*shape, scale=1.0, dtype=torch.bfloat16):
                return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype).contiguous()

            x, gy = mk(n, h, w, c), mk(n, h, w, c)  # NHWC
            w31, w13 = mk(3 * c, c, scale=c ** -0.5), mk(3 * c, c, scale=c ** -0.5)
            w31t, w13t = mk(3 * c, c, scale=c ** -0.5), mk(3 * c, c, scale=c ** -0.5)
            rapm = mk(c, c, scale=c ** -0.5) if rap else None
            b31 = mk(c, dtype=torch.float32)
            pa = (1.0 + 0.2 * mk(c, dtype=torch.float32)).abs() if pre else None
            pb = 0.2 * mk(c, dtype=torch.float32) if pre else None
            outs, bwd = [], []
            stream = torch.cuda.current_stream().cuda_stream
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            for lib in libs:
                y = torch.empty_like(x)
                stats = torch.empty(2, c, device=dev)
                scratch = torch.empty(lib.nb1d_train_fwd_bf16_scratch(c, n, h, w), device=dev)
                rc = lib.nb1d_train_fwd_bf16(c, x.data_ptr(), w31.data_ptr(), b31.data_ptr(),
                                             w13.data_ptr(), ptr(rapm), ptr(pa), ptr(pb),
                                             y.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
                                             n, h, w, d, *(0, h) * lib.window, stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"nb1d_train_fwd_bf16 returned {rc} for {name}")
                outs.append((y, stats))
                du = torch.empty_like(x)
                grads = torch.empty(lib.nb1d_train_grad_len(c, int(rap)), device=dev)
                scratch = torch.empty(lib.nb1d_train_bwd_bf16_scratch(c, n, h, w, int(rap)),
                                      device=dev)
                rc = lib.nb1d_train_bwd_bf16(c, x.data_ptr(), gy.data_ptr(), w31.data_ptr(),
                                             b31.data_ptr(), w13t.data_ptr(), w31t.data_ptr(),
                                             ptr(rapm), ptr(pa), ptr(pb), du.data_ptr(),
                                             grads.data_ptr(), scratch.data_ptr(), n, h, w, d,
                                             stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"nb1d_train_bwd_bf16 returned {rc} for {name}")
                bwd.append((du, grads))
            k3_equal = all(torch.equal(a, b) for a, b in zip(*bwd))
            same &= k3_equal
            print(f"K3 bf16 {name} [{n},{h},{w},{c}] {'with' if pre else 'without'} pre-stage, "
                  f"du and weight gradients: " + ("bitwise equal" if k3_equal else "differ"))
            same &= report_k2("bf16", name, n, h, w, c, pre, outs)
    return same


def report_k2(dt: str, name, n, h, w, c, pre, outs) -> bool:
    """Print whether the two libraries' K2 y and stats are bitwise equal (else
    how far apart); True if both are."""
    import torch

    (ya, sa), (yb, sb) = outs
    y_eq, s_eq = torch.equal(ya, yb), torch.equal(sa, sb)
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(sa, sb)]
    print(f"K2 {dt} {name} [{n},{h},{w},{c}] {'with' if pre else 'without'} pre-stage: y "
          + ("bitwise equal" if y_eq else f"{int((ya != yb).sum())} elements differ")
          + "; stats " + ("bitwise equal" if s_eq else
                          f"largest relative difference: sum {rel[0]:.2e}, sum of squares "
                          f"{rel[1]:.2e}"))
    return y_eq and s_eq


def fwd_f32_case(libs, gen, dev, name, c, d, rap, h, w, n, pre) -> bool:
    """K2 fp32's y and stats of both libraries on the same inputs."""
    import torch

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev).contiguous()

    x = mk(n, h, w, c)
    w31, w13 = mk(3 * c, c, scale=c ** -0.5), mk(3 * c, c, scale=c ** -0.5)
    rapm = mk(c, c, scale=c ** -0.5) if rap else None
    b31 = mk(c)
    pa = (1.0 + 0.2 * mk(c)).abs() if pre else None
    pb = 0.2 * mk(c) if pre else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    outs = []
    for lib in libs:
        y = torch.empty_like(x)
        stats = torch.empty(2, c, device=dev)
        scratch = torch.empty(lib.nb1d_train_fwd_scratch(c, n, h, w), device=dev)
        rc = lib.nb1d_train_fwd(c, x.data_ptr(), w31.data_ptr(), b31.data_ptr(), w13.data_ptr(),
                                ptr(rapm), ptr(pa), ptr(pb), y.data_ptr(), stats.data_ptr(),
                                scratch.data_ptr(), n, h, w, d, *(0, h) * lib.window,
                                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"nb1d_train_fwd returned {rc} for {name}")
        outs.append((y, stats))
    return report_k2("fp32", name, n, h, w, c, pre, outs)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a", type=Path)
    ap.add_argument("root_b", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    libs = [load(build(r.resolve(), "nb1d_infer")) for r in (args.root_a, args.root_b)]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    same = True
    for name, c, d, rap, h, w in BLOCKS:
        for n in (1, 6):
            for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
                def mk(*shape, scale=1.0, dtype=dt):
                    return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype).contiguous()

                u = mk(n, h, w, c)  # NHWC
                w31, w13 = mk(3 * c, c, scale=c ** -0.5), mk(3 * c, c, scale=c ** -0.5)
                rapm = mk(c, c, scale=c ** -0.5) if rap else None
                b31, a, b = (mk(c, dtype=torch.float32) for _ in range(3))
                for res in (None, mk(n, h, w, c)):
                    outs = []
                    for lib in libs:
                        out = torch.empty_like(u)
                        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
                        rc = lib.nb1d_pair(code, c, u.data_ptr(), w31.data_ptr(), b31.data_ptr(),
                                           w13.data_ptr(), ptr(rapm), a.data_ptr(), b.data_ptr(),
                                           ptr(res), out.data_ptr(), n, h, w, d,
                                           torch.cuda.current_stream().cuda_stream)
                        torch.cuda.synchronize()
                        if rc != 0:
                            raise RuntimeError(f"nb1d_pair returned {rc} for {name}")
                        outs.append(out)
                    equal = torch.equal(outs[0], outs[1])
                    same &= equal
                    print(f"{name} [{n},{h},{w},{c}] {str(dt)[6:]} "
                          f"{'with' if res is not None else 'without'} residual: "
                          + ("bitwise equal" if equal else
                             f"{int((outs[0] != outs[1]).sum())} elements differ"))
    roots = (args.root_a, args.root_b)
    same &= train_cases([load_train(build(r.resolve(), "nb1d_train"), has_window(r.resolve()))
                         for r in roots], gen, dev)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
