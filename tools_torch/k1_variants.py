#!/usr/bin/env python3
"""K1's kernels (csrc/nb1d_infer.cu: fp32 nb1d_pair_tf32_kernel, bf16
nb1d_pair_mma_kernel) against variants of their own sources, on one NVIDIA
card: device time per forward and accuracy against the plain version.

    python3 tools_torch/k1_variants.py [--out build/k1_variants.json] [--only NAME ...]
                                       [--dtypes f32 bf16]

Variants, each a text substitution of the committed sources (csrc/nb1d_infer.cu,
csrc/tf32_pair.cuh, csrc/bf16_pair.cuh, csrc/sm90_async.cuh, ops/nb1d_infer.py) built into
build/k1_variants/<name>/ and run in its own process:
  as_built     the sources as they are (run first and last);
  fp32:
  cuda_cores   the CUDA-core kernel the fp32 path had before it moved to the
               tensor cores (fp32 FMAs, each thread a 4-pixel x 4 or
               8-channel tile; kept here only, as the baseline);
  one_cta      one CTA per SM (up to 255 registers a thread) instead of two
               (at most 128);
  presplit_w   the weights as TF32 hi / lo planes side by side ([rows][2C]),
               made once per weight tensor by the wrapper (eval weights are
               constant, so prepare_operands could keep them), so the warps
               split only the A fragments; the B chunks take twice the shared
               memory;
  bf16:
  stages4      a cp.async ring 4 deep instead of 3;
  kc64         K chunks of 64 input channels instead of 32 (C = 64, 128);
  narrow       4 warps per CTA instead of 8: tiles of 32 / 64 / 128 output
               columns at C = 128 / 64 / 16 instead of 64 / 128 / 256, so
               256 CTAs instead of 128 on the 64x128 map at batch 1.
Every variant is measured in both types, or in those --dtypes names. Times:
torch.profiler device ms of the kernel for the 7 block shapes of one
512x1024 forward (chip_smoke's blocks), at batch 1 and 6, summed over the
17 blocks; CUDA events over back-to-back calls beside them. Accuracy: worst
relative L2 against the plain version of the same type (TF32 off) over the
same calls. `--measure ROOT NAME` measures the package under ROOT alone.
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
# the files a variant may change, relative to the package
SOURCE, PAIR, RING = "csrc/nb1d_infer.cu", "csrc/tf32_pair.cuh", "csrc/sm90_async.cuh"
BF16 = "csrc/bf16_pair.cuh"  # the bf16 kernel's tiles and mainloop
WRAPPER = "ops/nb1d_infer.py"
FILES = (SOURCE, PAIR, RING, WRAPPER, BF16)
DTYPES = ("f32", "bf16")
# both types' kernels and the CUDA-core one by name in a profiler trace (one type per call)
KERNEL = "nb1d_pair_"

# The CUDA-core fp32 kernel and its helpers, as K1 had them before the tensor cores: one CTA per
# (image, row, TW columns), each thread 4 pixels x MC channels of fp32 FMAs from shared memory,
# two barriers per K chunk of 32 input channels, no asynchronous copies.
CUDA_CORES = r"""
constexpr int kMP = 4;  // pixels per thread

template <int C>
struct Cfg {
  static constexpr int MC = C >= 64 ? 8 : 4;   // channels per thread
  static constexpr int CG = C / MC;            // channel groups
  static constexpr int PG = kThreads / CG;     // pixel groups
  static constexpr int TW = PG * kMP;          // output columns per CTA = pixels per chunk
  static constexpr int KC = C < 32 ? C : 32;   // input channels per K chunk
  static constexpr int LDA = TW + 4;           // row stride of the A chunk (floats)
  static_assert(C % MC == 0 && kThreads % CG == 0 && KC % 4 == 0, "tile shape");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Channel of a thread's register slot: slot 4*j+q of channel group cg maps to
// j*(4*CG) + 4*cg + q, so the float4 reads of one warp from a weight row of
// shared memory fall on distinct banks.
template <int C>
__device__ __forceinline__ int slot_channel(int j, int cg) {
  return j * 4 * Cfg<C>::CG + 4 * cg;
}

// A chunk [KC][LDA] <- u[n, row, col0 + m, ci0 : ci0 + KC] for m < npix
// (transposed so each thread reads its 4 pixels as one float4); 0 outside.
template <int C, typename T>
__device__ __forceinline__ void load_a_global(float* A_s, const T* __restrict__ u, int n, int row,
                                              int col0, int ci0, int npix, int H, int W) {
  using K = Cfg<C>;
  constexpr int V = K::KC / 4;
  for (int idx = threadIdx.x; idx < K::TW * V; idx += kThreads) {
    const int m = idx / V, kv = (idx % V) * 4, col = col0 + m;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < npix && row >= 0 && row < H && col >= 0 && col < W)
      v = load4(u + ((static_cast<size_t>(n) * H + row) * W + col) * C + ci0 + kv);
    A_s[(kv + 0) * K::LDA + m] = v.x;
    A_s[(kv + 1) * K::LDA + m] = v.y;
    A_s[(kv + 2) * K::LDA + m] = v.z;
    A_s[(kv + 3) * K::LDA + m] = v.w;
  }
}

// A chunk <- c_s[(m + shift), ci0 : ci0 + KC] (the 1x3 conv's shifted tap).
template <int C>
__device__ __forceinline__ void load_a_shared(float* A_s, const float* c_s, int shift, int ci0) {
  using K = Cfg<C>;
  constexpr int V = K::KC / 4;
  for (int idx = threadIdx.x; idx < K::TW * V; idx += kThreads) {
    const int m = idx / V, kv = (idx % V) * 4;
    const float4 v = *reinterpret_cast<const float4*>(c_s + (m + shift) * C + ci0 + kv);
    A_s[(kv + 0) * K::LDA + m] = v.x;
    A_s[(kv + 1) * K::LDA + m] = v.y;
    A_s[(kv + 2) * K::LDA + m] = v.z;
    A_s[(kv + 3) * K::LDA + m] = v.w;
  }
}

// B chunk [KC][C] <- rows row0 .. row0+KC of a [rows][C] weight matrix.
template <int C, typename T>
__device__ __forceinline__ void load_b(float* B_s, const T* __restrict__ w, int row0) {
  constexpr int E = Cfg<C>::KC * C;
  const T* src = w + static_cast<size_t>(row0) * C;
  for (int e = threadIdx.x * 4; e < E; e += kThreads * 4) store4(B_s + e, load4(src + e));
}

// acc[i][s] += sum_kk A[kk][p0 + i] * B[kk][channel(s)]
template <int C>
__device__ __forceinline__ void fma_chunk(const float* A_s, const float* B_s, int p0, int cg,
                                          float (&acc)[kMP][Cfg<C>::MC]) {
  using K = Cfg<C>;
#pragma unroll 8
  for (int kk = 0; kk < K::KC; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(A_s + kk * K::LDA + p0);
    const float a[kMP] = {av.x, av.y, av.z, av.w};
    float bw[K::MC];
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(B_s + kk * C + slot_channel<C>(j, cg));
      bw[4 * j + 0] = bv.x;
      bw[4 * j + 1] = bv.y;
      bw[4 * j + 2] = bv.z;
      bw[4 * j + 3] = bv.w;
    }
#pragma unroll
    for (int i = 0; i < kMP; ++i)
#pragma unroll
      for (int s = 0; s < K::MC; ++s) acc[i][s] = fmaf(a[i], bw[s], acc[i][s]);
  }
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[kMP][Cfg<C>::MC]) {
#pragma unroll
  for (int i = 0; i < kMP; ++i)
#pragma unroll
    for (int s = 0; s < Cfg<C>::MC; ++s) acc[i][s] = 0.f;
}

// One conv pair. rap (C x C, [ci][co]) and res may be null.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
nb1d_pair_kernel(const T* __restrict__ u, const T* __restrict__ w31, const float* __restrict__ b31,
                 const T* __restrict__ w13, const T* __restrict__ rap,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const T* __restrict__ res, T* __restrict__ out, int H, int W, int d) {
  using K = Cfg<C>;
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [KC][LDA]
  float* B_s = A_s + K::KC * K::LDA;              // [KC][C]
  float* c_s = B_s + K::KC * C;                   // [TW + 2d][C]

  const int w0 = blockIdx.x * K::TW, r = blockIdx.y, n = blockIdx.z;
  const int cg = threadIdx.x % K::CG, p0 = (threadIdx.x / K::CG) * kMP;
  const int cpix = K::TW + 2 * d;  // c columns w0-d .. w0+TW+d-1

  float acc[kMP][K::MC];

  // ---- stage A: c = relu(rowconv_d(u) + b31), 0 outside the image ----
  float bias31[K::MC];
#pragma unroll
  for (int j = 0; j < K::MC / 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) bias31[4 * j + q] = b31[slot_channel<C>(j, cg) + q];

  for (int m0 = 0; m0 < cpix; m0 += K::TW) {
    const int npix = min(K::TW, cpix - m0);  // the last chunk holds only halo columns
    zero<C>(acc);
    for (int k = 0; k < 3; ++k) {
      const int row = r + (k - 1) * d;
      if (row < 0 || row >= H) continue;  // zero-padded tap, uniform over the CTA
      for (int ci0 = 0; ci0 < C; ci0 += K::KC) {
        __syncthreads();
        load_a_global<C>(A_s, u, n, row, w0 - d + m0, ci0, npix, H, W);
        load_b<C>(B_s, w31, k * C + ci0);
        __syncthreads();
        if (p0 < npix) fma_chunk<C>(A_s, B_s, p0, cg, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < kMP; ++i) {
      const int m = m0 + p0 + i;
      if (m >= cpix) continue;
      const int col = w0 - d + m;
      const bool inside = col >= 0 && col < W;
#pragma unroll
      for (int j = 0; j < K::MC / 4; ++j) {
        float4 v;
        v.x = inside ? fmaxf(acc[i][4 * j + 0] + bias31[4 * j + 0], 0.f) : 0.f;
        v.y = inside ? fmaxf(acc[i][4 * j + 1] + bias31[4 * j + 1], 0.f) : 0.f;
        v.z = inside ? fmaxf(acc[i][4 * j + 2] + bias31[4 * j + 2], 0.f) : 0.f;
        v.w = inside ? fmaxf(acc[i][4 * j + 3] + bias31[4 * j + 3], 0.f) : 0.f;
        store4(c_s + m * C + slot_channel<C>(j, cg), v);
      }
    }
  }

  // ---- stage B: y = colconv_d(c) [+ u @ rap] ----
  zero<C>(acc);
  for (int k = 0; k < 3; ++k) {
    for (int ci0 = 0; ci0 < C; ci0 += K::KC) {
      __syncthreads();  // also orders the c_s writes above before these reads
      load_a_shared<C>(A_s, c_s, k * d, ci0);
      load_b<C>(B_s, w13, k * C + ci0);
      __syncthreads();
      fma_chunk<C>(A_s, B_s, p0, cg, acc);
    }
  }
  if (rap != nullptr) {
    const int npix = min(K::TW, W - w0);
    for (int ci0 = 0; ci0 < C; ci0 += K::KC) {
      __syncthreads();
      load_a_global<C>(A_s, u, n, r, w0, ci0, npix, H, W);
      load_b<C>(B_s, rap, ci0);
      __syncthreads();
      fma_chunk<C>(A_s, B_s, p0, cg, acc);
    }
  }

  // ---- epilogue: relu(a*y + b [+ res]) ----
  float sa[K::MC], sb[K::MC];
#pragma unroll
  for (int j = 0; j < K::MC / 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sa[4 * j + q] = a[slot_channel<C>(j, cg) + q];
      sb[4 * j + q] = b[slot_channel<C>(j, cg) + q];
    }
#pragma unroll
  for (int i = 0; i < kMP; ++i) {
    const int col = w0 + p0 + i;
    if (col >= W) continue;
    const size_t base = ((static_cast<size_t>(n) * H + r) * W + col) * C;
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j) {
      const int ch = slot_channel<C>(j, cg);
      float4 v;
      v.x = fmaf(sa[4 * j + 0], acc[i][4 * j + 0], sb[4 * j + 0]);
      v.y = fmaf(sa[4 * j + 1], acc[i][4 * j + 1], sb[4 * j + 1]);
      v.z = fmaf(sa[4 * j + 2], acc[i][4 * j + 2], sb[4 * j + 2]);
      v.w = fmaf(sa[4 * j + 3], acc[i][4 * j + 3], sb[4 * j + 3]);
      if (res != nullptr) {
        const float4 rv = load4(res + base + ch);
        v.x += rv.x;
        v.y += rv.y;
        v.z += rv.z;
        v.w += rv.w;
      }
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
      store4(out + base + ch, v);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* u, const void* w31, const void* b31, const void* w13,
                   const void* rap, const void* a, const void* b, const void* res, void* out,
                   int n, int h, int w, int d, cudaStream_t stream) {
  using K = Cfg<C>;
  const size_t smem = sizeof(float) * (static_cast<size_t>(K::KC) * K::LDA +
                                       static_cast<size_t>(K::KC) * C +
                                       static_cast<size_t>(K::TW + 2 * d) * C);
  auto kernel = nb1d_pair_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((w + K::TW - 1) / K::TW, h, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(w31), static_cast<const float*>(b31),
      static_cast<const T*>(w13), static_cast<const T*>(rap), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const T*>(res), static_cast<T*>(out), h, w, d);
  return cudaGetLastError();
}
"""

# presplit_w: the wrapper hands the kernel [rows][2C] weights, hi then lo
PRESPLIT_PY = '''

_SPLIT: dict = {}


def _presplit(t):
    """t [rows, C] float32 -> [rows, 2C]: its TF32 hi = rna(t) and lo = rna(t - hi)
    side by side, made once per tensor (the entry keeps t alive, so its address
    is not reused while the entry stands)."""
    if t is None:
        return None
    key = (t.data_ptr(), t._version, tuple(t.shape))
    if key not in _SPLIT:
        hi = ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        lo = (((t - hi).view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        _SPLIT[key] = (t, torch.cat([hi, lo], dim=1).contiguous())
    return _SPLIT[key][1]


def _launch_pair('''


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} x {old!r} in the K1 sources")
    return text.replace(old, new)


def variants(files: dict[str, str]) -> dict[str, dict[str, str]]:
    """name -> {file (relative to the package): its text} for each file the
    variant changes; `files` holds the committed text of FILES."""
    src, pair, ring, wrapper, bf16 = (files[f] for f in FILES)

    cores = _sub(src, "// ---- float32: 3xTF32 on the tensor cores",
                 CUDA_CORES + "\n// ---- float32: 3xTF32 on the tensor cores")
    cores = _sub(cores, "if (dtype == 0) return launch_tf32<C>(",
                 "if (dtype == 0) return launch<float, C>(")

    split = _sub(pair, "  static constexpr int LDB = C + 8;                 // 32 banks; B chunk "
                       "[KC][LDB] likewise",
                 "  static constexpr int LDB = 2 * C + 8;  // B chunk [KC][LDB]: hi | lo")
    split = _sub(split, "    const float* w = tap(s / NCH).w + static_cast<size_t>((s % NCH) * "
                        "L::KC) * C;\n"
                        "    for (int e = threadIdx.x; e < L::KC * (C / 4); e += kThreads) {\n"
                        "      const int row = e / (C / 4), c4 = (e % (C / 4)) * 4;\n"
                        "      cp_async16(B + row * L::LDB + c4, w + row * C + c4);",
                 "    const float* w = tap(s / NCH).w + static_cast<size_t>((s % NCH) * "
                 "L::KC) * 2 * C;\n"
                 "    for (int e = threadIdx.x; e < L::KC * (C / 2); e += kThreads) {\n"
                 "      const int row = e / (C / 2), c4 = (e % (C / 2)) * 4;\n"
                 "      cp_async16(B + row * L::LDB + c4, w + row * 2 * C + c4);")
    split = _sub(split, "    uint32_t bh0, bl0, bh1, bl1;\n"
                        "    split_tf32(q[0], bh0, bl0);\n"
                        "    split_tf32(q[4 * LDB], bh1, bl1);\n",
                 "    constexpr int CB = (LDB - 8) / 2;  // the lo plane\n"
                 "    const uint32_t bh0 = __float_as_uint(q[0]), bl0 = __float_as_uint(q[CB]);\n"
                 "    const uint32_t bh1 = __float_as_uint(q[4 * LDB]);\n"
                 "    const uint32_t bl1 = __float_as_uint(q[4 * LDB + CB]);\n")
    split = _sub(split, "w31 + static_cast<size_t>(k0 + j) * C * C",
                 "w31 + static_cast<size_t>(k0 + j) * 2 * C * C")
    split = _sub(split, "w13 + static_cast<size_t>(k) * C * C",
                 "w13 + static_cast<size_t>(k) * 2 * C * C")
    split_py = _sub(wrapper, "\n\ndef _launch_pair(", PRESPLIT_PY)
    split_py = _sub(split_py, "    lib = _library()\n    n, c, h, w = u.shape\n",
                    "    lib = _library()\n    n, c, h, w = u.shape\n"
                    "    if u.dtype == torch.float32:\n"
                    "        w31, w13, rap = (_presplit(t) for t in (w31, w13, rap))\n")

    kc = "static constexpr int KC = C < 32 ? C : 32;        // input channels per staged chunk"
    narrow = _sub(bf16, "static constexpr int THREADS = 256;", "static constexpr int THREADS = 128;")
    narrow = _sub(narrow, "static constexpr int MTA = 3;", "static constexpr int MTA = C == 128 ? 4 : 3;")
    return {
        "as_built": {},
        "cuda_cores": {SOURCE: cores},
        "one_cta": {SOURCE: _sub(src, "__launch_bounds__(kThreads, K2_CTAS)\nnb1d_pair_tf32_kernel",
                                 "__launch_bounds__(kThreads, 1)\nnb1d_pair_tf32_kernel")},
        "presplit_w": {PAIR: split, WRAPPER: split_py},
        "stages4": {RING: _sub(ring, "constexpr int kStages = 3;", "constexpr int kStages = 4;")},
        "kc64": {BF16: _sub(bf16, kc, kc.replace("C < 32 ? C : 32", "C < 64 ? C : 64"))},
        "narrow": {BF16: narrow},
    }


def measure(root: Path, name: str, dtypes=DTYPES) -> dict:
    sys.path[:0] = [str(root), str(ROOT)]
    import torch

    import chip_smoke as cs
    from mdilss_tpu_torch.ops import nb1d_infer as K

    if not Path(K.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {K.__file__}, not the variant under {root}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    totals, blocks, worst = {}, [], dict.fromkeys(dtypes, 0.0)
    for i, spec in enumerate(cs.BLOCKS):
        block, c, d, rap, h, w, count = spec
        blk = cs.make_block(spec, 10 * i, dev)
        for dt in dtypes:
            ops = K.prepare_operands(blk, 2 if rap else None, types[dt])
            for n in cs.BATCHES:
                gen = torch.Generator().manual_seed(10 * i + n)
                x = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, types[dt]))

                def fn(x=x, ops=ops, d=d):
                    return K.nb1d_infer(x, ops, d)

                worst[dt] = max(worst[dt], cs.rel_l2(fn(), K.nb1d_infer_plain(x, ops, d)))
                dev_ms = cs.device_ms_by_kind(fn, {"k1": KERNEL})["k1"]
                event_ms = cs.time_ms(fn)
                blocks.append({"block": block, "dtype": dt, "batch": n, "device_ms": dev_ms,
                               "event_ms": event_ms})
                t = totals.setdefault(f"{dt} batch{n}", {"device_ms": 0.0, "event_ms": 0.0})
                t["device_ms"] = cs.add_ms(t["device_ms"],
                                           None if dev_ms is None else count * dev_ms)
                t["event_ms"] += count * event_ms
    return {"variant": name, "card": cs.card_line(), "k1_per_forward": totals,
            "blocks": blocks, "worst_rel_l2_vs_plain": worst}


def committed() -> dict[str, str]:
    return {f: (PACKAGE / f).read_text() for f in FILES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k1_variants.json")
    ap.add_argument("--only", nargs="*", help="variants to run beside as_built")
    ap.add_argument("--dtypes", nargs="+", choices=DTYPES, default=list(DTYPES))
    ap.add_argument("--measure", nargs=2, metavar=("ROOT", "NAME"),
                    help="measure the package under ROOT alone and print one JSON line")
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(Path(args.measure[0]), args.measure[1], args.dtypes)))
        return 0
    table = variants(committed())
    names = [n for n in table if n != "as_built" and (not args.only or n in args.only)]
    for name in ["as_built", *names]:
        root = WORK / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE, root / PACKAGE.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        for fname, text in table[name].items():
            (root / PACKAGE.name / fname).write_text(text)
    results = []
    for name in ["as_built", *names, "as_built"]:
        proc = subprocess.run([sys.executable, __file__, "--measure", str(WORK / name), name,
                               "--dtypes", *args.dtypes],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(rec)
        print(f"{name:10s} K1 per 17-block forward: "
              + ", ".join(f"{b} device {v['device_ms']:.4f} ms (events {v['event_ms']:.4f})"
                          if v["device_ms"] is not None else f"{b} device not measured"
                          for b, v in rec["k1_per_forward"].items())
              + "; worst rel L2 vs plain " + ", ".join(
                  f"{dt} {e:.2e}" for dt, e in rec["worst_rel_l2_vs_plain"].items()))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
