#!/usr/bin/env python3
"""K2 (the training conv pair's forward, csrc/nb1d_train.cu) against variants of
its own source, on one NVIDIA card: device time per student forward and
accuracy.

    python3 tools_torch/k2_variants.py [--dtype f32|bf16] [--only NAME ...]
                                       [--against ROOT] [--out build/k2_variants_<dtype>.json]

Variants, each a text substitution of the committed sources (csrc/nb1d_train.cu
and csrc/tf32_pair.cuh, which holds the pair mainloop K2 shares with K1's fp32
kernel) built into build/k2_variants/<name>/ and run in its own process.
float32 (`--dtype f32`):
  as_built    the source as it is (run first and last);
  cuda_cores  the CUDA-core kernel K2 had before it moved to the tensor cores
              (fp32 FMAs, each thread a 4-pixel x 8-channel tile; kept here
              only, as the baseline);
  c_split     c kept in shared memory as pre-split TF32 hi / lo planes:
              stage A's epilogue splits each c element once, and stage B,
              which reads each element 3 x WN times, loads its A fragments
              without splitting them;
  ring3, ring4  K2's cp.async ring 3 or 4 deep instead of 2 (one CTA per
              SM: the shared memory of two no longer fits);
  tm_smaller  half the output columns per CTA (32 / 64 / 128 at C = 128 /
              64 / 16: one m16 tile per warp in stage B, two per pass in
              stage A);
  one_cta     one CTA per SM (up to 255 registers a thread) instead of two
              (at most 128).
bfloat16 (`--dtype bf16`, the knobs of K2 bf16's walkers, FwdRing):
  as_built             as above;
  bf16_ring2, bf16_ring3   a ring at most 2 or 3 stages deep instead of 6 (as
                       deep as shared memory holds: 2 / 3 / 6 at C = 128 / 64 /
                       16);
  bf16_w_streamed      at C = 64 w31 and rap streamed a chunk per stage beside
                       the u chunk, as at C = 128, instead of resident;
  bf16_kc32            chunks of 32 input channels (the pair mainloop's) instead
                       of 64: twice the stages per tile, half as large, so the
                       ring holds 4 / 6 at C = 128 / 64. ConvTiles' KC, which
                       K3 bf16's conv launches share;
  bf16_walkers_132     132 walkers at most (the H100's SMs) instead of 128;
  bf16_walkers_half    64 walkers at most: half the SMs, fewer partials;
  bf16_cta_per_tile    a CTA per tile (walkers unbounded): per-tile partials,
                       the weights loaded by every CTA;
  bf16_rap_stages      RAP at C <= 64 in stages of its own, u's row staged again
                       (as at C = 128), instead of from the copy of the centre
                       row tap's chunk;
  bf16_params_global   b31, pa and pb read from global memory where a stage
                       ends instead of from shared memory;
  bf16_cta256_mt4      walkers of 256 threads, each warp 4 m16 tiles (64
                       pixels x 8NT channels: a quarter fewer ldmatrix bytes
                       per product) instead of 512 threads with 2 tiles a warp;
  diag_no_products, diag_no_y_stores, diag_no_u_loads, diag_no_pre
                       diagnostics, each K2 bf16 without one part (its
                       products, y's global stores, the u chunks' copies (zero
                       filled instead), the pre-stage): wrong outputs, read
                       for the time that part takes.
`--against ROOT` also measures another checkout (a parent's `git archive`)
as "parent", first and last, so both trees are timed in one call.
Times: CUDA events over fwd_pair for the two pairs of each of the 7 block
shapes at 6x512x1024 (chip_smoke's inputs and timing), summed over the blocks
of one student forward; device ms of the pair kernel and of the partials' sum
from torch.profiler, also per block. Accuracy, at the 7 shapes and the ragged
one, RAP and pre-stage on: float32: y against the plain pair in float64
(relative L2), the batch mean and variance from the stats against a float64
two-pass over y; bfloat16: y and the stats against the plain bf16 version,
the stats against a float64 two-pass over the returned y.
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
WORK = ROOT / "build" / "k2_variants"
ORDER = {"f32": ("as_built", "cuda_cores", "c_split", "ring3", "ring4", "tm_smaller", "one_cta",
                 "as_built"),
         "bf16": ("as_built", "bf16_ring2", "bf16_ring3", "bf16_w_streamed", "bf16_kc32", "bf16_walkers_132",
                  "bf16_walkers_half", "bf16_cta_per_tile", "bf16_rap_stages",
                  "bf16_params_global", "bf16_cta256_mt4", "diag_no_products",
                  "diag_no_y_stores", "diag_no_u_loads", "diag_no_pre", "as_built")}
# the files a variant may change, relative to the package
SOURCE, PAIR = "csrc/nb1d_train.cu", "csrc/tf32_pair.cuh"
FILES = (SOURCE, PAIR)
# device time by kernel name: the pair kernel (any design, either type) and the fixed-order sum
KINDS = {"pair": "fwd_pair", "sum": "namespace)::reduce_kernel("}

# The CUDA-core K2 kernel and its helpers, as K2 had them before the tensor cores: one CTA per
# (image, row, TW columns), each thread 4 pixels x MC channels of fp32 FMAs from shared memory,
# two barriers per K chunk of 32 input channels, no asynchronous copies.
CUDA_CORES = r"""
constexpr int kMP = 4;  // pixels per thread in the conv kernels

template <int C>
struct Cfg {
  static constexpr int MC = C >= 64 ? 8 : 4;   // channels per thread
  static constexpr int CG = C / MC;            // channel groups
  static constexpr int PG = kThreads / CG;     // pixel groups
  static constexpr int TW = PG * kMP;          // output columns per CTA
  static constexpr int KC = C < 32 ? C : 32;   // input channels per K chunk
  static constexpr int LDA = TW + 4;           // row stride of the A chunk (floats)
  static constexpr int AB = KC * LDA + KC * C; // floats of the A and B chunks
  static_assert(C % MC == 0 && kThreads % CG == 0 && KC % 4 == 0, "tile shape");
  static_assert(2 * PG * C <= AB, "the stats reduction reuses the A/B chunks");
};


// Channel of register slot 4*j+q of thread group g when `groups` groups split C channels:
// j*4*groups + 4*g + q, so the float4 reads of one warp from a row of shared memory fall on
// distinct banks.
__device__ __forceinline__ int slot_channel(int j, int g, int groups) {
  return j * 4 * groups + 4 * g;
}

// A chunk [KC][LDA] <- src[n, row, col0 + m, ci0 : ci0 + KC] for m < npix, transposed so that
// each thread reads its 4 pixels as one float4; 0 outside the image. With pa, the pre-stage is
// applied to pixels inside the image.
template <int C>
__device__ __forceinline__ void load_a_global(float* A_s, const float* __restrict__ src, int n,
                                              int row, int col0, int ci0, int npix, int H, int W,
                                              const float* __restrict__ pa,
                                              const float* __restrict__ pb) {
  using K = Cfg<C>;
  constexpr int V = K::KC / 4;
  for (int idx = threadIdx.x; idx < K::TW * V; idx += kThreads) {
    const int m = idx / V, kv = (idx % V) * 4, col = col0 + m;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < npix && row >= 0 && row < H && col >= 0 && col < W) {
      v = ld4(src + ((static_cast<size_t>(n) * H + row) * W + col) * C + ci0 + kv);
      if (pa != nullptr) v = pre4(v, pa, pb, ci0 + kv);
    }
    A_s[(kv + 0) * K::LDA + m] = v.x;
    A_s[(kv + 1) * K::LDA + m] = v.y;
    A_s[(kv + 2) * K::LDA + m] = v.z;
    A_s[(kv + 3) * K::LDA + m] = v.w;
  }
}

// A chunk <- c_s[m + shift, ci0 : ci0 + KC] (the 1x3 conv's shifted tap).
template <int C>
__device__ __forceinline__ void load_a_shared(float* A_s, const float* c_s, int shift, int ci0) {
  using K = Cfg<C>;
  constexpr int V = K::KC / 4;
  for (int idx = threadIdx.x; idx < K::TW * V; idx += kThreads) {
    const int m = idx / V, kv = (idx % V) * 4;
    const float4 v = ld4(c_s + (m + shift) * C + ci0 + kv);
    A_s[(kv + 0) * K::LDA + m] = v.x;
    A_s[(kv + 1) * K::LDA + m] = v.y;
    A_s[(kv + 2) * K::LDA + m] = v.z;
    A_s[(kv + 3) * K::LDA + m] = v.w;
  }
}

// B chunk [KC][C] <- rows row0 .. row0+KC of a [rows][C] weight matrix.
template <int C>
__device__ __forceinline__ void load_b(float* B_s, const float* __restrict__ w, int row0) {
  constexpr int E = Cfg<C>::KC * C;
  const float* src = w + static_cast<size_t>(row0) * C;
  for (int e = threadIdx.x * 4; e < E; e += kThreads * 4) st4(B_s + e, ld4(src + e));
}

// acc[i][s] += sum_kk A[kk][p0 + i] * B[kk][channel(s)]
template <int C>
__device__ __forceinline__ void fma_chunk(const float* A_s, const float* B_s, int p0, int cg,
                                          float (&acc)[kMP][Cfg<C>::MC]) {
  using K = Cfg<C>;
#pragma unroll 8
  for (int kk = 0; kk < K::KC; ++kk) {
    const float4 av = ld4(A_s + kk * K::LDA + p0);
    const float a[kMP] = {av.x, av.y, av.z, av.w};
    float bw[K::MC];
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j) {
      const float4 bv = ld4(B_s + kk * C + slot_channel(j, cg, K::CG));
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

// acc += sum_k sum_ci src'[n, r + (k-1)d, col0 + m, ci] * w[k*C + ci][co] for m < npix, where
// src' is src through the optional pre-stage; a tap whose row falls outside the image is
// skipped (zero padding; the condition is uniform over the CTA).
template <int C>
__device__ __forceinline__ void row_conv(float* A_s, float* B_s, const float* __restrict__ src,
                                         const float* __restrict__ w, int n, int r, int col0,
                                         int npix, int H, int W, int d,
                                         const float* __restrict__ pa,
                                         const float* __restrict__ pb, int p0, int cg,
                                         float (&acc)[kMP][Cfg<C>::MC]) {
  for (int k = 0; k < 3; ++k) {
    const int row = r + (k - 1) * d;
    if (row < 0 || row >= H) continue;
    for (int ci0 = 0; ci0 < C; ci0 += Cfg<C>::KC) {
      __syncthreads();
      load_a_global<C>(A_s, src, n, row, col0, ci0, npix, H, W, pa, pb);
      load_b<C>(B_s, w, k * C + ci0);
      __syncthreads();
      if (p0 < npix) fma_chunk<C>(A_s, B_s, p0, cg, acc);
    }
  }
}

// acc += src'[n, r, col0 + m, :] @ w ([C][C]) for m < npix.
template <int C>
__device__ __forceinline__ void pixel_mm(float* A_s, float* B_s, const float* __restrict__ src,
                                         const float* __restrict__ w, int n, int r, int col0,
                                         int npix, int H, int W, const float* __restrict__ pa,
                                         const float* __restrict__ pb, int p0, int cg,
                                         float (&acc)[kMP][Cfg<C>::MC]) {
  for (int ci0 = 0; ci0 < C; ci0 += Cfg<C>::KC) {
    __syncthreads();
    load_a_global<C>(A_s, src, n, r, col0, ci0, npix, H, W, pa, pb);
    load_b<C>(B_s, w, ci0);
    __syncthreads();
    if (p0 < npix) fma_chunk<C>(A_s, B_s, p0, cg, acc);
  }
}

template <int C>
__device__ __forceinline__ void load_slots(const float* __restrict__ v, int cg, float (&out)[Cfg<C>::MC]) {
#pragma unroll
  for (int j = 0; j < Cfg<C>::MC / 4; ++j) {
    const float4 t = ld4(v + slot_channel(j, cg, Cfg<C>::CG));
    out[4 * j + 0] = t.x;
    out[4 * j + 1] = t.y;
    out[4 * j + 2] = t.z;
    out[4 * j + 3] = t.w;
  }
}

// ---- K2: forward pair -------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(kThreads)
fwd_pair_kernel(const float* __restrict__ x, const float* __restrict__ w31,
                const float* __restrict__ b31, const float* __restrict__ w13,
                const float* __restrict__ rap, const float* __restrict__ pa,
                const float* __restrict__ pb, float* __restrict__ y, float* __restrict__ part,
                int H, int W, int d) {
  using K = Cfg<C>;
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [KC][LDA]
  float* B_s = A_s + K::KC * K::LDA;              // [KC][C]
  float* c_s = B_s + K::KC * C;                   // [TW + 2d][C]

  const int w0 = blockIdx.x * K::TW, r = blockIdx.y, n = blockIdx.z;
  const int cg = threadIdx.x % K::CG, pg = threadIdx.x / K::CG, p0 = pg * kMP;
  const int cpix = K::TW + 2 * d;  // c columns w0-d .. w0+TW+d-1

  float acc[kMP][K::MC];
  float bias[K::MC];
  load_slots<C>(b31, cg, bias);

  // c = relu(rowconv_d(u) + b31) for the TW + 2d columns, 0 outside the image
  for (int m0 = 0; m0 < cpix; m0 += K::TW) {
    const int npix = min(K::TW, cpix - m0);  // the last chunk holds only halo columns
    zero<C>(acc);
    row_conv<C>(A_s, B_s, x, w31, n, r, w0 - d + m0, npix, H, W, d, pa, pb, p0, cg, acc);
#pragma unroll
    for (int i = 0; i < kMP; ++i) {
      const int m = m0 + p0 + i;
      if (m >= cpix) continue;
      const int col = w0 - d + m;
      const bool inside = col >= 0 && col < W;
#pragma unroll
      for (int j = 0; j < K::MC / 4; ++j) {
        float4 v;
        v.x = inside ? fmaxf(acc[i][4 * j + 0] + bias[4 * j + 0], 0.f) : 0.f;
        v.y = inside ? fmaxf(acc[i][4 * j + 1] + bias[4 * j + 1], 0.f) : 0.f;
        v.z = inside ? fmaxf(acc[i][4 * j + 2] + bias[4 * j + 2], 0.f) : 0.f;
        v.w = inside ? fmaxf(acc[i][4 * j + 3] + bias[4 * j + 3], 0.f) : 0.f;
        st4(c_s + m * C + slot_channel(j, cg, K::CG), v);
      }
    }
  }

  // y = colconv_d(c) [+ u @ rap]
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
  if (rap != nullptr)
    pixel_mm<C>(A_s, B_s, x, rap, n, r, w0, K::TW, H, W, pa, pb, p0, cg, acc);

  // write y; per-thread sums over its pixels inside the image
  float s[K::MC], ss[K::MC];
#pragma unroll
  for (int t = 0; t < K::MC; ++t) s[t] = ss[t] = 0.f;
#pragma unroll
  for (int i = 0; i < kMP; ++i) {
    const int col = w0 + p0 + i;
    if (col >= W) continue;
    const size_t base = ((static_cast<size_t>(n) * H + r) * W + col) * C;
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j) {
      const float4 v = make_float4(acc[i][4 * j + 0], acc[i][4 * j + 1], acc[i][4 * j + 2],
                                   acc[i][4 * j + 3]);
      st4(y + base + slot_channel(j, cg, K::CG), v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[4 * j + q] += acc[i][4 * j + q];
        ss[4 * j + q] += acc[i][4 * j + q] * acc[i][4 * j + q];
      }
    }
  }

  // the CTA's partial stats: sum over the pixel groups in a fixed order
  __syncthreads();  // every thread is done with the A/B chunks
  float* red = A_s;  // [2][PG][C]
#pragma unroll
  for (int j = 0; j < K::MC / 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ch = slot_channel(j, cg, K::CG) + q;
      red[pg * C + ch] = s[4 * j + q];
      red[(K::PG + pg) * C + ch] = ss[4 * j + q];
    }
  __syncthreads();
  float* out = part + cta_index() * 2 * C;
  for (int t = threadIdx.x; t < 2 * C; t += kThreads) {
    const int which = t / C, ch = t % C;
    float sum = 0.f;
    for (int g = 0; g < K::PG; ++g) sum += red[(which * K::PG + g) * C + ch];
    out[t] = sum;
  }
}
"""

CUDA_CORES_LAUNCH = """\
  using K = Cfg<C>;
  const size_t smem = sizeof(float) * (K::AB + static_cast<size_t>(K::TW + 2 * d) * C);
  cudaError_t err = set_smem(fwd_pair_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  fwd_pair_kernel<C><<<dim3((w + K::TW - 1) / K::TW, h, n), kThreads, smem, s>>>(
      x, w31, b31, w13, rap, pa, pb, y, scratch, h, w, d);
  err = cudaGetLastError();
"""

# stage B's A fragments from pre-split c: hi at a[m * AM + k], lo at a[m * AM + C + k]
C_SPLIT = """
template <int MT, int NT, int AM, int LDB, int C, bool FIRST>
__device__ __forceinline__ void mma_k8_presplit(const float* a_s, const float* b_s,
                                                float (&loc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* p = a_s + (mt * 16 + g) * AM + t;
    const int off[4] = {0, 8 * AM, 4, 8 * AM + 4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[mt][i] = __float_as_uint(p[off[i]]);
      al[mt][i] = __float_as_uint(p[off[i] + C]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* q = b_s + t * LDB + nt * 8 + g;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(q[0], bh0, bl0);
    split_tf32(q[4 * LDB], bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (FIRST) mma_tf32_first(loc[mt][nt], al[mt], bh0, bh1);
      else mma_tf32(loc[mt][nt], al[mt], bh0, bh1);
      mma_tf32(loc[mt][nt], ah[mt], bl0, bl1);
      mma_tf32(loc[mt][nt], ah[mt], bh0, bh1);
    }
  }
}

template <typename L>
__device__ __forceinline__ void multiply_presplit(const float* a, const float* b,
                                                  Frag<L::MT, L::NT>& f) {
  const int warp = threadIdx.x >> 5, wm = warp % L::WM, wn = warp / L::WM;
  const float* A = a + wm * L::WROWS * L::LDC;
  const float* B = b + wn * L::NT * 8;
#pragma unroll
  for (int ks = 0; ks < L::KC / 8; ++ks) {
    if (ks == 0)
      mma_k8_presplit<L::MT, L::NT, L::LDC, L::LDB, L::CH, true>(A, B, f.loc);
    else
      mma_k8_presplit<L::MT, L::NT, L::LDC, L::LDB, L::CH, false>(A + ks * 8, B + ks * 8 * L::LDB,
                                                                  f.loc);
  }
  f.flush();
}

"""


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} x {old!r} in the K2 sources")
    return text.replace(old, new)


def _between(text: str, start: str, end: str) -> str:
    """The text from `start` up to and including `end` (each found once)."""
    i = text.index(start)
    j = text.index(end, i) + len(end)
    if text.count(start) != 1:
        raise RuntimeError(f"expected one {start!r} in the K2 sources")
    return text[i:j]


def variants(files: dict[str, str]) -> dict[str, dict[str, str]]:
    """name -> {file (relative to the package): its text} for each file the
    variant changes; `files` holds the committed text of FILES."""
    src, pair = files[SOURCE], files[PAIR]
    partials = "template <int C>\nsize_t fwd_partials(int n, int h, int w) {"
    cores = _sub(src, partials, CUDA_CORES + "\n" + partials)
    cores = _sub(cores, "const dim3 g = pair_grid<C>(n, h, w);",
                 "const dim3 g((w + Cfg<C>::TW - 1) / Cfg<C>::TW, h, n);")
    cores = _sub(cores, _between(cores, "  // the ring and c; a halo past",
                                 "  err = cudaGetLastError();\n"), CUDA_CORES_LAUNCH)

    split = _sub(pair, "  static constexpr int LDC = C + 4;",
                 "  static constexpr int LDC = 2 * C + 4;  // hi, then lo")
    split = _sub(split, "      st2(p, c0, c1);\n",
                 "      uint32_t h0, l0, h1, l1;\n"
                 "      split_tf32(c0, h0, l0);\n"
                 "      split_tf32(c1, h1, l1);\n"
                 "      st2(p, __uint_as_float(h0), __uint_as_float(h1));\n"
                 "      st2(p + C, __uint_as_float(l0), __uint_as_float(l1));\n")
    split = _sub(split, "cv.template multiply<B::LDC>(c_s + tap * d * B::LDC + ci0, buf, f, "
                        "B::MT);",
                 "multiply_presplit<B>(c_s + tap * d * B::LDC + ci0, "
                 "smem + buf * B::STAGE + B::B_OFF, f);")
    mainloop = "// ---- the pair mainloop"
    split = _sub(split, mainloop, C_SPLIT + mainloop)

    small = _sub(pair, "struct K2B : Tiling<C, 2, Warps<C>::WM * 32, 32, 16,",
                 "struct K2B : Tiling<C, 1, Warps<C>::WM * 16, 16, 16,")
    small = _sub(small, "  static constexpr int TM = Warps<C>::WM * 32;      // 64, 128, 256",
                 "  static constexpr int TM = Warps<C>::WM * 16;")
    small = _sub(small, "struct K2A : Tiling<C, 3, Warps<C>::WM * 48,",
                 "struct K2A : Tiling<C, 2, Warps<C>::WM * 32,")
    small = _sub(small, "Warps<C>::WM * 48 >= K2B<C>::TM", "Warps<C>::WM * 32 >= K2B<C>::TM")

    occ = "constexpr int K2_CTAS = 2, K2_DEPTH = 2;"
    walkers = "  static constexpr int WALKERS = 128;"
    return {
        "as_built": {},
        "cuda_cores": {SOURCE: cores},
        "c_split": {PAIR: split},
        "ring3": {PAIR: _sub(pair, occ, "constexpr int K2_CTAS = 2, K2_DEPTH = 3;")},
        "ring4": {PAIR: _sub(pair, occ, "constexpr int K2_CTAS = 2, K2_DEPTH = 4;")},
        "tm_smaller": {PAIR: small},
        "one_cta": {PAIR: _sub(pair, occ, "constexpr int K2_CTAS = 1, K2_DEPTH = 2;")},
        "bf16_ring2": {SOURCE: _sub(src, "MAX_DEPTH = 6;", "MAX_DEPTH = 2;")},
        "bf16_ring3": {SOURCE: _sub(src, "MAX_DEPTH = 6;", "MAX_DEPTH = 3;")},
        "bf16_w_streamed": {SOURCE: _sub(src, "W_RESIDENT = C <= 64;", "W_RESIDENT = C <= 16;")},
        "bf16_kc32": {SOURCE: _sub(src, "  static constexpr int KC = C >= 64 ? 64 : C;",
                                   "  static constexpr int KC = C >= 32 ? 32 : C;")},
        "bf16_walkers_132": {SOURCE: _sub(src, walkers, walkers.replace("128", "132"))},
        "bf16_walkers_half": {SOURCE: _sub(src, walkers, walkers.replace("128", "64"))},
        "bf16_cta_per_tile": {SOURCE: _sub(src, walkers, walkers.replace("128", "INT_MAX"))},
        "bf16_rap_stages": {SOURCE: _sub(
            _sub(src, "fw.rap = rap != nullptr && !R::W_RESIDENT;", "fw.rap = rap != nullptr;"),
            "const bool rap_row = rap != nullptr && R::W_RESIDENT;", "const bool rap_row = false;")},
        "bf16_params_global": {SOURCE: _sub(_sub(
            src, "const float* a = prm + C + mw.ch * KC + v;\n      const float4 a0 = ld4(a), "
                 "a1 = ld4(a + 4), b0 = ld4(a + C), b1 = ld4(a + C + 4);",
            "const float* a = pa + mw.ch * KC + v;\n      const float* b = pb + mw.ch * KC + v;\n"
            "      const float4 a0 = ld4(a), a1 = ld4(a + 4), b0 = ld4(b), b1 = ld4(b + 4);"),
            "const float2 bias = *reinterpret_cast<const float2*>(prm + co);",
            "const float2 bias = *reinterpret_cast<const float2*>(b31 + co);")},
        "bf16_cta256_mt4": {SOURCE: _sub(
            src, "static constexpr int THREADS = 512, MT = Mma<C>::MT;",
            "static constexpr int THREADS = 256, MT = 2 * Mma<C>::MT;")},
        "diag_no_products": {SOURCE: _sub(_sub(
            _sub(src, "warp_mma<KC, MT, NT, LDA, LDB>(", "if (0) warp_mma<KC, MT, NT, LDA, LDB>(", 3),
            "warp_mma<C, MT, NT, LDB, LDB>(", "if (0) warp_mma<C, MT, NT, LDB, LDB>("),
            "warp_mma<C, MT, NT, R::LDU, LDB>(", "if (0) warp_mma<C, MT, NT, R::LDU, LDB>(")},
        "diag_no_y_stores": {SOURCE: _sub(
            src, "      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * C) = raw8;\n", "")},
        "diag_no_u_loads": {SOURCE: _sub(
            src, "if (col >= 0 && col < W) cp_async16(dst, src + static_cast<size_t>(col) * C + v);",
            "if (0) cp_async16(dst, src + static_cast<size_t>(col) * C + v);")},
        "diag_no_pre": {SOURCE: _sub(src, "    if (pa != nullptr) {\n      const float* a = prm",
                                     "    if (0) {\n      const float* a = prm")},
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
    dtype = cs.DTYPES[dt]
    n = cs.TRAIN_BATCH
    total = {"ms": 0.0, **dict.fromkeys(KINDS, 0.0)}
    blocks = {}
    for i, (bname, c, d, rap, h, w, count) in enumerate(cs.BLOCKS):
        gen = torch.Generator().manual_seed(100 * i)
        x = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, dtype))
        row = {"ms": 0.0}
        for dd, pre in ((1, False), (d, True)):
            args = cs.pair_args(gen, c, rap, pre, dev)

            def fn(args=args, dd=dd):
                return T.fwd_pair(x, *args, dd)

            row["ms"] += cs.time_ms(fn, iters=10, warmup=2)
            for k, v in cs.device_ms_by_kind(fn, KINDS).items():
                row[k] = cs.add_ms(row.get(k, 0.0), v)
        blocks[bname] = row
        for k in total:
            total[k] = cs.add_ms(total[k], None if row[k] is None else count * row[k])
    worst: dict[str, float] = {}
    for i, (_, c, d, _, h, w, _) in enumerate(cs.BLOCKS + (cs.RAGGED,)):
        gen = torch.Generator().manual_seed(7 + i)
        args = cs.pair_args(gen, c, True, True, dev)
        x = cs.cl(torch.randn(n, c, h, w, generator=gen).to(dev, dtype))
        y, st = T.fwd_pair(x, *args, d)
        yd = y.double()
        if dt == "f32":
            y64, _ = T.fwd_pair_plain(x.double(), *(cs.as_f64(a) for a in args), d)
            m64 = yd.mean((0, 2, 3))
            v64 = (yd - m64.view(1, -1, 1, 1)).square().mean((0, 2, 3))
            mu = st[0].double() / (n * h * w)
            var = torch.clamp(st[1].double() / (n * h * w) - mu * mu, min=0.0)
            errs = {"y": cs.rel_l2(y, y64),
                    "mean": float((mu - m64).norm() / v64.sqrt().norm()),
                    "var": float((var - v64).norm() / v64.norm())}
            del y64
        else:
            y_p, st_p = T.fwd_pair_plain(x, *args, d)
            two = torch.stack([yd.sum((0, 2, 3)), yd.square().sum((0, 2, 3))])
            errs = {"y": cs.rel_l2(y, y_p), "stats": cs.rel_l2(st, st_p),
                    "stats_vs_f64_two_pass": cs.rel_l2(st, two)}
            del y_p
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del y, yd
    return {"variant": name, "dtype": dt, "card": cs.card_line(), "k2_ms_per_forward": total,
            "blocks": blocks, "worst": worst,
            "against": "float64" if dt == "f32" else "the plain bf16 version"}


def committed() -> dict[str, str]:
    return {f: (PACKAGE / f).read_text() for f in FILES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--only", nargs="+", metavar="NAME", help="run these variants (and as_built)")
    ap.add_argument("--against", type=Path, metavar="ROOT",
                    help="also measure this checkout, as 'parent', first and last")
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
    roots = {name: WORK / name for name in order}
    if args.against:
        roots["parent"] = args.against.resolve()
        order = ["parent", *order, "parent"]
    results = []
    for name in order:
        proc = subprocess.run([sys.executable, __file__, "--dtype", args.dtype, "--measure",
                               str(roots[name]), name], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(rec)
        t, e = rec["k2_ms_per_forward"], rec["worst"]
        print(f"{name:18s} K2 {args.dtype} {t['ms']:.3f} ms per forward (device "
              + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured"
                          for k, v in t.items() if k != "ms")
              + f"); worst vs {rec['against']} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items()),
              flush=True)
        for block, row in rec["blocks"].items():
            print(f"{'':18s}   {block:16s} "
                  + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                              for k, v in row.items()), flush=True)
    out = Path(args.out or f"build/k2_variants_{args.dtype}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
