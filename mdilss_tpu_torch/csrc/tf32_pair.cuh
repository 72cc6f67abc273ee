// The 3xTF32 machinery of the port's fp32 kernels on Hopper's tensor cores and the conv-pair
// mainloop built on it, shared by nb1d_train.cu (K2's fwd_pair_mma_kernel and K3) and
// nb1d_infer.cu (K1's fp32 nb1d_pair_tf32_kernel). sm_80 and later; built for sm_90a.
//
// The pair: with u = pa ? relu(pa * x + pb) : x (rows outside the image are zero padding),
//   c = relu(rowconv_d(u, w31) + b31)
//   y = colconv_d(c, w13) [+ u @ rap]
// rowconv_d is the 3x1 conv with row dilation d, colconv_d the 1x3 conv with column dilation d,
// both zero-padded "same" convs; weights are tap-stacked [3C][C] matrices (row k*C + ci, column
// co). Activations are fp32 NHWC, C in {16, 64, 128}. `pair_mainloop` leaves each warp's
// fragments of y in registers; each kernel writes its own epilogue (K2: y and the CTA's partial
// [2][C] stats; K1: relu(a * y + b [+ res])), so for the same inputs the two compute the same y
// bit for bit (card test test_k1_fp32_and_k2_compute_the_same_y).
//
// Why 3xTF32 and not one TF32 pass: TF32 keeps 10 mantissa bits, so one pass is ~3e-4 off in
// relative L2, far from the 1e-5 the port's fp32 kernels are held to. Splitting each operand
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and summing lo*hi + hi*lo + hi*hi keeps ~22
// bits (the dropped lo*lo term is ~2^-22 relative). Each warp splits its fragments as it loads
// them. The tensor cores' fp32 accumulation truncates, so each warp sums one K chunk in the mma
// accumulator and adds it to a second, float32 sum with a round-to-nearest add (without it, K3's
// weight gradients were 2.2e-5 off float64).
//
// The mainloop (K2's design): one CTA per (image, row, TM output columns) x all C channels.
//   - operands reach shared memory through 16-byte cp.async in a ring (sm90_async.cuh), one
//     barrier per K chunk of KC input channels; row strides of KC+4 / C+8 floats put each
//     fragment load of a warp on 32 distinct banks (A fragments by ldmatrix);
//   - stage A computes c for the TM + 2d columns w0-d .. w0+TM+d-1 into fp32 shared memory (row
//     stride C+4 floats, so stage B's fragment loads at the column shifts k*d hit 32 distinct
//     banks). Its m16 tiles are dealt to the warp rows in turn (one pass covers d <= 16, a
//     larger d takes more passes); each K chunk's product is added into c's shared memory rather
//     than into registers, and the pass ends with relu(c + b31), 0 outside the image. The row
//     taps outside the image are skipped, uniformly over the CTA;
//   - stage B streams only the w13 chunks and reads its A fragments straight from c; RAP is one
//     more K block, u's own row through the ring and the pre-stage;
//   - the 3xTF32 instruction stream (the splits beside the mma) needs many warps per SM, so the
//     mainloop keeps to 128 registers and a 2-deep ring and two CTAs share an SM (one CTA per SM
//     measured slower for K2 and for K1: `one_cta` in tools_torch/k2_variants.py and
//     k1_variants.py); that is why stage A's sums live in shared memory.
// A halo past the shared memory of a block (pair_smem_bytes) makes the launch fail.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// relu(a * v + b) on channels ch .. ch+3: the pre-stage (BN affine of the previous pair + relu)
__device__ __forceinline__ float4 pre4(float4 v, const float* __restrict__ a,
                                       const float* __restrict__ b, int ch) {
  const float4 av = ld4(a + ch), bv = ld4(b + ch);
  return make_float4(fmaxf(fmaf(av.x, v.x, bv.x), 0.f), fmaxf(fmaf(av.y, v.y, bv.y), 0.f),
                     fmaxf(fmaf(av.z, v.z, bv.z), 0.f), fmaxf(fmaf(av.w, v.w, bv.w), 0.f));
}

// ---- 3xTF32 mma.sync ---------------------------------------------------------------------
//
// Every product is a tile GEMM on mma.sync.m16n8k8 TF32 with the operands split in two:
// x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi), and a*b ~ lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b (the lo*lo term is below float32 rounding). A warp owns MT x NT fragments of the
// output; each staged K chunk goes into a fresh fragment accumulator (`loc`) that is then added
// to the running float32 sum (`acc`) with an ordinary round-to-nearest add, so the tensor cores
// never sum more than one chunk (their float32 accumulation truncates).

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero: what
// cvt.rna.tf32.f32 computes for finite x, in two integer instructions (ptxas expands the
// conversion into several on sm_90a)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d = a * b (a zero accumulator in)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a * b
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's MT m16 x NT n8 output fragments. Element i of fragment (mt, nt) sits at row
// g + 8*(i/2) of the warp's m16 tile mt and column nt*8 + 2t + i%2 of the warp's tile
// (g = lane/4, t = lane%4).
template <int MT, int NT>
struct Frag {
  float acc[MT][NT][4];
  float loc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  }

  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += loc[mt][nt][i];
  }
};

// loc (+)= A[0:16MT, 0:8] B[0:8, 0:8NT] in 3xTF32, small terms first; FIRST starts loc from
// zero. A element (m, k) of the warp's m16 tile mt at a_s[(mt * TROWS + m) * AM + k * AK], B
// element (k, n) at b_s[k * LDB + n], both already offset to the warp's tile and the k8 step.
// Tiles mt >= live are skipped (live is uniform over the warp); FIRST zeroes their loc. LDSM
// loads each A tile's fragment with one ldmatrix (the same registers as four scalar loads; A
// row-major with 16-byte aligned rows).
template <int MT, int NT, int AM, int AK, int LDB, bool FIRST, int TROWS = 16, bool LDSM = false>
__device__ __forceinline__ void mma_k8(const float* a_s, const float* b_s,
                                       float (&loc)[MT][NT][4], int live = MT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= live) continue;
    if constexpr (LDSM) {
      static_assert(AK == 1 && AM % 4 == 0, "ldmatrix reads rows of 16 bytes");
      // matrix j = lane / 8: rows (j % 2) * 8 .., k (j / 2) * 4 ..; register j is fragment
      // element j, (g + 8 (j % 2), t + 4 (j / 2))
      uint32_t r[4];
      ldsm_x4(r, a_s + (mt * TROWS + ((lane >> 3) & 1) * 8 + (lane & 7)) * AM + (lane >> 4) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), ah[mt][i], al[mt][i]);
    } else {
      const float* p = a_s + (mt * TROWS + g) * AM + t * AK;
      split_tf32(p[0], ah[mt][0], al[mt][0]);
      split_tf32(p[8 * AM], ah[mt][1], al[mt][1]);
      split_tf32(p[4 * AK], ah[mt][2], al[mt][2]);
      split_tf32(p[8 * AM + 4 * AK], ah[mt][3], al[mt][3]);
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
      if (mt >= live) {
        if constexpr (FIRST)
          loc[mt][nt][0] = loc[mt][nt][1] = loc[mt][nt][2] = loc[mt][nt][3] = 0.f;
        continue;
      }
      if constexpr (FIRST) mma_tf32_first(loc[mt][nt], al[mt], bh0, bh1);
      else mma_tf32(loc[mt][nt], al[mt], bh0, bh1);
      mma_tf32(loc[mt][nt], ah[mt], bl0, bl1);
      mma_tf32(loc[mt][nt], ah[mt], bh0, bh1);
    }
  }
}

// ---- conv GEMMs on the tensor cores ---------------------------------------------------------

// The warp grid of a conv GEMM: (pixels) x (all C channels) as WM x WN warps, each NT n8
// fragments wide; K streams in chunks of KC input channels.
template <int C>
struct Warps {
  static constexpr int KC = C < 32 ? C : 32;        // input channels per staged chunk
  static constexpr int NT = C >= 64 ? 4 : 2;
  static constexpr int WN = C / (8 * NT);           // 4, 2, 1 for C = 128, 64, 16
  static constexpr int WM = kThreads / 32 / WN;     // 2, 4, 8
  static constexpr int LDA = KC + 4;                // A chunk [ROWS][LDA]: fragment loads hit
  static constexpr int LDB = C + 8;                 // 32 banks; B chunk [KC][LDB] likewise
  static_assert(WM * WN * 32 == kThreads && KC % 8 == 0 && C % KC == 0, "conv warp grid");
};

// A conv GEMM's tiling: each warp MT m16 x NT n8 fragments; a staged A chunk holds ROWS pixels;
// warp row wm's m16 tiles start at row wm * WROWS and follow each other every TROWS rows. The
// operands stream through a ring of DEPTH stages; LDSM: A fragments by ldmatrix (mma_k8).
template <int C, int MT_, int ROWS_, int WROWS_, int TROWS_, int DEPTH_ = kStages,
          bool LDSM_ = false>
struct Tiling : Warps<C> {
  static constexpr int CH = C, MT = MT_, ROWS = ROWS_, WROWS = WROWS_, TROWS = TROWS_;
  static constexpr int DEPTH = DEPTH_;
  static constexpr bool LDSM = LDSM_;
  static constexpr int B_OFF = ROWS * Warps<C>::LDA;              // stage: A then B
  static constexpr int STAGE = B_OFF + Warps<C>::KC * Warps<C>::LDB;
};

// The pair kernels (K2, K1 fp32) run two CTAs per SM where their shared memory fits: at most
// 128 registers a thread and a ring 2 deep (K2_DEPTH).
constexpr int K2_CTAS = 2, K2_DEPTH = 2;

// The pair's CTA tile and stage B: TM output columns x all C channels, each warp MT consecutive
// m16 tiles; c in shared memory at a row stride of LDC floats.
template <int C>
struct K2B : Tiling<C, 2, Warps<C>::WM * 32, 32, 16, K2_DEPTH, true> {
  static constexpr int TM = Warps<C>::WM * 32;      // 64, 128, 256
  static constexpr int LDC = C + 4;
};

// The pair's stage A: the TM + 2d c columns in passes of ROWS, each pass's m16 tiles dealt to
// the WM warp rows in turn (tile i of warp row wm at row (wm + i*WM) * 16), up to MT per warp row.
template <int C>
struct K2A : Tiling<C, 3, Warps<C>::WM * 48, 16, Warps<C>::WM * 16, K2_DEPTH, true> {
  static_assert(Warps<C>::WM * 48 >= K2B<C>::TM + 32, "one stage-A pass covers d <= 16");
};

// One tap of a conv: output pixel (n, r, col) reads src[n, row, col + shift, :] (0 outside the
// image) against the weight rows w[ci][co].
struct Tap {
  const float* src;
  const float* w;
  int row, shift;
};

// The stages of a conv GEMM in tiling L: stage s multiplies tap(s / NCH), input channels
// (s % NCH) * KC .. + KC. Its A chunk holds the pixels w0 .. w0+rows-1 of the tap's row at the
// tap's column shift, 0 outside the image, through the pre-stage relu(pa*v + pb) where pa is
// non-null; its B chunk the matching KC rows of the tap's weights. The pre-stage cannot ride on
// cp.async: each thread applies it in shared memory to the elements it copied itself.
template <typename L, typename TapFn>
struct ConvStages {
  static constexpr int NCH = L::CH / L::KC, AV = L::KC / 4;
  float* smem;
  TapFn tap;
  int n, w0, rows, H, W;
  const float* pa;
  const float* pb;

  // source of A element group idx of stage s, or null where the column is outside the image
  __device__ __forceinline__ const float* a_src(int s, int idx) const {
    const Tap tp = tap(s / NCH);
    const int col = w0 + idx / AV + tp.shift;
    if (col < 0 || col >= W) return nullptr;
    return tp.src + ((static_cast<size_t>(n) * H + tp.row) * W + col) * L::CH +
           (s % NCH) * L::KC + (idx % AV) * 4;
  }
  __device__ __forceinline__ float* a_dst(int buf, int idx) const {
    return smem + buf * L::STAGE + (idx / AV) * L::LDA + (idx % AV) * 4;
  }
  __device__ __forceinline__ void fetch_b(int s, int buf) const {
    constexpr int C = L::CH;
    float* B = smem + buf * L::STAGE + L::B_OFF;
    const float* w = tap(s / NCH).w + static_cast<size_t>((s % NCH) * L::KC) * C;
    for (int e = threadIdx.x; e < L::KC * (C / 4); e += kThreads) {
      const int row = e / (C / 4), c4 = (e % (C / 4)) * 4;
      cp_async16(B + row * L::LDB + c4, w + row * C + c4);
    }
  }
  __device__ __forceinline__ void fetch(int s, int buf) const {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = threadIdx.x; idx < rows * AV; idx += kThreads) {
      const float* src = a_src(s, idx);
      if (src != nullptr) cp_async16(a_dst(buf, idx), src);
      else st4(a_dst(buf, idx), zero4);
    }
    fetch_b(s, buf);
  }
  __device__ __forceinline__ void fixup(int s, int buf) const {
    if (pa == nullptr) return;
    const int ci0 = (s % NCH) * L::KC;
    for (int idx = threadIdx.x; idx < rows * AV; idx += kThreads)
      if (a_src(s, idx) != nullptr) {
        float* p = a_dst(buf, idx);
        st4(p, pre4(ld4(p), pa, pb, ci0 + (idx % AV) * 4));
      }
  }
  // loc = the warp's tiles (< live) of A @ (the B chunk in buffer buf), A element (m, k) at
  // a[m * AM + k]
  template <int AM>
  __device__ __forceinline__ void product(const float* a, int buf,
                                          float (&loc)[L::MT][L::NT][4], int live) const {
    const int warp = threadIdx.x >> 5, wm = warp % L::WM, wn = warp / L::WM;
    const float* A = a + wm * L::WROWS * AM;
    const float* B = smem + buf * L::STAGE + L::B_OFF + wn * L::NT * 8;
#pragma unroll
    for (int ks = 0; ks < L::KC / 8; ++ks) {
      if (ks == 0)
        mma_k8<L::MT, L::NT, AM, 1, L::LDB, true, L::TROWS, L::LDSM>(A, B, loc, live);
      else
        mma_k8<L::MT, L::NT, AM, 1, L::LDB, false, L::TROWS, L::LDSM>(
            A + ks * 8, B + ks * 8 * L::LDB, loc, live);
    }
  }
  // f.acc += the same product
  template <int AM>
  __device__ __forceinline__ void multiply(const float* a, int buf, Frag<L::MT, L::NT>& f,
                                           int live) const {
    product<AM>(a, buf, f.loc, live);
    f.flush();
  }
  __device__ __forceinline__ void compute(int buf, Frag<L::MT, L::NT>& f, int live) const {
    multiply<L::LDA>(smem + buf * L::STAGE, buf, f, live);
  }
};

// Calls fn(mt, nt, h, m, co) for each pair of adjacent elements (2h, 2h+1) of the thread's
// fragments in tiling L, its m16 tiles below live: row m0 + m of the A chunk (a pixel of the CTA
// tile), channels co and co + 1.
template <typename L, typename Fn>
__device__ __forceinline__ void frag_pairs(int m0, Fn fn, int live = L::MT) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m1 = m0 + (warp % L::WM) * L::WROWS + (lane >> 2);
  const int c0 = (warp / L::WM) * L::NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    if (mt >= live) continue;  // uniform over the warp
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) fn(mt, nt, h, m1 + mt * L::TROWS + 8 * h, c0 + nt * 8);
  }
}

// ---- the pair mainloop ------------------------------------------------------------------------
// f.acc = y = colconv_d(c) [+ u @ rap] for the CTA's TM output columns
// w0 = blockIdx.x * TM .. of row blockIdx.y of image blockIdx.z (frag_pairs<K2B<C>> maps the
// fragments to pixels and channels). Shared memory: the ring (K2_DEPTH stages of K2A) and c,
// [TM + 2d rounded up to 16][LDC] (pair_smem_bytes).
template <int C>
__device__ __forceinline__ void pair_mainloop(float* smem, const float* __restrict__ x,
                                              const float* __restrict__ w31,
                                              const float* __restrict__ b31,
                                              const float* __restrict__ w13,
                                              const float* __restrict__ rap,
                                              const float* __restrict__ pa,
                                              const float* __restrict__ pb, int H, int W, int d,
                                              Frag<K2B<C>::MT, K2B<C>::NT>& f) {
  using A = K2A<C>;
  using B = K2B<C>;
  float* c_s = smem + A::DEPTH * A::STAGE;  // c at columns w0-d .. w0+TM+d-1
  const int w0 = blockIdx.x * B::TM, r = blockIdx.y, n = blockIdx.z;
  const int wm = (threadIdx.x >> 5) % B::WM;
  const int cols = B::TM + 2 * d;

  // ---- stage A: c = relu(rowconv_d(u) + b31), 0 outside the image; the row taps inside the
  // image are k0 .. k1. The stages are ConvStages', but the running float32 sum of each element
  // lives in c_s rather than in registers (what keeps the kernels within 128 registers): the
  // first stage stores its chunk's product, each later one adds to it, to nearest, as
  // Frag::flush does ----
  const int k0 = r - d < 0 ? 1 : 0, k1 = r + d >= H ? 1 : 2;
  const auto row_tap = [&](int j) {
    return Tap{x, w31 + static_cast<size_t>(k0 + j) * C * C, r + (k0 + j - 1) * d, 0};
  };
  for (int p0 = 0; p0 < cols; p0 += A::ROWS) {
    const int rows = min(A::ROWS, cols - p0);
    const int live = ((rows + 15) / 16 - wm + A::WM - 1) / A::WM;  // tiles wm, wm + WM, ...
    const ConvStages<A, decltype(row_tap)> cs{smem, row_tap, n, w0 - d + p0, rows, H, W, pa, pb};
    float loc[A::MT][A::NT][4];
    pipeline<A::DEPTH>(
        (k1 - k0 + 1) * cs.NCH, [&](int s, int buf) { cs.fetch(s, buf); },
        [&](int s, int buf) { cs.fixup(s, buf); },
        [&](int s, int buf) {
          cs.template product<A::LDA>(smem + buf * A::STAGE, buf, loc, live);
          // the first stage stores its product in c_s, each later one adds to it (to nearest);
          // a live tile's tail past cols lands in c_s's padding rows
          frag_pairs<A>(p0, [&](int mt, int nt, int h, int m, int co) {
            float* p = c_s + m * B::LDC + co;
            float v0 = loc[mt][nt][2 * h], v1 = loc[mt][nt][2 * h + 1];
            if (s > 0) {
              const float2 sum = *reinterpret_cast<const float2*>(p);
              v0 = sum.x + v0;
              v1 = sum.y + v1;
            }
            st2(p, v0, v1);
          }, live);
        });
    // each thread converts its own sums (stage B's first barrier publishes them)
    frag_pairs<A>(p0, [&](int, int, int, int m, int co) {
      float* p = c_s + m * B::LDC + co;
      const int col = w0 - d + m;
      float c0 = 0.f, c1 = 0.f;
      if (col >= 0 && col < W) {
        const float2 sum = *reinterpret_cast<const float2*>(p);
        const float2 bias = *reinterpret_cast<const float2*>(b31 + co);
        c0 = fmaxf(sum.x + bias.x, 0.f);
        c1 = fmaxf(sum.y + bias.y, 0.f);
      }
      st2(p, c0, c1);
    }, live);
  }

  // ---- stage B: y = colconv_d(c) [+ u @ rap]; stage s < kConv multiplies tap s / NCH of c,
  // straight from c_s, with rows s*KC.. of w13; then the RAP chunks of u's own row ----
  // (the ring's first barrier orders the c_s writes above before these reads)
  constexpr int NCH = C / B::KC, kConv = 3 * NCH;
  const auto col_tap = [&](int k) {
    return Tap{nullptr, w13 + static_cast<size_t>(k) * C * C, r, 0};
  };
  const auto rap_tap = [&](int) { return Tap{x, rap, r, 0}; };
  const ConvStages<B, decltype(col_tap)> cv{smem, col_tap, n, w0, B::TM, H, W, nullptr, nullptr};
  const ConvStages<B, decltype(rap_tap)> rp{smem, rap_tap, n, w0, B::TM, H, W, pa, pb};
  f.zero();
  pipeline<B::DEPTH>(
      kConv + (rap != nullptr ? NCH : 0),
      [&](int s, int buf) {
        if (s < kConv) cv.fetch_b(s, buf);
        else rp.fetch(s - kConv, buf);
      },
      [&](int s, int buf) {
        if (s >= kConv) rp.fixup(s - kConv, buf);
      },
      [&](int s, int buf) {
        if (s < kConv) {
          const int tap = s / NCH, ci0 = (s % NCH) * B::KC;
          cv.template multiply<B::LDC>(c_s + tap * d * B::LDC + ci0, buf, f, B::MT);
        } else {
          rp.compute(buf, f, B::MT);
        }
      });
}

// The grid of a pair launch: one CTA per (image, row, TM output columns).
template <int C>
dim3 pair_grid(int n, int h, int w) {
  return dim3((w + K2B<C>::TM - 1) / K2B<C>::TM, h, n);
}

// Bytes of shared memory of a pair CTA at dilation d: the ring and c.
template <int C>
size_t pair_smem_bytes(int d) {
  const size_t c_rows = (K2B<C>::TM + 2 * static_cast<size_t>(d) + 15) / 16 * 16;
  return sizeof(float) * (static_cast<size_t>(K2A<C>::DEPTH) * K2A<C>::STAGE +
                          c_rows * K2B<C>::LDC);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
