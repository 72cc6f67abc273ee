// Training conv pair of the non-bottleneck-1d block, forward and backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of mdilss_tpu/ops/pallas/nb1d_train.py:
//
//   K2 _fwd_pair_kernel (entry fwd_pair):
//     u = pre ? relu(a * x + b) : x          (rows outside the image are zero padding)
//     c = relu(rowconv_d(u, w31) + b31)
//     y = colconv_d(c, w13) [+ u @ rap]      -> y and per-channel [2, C] sum / sum of squares
//   K3 _bwd_pair_kernel (entry bwd_pair), the gradient of y with respect to u and the weights:
//     dc   = colconv_d^T(gy, w13) * [c > 0]  (c recomputed from u)
//     du   = rowconv_d^T(dc, w31) [+ gy @ rap^T]
//     dw31[k] = sum u_shift_k^T dc, db31 = sum dc, dw13[k] = sum c_shift_k^T gy, drap = sum u^T gy
//
// rowconv_d is the 3x1 conv with row dilation d, colconv_d the 1x3 conv with column dilation d,
// both zero-padded "same" convs; weights are tap-stacked [3C][C] matrices (row k*C + ci, column
// co). The transposed convs of the backward are the same convs with transposed, tap-reversed
// stacks (row k*C + co, column ci = w[(2-k)*C + ci][co]), which the caller passes.
//
// Design. The TPU kernels walk a sequential grid and carry the stats and the weight gradients
// in revisited VMEM blocks. Here blocks run in parallel, so every cross-block sum is written as
// per-block partials and summed by a second pass in a fixed order (in double); no float atomics,
// so two runs on the same input give bitwise-equal outputs. The pieces:
//   fwd_pair_mma_kernel  one CTA per (image, row, TM columns): the pair mainloop of
//                        tf32_pair.cuh (stage A: c for the TM + 2d columns w0-d .. w0+TM+d-1
//                        into shared memory; stage B: y from it), then y and the CTA's [2][C]
//                        partial stats;
//   bwd_dc_kernel        one CTA per (image, row, TM columns): c for the TM columns (also written
//                        to a scratch buffer, its sign kept in registers), then dc; writing dc
//                        keeps every halo 1-D (2 launches instead of one CTA needing u rows
//                        r-2d..r+2d);
//   bwd_du_kernel        same tiling: du from dc and gy;
//   bwd_wgrad_kernel     grid (P, matrices, column halves): each CTA walks a fixed set of pixel
//                        tiles and keeps its part of one C x C weight gradient in registers;
//   reduce_kernel        sums the partials in a fixed order.
// Activations are fp32, NHWC (torch.channels_last), C in {16, 64, 128}; any N, H, W (the last
// column or pixel tile masks its edge).
//
// On the tensor cores. Per pixel the forward is 6C^2 MACs (+C^2 RAP) and the backward 17C^2
// (recompute 3C^2, dc 3C^2, du 4C^2, weight gradients 7C^2; 2C^2 less without RAP), against 2
// (forward) or 4 (backward) reads and writes of C fp32 values per pixel, so both are bound by
// operations: per student pass 5.10 ms (K2) and 12.4 ms (K3) at the CUDA cores' fp32 rate
// (67 TFLOP/s), 2.07 and 5.05 ms on the tensor cores in 3xTF32 (3 TF32 products per fp32
// product at 495 TFLOP/s, i.e. 165 TFLOP/s of fp32 work). Every product of K2 and K3 is a
// 3xTF32 mma.sync.m16n8k8 tile GEMM (tf32_pair.cuh: the split, the second accumulator per K
// chunk, ConvStages, the pair mainloop):
//   - the conv GEMMs tile (pixels of one row) x (all C channels), K = taps x C input channels
//     (ConvStages); K3's conv launches stream their operands through a 3-deep cp.async ring,
//     K2 through the pair mainloop's 2-deep one; the pre-stage relu(a*x+b) cannot ride on
//     cp.async, so each thread applies it in shared memory to the elements it copied, after they
//     land and before the barrier that publishes the chunk; taps outside the image are skipped
//     (rows, uniformly over the CTA) or zero-filled (columns);
//   - K2's epilogue writes y as float2 pairs and sums the CTA's stats per thread, over the lanes
//     (a fixed shuffle tree) and over the warp rows in a fixed order;
//   - the weight gradients are [pixels x C]^T [pixels x C] products (M = ci, N = co, K = pixels)
//     with tiles of one image row's pixels streamed the same way and a fixed grid of P CTAs per
//     matrix (two per matrix at C = 128, one per half of the columns, to keep the fragments in
//     registers). Splitting once per CTA in shared memory measured no faster for K3.
// c in K2 and in K3: K2's stage A and K3's bwd_dc_kernel compute c with the same stages
// (ConvStages) and products (mma_k8) in the same order (taps k0..k1, chunks of KC channels, one
// fresh accumulator each, the small terms first, each chunk added to the running float32 sum
// to nearest, K2's sum in shared memory and K3's in registers), so for the same inputs the two
// give the same c bit for bit and a pre-activation within float32 rounding of 0 takes the same
// side of the relu in both (card test test_fwd_and_bwd_compute_the_same_c). Against float64,
// that element may still take the other side; the card check holds dc-dependent outputs to
// float64 within that band.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_pair.cuh"
#include "tf32_pair.cuh"

namespace {

__device__ __forceinline__ size_t cta_index() {
  return (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

// K3's conv launches: one CTA per (image, row, TM columns) x all C output channels; each warp
// 2 consecutive m16 tiles, 32 pixels x 8NT channels.
template <int C>
struct TC : Tiling<C, 2, Warps<C>::WM * 32, 32, 16> {
  static constexpr int TM = Warps<C>::WM * 32;      // pixels per CTA: 64, 128, 256
};

// f.acc += sum over taps j < ntaps of src'[tap(j)] @ w[tap(j)] for the `rows` pixels w0 .. of
// image n (ConvStages), the warp's m16 tiles below `live` only.
template <typename L, typename TapFn>
__device__ __forceinline__ void conv_gemm(float* smem, TapFn tap, int ntaps, int n, int w0,
                                          int H, int W, const float* __restrict__ pa,
                                          const float* __restrict__ pb,
                                          Frag<L::MT, L::NT>& f, int rows = L::ROWS,
                                          int live = L::MT) {
  const ConvStages<L, TapFn> cs{smem, tap, n, w0, rows, H, W, pa, pb};
  pipeline<L::DEPTH>(
      ntaps * cs.NCH, [&](int s, int buf) { cs.fetch(s, buf); },
      [&](int s, int buf) { cs.fixup(s, buf); },
      [&](int, int buf) { cs.compute(buf, f, live); });
}

// ---- K2: forward pair ---------------------------------------------------------------------
// Shared memory: pair_smem_bytes (the ring and c).
template <int C>
__global__ void __launch_bounds__(kThreads, K2_CTAS)
fwd_pair_mma_kernel(const float* __restrict__ x, const float* __restrict__ w31,
                    const float* __restrict__ b31, const float* __restrict__ w13,
                    const float* __restrict__ rap, const float* __restrict__ pa,
                    const float* __restrict__ pb, float* __restrict__ y,
                    float* __restrict__ part, int H, int W, int d) {
  using B = K2B<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w0 = blockIdx.x * B::TM, r = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % B::WM, wn = warp / B::WM, g = lane >> 2, t = lane & 3;
  Frag<B::MT, B::NT> f;
  pair_mainloop<C>(smem, x, w31, b31, w13, rap, pa, pb, H, W, d, f);

  // ---- epilogue: write y; the CTA's [2][C] partial sum and sum of squares over its columns
  // inside the image, per thread, then over the 8 lanes of each channel pair (a fixed shuffle
  // tree), then over the warp rows in order ----
  const size_t row_base = (static_cast<size_t>(n) * H + r) * W;
  float s[B::NT][2], q[B::NT][2];
#pragma unroll
  for (int nt = 0; nt < B::NT; ++nt) s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
  frag_pairs<B>(0, [&](int mt, int nt, int h, int m, int co) {
    if (w0 + m >= W) return;
    const float v0 = f.acc[mt][nt][2 * h], v1 = f.acc[mt][nt][2 * h + 1];
    st2(y + (row_base + w0 + m) * C + co, v0, v1);
    s[nt][0] += v0;
    s[nt][1] += v1;
    q[nt][0] += v0 * v0;
    q[nt][1] += v1 * v1;
  });
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nt = 0; nt < B::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] += __shfl_xor_sync(0xffffffffu, s[nt][e], off);
        q[nt][e] += __shfl_xor_sync(0xffffffffu, q[nt][e], off);
      }
  float* red = smem;  // [WM][2][C]; the ring is free after the pipeline's last barrier
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < B::NT; ++nt) {
      const int co = wn * B::NT * 8 + nt * 8 + 2 * t;
      st2(red + (wm * 2 + 0) * C + co, s[nt][0], s[nt][1]);
      st2(red + (wm * 2 + 1) * C + co, q[nt][0], q[nt][1]);
    }
  __syncthreads();
  float* out = part + cta_index() * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    float sum = 0.f;
    for (int k = 0; k < B::WM; ++k) sum += red[k * 2 * C + i];
    out[i] = sum;
  }
}

// ---- K3, launch 1: c (recomputed) and dc ---------------------------------------------------
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dc_kernel(const float* __restrict__ raw, const float* __restrict__ gy,
              const float* __restrict__ w31, const float* __restrict__ b31,
              const float* __restrict__ w13t, const float* __restrict__ pa,
              const float* __restrict__ pb, float* __restrict__ cbuf, float* __restrict__ dc,
              int H, int W, int d) {
  using K = TC<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w0 = blockIdx.x * K::TM, r = blockIdx.y, n = blockIdx.z;
  const size_t row_base = (static_cast<size_t>(n) * H + r) * W;

  // c = relu(rowconv_d(u) + b31); the taps whose rows are inside the image (the rest is zero
  // padding) are k0 .. k1
  const int k0 = r - d < 0 ? 1 : 0, k1 = r + d >= H ? 1 : 2;
  Frag<K::MT, K::NT> f;
  f.zero();
  conv_gemm<K>(
      smem,
      [&](int j) {
        return Tap{raw, w31 + static_cast<size_t>(k0 + j) * C * C, r + (k0 + j - 1) * d, 0};
      },
      k1 - k0 + 1, n, w0, H, W, pa, pb, f);
  uint32_t pos = 0;  // bit (mt*NT + nt)*4 + i: c > 0
  frag_pairs<K>(0, [&](int mt, int nt, int h, int m, int co) {
    const float2 b = *reinterpret_cast<const float2*>(b31 + co);
    const float c0 = fmaxf(f.acc[mt][nt][2 * h] + b.x, 0.f);
    const float c1 = fmaxf(f.acc[mt][nt][2 * h + 1] + b.y, 0.f);
    const int bit = (mt * K::NT + nt) * 4 + 2 * h;
    pos |= (c0 > 0.f ? 1u : 0u) << bit;
    pos |= (c1 > 0.f ? 1u : 0u) << (bit + 1);
    if (w0 + m < W) st2(cbuf + (row_base + w0 + m) * C + co, c0, c1);
  });

  // g = colconv_d^T(gy): the 1x3 conv of gy with the transposed, tap-reversed stack
  f.zero();
  conv_gemm<K>(
      smem,
      [&](int j) { return Tap{gy, w13t + static_cast<size_t>(j) * C * C, r, (j - 1) * d}; }, 3,
      n, w0, H, W, nullptr, nullptr, f);

  // dc = g * [c > 0]
  frag_pairs<K>(0, [&](int mt, int nt, int h, int m, int co) {
    const int bit = (mt * K::NT + nt) * 4 + 2 * h;
    if (w0 + m < W)
      st2(dc + (row_base + w0 + m) * C + co, (pos >> bit) & 1u ? f.acc[mt][nt][2 * h] : 0.f,
          (pos >> (bit + 1)) & 1u ? f.acc[mt][nt][2 * h + 1] : 0.f);
  });
}

// ---- K3, launch 2: du ------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
bwd_du_kernel(const float* __restrict__ dc, const float* __restrict__ gy,
              const float* __restrict__ w31t, const float* __restrict__ rapt,
              float* __restrict__ du, int H, int W, int d) {
  using K = TC<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w0 = blockIdx.x * K::TM, r = blockIdx.y, n = blockIdx.z;
  const size_t row_base = (static_cast<size_t>(n) * H + r) * W;

  // du = rowconv_d^T(dc) [+ gy @ rap^T]: the row taps k0 .. k1 inside the image, then RAP
  const int k0 = r - d < 0 ? 1 : 0, k1 = r + d >= H ? 1 : 2, nrow = k1 - k0 + 1;
  Frag<K::MT, K::NT> f;
  f.zero();
  conv_gemm<K>(
      smem,
      [&](int j) {
        return j < nrow ? Tap{dc, w31t + static_cast<size_t>(k0 + j) * C * C,
                              r + (k0 + j - 1) * d, 0}
                        : Tap{gy, rapt, r, 0};
      },
      nrow + (rapt != nullptr ? 1 : 0), n, w0, H, W, nullptr, nullptr, f);
  frag_pairs<K>(0, [&](int mt, int nt, int h, int m, int co) {
    if (w0 + m < W)
      st2(du + (row_base + w0 + m) * C + co, f.acc[mt][nt][2 * h], f.acc[mt][nt][2 * h + 1]);
  });
}

// ---- K3, launch 3: weight-gradient partials --------------------------------------------------
// Each weight gradient is [pixels x C]^T [pixels x C]: M = ci, N = co, K = pixels. A CTA
// computes CO columns of one matrix (C = 128: two CTAs, one per half) over a fixed set of pixel
// tiles, each TP pixels of one image row (the last tile of a row masks its edge); the warps tile
// the output WM (ci) x WN (co), and at C = 16 the 8 warps split each tile's k8 steps and are
// summed in a fixed order at the end.
template <int C>
struct WG {
  static constexpr int HALVES = C >= 128 ? 2 : 1;
  static constexpr int CO = C / HALVES;             // output columns per CTA
  static constexpr int KS = C == 16 ? 8 : 1;        // warps splitting the k8 steps
  static constexpr int MT = C == 16 ? 1 : 2;
  static constexpr int NT = C >= 128 ? 4 : 2;
  static constexpr int WN = CO / (8 * NT);          // 2, 4, 1 for C = 128, 64, 16
  static constexpr int WM = C / (16 * MT);          // 4, 2, 1
  static constexpr int TP = C == 16 ? 128 : 32;     // pixels per staged tile
  static constexpr int LDA = C + 8, LDB = CO + 8;   // A tile [TP][LDA], B tile [TP][LDB]
  static constexpr int B_OFF = TP * LDA;            // stage: A then B
  static constexpr int STAGE = B_OFF + TP * LDB;
  static constexpr int BV = CO / 4;                 // float4 per pixel of a B tile
  static constexpr int DL = kThreads / BV;          // db31 lanes, 4 channels each
  static constexpr int RED = KS > 1 ? KS * C * C : 0;  // floats of the per-warp sums
  static_assert(WM * WN * KS * 32 == kThreads && (TP / 8) % KS == 0, "wgrad tile shape");
  static_assert(kThreads % BV == 0 && (TP * BV) % kThreads == 0, "db31 lanes");
  static_assert(RED + DL * CO <= kStages * STAGE, "the epilogue reuses the stage buffers");
};

// Offsets in the gradient vector [dw31 3C^2 | dw13 3C^2 | db31 C | drap C^2].
__host__ __device__ constexpr size_t grad_offset(int mat, int C) {
  return mat < 6 ? static_cast<size_t>(mat) * C * C : static_cast<size_t>(6) * C * C + C;
}

// Pixel tiles of the weight-gradient grid: TP pixels of one image row each.
__host__ __device__ __forceinline__ int row_tiles(int w, int tp) { return (w + tp - 1) / tp; }

// Matrix `mat` = blockIdx.y: 0-2 dw31[k] (A = u at row r+(k-1)d, B = dc), 3-5 dw13[k] (A = c at
// column w+(k-1)d, B = gy), 6 drap (A = u, B = gy); matrix 1 also sums db31 = sum dc. Columns
// blockIdx.z * CO onwards. CTA blockIdx.x of P takes pixel tiles blockIdx.x, blockIdx.x + P, ...
template <int C>
__global__ void __launch_bounds__(kThreads)
bwd_wgrad_kernel(const float* __restrict__ raw, const float* __restrict__ pa,
                 const float* __restrict__ pb, const float* __restrict__ cbuf,
                 const float* __restrict__ dc, const float* __restrict__ gy,
                 float* __restrict__ part, size_t part_len, int N, int H, int W, int d) {
  using K = WG<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int AV = C / 4, BV = K::BV;

  const int mat = blockIdx.y, P = gridDim.x, co0 = blockIdx.z * K::CO;
  const int warp = threadIdx.x >> 5, kw = warp % K::KS, wmn = warp / K::KS;
  const int wm = wmn % K::WM, wn = wmn / K::WM;
  const int tpr = row_tiles(W, K::TP), ntiles = N * H * tpr;
  const int mine = (ntiles - static_cast<int>(blockIdx.x) + P - 1) / P;  // tiles of this CTA

  const bool a_is_c = mat >= 3 && mat < 6;
  const float* asrc = a_is_c ? cbuf : raw;
  const float* bsrc = mat < 3 ? dc : gy;
  const float* apa = a_is_c ? nullptr : pa;
  const int drow = mat < 3 ? (mat - 1) * d : 0;
  const int dcol = a_is_c ? (mat - 4) * d : 0;

  // The CTA's tiles blockIdx.x, blockIdx.x + P, ... in order, walked without a division per
  // tile: a step of P tiles is step_w tile columns and step_r rows, plus the carries.
  struct TileAt {
    int n, r, w0;  // image, row and first column of the tile
  };
  const int step_r = P / tpr, step_w = (P - step_r * tpr) * K::TP;
  auto first_tile = [&]() {
    const int t = static_cast<int>(blockIdx.x), nr = t / tpr, n = nr / H;
    return TileAt{n, nr - n * H, (t - nr * tpr) * K::TP};
  };
  auto advance = [&](TileAt& ta) {
    ta.w0 += step_w;
    ta.r += step_r;
    if (ta.w0 >= tpr * K::TP) {
      ta.w0 -= tpr * K::TP;
      ++ta.r;
    }
    while (ta.r >= H) {
      ta.r -= H;
      ++ta.n;
    }
  };
  TileAt fetched = first_tile(), fixed = fetched;  // the next tile to fetch / to fix up
  // source of A element group idx of the tile, or null for zero padding / past the row's end
  auto a_src = [&](TileAt ta, int idx) -> const float* {
    const int w = ta.w0 + idx / AV, ac = w + dcol, ar = ta.r + drow;
    if (w >= W || ar < 0 || ar >= H || ac < 0 || ac >= W) return nullptr;
    return asrc + ((static_cast<size_t>(ta.n) * H + ar) * W + ac) * C + (idx % AV) * 4;
  };
  auto a_dst = [&](int buf, int idx) {
    return smem + buf * K::STAGE + (idx / AV) * K::LDA + (idx % AV) * 4;
  };
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto b_dst = [&](int buf, int idx) {
    return smem + buf * K::STAGE + K::B_OFF + (idx / BV) * K::LDB + (idx % BV) * 4;
  };
  auto fetch = [&](int, int buf) {  // called for stages 0, 1, ... in order
    const TileAt ta = fetched;
    advance(fetched);
    for (int idx = threadIdx.x; idx < K::TP * AV; idx += kThreads) {
      const float* src = a_src(ta, idx);
      if (src != nullptr) cp_async16(a_dst(buf, idx), src);
      else st4(a_dst(buf, idx), zero4);
    }
    const float* brow = bsrc + (static_cast<size_t>(ta.n) * H + ta.r) * W * C + co0;
    for (int idx = threadIdx.x; idx < K::TP * BV; idx += kThreads) {
      const int p = idx / BV;
      if (ta.w0 + p < W) cp_async16(b_dst(buf, idx), brow + static_cast<size_t>(ta.w0 + p) * C + (idx % BV) * 4);
      else st4(b_dst(buf, idx), zero4);
    }
  };
  // db31 = sum dc: each thread sums the 4 channels (threadIdx.x % BV)*4.. of the B elements it
  // copied; the DL lanes are summed in a fixed order at the end
  float4 bsum = zero4;
  auto fixup = [&](int, int buf) {  // called for stages 0, 1, ... in order
    const TileAt ta = fixed;
    advance(fixed);
    if (apa != nullptr)
      for (int idx = threadIdx.x; idx < K::TP * AV; idx += kThreads)
        if (a_src(ta, idx) != nullptr) {
          float* p = a_dst(buf, idx);
          st4(p, pre4(ld4(p), apa, pb, (idx % AV) * 4));
        }
    if (mat == 1)
      for (int idx = threadIdx.x; idx < K::TP * BV; idx += kThreads) {
        const float4 v = ld4(b_dst(buf, idx));
        bsum = make_float4(bsum.x + v.x, bsum.y + v.y, bsum.z + v.z, bsum.w + v.w);
      }
  };

  Frag<K::MT, K::NT> f;
  f.zero();
  auto compute = [&](int, int buf) {
    const float* A = smem + buf * K::STAGE + wm * K::MT * 16;
    const float* B = smem + buf * K::STAGE + K::B_OFF + wn * K::NT * 8;
#pragma unroll
    for (int i = 0; i < K::TP / 8 / K::KS; ++i) {
      const int ks = kw + i * K::KS;
      if (i == 0)
        mma_k8<K::MT, K::NT, 1, K::LDA, K::LDB, true>(A + ks * 8 * K::LDA, B + ks * 8 * K::LDB,
                                                      f.loc);
      else
        mma_k8<K::MT, K::NT, 1, K::LDA, K::LDB, false>(A + ks * 8 * K::LDA, B + ks * 8 * K::LDB,
                                                       f.loc);
    }
    f.flush();
  };
  pipeline(mine, fetch, fixup, compute);

  // fragment element (mt, nt, i): ci = wm*16MT + mt*16 + g + 8(i/2), co = wn*8NT + nt*8 + 2t + i%2
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* out = part + static_cast<size_t>(blockIdx.x) * part_len + grad_offset(mat, C);
  float* red = smem;  // [KS][C][C] (KS > 1)
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = wm * K::MT * 16 + mt * 16 + g + 8 * h;
        const int co = co0 + wn * K::NT * 8 + nt * 8 + 2 * t;
        const float x = f.acc[mt][nt][2 * h], y = f.acc[mt][nt][2 * h + 1];
        if constexpr (K::KS == 1) st2(out + ci * C + co, x, y);
        else st2(red + (kw * C + ci) * C + co, x, y);
      }
  if constexpr (K::KS > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < C * C; e += kThreads) {
      float sum = 0.f;
      for (int k = 0; k < K::KS; ++k) sum += red[k * C * C + e];
      out[e] = sum;
    }
  }
  if (mat == 1) {
    float* rb = smem + K::RED;  // [DL][CO]
    st4(rb + (threadIdx.x / BV) * K::CO + (threadIdx.x % BV) * 4, bsum);
    __syncthreads();
    float* db = part + static_cast<size_t>(blockIdx.x) * part_len + static_cast<size_t>(6) * C * C;
    for (int c = threadIdx.x; c < K::CO; c += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < K::DL; ++l) sum += rb[l * K::CO + c];
      db[co0 + c] = sum;
    }
  }
}

// ---- fixed-order sum of partials: out[l] = sum_p part[p * len + l], in double --------------
constexpr int kRedCols = 32, kRedSlices = kThreads / kRedCols;

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ part, int P, size_t len, float* __restrict__ out) {
  __shared__ double red[kRedSlices][kRedCols];
  const int col = threadIdx.x % kRedCols, slice = threadIdx.x / kRedCols;
  const size_t l = static_cast<size_t>(blockIdx.x) * kRedCols + col;
  double acc = 0.0;
  if (l < len)
    for (int p = slice; p < P; p += kRedSlices) acc += part[static_cast<size_t>(p) * len + l];
  red[slice][col] = acc;
  __syncthreads();
  if (slice == 0 && l < len) {
    double t = 0.0;
    for (int s = 0; s < kRedSlices; ++s) t += red[s][col];
    out[l] = static_cast<float>(t);
  }
}

cudaError_t launch_reduce(const float* part, int P, size_t len, float* out, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((len + kRedCols - 1) / kRedCols);
  reduce_kernel<<<blocks, kThreads, 0, s>>>(part, P, len, out);
  return cudaGetLastError();
}

template <int C>
size_t fwd_partials(int n, int h, int w) {
  const dim3 g = pair_grid<C>(n, h, w);
  return static_cast<size_t>(g.x) * g.y * g.z;
}

template <int C>
int wgrad_ctas(int n, int h, int w) {
  const long long ntiles = static_cast<long long>(n) * h * row_tiles(w, WG<C>::TP);
  return static_cast<int>(ntiles < 64 ? ntiles : 64);
}

size_t grad_len(int C, bool rap) {
  return static_cast<size_t>(6) * C * C + C + (rap ? static_cast<size_t>(C) * C : 0);
}

template <int C>
cudaError_t fwd(const float* x, const float* w31, const float* b31, const float* w13,
                const float* rap, const float* pa, const float* pb, float* y, float* stats,
                float* scratch, int n, int h, int w, int d, cudaStream_t s) {
  // the ring and c; a halo past the card's shared memory per block fails here
  const size_t smem = pair_smem_bytes<C>(d);
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fwd_pair_mma_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  fwd_pair_mma_kernel<C><<<pair_grid<C>(n, h, w), kThreads, smem, s>>>(x, w31, b31, w13, rap, pa,
                                                                       pb, y, scratch, h, w, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, static_cast<int>(fwd_partials<C>(n, h, w)), 2 * C, stats, s);
}

template <int C>
cudaError_t bwd(const float* raw, const float* gy, const float* w31, const float* b31,
                const float* w13t, const float* w31t, const float* rapt, const float* pa,
                const float* pb, float* du, float* grads, float* scratch, int n, int h, int w,
                int d, cudaStream_t s) {
  using K = TC<C>;
  using WK = WG<C>;
  // the weight-gradient kernel indexes pixels with int
  if (static_cast<long long>(n) * h * w > INT_MAX) return cudaErrorInvalidValue;
  const size_t act = static_cast<size_t>(n) * h * w * C;
  float* cbuf = scratch;
  float* dc = scratch + act;
  float* part = scratch + 2 * act;
  const dim3 grid((w + K::TM - 1) / K::TM, h, n);

  size_t smem = sizeof(float) * kStages * K::STAGE;
  cudaError_t err = set_smem(bwd_dc_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  bwd_dc_kernel<C><<<grid, kThreads, smem, s>>>(raw, gy, w31, b31, w13t, pa, pb, cbuf, dc, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(bwd_du_kernel<C>, smem)) != cudaSuccess) return err;
  bwd_du_kernel<C><<<grid, kThreads, smem, s>>>(dc, gy, w31t, rapt, du, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const bool rap = rapt != nullptr;
  const size_t len = grad_len(C, rap);
  const int P = wgrad_ctas<C>(n, h, w);
  smem = sizeof(float) * kStages * WK::STAGE;
  if ((err = set_smem(bwd_wgrad_kernel<C>, smem)) != cudaSuccess) return err;
  bwd_wgrad_kernel<C><<<dim3(P, rap ? 7 : 6, WK::HALVES), kThreads, smem, s>>>(
      raw, pa, pb, cbuf, dc, gy, part, len, n, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(part, P, len, grads, s);
}

// ---- bfloat16: K2 and K3 on bf16 mma.sync with fp32 accumulators (bf16_pair.cuh) ----------

// K2 in bf16: the bf16 pair mainloop (K1's, with the pre-stage), then y rounded to bf16 and the
// CTA's [2][C] partial sum and sum of squares of the ROUNDED y (what the next pair and the BN glue
// read, nb1d_train.py:162-165), over its columns inside the image: per thread, over the 8 lanes of
// each channel pair (a fixed shuffle tree), then over the warp rows in order. Shared memory:
// bf16_pair_smem_bytes.
template <int C>
__global__ void __launch_bounds__(Mma<C>::THREADS, 512 / Mma<C>::THREADS)  // <= 128 registers
fwd_pair_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w31,
                     const float* __restrict__ b31, const bf16* __restrict__ w13,
                     const bf16* __restrict__ rap, const float* __restrict__ pa,
                     const float* __restrict__ pb, bf16* __restrict__ y,
                     float* __restrict__ part, int H, int W, int d) {
  using K = Mma<C>;
  extern __shared__ uint4 smem16[];
  bf16* smem = reinterpret_cast<bf16*>(smem16);
  const int w0 = blockIdx.x * K::TM;
  const size_t row_base = (static_cast<size_t>(blockIdx.z) * H + blockIdx.y) * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % K::WM, wn = warp / K::WM, g = lane >> 2, t = lane & 3;
  float acc[K::MT][K::NT][4];
  bf16_pair_mainloop<C>(smem, x, w31, b31, w13, rap, pa, pb, H, W, d, acc);

  float s[K::NT][2], q[K::NT][2];
#pragma unroll
  for (int nt = 0; nt < K::NT; ++nt) s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
#pragma unroll
  for (int i = 0; i < K::MT; ++i)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w0 + wm * K::MT * 16 + i * 16 + g + 8 * h;
        if (col >= W) continue;
        const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(y + (row_base + col) * C + co) = v;
        const float2 f = __bfloat1622float2(v);
        s[nt][0] += f.x;
        s[nt][1] += f.y;
        q[nt][0] += f.x * f.x;
        q[nt][1] += f.y * f.y;
      }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] += __shfl_xor_sync(0xffffffffu, s[nt][e], off);
        q[nt][e] += __shfl_xor_sync(0xffffffffu, q[nt][e], off);
      }
  float* red = reinterpret_cast<float*>(smem);  // [WM][2][C]; the ring is free after its last barrier
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt) {
      const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
      st2(red + (wm * 2 + 0) * C + co, s[nt][0], s[nt][1]);
      st2(red + (wm * 2 + 1) * C + co, q[nt][0], q[nt][1]);
    }
  __syncthreads();
  float* out = part + cta_index() * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += K::THREADS) {
    float sum = 0.f;
    for (int k = 0; k < K::WM; ++k) sum += red[k * 2 * C + i];
    out[i] = sum;
  }
}

// One tap of a bf16 conv launch of K3: output pixel (row, w0 + m) reads row[(w0 + m + shift) * C ..]
// (0 outside the image) against the weight rows w[ci][co].
struct Tap16 {
  const bf16* row;
  const bf16* w;
  int shift;
};

// acc += sum over the taps j < ntaps of A_j @ tap(j).w for the CTA's TM pixels w0 .. of one row,
// A_j through the pre-stage where pa is non-null; the tiles of the pair's stage B (Mma<C>), each
// tap's K streamed in chunks of KC input channels through the ring.
template <int C, typename TapFn>
__device__ __forceinline__ void conv_gemm_bf16(bf16* smem, TapFn tap, int ntaps, int w0, int W,
                                               const float* __restrict__ pa,
                                               const float* __restrict__ pb,
                                               float (&acc)[Mma<C>::MT][Mma<C>::NT][4]) {
  using K = Mma<C>;
  const int warp = threadIdx.x >> 5, wm = warp % K::WM, wn = warp / K::WM;
  pipeline(
      ntaps * K::NCH,
      [&](int s, int buf) {
        const Tap16 tp = tap(s / K::NCH);
        const int ci0 = (s % K::NCH) * K::KC;
        bf16* A = smem + buf * K::STAGE;
        fetch_rows<C>(A, tp.row + ci0, w0 + tp.shift, K::TM, W);
        fetch_weights<C>(A + K::B_OFF, tp.w + static_cast<size_t>(ci0) * C);
      },
      [&](int s, int buf) {
        pre_rows<C>(smem + buf * K::STAGE, w0 + tap(s / K::NCH).shift, K::TM, W, pa, pb,
                    (s % K::NCH) * K::KC);
      },
      [&](int, int buf) {
        const bf16* A = smem + buf * K::STAGE;
        warp_mma<K::KC, K::MT, K::NT, K::LDA, K::LDB>(acc, A + wm * K::MT * 16 * K::LDA, 16,
                                                      K::MT, A + K::B_OFF + wn * K::NT * 8);
      });
}

// K3 in bf16, launch 1: c (recomputed in K2's order, so for the same inputs the same bf16 c and
// the same side of each relu) written to a scratch buffer, its sign kept in registers; then
// dc = bf16(colconv_d^T(gy) * [c > 0]).
template <int C>
__global__ void __launch_bounds__(Mma<C>::THREADS, 2)
bwd_dc_bf16_kernel(const bf16* __restrict__ raw, const bf16* __restrict__ gy,
                   const bf16* __restrict__ w31, const float* __restrict__ b31,
                   const bf16* __restrict__ w13t, const float* __restrict__ pa,
                   const float* __restrict__ pb, bf16* __restrict__ cbuf, bf16* __restrict__ dc,
                   int H, int W, int d) {
  using K = Mma<C>;
  extern __shared__ uint4 smem16[];
  bf16* smem = reinterpret_cast<bf16*>(smem16);
  const int w0 = blockIdx.x * K::TM, r = blockIdx.y;
  const size_t img_row0 = static_cast<size_t>(blockIdx.z) * H;
  const size_t row_base = (img_row0 + r) * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % K::WM, wn = warp / K::WM, g = lane >> 2, t = lane & 3;
  static_assert(K::MT * K::NT * 4 <= 32, "one sign bit per fragment element");

  const int k0 = r - d < 0 ? 1 : 0, k1 = r + d >= H ? 1 : 2;  // row taps inside the image
  float acc[K::MT][K::NT][4];
  zero_frags(acc);
  conv_gemm_bf16<C>(
      smem,
      [&](int j) {
        const int tap = k0 + j;
        return Tap16{raw + (img_row0 + r + (tap - 1) * d) * W * C,
                     w31 + static_cast<size_t>(tap) * C * C, 0};
      },
      k1 - k0 + 1, w0, W, pa, pb, acc);
  uint32_t pos = 0;  // bit (i*NT + nt)*4 + e: c > 0
#pragma unroll
  for (int i = 0; i < K::MT; ++i)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w0 + wm * K::MT * 16 + i * 16 + g + 8 * h;
        const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
        const float2 bias = *reinterpret_cast<const float2*>(b31 + co);
        const __nv_bfloat162 cv = __floats2bfloat162_rn(fmaxf(acc[i][nt][2 * h] + bias.x, 0.f),
                                                        fmaxf(acc[i][nt][2 * h + 1] + bias.y, 0.f));
        const float2 cf = __bfloat1622float2(cv);
        const int bit = (i * K::NT + nt) * 4 + 2 * h;
        pos |= (cf.x > 0.f ? 1u : 0u) << bit;
        pos |= (cf.y > 0.f ? 1u : 0u) << (bit + 1);
        if (col < W) *reinterpret_cast<__nv_bfloat162*>(cbuf + (row_base + col) * C + co) = cv;
      }

  // g = colconv_d^T(gy): the 1x3 conv of gy with the transposed, tap-reversed stack
  zero_frags(acc);
  conv_gemm_bf16<C>(
      smem,
      [&](int j) {
        return Tap16{gy + row_base * C, w13t + static_cast<size_t>(j) * C * C, (j - 1) * d};
      },
      3, w0, W, nullptr, nullptr, acc);
#pragma unroll
  for (int i = 0; i < K::MT; ++i)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w0 + wm * K::MT * 16 + i * 16 + g + 8 * h;
        if (col >= W) continue;
        const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
        const int bit = (i * K::NT + nt) * 4 + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dc + (row_base + col) * C + co) =
            __floats2bfloat162_rn((pos >> bit) & 1u ? acc[i][nt][2 * h] : 0.f,
                                  (pos >> (bit + 1)) & 1u ? acc[i][nt][2 * h + 1] : 0.f);
      }
}

// K3 in bf16, launch 2: du = bf16(rowconv_d^T(dc) [+ gy @ rap^T]).
template <int C>
__global__ void __launch_bounds__(Mma<C>::THREADS, 2)
bwd_du_bf16_kernel(const bf16* __restrict__ dc, const bf16* __restrict__ gy,
                   const bf16* __restrict__ w31t, const bf16* __restrict__ rapt,
                   bf16* __restrict__ du, int H, int W, int d) {
  using K = Mma<C>;
  extern __shared__ uint4 smem16[];
  bf16* smem = reinterpret_cast<bf16*>(smem16);
  const int w0 = blockIdx.x * K::TM, r = blockIdx.y;
  const size_t img_row0 = static_cast<size_t>(blockIdx.z) * H;
  const size_t row_base = (img_row0 + r) * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % K::WM, wn = warp / K::WM, g = lane >> 2, t = lane & 3;

  // the row taps k0 .. k1 inside the image, then RAP on gy's own row
  const int k0 = r - d < 0 ? 1 : 0, k1 = r + d >= H ? 1 : 2, nrow = k1 - k0 + 1;
  float acc[K::MT][K::NT][4];
  zero_frags(acc);
  conv_gemm_bf16<C>(
      smem,
      [&](int j) {
        return j < nrow ? Tap16{dc + (img_row0 + r + (k0 + j - 1) * d) * W * C,
                                w31t + static_cast<size_t>(k0 + j) * C * C, 0}
                        : Tap16{gy + row_base * C, rapt, 0};
      },
      nrow + (rapt != nullptr ? 1 : 0), w0, W, nullptr, nullptr, acc);
#pragma unroll
  for (int i = 0; i < K::MT; ++i)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w0 + wm * K::MT * 16 + i * 16 + g + 8 * h;
        if (col >= W) continue;
        const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(du + (row_base + col) * C + co) =
            __floats2bfloat162_rn(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
      }
}

// K3 in bf16, launch 3: weight-gradient partials, as bwd_wgrad_kernel tiles them (M = ci, N = co,
// K = pixels; a fixed grid of P CTAs per matrix, two per matrix at C = 128, one per half of the
// columns; tiles of TP pixels of one image row) but on bf16 mma.sync: the A tile [pixel][ci] is
// read transposed by ldmatrix, the B tile [pixel][co] as the pair's weights are. Each CTA sums
// its tiles in the fp32 accumulators; at C = 16 the 8 warps split each tile's k16 steps and are
// summed in a fixed order at the end.
template <int C>
struct WG16 {
  static constexpr int HALVES = C >= 128 ? 2 : 1;
  static constexpr int CO = C / HALVES;             // output columns per CTA
  static constexpr int KS = C == 16 ? 8 : 1;        // warps splitting the k16 steps
  static constexpr int MT = C == 16 ? 1 : 2;
  static constexpr int NT = C >= 128 ? 4 : 2;
  static constexpr int WN = CO / (8 * NT);          // 2, 4, 1 for C = 128, 64, 16
  static constexpr int WM = C / (16 * MT);          // 4, 2, 1
  static constexpr int TP = C == 16 ? 128 : 64;     // pixels per staged tile
  static constexpr int LDA = C + 8, LDB = CO + 8;   // bf16: A tile [TP][LDA], B tile [TP][LDB]
  static constexpr int B_OFF = TP * LDA;            // stage: A then B
  static constexpr int STAGE = B_OFF + TP * LDB;
  static constexpr int AV = C / 8, BV = CO / 8;     // 16-byte groups per pixel of a tile
  static constexpr int DL = kThreads / BV;          // db31 lanes, 8 channels each
  static constexpr int RED = KS > 1 ? KS * C * C : 0;  // floats of the per-warp sums
  static_assert(WM * WN * KS * 32 == kThreads && (TP / 16) % KS == 0 && NT % 2 == 0,
                "wgrad tile shape");
  static_assert(kThreads % BV == 0 && (TP * BV) % kThreads == 0, "db31 lanes");
  static_assert(4 * (RED + DL * CO) <= 2 * kStages * STAGE, "the epilogue reuses the ring");
};

// The pixel tiles blockIdx.x, blockIdx.x + P, ... of a weight-gradient CTA in order (TP pixels of
// one image row each), walked without a division per tile: a step of P tiles is step_w tile
// columns and step_r rows, plus the carries.
struct TileWalk {
  int n, r, w0;  // image, row and first column of the tile
  int step_r, step_w, span, H;
  __device__ TileWalk(int P, int tpr, int tp, int H_) : span(tpr * tp), H(H_) {
    const int t = static_cast<int>(blockIdx.x), nr = t / tpr;
    n = nr / H;
    r = nr - n * H;
    w0 = (t - nr * tpr) * tp;
    step_r = P / tpr;
    step_w = (P - step_r * tpr) * tp;
  }
  __device__ void advance() {
    w0 += step_w;
    r += step_r;
    if (w0 >= span) {
      w0 -= span;
      ++r;
    }
    while (r >= H) {
      r -= H;
      ++n;
    }
  }
};

// Matrix `mat` = blockIdx.y: 0-2 dw31[k] (A = u at row r+(k-1)d, B = dc), 3-5 dw13[k] (A = c at
// column w+(k-1)d, B = gy), 6 drap (A = u, B = gy); matrix 1 also sums db31 = sum dc. Columns
// blockIdx.z * CO onwards.
template <int C>
__global__ void __launch_bounds__(kThreads)
bwd_wgrad_bf16_kernel(const bf16* __restrict__ raw, const float* __restrict__ pa,
                      const float* __restrict__ pb, const bf16* __restrict__ cbuf,
                      const bf16* __restrict__ dc, const bf16* __restrict__ gy,
                      float* __restrict__ part, size_t part_len, int N, int H, int W, int d) {
  using K = WG16<C>;
  extern __shared__ uint4 smem16[];
  bf16* smem = reinterpret_cast<bf16*>(smem16);
  const int mat = blockIdx.y, P = gridDim.x, co0 = blockIdx.z * K::CO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp % K::KS, wmn = warp / K::KS, wm = wmn % K::WM, wn = wmn / K::WM;
  const int tpr = row_tiles(W, K::TP), ntiles = N * H * tpr;
  const int mine = (ntiles - static_cast<int>(blockIdx.x) + P - 1) / P;  // tiles of this CTA

  const bool a_is_c = mat >= 3 && mat < 6;
  const bf16* asrc = a_is_c ? cbuf : raw;
  const bf16* bsrc = mat < 3 ? dc : gy;
  const float* apa = a_is_c ? nullptr : pa;
  const int drow = mat < 3 ? (mat - 1) * d : 0;
  const int dcol = a_is_c ? (mat - 4) * d : 0;

  TileWalk fetched(P, tpr, K::TP, H), fixed = fetched;  // the next tile to fetch / to fix up
  // source of A group idx of the tile, or null for zero padding / past the row's end
  auto a_src = [&](const TileWalk& ta, int idx) -> const bf16* {
    const int w = ta.w0 + idx / K::AV, ac = w + dcol, ar = ta.r + drow;
    if (w >= W || ar < 0 || ar >= H || ac < 0 || ac >= W) return nullptr;
    return asrc + ((static_cast<size_t>(ta.n) * H + ar) * W + ac) * C + (idx % K::AV) * 8;
  };
  auto a_dst = [&](int buf, int idx) {
    return smem + buf * K::STAGE + (idx / K::AV) * K::LDA + (idx % K::AV) * 8;
  };
  auto b_dst = [&](int buf, int idx) {
    return smem + buf * K::STAGE + K::B_OFF + (idx / K::BV) * K::LDB + (idx % K::BV) * 8;
  };
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int, int buf) {  // called for stages 0, 1, ... in order
    const TileWalk ta = fetched;
    fetched.advance();
    for (int idx = threadIdx.x; idx < K::TP * K::AV; idx += kThreads) {
      const bf16* src = a_src(ta, idx);
      if (src != nullptr) cp_async16(a_dst(buf, idx), src);
      else *reinterpret_cast<uint4*>(a_dst(buf, idx)) = zero;
    }
    const bf16* brow = bsrc + (static_cast<size_t>(ta.n) * H + ta.r) * W * C + co0;
    for (int idx = threadIdx.x; idx < K::TP * K::BV; idx += kThreads) {
      const int p = idx / K::BV;
      if (ta.w0 + p < W)
        cp_async16(b_dst(buf, idx), brow + static_cast<size_t>(ta.w0 + p) * C + (idx % K::BV) * 8);
      else *reinterpret_cast<uint4*>(b_dst(buf, idx)) = zero;
    }
  };
  // db31 = sum dc: each thread sums the 8 channels (threadIdx.x % BV)*8.. of the B groups it
  // copied; the DL lanes are summed in a fixed order at the end
  float bsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto fixup = [&](int, int buf) {  // called for stages 0, 1, ... in order
    const TileWalk ta = fixed;
    fixed.advance();
    if (apa != nullptr)
      for (int idx = threadIdx.x; idx < K::TP * K::AV; idx += kThreads)
        if (a_src(ta, idx) != nullptr) pre8(a_dst(buf, idx), apa, pb, (idx % K::AV) * 8);
    if (mat == 1)
      for (int idx = threadIdx.x; idx < K::TP * K::BV; idx += kThreads) {
        uint4 raw8 = *reinterpret_cast<const uint4*>(b_dst(buf, idx));
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          bsum[2 * e] += f.x;
          bsum[2 * e + 1] += f.y;
        }
      }
  };

  float acc[K::MT][K::NT][4];
  zero_frags(acc);
  const int j = lane >> 3, r8 = lane & 7;
  auto compute = [&](int, int buf) {
    const bf16* A = smem + buf * K::STAGE;
    const bf16* B = A + K::B_OFF + wn * K::NT * 8;
#pragma unroll
    for (int i = 0; i < K::TP / 16 / K::KS; ++i) {
      const int k0 = (kw + i * K::KS) * 16;
      uint32_t bf[K::NT][2];
      load_b_frags<K::NT, K::LDB>(bf, B, k0);
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) {
        // A^T: matrix j holds ci 8(j%2) .., pixels 8(j/2) ..; its rows in memory are pixels
        uint32_t af[4];
        ldsm_x4_trans(af, A + (k0 + (j >> 1) * 8 + r8) * K::LDA + wm * K::MT * 16 + mt * 16 +
                              (j & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < K::NT; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
      }
    }
  };
  pipeline(mine, fetch, fixup, compute);

  // fragment element (mt, nt, e): ci = wm*16MT + mt*16 + g + 8(e/2), co = wn*8NT + nt*8 + 2t + e%2
  const int g = lane >> 2, t = lane & 3;
  float* out = part + static_cast<size_t>(blockIdx.x) * part_len + grad_offset(mat, C);
  float* red = reinterpret_cast<float*>(smem);  // [KS][C][C] (KS > 1)
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = wm * K::MT * 16 + mt * 16 + g + 8 * h;
        const int co = co0 + wn * K::NT * 8 + nt * 8 + 2 * t;
        const float a0 = acc[mt][nt][2 * h], a1 = acc[mt][nt][2 * h + 1];
        if constexpr (K::KS == 1) st2(out + ci * C + co, a0, a1);
        else st2(red + (kw * C + ci) * C + co, a0, a1);
      }
  if constexpr (K::KS > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < C * C; e += kThreads) {
      float sum = 0.f;
      for (int k = 0; k < K::KS; ++k) sum += red[k * C * C + e];
      out[e] = sum;
    }
  }
  if (mat == 1) {
    float* rb = red + K::RED;  // [DL][CO]
    float* mine8 = rb + (threadIdx.x / K::BV) * K::CO + (threadIdx.x % K::BV) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) mine8[e] = bsum[e];
    __syncthreads();
    float* db = part + static_cast<size_t>(blockIdx.x) * part_len + static_cast<size_t>(6) * C * C;
    for (int c = threadIdx.x; c < K::CO; c += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < K::DL; ++l) sum += rb[l * K::CO + c];
      db[co0 + c] = sum;
    }
  }
}

template <int C>
size_t fwd_bf16_partials(int n, int h, int w) {
  const dim3 g = bf16_pair_grid<C>(n, h, w);
  return static_cast<size_t>(g.x) * g.y * g.z;
}

template <int C>
int wgrad_bf16_ctas(int n, int h, int w) {
  const long long ntiles = static_cast<long long>(n) * h * row_tiles(w, WG16<C>::TP);
  return static_cast<int>(ntiles < 64 ? ntiles : 64);
}

template <int C>
cudaError_t fwd_bf16(const bf16* x, const bf16* w31, const float* b31, const bf16* w13,
                     const bf16* rap, const float* pa, const float* pb, bf16* y, float* stats,
                     float* scratch, int n, int h, int w, int d, cudaStream_t s) {
  // shared memory: the ring and c (a halo too wide for a block fails at the attribute)
  const size_t smem = bf16_pair_smem_bytes<C>(d);
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fwd_pair_bf16_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  fwd_pair_bf16_kernel<C><<<bf16_pair_grid<C>(n, h, w), Mma<C>::THREADS, smem, s>>>(
      x, w31, b31, w13, rap, pa, pb, y, scratch, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(scratch, static_cast<int>(fwd_bf16_partials<C>(n, h, w)), 2 * C, stats, s);
}

template <int C>
cudaError_t bwd_bf16(const bf16* raw, const bf16* gy, const bf16* w31, const float* b31,
                     const bf16* w13t, const bf16* w31t, const bf16* rapt, const float* pa,
                     const float* pb, bf16* du, float* grads, float* scratch, int n, int h,
                     int w, int d, cudaStream_t s) {
  // the weight-gradient kernel indexes pixels with int
  if (static_cast<long long>(n) * h * w > INT_MAX) return cudaErrorInvalidValue;
  const size_t act = static_cast<size_t>(n) * h * w * C;
  bf16* cbuf = reinterpret_cast<bf16*>(scratch);
  bf16* dc = cbuf + act;
  float* part = scratch + act;  // after c and dc: 2 * act bf16 = act floats
  const dim3 grid = bf16_pair_grid<C>(n, h, w);

  size_t smem = sizeof(bf16) * kStages * Mma<C>::STAGE;
  cudaError_t err = set_smem(bwd_dc_bf16_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  bwd_dc_bf16_kernel<C><<<grid, Mma<C>::THREADS, smem, s>>>(raw, gy, w31, b31, w13t, pa, pb, cbuf,
                                                            dc, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(bwd_du_bf16_kernel<C>, smem)) != cudaSuccess) return err;
  bwd_du_bf16_kernel<C><<<grid, Mma<C>::THREADS, smem, s>>>(dc, gy, w31t, rapt, du, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const bool rap = rapt != nullptr;
  const size_t len = grad_len(C, rap);
  const int P = wgrad_bf16_ctas<C>(n, h, w);
  smem = sizeof(bf16) * kStages * WG16<C>::STAGE;
  if ((err = set_smem(bwd_wgrad_bf16_kernel<C>, smem)) != cudaSuccess) return err;
  bwd_wgrad_bf16_kernel<C><<<dim3(P, rap ? 7 : 6, WG16<C>::HALVES), kThreads, smem, s>>>(
      raw, pa, pb, cbuf, dc, gy, part, len, n, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(part, P, len, grads, s);
}

// f(std::integral_constant<int, C>{}) for the supported channel counts, else invalid
template <typename F>
cudaError_t by_channels(int channels, F f) {
  switch (channels) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int n, int h, int w, int d) {
  return n <= 0 || h <= 0 || w <= 0 || d <= 0 || h > 65535 || n > 65535;
}

}  // namespace

// Floats of scratch nb1d_train_fwd needs (the per-CTA partial stats); -1 for an unsupported C.
extern "C" long long nb1d_train_fwd_scratch(int channels, int n, int h, int w) {
  switch (channels) {
    case 16: return static_cast<long long>(fwd_partials<16>(n, h, w)) * 2 * 16;
    case 64: return static_cast<long long>(fwd_partials<64>(n, h, w)) * 2 * 64;
    case 128: return static_cast<long long>(fwd_partials<128>(n, h, w)) * 2 * 128;
    default: return -1;
  }
}

// K2 on the given stream; allocates nothing, does not synchronise. x, y: float32 NHWC
// [n, h, w, C]; w31, w13: tap-stacked [3C][C]; b31, pa, pb: [C]; rap: [C][C] ([ci][co]); rap
// and pa/pb may be null. stats: [2][C] (sum, sum of squares of y over n*h*w). scratch: the
// floats nb1d_train_fwd_scratch gives. Returns the cudaError_t of the launches (0 on success).
extern "C" int nb1d_train_fwd(int channels, const void* x, const void* w31, const void* b31,
                              const void* w13, const void* rap, const void* pa, const void* pb,
                              void* y, void* stats, void* scratch, int n, int h, int w, int d,
                              void* stream) {
  if (bad_shape(n, h, w, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto c) {
    return fwd<decltype(c)::value>(
        static_cast<const float*>(x), static_cast<const float*>(w31),
        static_cast<const float*>(b31), static_cast<const float*>(w13),
        static_cast<const float*>(rap), static_cast<const float*>(pa),
        static_cast<const float*>(pb), static_cast<float*>(y), static_cast<float*>(stats),
        static_cast<float*>(scratch), n, h, w, d, s);
  };
  cudaError_t err;
  switch (channels) {
    case 16: err = f(std::integral_constant<int, 16>{}); break;
    case 64: err = f(std::integral_constant<int, 64>{}); break;
    case 128: err = f(std::integral_constant<int, 128>{}); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Floats of scratch nb1d_train_bwd needs: c and dc (n*h*w*C each) and the weight-gradient
// partials; -1 for an unsupported C.
extern "C" long long nb1d_train_bwd_scratch(int channels, int n, int h, int w, int rap) {
  const long long act = static_cast<long long>(n) * h * w * channels;
  long long ctas;
  switch (channels) {
    case 16: ctas = wgrad_ctas<16>(n, h, w); break;
    case 64: ctas = wgrad_ctas<64>(n, h, w); break;
    case 128: ctas = wgrad_ctas<128>(n, h, w); break;
    default: return -1;
  }
  return 2 * act + ctas * static_cast<long long>(grad_len(channels, rap != 0));
}

// Floats of the gradient vector nb1d_train_bwd writes: [dw31 3C^2 | dw13 3C^2 | db31 C | drap C^2]
// (drap only with rap).
extern "C" long long nb1d_train_grad_len(int channels, int rap) {
  return static_cast<long long>(grad_len(channels, rap != 0));
}

// K3 on the given stream. raw, gy, du: float32 NHWC; w31: the forward's stack (to recompute
// c); w13t, w31t: transposed tap-reversed stacks; rapt: rap^T or null; pa/pb: the pre-stage
// or null. grads: nb1d_train_grad_len floats, with dw31/dw13 as stacks [3][ci][co] and drap
// as [ci][co]. du is the gradient with respect to the pair's input after the pre-stage.
extern "C" int nb1d_train_bwd(int channels, const void* raw, const void* gy, const void* w31,
                              const void* b31, const void* w13t, const void* w31t,
                              const void* rapt, const void* pa, const void* pb, void* du,
                              void* grads, void* scratch, int n, int h, int w, int d,
                              void* stream) {
  if (bad_shape(n, h, w, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto c) {
    return bwd<decltype(c)::value>(
        static_cast<const float*>(raw), static_cast<const float*>(gy),
        static_cast<const float*>(w31), static_cast<const float*>(b31),
        static_cast<const float*>(w13t), static_cast<const float*>(w31t),
        static_cast<const float*>(rapt), static_cast<const float*>(pa),
        static_cast<const float*>(pb), static_cast<float*>(du), static_cast<float*>(grads),
        static_cast<float*>(scratch), n, h, w, d, s);
  };
  cudaError_t err;
  switch (channels) {
    case 16: err = f(std::integral_constant<int, 16>{}); break;
    case 64: err = f(std::integral_constant<int, 64>{}); break;
    case 128: err = f(std::integral_constant<int, 128>{}); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* nb1d_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch nb1d_train_fwd_bf16 needs (the per-CTA partial stats); -1 for an unsupported C.
extern "C" long long nb1d_train_fwd_bf16_scratch(int channels, int n, int h, int w) {
  switch (channels) {
    case 16: return static_cast<long long>(fwd_bf16_partials<16>(n, h, w)) * 2 * 16;
    case 64: return static_cast<long long>(fwd_bf16_partials<64>(n, h, w)) * 2 * 64;
    case 128: return static_cast<long long>(fwd_bf16_partials<128>(n, h, w)) * 2 * 128;
    default: return -1;
  }
}

// K2 in bf16, as nb1d_train_fwd with x, y, w31, w13 and rap in bf16 (b31, pa, pb, stats float32);
// the stats are the sums of the bf16 y.
extern "C" int nb1d_train_fwd_bf16(int channels, const void* x, const void* w31, const void* b31,
                                   const void* w13, const void* rap, const void* pa,
                                   const void* pb, void* y, void* stats, void* scratch, int n,
                                   int h, int w, int d, void* stream) {
  if (bad_shape(n, h, w, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_channels(channels, [&](auto c) {
    return fwd_bf16<decltype(c)::value>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w31),
        static_cast<const float*>(b31), static_cast<const bf16*>(w13),
        static_cast<const bf16*>(rap), static_cast<const float*>(pa),
        static_cast<const float*>(pb), static_cast<bf16*>(y), static_cast<float*>(stats),
        static_cast<float*>(scratch), n, h, w, d, s);
  }));
}

// Floats of scratch nb1d_train_bwd_bf16 needs: c and dc in bf16 (n*h*w*C each, n*h*w*C floats
// together) and the weight-gradient partials; -1 for an unsupported C.
extern "C" long long nb1d_train_bwd_bf16_scratch(int channels, int n, int h, int w, int rap) {
  const long long act = static_cast<long long>(n) * h * w * channels;
  long long ctas;
  switch (channels) {
    case 16: ctas = wgrad_bf16_ctas<16>(n, h, w); break;
    case 64: ctas = wgrad_bf16_ctas<64>(n, h, w); break;
    case 128: ctas = wgrad_bf16_ctas<128>(n, h, w); break;
    default: return -1;
  }
  return act + ctas * static_cast<long long>(grad_len(channels, rap != 0));
}

// K3 in bf16, as nb1d_train_bwd with raw, gy, du and the weight stacks in bf16 (b31, pa, pb and
// the gradient vector float32). du is rounded to bf16 once; the weight gradients are fp32 sums of
// bf16 products.
extern "C" int nb1d_train_bwd_bf16(int channels, const void* raw, const void* gy, const void* w31,
                                   const void* b31, const void* w13t, const void* w31t,
                                   const void* rapt, const void* pa, const void* pb, void* du,
                                   void* grads, void* scratch, int n, int h, int w, int d,
                                   void* stream) {
  if (bad_shape(n, h, w, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_channels(channels, [&](auto c) {
    return bwd_bf16<decltype(c)::value>(
        static_cast<const bf16*>(raw), static_cast<const bf16*>(gy),
        static_cast<const bf16*>(w31), static_cast<const float*>(b31),
        static_cast<const bf16*>(w13t), static_cast<const bf16*>(w31t),
        static_cast<const bf16*>(rapt), static_cast<const float*>(pa),
        static_cast<const float*>(pb), static_cast<bf16*>(du), static_cast<float*>(grads),
        static_cast<float*>(scratch), n, h, w, d, s);
  }));
}
