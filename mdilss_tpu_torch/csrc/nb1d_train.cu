// Training conv pair of the non-bottleneck-1d block, forward and backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of mdilss_tpu/ops/pallas/nb1d_train.py:
//
//   K2 _fwd_pair_kernel (entry fwd_pair):
//     u = pre ? relu(a * x + b) : x          (rows outside the image are zero padding)
//     c = relu(rowconv_d(u, w31) + b31)
//     y = colconv_d(c, w13) [+ u @ rap]      -> y and per-channel [2, C] sum / sum of squares
//                                              of y over the rows row0 .. row1 - 1 of each image
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
                    float* __restrict__ part, int H, int W, int d, int row0, int row1) {
  using B = K2B<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w0 = blockIdx.x * B::TM, r = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % B::WM, wn = warp / B::WM, g = lane >> 2, t = lane & 3;
  Frag<B::MT, B::NT> f;
  pair_mainloop<C>(smem, x, w31, b31, w13, rap, pa, pb, H, W, d, f);

  // ---- epilogue: write y; the CTA's [2][C] partial sum and sum of squares over its columns
  // inside the image (zero for a row outside the stats window), per thread, then over the 8
  // lanes of each channel pair (a fixed shuffle tree), then over the warp rows in order ----
  const size_t row_base = (static_cast<size_t>(n) * H + r) * W;
  const bool counted = r >= row0 && r < row1;
  float s[B::NT][2], q[B::NT][2];
#pragma unroll
  for (int nt = 0; nt < B::NT; ++nt) s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
  frag_pairs<B>(0, [&](int mt, int nt, int h, int m, int co) {
    if (w0 + m >= W) return;
    const float v0 = f.acc[mt][nt][2 * h], v1 = f.acc[mt][nt][2 * h + 1];
    st2(y + (row_base + w0 + m) * C + co, v0, v1);
    if (!counted) return;
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
                float* scratch, int n, int h, int w, int d, int row0, int row1, cudaStream_t s) {
  // the ring and c; a halo past the card's shared memory per block fails here
  const size_t smem = pair_smem_bytes<C>(d);
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fwd_pair_mma_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  fwd_pair_mma_kernel<C><<<pair_grid<C>(n, h, w), kThreads, smem, s>>>(
      x, w31, b31, w13, rap, pa, pb, y, scratch, h, w, d, row0, row1);
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
// K3 first: K2 (fwd_pair_bf16_kernel, after K3's kernels) walks K3's conv tiles.

// ---- K3 in bf16 ------------------------------------------------------------------------------
// Three launches and the fixed-order sum, as in fp32, redesigned for the H100:
//   k3_c_dc_bf16_kernel   c (recomputed in K2's order) written to a scratch buffer, then
//                         dc = bf16(colconv_d^T(gy) * [c > 0]);
//   k3_du_bf16_kernel     du = bf16(rowconv_d^T(dc) [+ gy @ rap^T]);
//   k3_wgrad_bf16_kernel  the weight-gradient partials of every matrix from one staging of each
//                         pixel tile's operands;
//   reduce_kernel         the partials summed in a fixed order.
// On the H100 the three launches are bound neither by the tensor cores nor by device memory: the
// mma.sync products with their ldmatrix loads, the operands' traffic from L2 into shared memory
// and the barrier of each ring stage take the time. The design cuts the traffic (each operand
// staged once per tile for every product that reads it, weights resident, halos) and the
// barriers (wide chunks, persistent CTAs); PERF.md has the measured split.
// The conv launches are persistent: a CTA walks the pixel tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... as one stream of ring stages (tile, tap, chunk of KC input channels), so the
// loads of the next tile overlap the products and the epilogue of this one; the grid is as many
// CTAs as fit on the card at once. Each output pixel is computed by one CTA in a fixed order, so
// the grid does not change a bit of the result.

// The conv launches' tiles, rings and resident weights. The warp tiles are Mma<C>'s (32 pixels x
// 8NT channels), with twice the pair's warps along the pixels: a tile of TM pixels of one row per
// CTA. A CTA keeps the weights of its products resident in shared memory for its whole walk
// (loaded once), except dc's w31 at C = 128, which does not fit beside w13t and the ring and is
// streamed a chunk per stage: so each weight is read once per CTA, not once per tile. A stage
// holds an A chunk (KC input channels of the TM pixels, or of TM + 2d for a halo of d <= DMAX
// columns on each side); the chunk is wider than the pair's (fewer stages and barriers per tile).
// None of this changes the k16 steps of any product, so c keeps the pair's order. A tile's
// outputs go through the stage buffer just multiplied and leave as 16-byte rows (conv_store):
// written straight from the fragments, each store would fill half a 32-byte sector.
template <int C>
struct ConvTiles {
  static constexpr int THREADS = 512;
  static constexpr int WM = THREADS / 32 / Mma<C>::WN;  // warps along the pixels: 4, 8, 16
  static constexpr int TM = WM * Mma<C>::MT * 16;       // pixels per tile: 128, 256, 512
  static constexpr int KC = C >= 64 ? 64 : C;           // input channels per stage
  static constexpr int NCH = C / KC;
  static constexpr int LDA = KC + 8;                    // an odd multiple of 16 bytes, as Mma<C>'s
  static constexpr int LDB = Mma<C>::LDB;               // weight rows [ci][LDB]
  static constexpr int LDO = C + 8;                     // the epilogue's tile [TM][LDO]
  static_assert(KC % 16 == 0 && C % KC == 0 && (LDA / 8) % 2 == 1, "conv chunk");
};

// Launch 1's shared memory: w13t [3C][LDB] (and w31 after it at C <= 64), then DEPTH stages of an
// A chunk [TM + 2 DMAX][LDA] (and at C = 128 a w31 chunk [KC][LDB]), each at least as large as
// the epilogue's tile.
template <int C>
struct DcRing : ConvTiles<C> {
  using T = ConvTiles<C>;
  static constexpr bool W31_RESIDENT = C <= 64;
  static constexpr int DMAX = 16;  // the widest halo a stage holds (the model's d <= 16)
  static constexpr int WRES = (W31_RESIDENT ? 6 : 3) * C * T::LDB;
  static constexpr int B_OFF = (T::TM + 2 * DMAX) * T::LDA;
  static constexpr int OPERANDS = B_OFF + (W31_RESIDENT ? 0 : T::KC * T::LDB);
  static constexpr int STAGE = OPERANDS > T::TM * T::LDO ? OPERANDS : T::TM * T::LDO;
  static constexpr int DEPTH = 3;  // 225.8 KB of shared memory at C = 128
  static constexpr size_t BYTES = sizeof(bf16) * (WRES + DEPTH * STAGE);
};

// Launch 2's shared memory: w31t [3C][LDB] and rapt [C][LDB], then DEPTH stages of an A chunk
// [TM][LDA], each as large as the epilogue's tile.
template <int C>
struct DuRing : ConvTiles<C> {
  using T = ConvTiles<C>;
  static constexpr int WRES = 4 * C * T::LDB;
  static constexpr int STAGE = T::TM * T::LDO;
  static constexpr int DEPTH = 2;  // a third stage does not fit beside the weights at C = 128
  static constexpr size_t BYTES = sizeof(bf16) * (WRES + DEPTH * STAGE);
  static_assert(T::LDA <= T::LDO, "an A chunk fits a stage");
};

// A chunk row m <- src_row[col0 + m, 0 : KC] for m < rows, 0 outside the image (columns 0 .. W-1)
template <int C>
__device__ __forceinline__ void conv_fetch_rows(bf16* A, const bf16* src_row, int col0, int W,
                                                int rows = ConvTiles<C>::TM) {
  using R = ConvTiles<C>;
  constexpr int AV = R::KC / 8;
  for (int idx = threadIdx.x; idx < rows * AV; idx += R::THREADS) {
    const int m = idx / AV, v = (idx % AV) * 8, col = col0 + m;
    bf16* dst = A + m * R::LDA + v;
    if (col >= 0 && col < W) cp_async16(dst, src_row + static_cast<size_t>(col) * C + v);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the pre-stage on the groups this thread copied with conv_fetch_rows(A, ., col0, W) from input
// channel ci0 on; nothing without one (pa null)
template <int C>
__device__ __forceinline__ void conv_pre_rows(bf16* A, int col0, int W,
                                              const float* __restrict__ pa,
                                              const float* __restrict__ pb, int ci0) {
  using R = ConvTiles<C>;
  constexpr int AV = R::KC / 8;
  if (pa == nullptr) return;
  for (int idx = threadIdx.x; idx < R::TM * AV; idx += R::THREADS) {
    const int m = idx / AV, v = (idx % AV) * 8, col = col0 + m;
    if (col >= 0 && col < W) pre8(A + m * R::LDA + v, pa, pb, ci0 + v);
  }
}

// rows rows of a [rows][C] weight matrix from w into B (row stride LDB), by THREADS threads
template <int C, int THREADS = ConvTiles<C>::THREADS>
__device__ __forceinline__ void conv_fetch_weights(bf16* B, const bf16* w, int rows) {
  constexpr int V = C / 8;
  for (int e = threadIdx.x; e < rows * V; e += THREADS) {
    const int row = e / V, c8 = (e % V) * 8;
    cp_async16(B + row * ConvTiles<C>::LDB + c8, w + static_cast<size_t>(row) * C + c8);
  }
}

// A conv launch's position in its CTA's walk: pixel tile t (TM columns w0 .. of image row `row`
// = n*H + r), tap j of the tile's n0 row taps k0 .. k0+n0-1 (the rows inside the image) and
// `extra` more, chunk ch. next() steps to the following stage.
struct ConvWalk {
  int t, row, r, w0, k0, n0, j, ch;
  int stride, tpr, tm, H, d, extra, nch;
  __device__ void tile(int t_) {
    t = t_;
    row = t / tpr;
    r = row % H;
    w0 = (t - row * tpr) * tm;
    k0 = r - d < 0 ? 1 : 0;
    n0 = (r + d >= H ? 1 : 2) - k0 + 1;
    j = ch = 0;
  }
  __device__ void next() {
    if (++ch < nch) return;
    ch = 0;
    if (++j < n0 + extra) return;
    tile(t + stride);
  }
  // the stages of the walk from tile blockIdx.x on
  __device__ int stages(int ntiles) const {
    ConvWalk w = *this;
    int s = 0;
    for (int u = static_cast<int>(blockIdx.x); u < ntiles; u += stride) {
      w.tile(u);
      s += (w.n0 + extra) * nch;
    }
    return s;
  }
};

template <int C>
__device__ ConvWalk conv_walk(int H, int W, int d, int extra) {
  ConvWalk w{};
  w.stride = static_cast<int>(gridDim.x);
  w.tm = ConvTiles<C>::TM;
  w.tpr = (W + ConvTiles<C>::TM - 1) / ConvTiles<C>::TM;
  w.H = H;
  w.d = d;
  w.extra = extra;
  w.nch = ConvTiles<C>::NCH;
  w.tile(static_cast<int>(blockIdx.x));
  return w;
}

// The tile's outputs, fn(i, nt, h) for the fragment pair (i, nt, 2h .. 2h+1) of each warp, through
// `stage` (the ring buffer just multiplied) to pixels w0 .. of image row `row` inside the image, of
// dst (an activation [N][H][W][C]), as 16-byte stores. The next refill of the buffer comes after
// the ring's next barrier.
template <int C, typename Fn>
__device__ __forceinline__ void conv_store(bf16* stage, bf16* __restrict__ dst, int row, int w0,
                                           int W, Fn fn) {
  using K = Mma<C>;
  using R = ConvTiles<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % R::WM, wn = warp / R::WM, g = lane >> 2, t = lane & 3;
  __syncthreads();  // every warp is done with the stage's operands
#pragma unroll
  for (int i = 0; i < K::MT; ++i)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(stage + (wm * K::MT * 16 + i * 16 + g + 8 * h) * R::LDO +
                                           wn * K::NT * 8 + nt * 8 + 2 * t) = fn(i, nt, h);
  __syncthreads();
  constexpr int V = C / 8;
  bf16* out = dst + (static_cast<size_t>(row) * W + w0) * C;
  for (int idx = threadIdx.x; idx < R::TM * V; idx += R::THREADS) {
    const int m = idx / V, v = (idx % V) * 8;
    if (w0 + m < W)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * C + v) =
          *reinterpret_cast<const uint4*>(stage + m * R::LDO + v);
  }
}

// acc += A[16MT rows of this warp from a][KC] @ B[KC][the warp's 8NT channels from b]
template <int C>
__device__ __forceinline__ void conv_mma(const bf16* a, const bf16* b,
                                         float (&acc)[Mma<C>::MT][Mma<C>::NT][4]) {
  using K = Mma<C>;
  using R = ConvTiles<C>;
  const int warp = threadIdx.x >> 5, wm = warp % R::WM, wn = warp / R::WM;
  warp_mma<R::KC, K::MT, K::NT, R::LDA, R::LDB>(acc, a + wm * K::MT * 16 * R::LDA, 16, K::MT,
                                                b + wn * K::NT * 8);
}

// Launch 1: per tile, GEMM 0 (the row taps k0 .. k0+n0-1 of w31 on u, through the pre-stage)
// then GEMM 1 (the 3 column taps of w13t on gy). GEMM 0 runs the taps, chunks and k16 steps of
// K2's stage A in K2's order into a fresh accumulator, so for the same inputs c is K2's bf16 c bit
// for bit and each relu takes the same side (card test test_bf16_fwd_and_bwd_compute_the_same_c).
// For d <= DMAX, GEMM 1 takes one stage per chunk: gy's TM + 2d columns w0-d .. once, tap k
// reading it from row k*d on; else a stage per tap and chunk.
template <int C>
__global__ void __launch_bounds__(ConvTiles<C>::THREADS, 1)
k3_c_dc_bf16_kernel(const bf16* __restrict__ raw, const bf16* __restrict__ gy,
                    const bf16* __restrict__ w31, const float* __restrict__ b31,
                    const bf16* __restrict__ w13t, const float* __restrict__ pa,
                    const float* __restrict__ pb, bf16* __restrict__ cbuf, bf16* __restrict__ dc,
                    int ntiles, int H, int W, int d) {
  using K = Mma<C>;
  using R = DcRing<C>;
  extern __shared__ uint4 smem16[];
  bf16* wres = reinterpret_cast<bf16*>(smem16);  // w13t, then w31 if resident
  bf16* ring = wres + R::WRES;
  conv_fetch_weights<C>(wres, w13t, 3 * C);
  if (R::W31_RESIDENT) conv_fetch_weights<C>(wres + 3 * C * R::LDB, w31, 3 * C);
  cp_async_commit();  // complete before the ring's first stage
  const bool halo = d <= R::DMAX;
  // fetch runs a stage ahead; fixup and multiply of a stage share a position
  ConvWalk fw = conv_walk<C>(H, W, d, halo ? 1 : 3), mw = fw;
  static_assert(K::MT * K::NT * 4 <= 32, "one sign bit per fragment element");
  const int co_base = (threadIdx.x >> 5) / R::WM * K::NT * 8 + 2 * (threadIdx.x & 3);
  float acc[K::MT][K::NT][4];
  zero_frags(acc);
  uint32_t pos = 0;  // bit (i*NT + nt)*4 + e: c > 0
  pipeline<R::DEPTH>(
      fw.stages(ntiles),
      [&](int, int buf) {
        bf16* A = ring + buf * R::STAGE;
        const int ci0 = fw.ch * R::KC;
        if (fw.j < fw.n0) {
          const int tap = fw.k0 + fw.j;
          conv_fetch_rows<C>(A, raw + static_cast<size_t>(fw.row + (tap - 1) * d) * W * C + ci0,
                             fw.w0, W);
          if (!R::W31_RESIDENT)
            conv_fetch_weights<C>(A + R::B_OFF, w31 + (static_cast<size_t>(tap) * C + ci0) * C,
                                  R::KC);
        } else {
          const int shift = halo ? -d : (fw.j - fw.n0 - 1) * d;
          conv_fetch_rows<C>(A, gy + static_cast<size_t>(fw.row) * W * C + ci0, fw.w0 + shift, W,
                             halo ? R::TM + 2 * d : R::TM);
        }
        fw.next();
      },
      [&](int, int buf) {
        if (mw.j < mw.n0) conv_pre_rows<C>(ring + buf * R::STAGE, mw.w0, W, pa, pb, mw.ch * R::KC);
      },
      [&](int, int buf) {
        bf16* stage = ring + buf * R::STAGE;
        const int ci0 = mw.ch * R::KC;
        if (mw.j < mw.n0) {
          const int tap = mw.k0 + mw.j;
          conv_mma<C>(stage, R::W31_RESIDENT ? wres + ((3 + tap) * C + ci0) * R::LDB
                                             : stage + R::B_OFF, acc);
        } else if (halo) {
          for (int k = 0; k < 3; ++k)
            conv_mma<C>(stage + k * d * R::LDA, wres + (k * C + ci0) * R::LDB, acc);
        } else {
          conv_mma<C>(stage, wres + ((mw.j - mw.n0) * C + ci0) * R::LDB, acc);
        }
        if (mw.ch == R::NCH - 1 && mw.j == mw.n0 - 1) {  // c = relu(acc + b31) as bf16
          pos = 0;
          conv_store<C>(stage, cbuf, mw.row, mw.w0, W, [&](int i, int nt, int h) {
            const float2 bias = *reinterpret_cast<const float2*>(b31 + co_base + nt * 8);
            const __nv_bfloat162 cv = __floats2bfloat162_rn(
                fmaxf(acc[i][nt][2 * h] + bias.x, 0.f), fmaxf(acc[i][nt][2 * h + 1] + bias.y, 0.f));
            const float2 cf = __bfloat1622float2(cv);
            const int bit = (i * K::NT + nt) * 4 + 2 * h;
            pos |= (cf.x > 0.f ? 1u : 0u) << bit | (cf.y > 0.f ? 1u : 0u) << (bit + 1);
            return cv;
          });
          zero_frags(acc);
        } else if (mw.ch == R::NCH - 1 && mw.j == mw.n0 + mw.extra - 1) {  // dc = g * [c > 0]
          conv_store<C>(stage, dc, mw.row, mw.w0, W, [&](int i, int nt, int h) {
            const int bit = (i * K::NT + nt) * 4 + 2 * h;
            return __floats2bfloat162_rn((pos >> bit) & 1u ? acc[i][nt][2 * h] : 0.f,
                                         (pos >> (bit + 1)) & 1u ? acc[i][nt][2 * h + 1] : 0.f);
          });
          zero_frags(acc);
        }
        mw.next();
      });
}

// Launch 2: per tile, the row taps k0 .. k0+n0-1 of w31t on dc, then RAP (rapt on gy's own row).
template <int C>
__global__ void __launch_bounds__(ConvTiles<C>::THREADS, 1)
k3_du_bf16_kernel(const bf16* __restrict__ dc, const bf16* __restrict__ gy,
                  const bf16* __restrict__ w31t, const bf16* __restrict__ rapt,
                  bf16* __restrict__ du, int ntiles, int H, int W, int d) {
  using K = Mma<C>;
  using R = DuRing<C>;
  extern __shared__ uint4 smem16[];
  bf16* wres = reinterpret_cast<bf16*>(smem16);  // w31t, then rapt
  bf16* ring = wres + R::WRES;
  conv_fetch_weights<C>(wres, w31t, 3 * C);
  if (rapt != nullptr) conv_fetch_weights<C>(wres + 3 * C * R::LDB, rapt, C);
  cp_async_commit();  // complete before the ring's first stage
  ConvWalk fw = conv_walk<C>(H, W, d, rapt != nullptr ? 1 : 0), mw = fw;
  float acc[K::MT][K::NT][4];
  zero_frags(acc);
  pipeline<R::DEPTH>(
      fw.stages(ntiles),
      [&](int, int buf) {
        const bool conv = fw.j < fw.n0;
        conv_fetch_rows<C>(ring + buf * R::STAGE,
                           (conv ? dc + static_cast<size_t>(fw.row + (fw.k0 + fw.j - 1) * d) * W * C
                                 : gy + static_cast<size_t>(fw.row) * W * C) +
                               fw.ch * R::KC,
                           fw.w0, W);
        fw.next();
      },
      [](int, int) {},
      [&](int, int buf) {
        bf16* stage = ring + buf * R::STAGE;
        const int wrow = (mw.j < mw.n0 ? (mw.k0 + mw.j) * C : 3 * C) + mw.ch * R::KC;
        conv_mma<C>(stage, wres + wrow * R::LDB, acc);
        if (mw.ch == R::NCH - 1 && mw.j == mw.n0 + mw.extra - 1) {
          conv_store<C>(stage, du, mw.row, mw.w0, W, [&](int i, int nt, int h) {
            return __floats2bfloat162_rn(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
          });
          zero_frags(acc);
        }
        mw.next();
      });
}

// Launch 3: the weight gradients, [pixels x C]^T [pixels x C] products (M = ci, N = co, K =
// pixels) on bf16 mma.sync, the A tiles [pixel][ci] read transposed by ldmatrix. Written so that
// the operands two matrices share are staged once:
//   dw31[k] = sum_s u[s]^T dc[s - (k-1)d]   (u at its own row, dc at rows s+d, s, s-d),
//   dw13[k] = sum_w c[w]^T gy[w - (k-1)d]   (c at its own column, gy at columns w+d, w, w-d),
//   drap    = sum u^T gy,   db31 = sum dc,
// zero outside the image. A CTA computes all 7 (6 without RAP) matrices for CO output columns:
// per pixel tile (TP pixels of one image row) it stages u and c at all C channels, dc at its three
// rows and gy once with a halo of d columns on each side (three shifted tiles for d > TP), each
// at its CO channels, once, and runs every product on them; at C = 128 the 4 column slices of
// one walker are neighbours in the grid, so they run together and the L2 serves their common u
// and c. The pre-stage's a and b of each thread's channels stay in registers. The grid is fixed by the shape (SLICES x P walkers, walker y taking tiles
// y, y + P, ...), each CTA writes its own partials and the fixed-order sum adds them: reruns are
// bitwise equal. At C = 16 the 8 warps split each tile's k16 steps and are summed in a fixed
// order at the end.
template <int C>
struct WG16 {
  static constexpr int THREADS = 256;
  static constexpr int CO = C >= 128 ? 32 : C;      // output columns per CTA
  static constexpr int SLICES = C / CO;             // CTAs per walker: 4, 1, 1
  static constexpr int WALKERS = C >= 128 ? 32 : 128;  // P at most
  static constexpr int KS = C == 16 ? 8 : 1;        // warps splitting the k16 steps
  static constexpr int MT = C == 16 ? 1 : 2;        // m16 (ci) tiles per warp
  static constexpr int NT = 2;                      // n8 (co) tiles per warp
  static constexpr int WM = C / (16 * MT);          // 4, 2, 1
  static constexpr int WN = CO / (8 * NT);          // 2, 4, 1
  static constexpr int TP = C == 16 ? 128 : 64;     // pixels per staged tile
  static constexpr int LDA = C + 8, LDB = CO + 8;   // bf16 row strides
  static constexpr int AV = C / 8, BV = CO / 8;     // 16-byte groups per pixel of a tile
  static constexpr int C_OFF = TP * LDA;            // stage: u [TP][LDA], c [TP][LDA],
  static constexpr int D_OFF = 2 * TP * LDA;        // dc at rows r+d, r, r-d ([TP][LDB] each),
  static constexpr int GY_OFF = D_OFF + 3 * TP * LDB;  // then gy, TP + 2d <= 3TP rows or 3 tiles
  static constexpr int STAGE = GY_OFF + 3 * TP * LDB;
  static constexpr int DL = THREADS / BV;           // db31 lanes, 8 channels each
  static constexpr int RED = KS > 1 ? KS * 7 * C * CO : 0;  // floats of the per-warp sums
  static constexpr size_t BYTES = sizeof(bf16) * kStages * STAGE;
  static_assert(WM * WN * KS * 32 == THREADS && (TP / 16) % KS == 0 && NT == 2, "wgrad tiles");
  static_assert(THREADS % BV == 0 && (TP * BV) % THREADS == 0, "db31 lanes");
  static_assert(THREADS % AV == 0 && (TP * AV) % THREADS == 0, "fixed u and c groups per thread");
  static_assert(sizeof(float) * (RED + DL * CO) <= BYTES, "the epilogue reuses the ring");
};

// The pixel tiles t, t + P, ... of a weight-gradient walker in order (TP pixels of one
// image row each), walked without a division per tile: a step of P tiles is step_w tile columns
// and step_r rows, plus the carries.
struct TileWalk {
  int n, r, w0;  // image, row and first column of the tile
  int step_r, step_w, span, H;
  __device__ TileWalk(int t, int P, int tpr, int tp, int H_) : span(tpr * tp), H(H_) {
    const int nr = t / tpr;
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

// relu(a * v + b) on the 8 bf16 values at p (16-byte aligned) as pre8 computes it, with the 8
// channels' a and b in registers
__device__ __forceinline__ void pre8_regs(bf16* p, const float (&a)[8], const float (&b)[8]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(a[2 * i], v.x), b[2 * i]), 0.f),
                                 fmaxf(__fadd_rn(__fmul_rn(a[2 * i + 1], v.y), b[2 * i + 1]), 0.f));
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <int C>
__global__ void __launch_bounds__(WG16<C>::THREADS, 1)
k3_wgrad_bf16_kernel(const bf16* __restrict__ raw, const float* __restrict__ pa,
                     const float* __restrict__ pb, const bf16* __restrict__ cbuf,
                     const bf16* __restrict__ dc, const bf16* __restrict__ gy, bool rap,
                     float* __restrict__ part, size_t part_len, int N, int H, int W, int d) {
  using K = WG16<C>;
  extern __shared__ uint4 smem16[];
  bf16* smem = reinterpret_cast<bf16*>(smem16);
  const int P = gridDim.y, co0 = blockIdx.x * K::CO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp % K::KS, wmn = warp / K::KS, wm = wmn % K::WM, wn = wmn / K::WM;
  const int tpr = row_tiles(W, K::TP), ntiles = N * H * tpr;
  const int mine = (ntiles - static_cast<int>(blockIdx.y) + P - 1) / P;  // tiles of this CTA

  TileWalk fetched(blockIdx.y, P, tpr, K::TP, H), fixed = fetched;  // next tile to fetch / fix up
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // Each thread copies the same groups of every tile: u and c groups (pixel pu + i*THREADS/AV,
  // channels vu ..), dc and gy groups (tile k6, pixel pd + .., channels co0 + vd ..). For d <= TP,
  // gy is staged once with a halo of d columns on each side (TP + 2d <= 3TP rows), and the
  // product of shift k reads it from row (2-k)d on; else as three shifted tiles.
  const bool halo = d <= K::TP;
  int gy_row[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) gy_row[k] = halo ? (2 - k) * d : k * K::TP;
  constexpr int NU = K::TP * K::AV / K::THREADS, ND = 6 * K::TP * K::BV / K::THREADS;
  const int pu = threadIdx.x / K::AV, vu = (threadIdx.x % K::AV) * 8;
  const int pd = threadIdx.x / K::BV, vd = (threadIdx.x % K::BV) * 8;
  auto fetch = [&](int, int buf) {  // called for stages 0, 1, ... in order
    const TileWalk ta = fetched;
    fetched.advance();
    bf16* st = smem + buf * K::STAGE;
    const size_t img = static_cast<size_t>(ta.n) * H;
    const size_t own = ((img + ta.r) * W + ta.w0) * C;  // the tile's first pixel
#pragma unroll
    for (int i = 0; i < NU; ++i) {  // u and c at the tile's own pixels
      const int p = pu + i * (K::THREADS / K::AV);
      bf16* ud = st + p * K::LDA + vu;
      if (ta.w0 + p < W) {
        cp_async16(ud, raw + own + static_cast<size_t>(p) * C + vu);
        cp_async16(ud + K::C_OFF, cbuf + own + static_cast<size_t>(p) * C + vu);
      } else {
        *reinterpret_cast<uint4*>(ud) = zero;
        *reinterpret_cast<uint4*>(ud + K::C_OFF) = zero;
      }
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {  // dc at rows r+d, r, r-d (and gy at columns w+d, w, w-d)
      const int k6 = i * K::THREADS / (K::TP * K::BV);
      if (k6 >= 3 && halo) break;
      const int p = pd + (i * K::THREADS % (K::TP * K::BV)) / K::BV, shift = (1 - k6 % 3) * d;
      const int rr = k6 < 3 ? ta.r + shift : ta.r, w = ta.w0 + p + (k6 < 3 ? 0 : shift);
      bf16* dst = st + K::D_OFF + (k6 * K::TP + p) * K::LDB + vd;
      if (rr >= 0 && rr < H && w >= 0 && w < W)
        cp_async16(dst, (k6 < 3 ? dc : gy) + ((img + rr) * W + w) * C + co0 + vd);
      else *reinterpret_cast<uint4*>(dst) = zero;
    }
    if (halo)  // gy at columns w0-d .. w0+TP+d-1 once
      for (int q = pd; q < K::TP + 2 * d; q += K::THREADS / K::BV) {
        const int w = ta.w0 - d + q;
        bf16* dst = st + K::GY_OFF + q * K::LDB + vd;
        if (w >= 0 && w < W) cp_async16(dst, gy + ((img + ta.r) * W + w) * C + co0 + vd);
        else *reinterpret_cast<uint4*>(dst) = zero;
      }
  };
  // the pre-stage's a and b of the channels vu .. vu+7 of every u group this thread copies, kept
  // in registers
  float pre_a[8], pre_b[8];
  if (pa != nullptr)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      pre_a[e] = pa[vu + e];
      pre_b[e] = pb[vu + e];
    }
  // db31 = sum dc: each thread sums the channels co0 + vd .. +7 of the groups of dc at the tile's
  // own row that it copied; the DL lanes are summed in a fixed order at the end
  float bsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto fixup = [&](int, int buf) {  // called for stages 0, 1, ... in order
    const TileWalk ta = fixed;
    fixed.advance();
    bf16* st = smem + buf * K::STAGE;
    if (pa != nullptr)
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int p = pu + i * (K::THREADS / K::AV);
        if (ta.w0 + p < W) pre8_regs(st + p * K::LDA + vu, pre_a, pre_b);
      }
#pragma unroll
    for (int i = 0; i < K::TP * K::BV / K::THREADS; ++i) {  // dc at the tile's own row
      const int p = pd + i * (K::THREADS / K::BV);
      uint4 raw8 = *reinterpret_cast<const uint4*>(st + K::D_OFF + (K::TP + p) * K::LDB + vd);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v[e]);
        bsum[2 * e] += f.x;
        bsum[2 * e + 1] += f.y;
      }
    }
  };

  float acc[7][K::MT][K::NT][4];  // dw31[0..2], dw13[0..2], drap
#pragma unroll
  for (int m = 0; m < 7; ++m) zero_frags(acc[m]);
  const int j = lane >> 3, r8 = lane & 7;
  auto compute = [&](int, int buf) {
    const bf16* st = smem + buf * K::STAGE;
    const bf16* B = st + K::D_OFF + wn * K::NT * 8;
#pragma unroll
    for (int i = 0; i < K::TP / 16 / K::KS; ++i) {
      const int k0 = (kw + i * K::KS) * 16;
      // A^T fragments of u and c: matrix j holds ci 8(j%2) .., pixels 8(j/2) ..
      uint32_t au[K::MT][4], ac[K::MT][4];
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) {
        const bf16* a = st + (k0 + (j >> 1) * 8 + r8) * K::LDA + wm * K::MT * 16 + mt * 16 +
                        (j & 1) * 8;
        ldsm_x4_trans(au[mt], a);
        ldsm_x4_trans(ac[mt], a + K::C_OFF);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int brow = k < 3 ? k * K::TP : 3 * K::TP + gy_row[k - 3];  // dc tile k / gy shift
        uint32_t bf[K::NT][2];
        load_b_frags<K::NT, K::LDB>(bf, B + brow * K::LDB, k0);
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < K::NT; ++nt) {
            mma_bf16(acc[k][mt][nt], k < 3 ? au[mt] : ac[mt], bf[nt]);
            if (k == 4 && rap) mma_bf16(acc[6][mt][nt], au[mt], bf[nt]);
          }
      }
    }
  };
  pipeline(mine, fetch, fixup, compute);

  // fragment element (mt, nt, e): ci = wm*16MT + mt*16 + g + 8(e/2), co = wn*8NT + nt*8 + 2t + e%2
  const int g = lane >> 2, t = lane & 3, nmat = rap ? 7 : 6;
  float* out = part + static_cast<size_t>(blockIdx.y) * part_len;
  float* red = reinterpret_cast<float*>(smem);  // [KS][7][C][CO] (KS > 1)
#pragma unroll
  for (int m = 0; m < 7; ++m) {
    if (m >= nmat) break;
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = wm * K::MT * 16 + mt * 16 + g + 8 * h;
          const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
          const float a0 = acc[m][mt][nt][2 * h], a1 = acc[m][mt][nt][2 * h + 1];
          if constexpr (K::KS == 1) st2(out + grad_offset(m, C) + ci * C + co0 + co, a0, a1);
          else st2(red + ((kw * 7 + m) * C + ci) * K::CO + co, a0, a1);
        }
  }
  if constexpr (K::KS > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < nmat * C * K::CO; e += K::THREADS) {
      const int m = e / (C * K::CO), ci = (e / K::CO) % C, co = e % K::CO;
      float sum = 0.f;
      for (int k = 0; k < K::KS; ++k) sum += red[k * 7 * C * K::CO + e];
      out[grad_offset(m, C) + ci * C + co0 + co] = sum;
    }
  }
  float* rb = red + K::RED;  // [DL][CO]
  float* mine8 = rb + (threadIdx.x / K::BV) * K::CO + (threadIdx.x % K::BV) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) mine8[e] = bsum[e];
  __syncthreads();
  for (int c = threadIdx.x; c < K::CO; c += K::THREADS) {
    float sum = 0.f;
    for (int l = 0; l < K::DL; ++l) sum += rb[l * K::CO + c];
    out[static_cast<size_t>(6) * C * C + co0 + c] = sum;
  }
}

// ---- K2 in bf16 ------------------------------------------------------------------------------
// The forward pair for the H100 on persistent CTAs (walkers) over K3's conv tiles (ConvTiles: TM
// pixels of one image row, a whole row at every nb1d block shape of the model at 512x1024). It
// computes u = pre(x) rounded to bf16 (zero outside the image), c = bf16(relu(rowconv_d(u) +
// b31)), y = bf16(colconv_d(c) [+ u @ rap]), and the float32 sum and sum of squares of the
// ROUNDED y (what the next pair and the BN glue read, nb1d_train.py:162-165). Walker b takes the
// tiles b, b + gridDim.x, ... as one stream of ring stages (tile, c pass, row tap, chunk of KC
// input channels; then at C = 128 RAP's chunks), so the loads of the next stages overlap the
// products and the epilogue of this one. The weights stay resident in shared memory for the
// whole walk (at C = 128 w13 only: w31 and rap stream a chunk per stage beside the u chunk), so
// each CTA reads them once, not once per tile. Per tile:
//   - c in one pass of stages over the row taps inside the image, for the tile's columns, into
//     shared memory (c_s); where a row has more than one tile, a second pass for the 16 columns
//     on each side (the halo, d <= 16); elsewhere the halo is zero padding, written once. An m16
//     tile wholly outside the image is not multiplied; c outside the image is 0;
//   - stage B in the pass's last stage, from c_s and the resident w13: no loads, no barrier per
//     chunk; then RAP: at C <= 64 in the same stage, from u_row, a copy of the centre row tap's
//     u chunk (u's own row, the pre-stage applied) that its stage made, and the resident rap; at
//     C = 128, where u_row does not fit, RAP's stages stream rap beside u's row staged again;
//   - y through shared memory into 16-byte rows (a store from the fragments fills half a 32-byte
//     sector); each thread adds the rounded y of its fixed 8 channels to its running sums.
// For d > 16 a tile is T3 columns, and its one c pass computes the three windows of T3 columns
// w0 + (k-1)d .. that column tap k reads.
// Orders: c keeps the pair mainloop's k16 steps per element (row taps k0 .. k1, input channels
// ascending), so it is K3's recomputed c bit for bit (card test
// test_bf16_fwd_and_bwd_compute_the_same_c); y keeps its stage B's (column taps 0, 1, 2 over the
// channels ascending, then RAP), so it is K1 bf16's bit for bit
// (test_k1_bf16_and_k2_bf16_compute_the_same_y). The chunk width and the warp tiling change no
// k16 step. The stats: each walker sums its tiles in order and its threads in a fixed tree, and
// writes one [2][C] partial; the walker count is fixed by the shape (at most WALKERS), not by
// the card, and reduce_kernel sums the partials in a fixed order: reruns are bitwise equal.
// Shared memory: the resident weights, c_s [TM + 2 DPAD][LDB], b31, pa and pb (read where a stage
// ends, so from shared memory rather than through the L2 the ring keeps busy), at C <= 64 u_row
// [TM][LDU], then DEPTH ring stages of an A chunk [TM][LDA] (and at C = 128 a weight chunk
// [KC][LDB]).
template <int C>
struct FwdRing {
  using T = ConvTiles<C>;  // K3's conv tiles: a tile's pixels, the chunk width, the row strides
  static constexpr int THREADS = 512, MT = Mma<C>::MT;  // m16 tiles per warp
  static constexpr int NT = Mma<C>::NT, WN = Mma<C>::WN;  // n8 tiles per warp, warps on channels
  static constexpr int WM = THREADS / 32 / WN, TM = WM * MT * 16;  // warps on pixels, pixels
  static constexpr int KC = T::KC, NCH = T::NCH, LDA = T::LDA, LDB = T::LDB;
  static constexpr bool W_RESIDENT = C <= 64;     // w31 and rap resident too (C = 128: streamed)
  static constexpr int DPAD = 16;                 // c_s rows before the tile's first column
  static constexpr int T3 = TM / 48 * 16;         // columns of a tile for d > DPAD: 32, 80, 160
  static constexpr int WRES = (W_RESIDENT ? 7 : 3) * C * LDB;  // [w31 |] w13 [| rap]
  static constexpr int CROWS = TM + 2 * DPAD;     // c at columns w0 - DPAD ..
  static constexpr int B_OFF = TM * LDA;          // a stage: A chunk, then a weight chunk
  static constexpr int STAGE = B_OFF + (W_RESIDENT ? 0 : KC * LDB);
  static constexpr int PARAMS = 3 * C * 2;        // b31, pa, pb as fp32 [C] each (bf16 units)
  static constexpr int LDU = C + 8, UROW = W_RESIDENT ? TM * LDU : 0;  // u's own row for RAP
  // as many stages as the H100's 227 KB per block holds beside the weights, c and the
  // per-channel parameters (and u's row), at most MAX_DEPTH: 2, 2, 6 at C = 128, 64, 16 (221.2,
  // 217.3, 203.7 KB)
  static constexpr int FIXED = WRES + CROWS * LDB + PARAMS + UROW, MAX_DEPTH = 6;
  static constexpr int FIT = (232448 / static_cast<int>(sizeof(bf16)) - FIXED) / STAGE;
  static constexpr int DEPTH = FIT < MAX_DEPTH ? FIT : MAX_DEPTH;
  static constexpr int WALKERS = 128;
  static constexpr size_t BYTES = sizeof(bf16) * (FIXED + DEPTH * STAGE);
  static_assert(DEPTH >= 2, "a ring of two stages fits");
  static_assert(TM == T::TM && 2 * DPAD <= TM && 3 * T3 <= TM, "a conv tile; c_s and y tiles");
  static_assert(WM * WN * 32 == THREADS && THREADS % (KC / 8) == 0 && THREADS % (C / 8) == 0,
                "each thread's channels fixed in the staging and the epilogue");
  static_assert(sizeof(float) * (THREADS / 32) * 2 * C <= sizeof(bf16) * DEPTH * STAGE,
                "the stats' sum reuses the ring");
};

// A K2 walker's position: tile t (tw columns w0 .. of image row `row` = n*H + r; the row taps
// k0 .. k0+n0-1 are inside the image), phase 0 (c of the tile's columns), 1 (c of the halo) or 2
// (RAP), tap j < n0 of a c pass, chunk ch. next() steps to the following stage.
struct FwdWalk {
  int t, row, r, w0, k0, n0, phase, j, ch;
  int stride, tpr, tw, H, d, nch;
  bool halo, rap;  // rap: RAP's stages (C = 128)
  __device__ void tile(int t_) {
    t = t_;
    row = t / tpr;
    r = row % H;
    w0 = (t - row * tpr) * tw;
    k0 = r - d < 0 ? 1 : 0;
    n0 = (r + d >= H ? 1 : 2) - k0 + 1;
    phase = j = ch = 0;
  }
  __device__ bool pass_end() const { return phase < 2 && j == n0 - 1 && ch == nch - 1; }
  __device__ bool c_end() const { return pass_end() && (phase == 1 || !halo); }
  __device__ bool tile_end() const { return rap ? phase == 2 && ch == nch - 1 : c_end(); }
  __device__ void next() {
    if (++ch < nch) return;
    ch = 0;
    if (phase < 2 && ++j < n0) return;
    j = 0;
    if (phase == 0 && halo) phase = 1;
    else if (phase < 2 && rap) phase = 2;
    else tile(t + stride);
  }
  // the stages of the walk from tile blockIdx.x on
  __device__ int stages(int ntiles) const {
    FwdWalk w = *this;
    int s = 0;
    for (int u = static_cast<int>(blockIdx.x); u < ntiles; u += stride) {
      w.tile(u);
      s += ((halo ? 2 : 1) * w.n0 + (rap ? 1 : 0)) * nch;
    }
    return s;
  }
};

template <int C>
__global__ void __launch_bounds__(FwdRing<C>::THREADS, 1)
fwd_pair_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w31,
                     const float* __restrict__ b31, const bf16* __restrict__ w13,
                     const bf16* __restrict__ rap, const float* __restrict__ pa,
                     const float* __restrict__ pb, bf16* __restrict__ y,
                     float* __restrict__ part, int ntiles, int H, int W, int d, int row0,
                     int row1) {
  using R = FwdRing<C>;
  constexpr int TM = R::TM, KC = R::KC, LDA = R::LDA, LDB = R::LDB, MT = R::MT, NT = R::NT;
  constexpr int THREADS = R::THREADS, AV = KC / 8, V = C / 8, DPAD = R::DPAD;
  extern __shared__ uint4 smem16[];
  bf16* wres = reinterpret_cast<bf16*>(smem16);
  bf16* w13_s = wres + (R::W_RESIDENT ? 3 * C * LDB : 0);
  bf16* c_s = wres + R::WRES;
  float* prm = reinterpret_cast<float*>(c_s + R::CROWS * LDB);  // b31, then pa and pb
  bf16* u_row = c_s + R::CROWS * LDB + R::PARAMS;
  bf16* ring = u_row + R::UROW;
  conv_fetch_weights<C, THREADS>(w13_s, w13, 3 * C);
  if (R::W_RESIDENT) {
    conv_fetch_weights<C, THREADS>(wres, w31, 3 * C);
    if (rap != nullptr) conv_fetch_weights<C, THREADS>(wres + 6 * C * LDB, rap, C);
  }
  cp_async_commit();  // complete before the ring's first stage
  for (int i = threadIdx.x; i < C; i += THREADS) {
    prm[i] = b31[i];
    if (pa != nullptr) {
      prm[C + i] = pa[i];
      prm[2 * C + i] = pb[i];
    }
  }

  const bool wide = d > DPAD;
  FwdWalk fw{};  // fetch runs ahead; fixup and compute of a stage share mw
  fw.stride = static_cast<int>(gridDim.x);
  fw.tw = wide ? R::T3 : TM;
  fw.tpr = (W + fw.tw - 1) / fw.tw;
  fw.H = H;
  fw.d = d;
  fw.nch = R::NCH;
  fw.halo = !wide && fw.tpr > 1;  // every tile of a row of two or more tiles has a halo
  fw.rap = rap != nullptr && !R::W_RESIDENT;
  const bool rap_row = rap != nullptr && R::W_RESIDENT;  // RAP from u_row
  fw.tile(static_cast<int>(blockIdx.x));
  FwdWalk mw = fw;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!fw.halo)  // the halo rows of c_s stay zero padding for the whole walk
    for (int idx = threadIdx.x; idx < 2 * DPAD * V; idx += THREADS) {
      const int m = idx / V;
      *reinterpret_cast<uint4*>(c_s + (m < DPAD ? m : TM + m) * LDB + (idx % V) * 8) = zero;
    }
  __syncthreads();  // the parameters and the halo's zeros before the first stage's pre-stage

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % R::WM, wn = warp / R::WM, g = lane >> 2, t4 = lane & 3;
  // the image column of row m of a stage's A chunk, -1 for none: phase 0 the tile's columns (for
  // d > DPAD the three windows), 1 the DPAD columns before the tile then the DPAD after it, 2 the
  // tile's columns
  auto a_col = [&](const FwdWalk& p, int m) {
    if (p.phase == 1) return m < DPAD ? p.w0 - DPAD + m : p.w0 + TM - DPAD + m;
    if (p.phase == 2 || !wide) return p.w0 + m;
    const int k = m / R::T3;
    return k < 3 ? p.w0 + (k - 1) * d + m - k * R::T3 : -1;
  };
  // the tile's output columns, rounded up to m16 tiles
  auto out_rows = [&](const FwdWalk& p) { return (min(p.tw, W - p.w0) + 15) / 16 * 16; };
  // the rows of a stage's A chunk that live m16 tiles read
  auto a_rows = [&](const FwdWalk& p) {
    return p.phase == 1 ? 2 * DPAD : p.phase == 0 && wide ? 3 * R::T3 : out_rows(p);
  };
  // this warp's m16 tiles among the first `rows` rows
  auto live = [&](int rows) { return max(0, min(MT, (rows - wm * MT * 16) / 16)); };

  auto fetch = [&](int, int buf) {
    bf16* A = ring + buf * R::STAGE;
    const int ci0 = fw.ch * KC;
    const int src_row = fw.phase < 2 ? fw.row + (fw.k0 + fw.j - 1) * d : fw.row;
    const bf16* src = x + static_cast<size_t>(src_row) * W * C + ci0;
    const int rows = a_rows(fw);
    for (int idx = threadIdx.x; idx < rows * AV; idx += THREADS) {
      const int m = idx / AV, v = (idx % AV) * 8, col = a_col(fw, m);
      bf16* dst = A + m * LDA + v;
      if (col >= 0 && col < W) cp_async16(dst, src + static_cast<size_t>(col) * C + v);
      else *reinterpret_cast<uint4*>(dst) = zero;
    }
    if (!R::W_RESIDENT)
      conv_fetch_weights<C, THREADS>(
          A + R::B_OFF,
          fw.phase < 2 ? w31 + (static_cast<size_t>(fw.k0 + fw.j) * C + ci0) * C
                       : rap + static_cast<size_t>(ci0) * C,
          KC);
    fw.next();
  };
  // the pre-stage on this thread's own copies, its 8 channels' a and b in registers; then, at
  // the centre row tap, its copies of u's own row (for d > DPAD the middle window) to u_row, at
  // the chunk's channels
  auto fixup = [&](int, int buf) {
    bf16* A = ring + buf * R::STAGE;
    const int v = (threadIdx.x % AV) * 8, rows = a_rows(mw);
    if (pa != nullptr) {
      const float* a = prm + C + mw.ch * KC + v;
      const float4 a0 = ld4(a), a1 = ld4(a + 4), b0 = ld4(a + C), b1 = ld4(a + C + 4);
      const float a8[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      for (int idx = threadIdx.x; idx < rows * AV; idx += THREADS) {
        const int m = idx / AV, col = a_col(mw, m);
        if (col >= 0 && col < W) pre8_regs(A + m * LDA + v, a8, b8);
      }
    }
    if (rap_row && mw.phase == 0 && mw.k0 + mw.j == 1) {
      const int skip = wide ? R::T3 : 0;
      for (int idx = threadIdx.x; idx < rows * AV; idx += THREADS) {
        const int m = idx / AV - skip;
        if (m >= 0 && m < (wide ? R::T3 : TM))
          *reinterpret_cast<uint4*>(u_row + m * R::LDU + mw.ch * KC + v) =
              *reinterpret_cast<const uint4*>(A + (m + skip) * LDA + v);
      }
    }
  };

  float acc[MT][NT][4];
  zero_frags(acc);
  float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, q8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
                                                                    0.f, 0.f};
  // c = relu(acc + b31) rounded to bf16, 0 outside the image, into c_s: phase 0 at rows DPAD + m,
  // phase 1 (warp rows 0 and 1, one m16 tile each) at the halo's rows
  auto store_c = [&](const FwdWalk& p) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (p.phase == 1 && (i > 0 || wm >= 2)) continue;
          const int m = (p.phase == 1 ? wm * 16 : wm * MT * 16 + i * 16) + g + 8 * h;
          const int col = a_col(p, m), co = wn * NT * 8 + nt * 8 + 2 * t4;
          const int row = p.phase == 1 ? (m < DPAD ? m : TM + m) : DPAD + m;
          float2 v = make_float2(0.f, 0.f);
          if (col >= 0 && col < W) {
            const float2 bias = *reinterpret_cast<const float2*>(prm + co);
            v.x = fmaxf(acc[i][nt][2 * h] + bias.x, 0.f);
            v.y = fmaxf(acc[i][nt][2 * h + 1] + bias.y, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(c_s + row * LDB + co) =
              __floats2bfloat162_rn(v.x, v.y);
        }
  };
  // stage B: acc = colconv_d(c), column taps 0, 1, 2, each over the channels ascending
  auto stage_b = [&](const FwdWalk& p) {
    const int lb = live(out_rows(p));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int off = wide ? DPAD + k * R::T3 : DPAD + (k - 1) * d;
      warp_mma<C, MT, NT, LDB, LDB>(acc, c_s + (off + wm * MT * 16) * LDB, 16, lb,
                                    w13_s + k * C * LDB + wn * NT * 8);
    }
  };
  // y rounded to bf16 through c_s's rows DPAD .. (the halo rows keep their zeros) to the tile's
  // columns inside the image as 16-byte rows; this thread's channels v .. v+7 of each row it
  // stores go into its running sums where the image row lies in the stats window
  auto store_y = [&](const FwdWalk& p) {
    bf16* ys = c_s + DPAD * LDB;
    __syncthreads();  // every warp is done with c_s
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(ys + (wm * MT * 16 + i * 16 + g + 8 * h) * LDB +
                                             wn * NT * 8 + nt * 8 + 2 * t4) =
              __floats2bfloat162_rn(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
    __syncthreads();
    const int n_out = min(p.tw, W - p.w0), v = (threadIdx.x % V) * 8;
    const bool counted = p.r >= row0 && p.r < row1;
    bf16* out = y + (static_cast<size_t>(p.row) * W + p.w0) * C + v;
    for (int m = threadIdx.x / V; m < n_out; m += THREADS / V) {
      const uint4 raw8 = *reinterpret_cast<const uint4*>(ys + m * LDB + v);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * C) = raw8;
      if (!counted) continue;
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        s8[2 * e] += f.x;
        s8[2 * e + 1] += f.y;
        q8[2 * e] += f.x * f.x;
        q8[2 * e + 1] += f.y * f.y;
      }
    }
  };
  auto compute = [&](int, int buf) {
    const bf16* stage = ring + buf * R::STAGE;
    const int ci0 = mw.ch * KC;
    if (mw.phase < 2) {  // c += u at row tap k0 + j @ w31[k0 + j], this chunk's channels
      const bf16* B = (R::W_RESIDENT ? wres + ((mw.k0 + mw.j) * C + ci0) * LDB
                                     : stage + R::B_OFF) + wn * NT * 8;
      if (mw.phase == 0)
        warp_mma<KC, MT, NT, LDA, LDB>(acc, stage + wm * MT * 16 * LDA, 16, live(a_rows(mw)), B);
      else
        warp_mma<KC, MT, NT, LDA, LDB>(acc, stage + wm * 16 * LDA, 16, wm < 2 ? 1 : 0, B);
      if (mw.pass_end()) {
        store_c(mw);
        zero_frags(acc);
        if (mw.c_end()) {
          __syncthreads();  // c_s is complete
          stage_b(mw);
          if (rap_row)  // y += u @ rap, the channels ascending
            warp_mma<C, MT, NT, R::LDU, LDB>(acc, u_row + wm * MT * 16 * R::LDU, 16,
                                             live(out_rows(mw)), wres + 6 * C * LDB + wn * NT * 8);
        }
      }
    } else {  // y += u @ rap, this chunk's channels
      warp_mma<KC, MT, NT, LDA, LDB>(
          acc, stage + wm * MT * 16 * LDA, 16, live(out_rows(mw)),
          (R::W_RESIDENT ? wres + (6 * C + ci0) * LDB : stage + R::B_OFF) + wn * NT * 8);
    }
    if (mw.tile_end()) {
      store_y(mw);
      zero_frags(acc);
    }
    mw.next();
  };
  pipeline<R::DEPTH>(fw.stages(ntiles), fetch, fixup, compute);

  // the walker's [2][C] partial: over the lanes of each channel group (a fixed shuffle tree), then
  // over the warps in order (the ring is free after the pipeline's last barrier)
#pragma unroll
  for (int off = V; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s8[e] += __shfl_xor_sync(0xffffffffu, s8[e], off);
      q8[e] += __shfl_xor_sync(0xffffffffu, q8[e], off);
    }
  float* red = reinterpret_cast<float*>(ring);  // [warps][2][C]
  if (lane < V)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[warp * 2 * C + lane * 8 + e] = s8[e];
      red[(warp * 2 + 1) * C + lane * 8 + e] = q8[e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {
    float sum = 0.f;
    for (int k = 0; k < THREADS / 32; ++k) sum += red[k * 2 * C + i];
    part[static_cast<size_t>(blockIdx.x) * 2 * C + i] = sum;
  }
}

// K2 bf16's walkers: one per tile up to WALKERS, fixed by the shape
template <int C>
int fwd_bf16_walkers(int n, int h, int w, int d) {
  using R = FwdRing<C>;
  const long long ntiles =
      static_cast<long long>(n) * h * row_tiles(w, d > R::DPAD ? R::T3 : R::TM);
  return static_cast<int>(ntiles < R::WALKERS ? ntiles : R::WALKERS);
}

template <int C>
int wgrad_bf16_walkers(int n, int h, int w) {
  const long long ntiles = static_cast<long long>(n) * h * row_tiles(w, WG16<C>::TP);
  return static_cast<int>(ntiles < WG16<C>::WALKERS ? ntiles : WG16<C>::WALKERS);
}

// The grid of a persistent conv launch: as many CTAs of `kernel` as the card holds at once, at
// most one per tile. The count is cached per device: K3 runs twice per pair call, and the bf16
// training step is bound by the host's launches.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int ntiles, int* grid) {
  static int resident[64] = {};  // per device index; 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = resident[dev] < ntiles ? resident[dev] : ntiles;
  return cudaSuccess;
}

template <int C>
cudaError_t fwd_bf16(const bf16* x, const bf16* w31, const float* b31, const bf16* w13,
                     const bf16* rap, const float* pa, const float* pb, bf16* y, float* stats,
                     float* scratch, int n, int h, int w, int d, int row0, int row1,
                     cudaStream_t s) {
  using R = FwdRing<C>;
  // the kernel indexes pixels and tiles with int
  if (static_cast<long long>(n) * h * w > INT_MAX) return cudaErrorInvalidValue;
  const int ntiles = n * h * row_tiles(w, d > R::DPAD ? R::T3 : R::TM);
  const int walkers = fwd_bf16_walkers<C>(n, h, w, d);
  cudaError_t err = set_smem(fwd_pair_bf16_kernel<C>, R::BYTES);
  if (err != cudaSuccess) return err;
  fwd_pair_bf16_kernel<C><<<walkers, R::THREADS, R::BYTES, s>>>(
      x, w31, b31, w13, rap, pa, pb, y, scratch, ntiles, h, w, d, row0, row1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(scratch, walkers, 2 * C, stats, s);
}

template <int C>
cudaError_t bwd_bf16(const bf16* raw, const bf16* gy, const bf16* w31, const float* b31,
                     const bf16* w13t, const bf16* w31t, const bf16* rapt, const float* pa,
                     const float* pb, bf16* du, float* grads, float* scratch, int n, int h,
                     int w, int d, cudaStream_t s) {
  // the kernels index pixels and tiles with int
  if (static_cast<long long>(n) * h * w > INT_MAX) return cudaErrorInvalidValue;
  const size_t act = static_cast<size_t>(n) * h * w * C;
  bf16* cbuf = reinterpret_cast<bf16*>(scratch);
  bf16* dc = cbuf + act;
  float* part = scratch + act;  // after c and dc: 2 * act bf16 = act floats
  const int ntiles = n * h * row_tiles(w, ConvTiles<C>::TM);
  constexpr int threads = ConvTiles<C>::THREADS;
  int grid = 0;

  size_t smem = DcRing<C>::BYTES;
  cudaError_t err = set_smem(k3_c_dc_bf16_kernel<C>, smem);
  if (err == cudaSuccess)
    err = persistent_grid(k3_c_dc_bf16_kernel<C>, threads, smem, ntiles, &grid);
  if (err != cudaSuccess) return err;
  k3_c_dc_bf16_kernel<C><<<grid, threads, smem, s>>>(raw, gy, w31, b31, w13t, pa, pb, cbuf, dc,
                                                     ntiles, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = DuRing<C>::BYTES;
  if ((err = set_smem(k3_du_bf16_kernel<C>, smem)) == cudaSuccess)
    err = persistent_grid(k3_du_bf16_kernel<C>, threads, smem, ntiles, &grid);
  if (err != cudaSuccess) return err;
  k3_du_bf16_kernel<C><<<grid, threads, smem, s>>>(dc, gy, w31t, rapt, du, ntiles, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using WK = WG16<C>;
  const bool rap = rapt != nullptr;
  const size_t len = grad_len(C, rap);
  const int P = wgrad_bf16_walkers<C>(n, h, w);
  if ((err = set_smem(k3_wgrad_bf16_kernel<C>, WK::BYTES)) != cudaSuccess) return err;
  k3_wgrad_bf16_kernel<C><<<dim3(WK::SLICES, P), WK::THREADS, WK::BYTES, s>>>(
      raw, pa, pb, cbuf, dc, gy, rap, part, len, n, h, w, d);
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
// and pa/pb may be null. stats: [2][C] (sum, sum of squares of y over the n * (row1 - row0) * w
// pixels of the rows row0 .. row1 - 1 of each image; 0, h for all, the stats window of a
// slab with halo rows). scratch: the floats nb1d_train_fwd_scratch gives. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int nb1d_train_fwd(int channels, const void* x, const void* w31, const void* b31,
                              const void* w13, const void* rap, const void* pa, const void* pb,
                              void* y, void* stats, void* scratch, int n, int h, int w, int d,
                              int row0, int row1, void* stream) {
  if (bad_shape(n, h, w, d) || row0 < 0 || row0 > row1 || row1 > h)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto c) {
    return fwd<decltype(c)::value>(
        static_cast<const float*>(x), static_cast<const float*>(w31),
        static_cast<const float*>(b31), static_cast<const float*>(w13),
        static_cast<const float*>(rap), static_cast<const float*>(pa),
        static_cast<const float*>(pb), static_cast<float*>(y), static_cast<float*>(stats),
        static_cast<float*>(scratch), n, h, w, d, row0, row1, s);
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

// Floats of scratch nb1d_train_fwd_bf16 needs (the walkers' partial stats, at most as many walkers
// as at any dilation); -1 for an unsupported C.
extern "C" long long nb1d_train_fwd_bf16_scratch(int channels, int n, int h, int w) {
  switch (channels) {
    case 16: return static_cast<long long>(fwd_bf16_walkers<16>(n, h, w, INT_MAX)) * 2 * 16;
    case 64: return static_cast<long long>(fwd_bf16_walkers<64>(n, h, w, INT_MAX)) * 2 * 64;
    case 128: return static_cast<long long>(fwd_bf16_walkers<128>(n, h, w, INT_MAX)) * 2 * 128;
    default: return -1;
  }
}

// K2 in bf16, as nb1d_train_fwd with x, y, w31, w13 and rap in bf16 (b31, pa, pb, stats float32);
// the stats are the sums of the bf16 y over the rows row0 .. row1 - 1.
extern "C" int nb1d_train_fwd_bf16(int channels, const void* x, const void* w31, const void* b31,
                                   const void* w13, const void* rap, const void* pa,
                                   const void* pb, void* y, void* stats, void* scratch, int n,
                                   int h, int w, int d, int row0, int row1, void* stream) {
  if (bad_shape(n, h, w, d) || row0 < 0 || row0 > row1 || row1 > h)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_channels(channels, [&](auto c) {
    return fwd_bf16<decltype(c)::value>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w31),
        static_cast<const float*>(b31), static_cast<const bf16*>(w13),
        static_cast<const bf16*>(rap), static_cast<const float*>(pa),
        static_cast<const float*>(pb), static_cast<bf16*>(y), static_cast<float*>(stats),
        static_cast<float*>(scratch), n, h, w, d, row0, row1, s);
  }));
}

// Floats of scratch nb1d_train_bwd_bf16 needs: c and dc in bf16 (n*h*w*C each, n*h*w*C floats
// together) and the weight-gradient partials; -1 for an unsupported C.
extern "C" long long nb1d_train_bwd_bf16_scratch(int channels, int n, int h, int w, int rap) {
  const long long act = static_cast<long long>(n) * h * w * channels;
  long long ctas;
  switch (channels) {
    case 16: ctas = wgrad_bf16_walkers<16>(n, h, w); break;
    case 64: ctas = wgrad_bf16_walkers<64>(n, h, w); break;
    case 128: ctas = wgrad_bf16_walkers<128>(n, h, w); break;
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
