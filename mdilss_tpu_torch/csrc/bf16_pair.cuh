// The bf16 conv pair of the port's kernels on Hopper's tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators): the pair mainloop of nb1d_infer.cu (K1's nb1d_pair_mma_kernel),
// and the warp tiles and helpers of nb1d_train.cu's bf16 launches (K2's fwd_pair_bf16_kernel,
// which repeats this mainloop's products in its order, and K3's). sm_80 and later; built for
// sm_90a.
//
// The pair, with rows and columns of u outside the image zero padding:
//   c = relu(rowconv_d(u, w31) + b31)   rounded to bf16
//   y = colconv_d(c, w13) [+ u @ rap]    left in the fp32 accumulators
// rowconv_d is the 3x1 conv with row dilation d, colconv_d the 1x3 conv with column dilation d,
// both zero-padded "same" convs; weights are tap-stacked bf16 [3C][C] matrices (row k*C + ci,
// column co); b31 is fp32 [C]. Activations are bf16 NHWC, C in {16, 64, 128}.
// `bf16_pair_mainloop` leaves each warp's fragments of y in registers for K1's epilogue
// relu(a * y + b [+ res]).
//
// One CTA per (image, row, TM output columns) x all C channels:
//   - u rows and weight chunks reach shared memory through 16-byte cp.async in a 3-deep ring
//     (sm90_async.cuh), one barrier per chunk of KC input channels; fragments load with ldmatrix
//     (A [pixel][k] as is, B [k][co] transposed), from rows padded by 8 bf16 so the 8 rows of one
//     ldmatrix fall on distinct banks;
//   - stage A computes c for the TM + 2d columns w0-d .. w0+TM+d-1 into shared memory, rounded
//     to bf16 (the Pallas kernels round c to the activation type, nb1d.py:112, :128,
//     nb1d_train.py:157); its m16 tiles are dealt to the warp rows in turn, and one pass covers
//     d <= 16, a larger d takes more passes;
//   - stage B reads its A fragments straight from c at the column shifts k*d; RAP is one more K
//     block, taken from u's own row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Tiles of the bf16 pair. The CTA's warps tile its TM output columns x C channels as WM x WN
// warps, each MT m16 x NT n8 fragments (32 columns x 8NT channels). Stage A's TM + 2d c columns
// are m16 tiles dealt to the WM warp rows in turn, up to MTA per warp per pass; one pass covers
// d <= 16, a larger d takes more passes.
template <int C>
struct Mma {
  static constexpr int THREADS = 256;
  static constexpr int NT = C >= 64 ? 4 : 2;        // n8 tiles per warp
  static constexpr int WN = C / (8 * NT);           // warps along channels: 4, 2, 1
  static constexpr int WM = THREADS / 32 / WN;      // warps along columns: 2, 4, 8
  static constexpr int MT = 2;                      // stage-B m16 tiles per warp
  static constexpr int TM = WM * MT * 16;           // output columns per CTA: 64, 128, 256
  static constexpr int MTA = 3;                     // stage-A m16 tiles per warp and pass
  static constexpr int PA = WM * MTA * 16;          // stage-A c columns per pass: 96, 192, 384
  static constexpr int KC = C < 32 ? C : 32;        // input channels per staged chunk
  static constexpr int NCH = C / KC;
  static constexpr int LDA = KC + 8;                // bf16 row strides, an odd multiple of 16
  static constexpr int LDB = C + 8;                 // bytes: an ldmatrix's 8 rows hit 32 banks
  static constexpr int B_OFF = PA * LDA;            // ring stage: A chunk [PA][LDA], then
  static constexpr int STAGE = B_OFF + KC * LDB;    // B chunk [KC][LDB] (bf16 elements)
  static_assert(WM * WN * 32 == THREADS && NT % 2 == 0 && KC % 16 == 0 && C % KC == 0,
                "mma tile");
  static_assert(PA >= TM + 32, "one stage-A pass covers d <= 16");
};

// four 8x8 bf16 matrices (ldsm_x4 in sm90_async.cuh), each transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b: bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of NT n8 tiles for one k16 step: B [k][n] at b (row stride LDB_), rows
// k0 .. k0+15, columns from the warp's first one; one transposed x4 load per two n8 tiles.
template <int NT, int LDB_>
__device__ __forceinline__ void load_b_frags(uint32_t (&bf)[NT][2], const bf16* b, int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  const bf16* b_lane = b + (k0 + (j & 1) * 8 + (lane & 7)) * LDB_ + (j >> 1) * 8;
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {  // n8 tiles 2p and 2p + 1
    uint32_t q[4];
    ldsm_x4_trans(q, b_lane + p * 16);
    bf[2 * p][0] = q[0];
    bf[2 * p][1] = q[1];
    bf[2 * p + 1][0] = q[2];
    bf[2 * p + 1][1] = q[3];
  }
}

// acc[i] += A_i[16 x KC] @ B[KC x 8NT] for the warp's m16 tiles i < live. Tile i's rows start
// step * i rows after a (row stride LDA_, [pixel][k]); B ([k][co], row stride LDB_) starts at
// the warp's first channel. Element (i, nt, e) of acc sits at row g + 8(e/2) of tile i and
// channel 8nt + 2t + e%2 (g = lane/4, t = lane%4).
template <int KC, int MT, int NT, int LDA_, int LDB_>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const bf16* a, int step,
                                         int live, const bf16* b) {
  const int lane = threadIdx.x & 31, j = lane >> 3, row = (j & 1) * 8 + (lane & 7);
  // ldmatrix j of a tile: rows 8(j%2) .. +7, k 8(j/2) .. +7
  const bf16* a_lane = a + row * LDA_ + (j >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t bf[NT][2];
    load_b_frags<NT, LDB_>(bf, b, kk);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < live) {  // uniform over the warp
        uint32_t af[4];
        ldsm_x4(af, a_lane + i * step * LDA_ + kk);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[i][nt], af, bf[nt]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_frags(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
}

// relu(a * v + b) on the 8 bf16 values at p (16-byte aligned), channels ch .. ch+7: in fp32, the
// product and the sum each rounded to nearest (as the plain version computes it), then rounded to
// bf16. The training pairs' pre-stage cannot ride on cp.async: after a chunk lands, each thread
// applies this to the 16-byte groups it copied itself, before the barrier that publishes the
// chunk; a column outside the image stays 0 (zero padding, not relu(b)).
__device__ __forceinline__ void pre8(bf16* p, const float* __restrict__ a,
                                     const float* __restrict__ b, int ch) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    const float2 av = *reinterpret_cast<const float2*>(a + ch + 2 * i);
    const float2 bv = *reinterpret_cast<const float2*>(b + ch + 2 * i);
    h[i] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(av.x, v.x), bv.x), 0.f),
                                 fmaxf(__fadd_rn(__fmul_rn(av.y, v.y), bv.y), 0.f));
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// A chunk row m <- src_row[col0 + m, 0 : KC] for m < rows, 0 outside the image (columns 0 .. W-1)
template <int C>
__device__ __forceinline__ void fetch_rows(bf16* A, const bf16* src_row, int col0, int rows,
                                           int W) {
  using K = Mma<C>;
  constexpr int AV = K::KC / 8;  // 16-byte copies per row of an A chunk
  for (int idx = threadIdx.x; idx < rows * AV; idx += K::THREADS) {
    const int m = idx / AV, v = (idx % AV) * 8, col = col0 + m;
    bf16* dst = A + m * K::LDA + v;
    if (col >= 0 && col < W) cp_async16(dst, src_row + static_cast<size_t>(col) * C + v);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// B chunk <- KC rows of a [rows][C] weight matrix from w
template <int C>
__device__ __forceinline__ void fetch_weights(bf16* B, const bf16* w) {
  using K = Mma<C>;
  constexpr int V = C / 8;
  for (int e = threadIdx.x; e < K::KC * V; e += K::THREADS) {
    const int row = e / V, c8 = (e % V) * 8;
    cp_async16(B + row * K::LDB + c8, w + row * C + c8);
  }
}

// acc = y = colconv_d(c) [+ u @ rap] for the CTA's TM output columns w0 = blockIdx.x * TM .. of
// row blockIdx.y of image blockIdx.z; element (i, nt, e) of acc is column w0 + wm*MT*16 + i*16 +
// g + 8(e/2), channel wn*NT*8 + nt*8 + 2t + e%2. Shared memory (from smem): the ring, kStages x
// (A chunk, B chunk), then c [TM + 2d][LDB] (bf16_pair_smem_bytes).
template <int C>
__device__ __forceinline__ void bf16_pair_mainloop(
    bf16* smem, const bf16* __restrict__ u, const bf16* __restrict__ w31,
    const float* __restrict__ b31, const bf16* __restrict__ w13, const bf16* __restrict__ rap,
    int H, int W, int d, float (&acc)[Mma<C>::MT][Mma<C>::NT][4]) {
  using K = Mma<C>;
  bf16* ring = smem;                      // kStages x (A chunk, B chunk)
  bf16* c_s = ring + kStages * K::STAGE;  // [TM + 2d][LDB]: c at columns w0-d ..

  const int w0 = blockIdx.x * K::TM, r = blockIdx.y;
  const size_t img_row0 = static_cast<size_t>(blockIdx.z) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % K::WM, wn = warp / K::WM, g = lane >> 2, t = lane & 3;
  const int cols = K::TM + 2 * d;

  // ---- stage A: c = relu(rowconv_d(u) + b31) as bf16, 0 outside the image ----
  const int k0 = r - d < 0 ? 1 : 0, k1 = r + d >= H ? 1 : 2;  // row taps inside the image
  for (int p0 = 0; p0 < cols; p0 += K::PA) {
    const int rows = min(K::PA, cols - p0), mtiles = (rows + 15) / 16;
    const int live = (mtiles - wm + K::WM - 1) / K::WM;  // this warp row's tiles wm + i*WM
    float c_acc[K::MTA][K::NT][4];
    zero_frags(c_acc);
    pipeline(
        (k1 - k0 + 1) * K::NCH,
        [&](int s, int buf) {
          const int tap = k0 + s / K::NCH, ci0 = (s % K::NCH) * K::KC;
          bf16* A = ring + buf * K::STAGE;
          fetch_rows<C>(A, u + (img_row0 + (r + (tap - 1) * d)) * W * C + ci0, w0 - d + p0, rows,
                        W);
          fetch_weights<C>(A + K::B_OFF, w31 + (static_cast<size_t>(tap) * C + ci0) * C);
        },
        [](int, int) {},
        [&](int, int buf) {
          const bf16* A = ring + buf * K::STAGE;
          warp_mma<K::KC, K::MTA, K::NT, K::LDA, K::LDB>(
              c_acc, A + wm * 16 * K::LDA, K::WM * 16, live, A + K::B_OFF + wn * K::NT * 8);
        });
#pragma unroll
    for (int i = 0; i < K::MTA; ++i)
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = p0 + (wm + i * K::WM) * 16 + g + 8 * h, col = w0 - d + m;
          if (m >= cols) continue;
          const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (col >= 0 && col < W) {
            const float2 bias = *reinterpret_cast<const float2*>(b31 + co);
            v.x = fmaxf(c_acc[i][nt][2 * h] + bias.x, 0.f);
            v.y = fmaxf(c_acc[i][nt][2 * h + 1] + bias.y, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(c_s + m * K::LDB + co) =
              __floats2bfloat162_rn(v.x, v.y);
        }
  }

  // ---- stage B: y = colconv_d(c) [+ u @ rap], A fragments straight from c_s ----
  // (the first barrier of the ring orders the c_s writes above before these reads)
  zero_frags(acc);
  constexpr int kConv = 3 * K::NCH;  // stage s < kConv: tap s / NCH, rows s*KC of w13
  pipeline(
      kConv + (rap != nullptr ? K::NCH : 0),
      [&](int s, int buf) {
        bf16* A = ring + buf * K::STAGE;
        if (s < kConv) {
          fetch_weights<C>(A + K::B_OFF, w13 + static_cast<size_t>(s) * K::KC * C);
        } else {
          const int ci0 = (s - kConv) * K::KC;
          fetch_rows<C>(A, u + (img_row0 + r) * W * C + ci0, w0, K::TM, W);
          fetch_weights<C>(A + K::B_OFF, rap + static_cast<size_t>(ci0) * C);
        }
      },
      [](int, int) {},
      [&](int s, int buf) {
        const bf16* stage = ring + buf * K::STAGE;
        const bf16* B = stage + K::B_OFF + wn * K::NT * 8;
        const int m0 = wm * K::MT * 16;
        if (s < kConv) {
          const int tap = s / K::NCH, ci0 = (s % K::NCH) * K::KC;
          warp_mma<K::KC, K::MT, K::NT, K::LDB, K::LDB>(
              acc, c_s + (m0 + tap * d) * K::LDB + ci0, 16, K::MT, B);
        } else {
          warp_mma<K::KC, K::MT, K::NT, K::LDA, K::LDB>(acc, stage + m0 * K::LDA, 16, K::MT, B);
        }
      });
}

// Bytes of shared memory of a bf16 pair CTA at dilation d: the ring and c.
template <int C>
size_t bf16_pair_smem_bytes(int d) {
  using K = Mma<C>;
  return sizeof(bf16) * (static_cast<size_t>(kStages) * K::STAGE +
                         static_cast<size_t>(K::TM + 2 * d) * K::LDB);
}

// The grid of a bf16 pair launch: one CTA per (image, row, TM output columns).
template <int C>
dim3 bf16_pair_grid(int n, int h, int w) {
  return dim3((w + Mma<C>::TM - 1) / Mma<C>::TM, h, n);
}

}  // namespace
