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
//   fwd_pair_kernel   one CTA per (image, row, TW columns): c for TW + 2d columns in shared
//                     memory, then y, then the CTA's [2][C] partial stats;
//   bwd_dc_kernel     same tiling: c for the TW columns (also written to a scratch buffer),
//                     then dc; writing dc keeps every halo 1-D (2 launches instead of one CTA
//                     needing u rows r-2d..r+2d);
//   bwd_du_kernel     same tiling: du from dc and gy;
//   bwd_wgrad_kernel  grid (P, matrices): each CTA walks a fixed set of pixel tiles and keeps
//                     one C x C weight gradient in registers, then writes its partial;
//   reduce_kernel     sums the partials in a fixed order.
// Every product is a small GEMM done with fp32 FMAs on the CUDA cores: the K dimension (input
// channels) streams through shared memory in chunks of KC, and each thread keeps a
// 4-pixel x MC-channel (or TI x TI weight) tile in registers. Activations are fp32, NHWC
// (torch.channels_last), C in {16, 64, 128}; any N, H, W (the last column tile masks its edge).
//
// What bounds it on the H100: per pixel the forward pair is 7C^2 MACs (6C^2 without RAP) and
// the backward 17C^2 (recompute 3C^2, dc 3C^2, du 4C^2, weight grads 7C^2; 2C^2 less without
// RAP) against 2-3 reads and writes of C fp32 values: for C = 64/128 that is 100-600 FLOP per
// byte, so compute-bound at the fp32 rate of the CUDA cores (67 TFLOP/s); the C=16 pair is
// closer to the memory line.
// This first version does nothing about the tensor cores (989 TFLOP/s bf16, 495 TF32) and
// recomputes c in the backward rather than storing it; both are later work.
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// relu(a * v + b) on channels ch .. ch+3: the pre-stage (BN affine of the previous pair + relu)
__device__ __forceinline__ float4 pre4(float4 v, const float* __restrict__ a,
                                       const float* __restrict__ b, int ch) {
  const float4 av = ld4(a + ch), bv = ld4(b + ch);
  return make_float4(fmaxf(fmaf(av.x, v.x, bv.x), 0.f), fmaxf(fmaf(av.y, v.y, bv.y), 0.f),
                     fmaxf(fmaf(av.z, v.z, bv.z), 0.f), fmaxf(fmaf(av.w, v.w, bv.w), 0.f));
}

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

__device__ __forceinline__ size_t cta_index() {
  return (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
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

// ---- K3, launch 1: c (recomputed) and dc ---------------------------------------------------
template <int C>
__global__ void __launch_bounds__(kThreads)
bwd_dc_kernel(const float* __restrict__ raw, const float* __restrict__ gy,
              const float* __restrict__ w31, const float* __restrict__ b31,
              const float* __restrict__ w13t, const float* __restrict__ pa,
              const float* __restrict__ pb, float* __restrict__ cbuf, float* __restrict__ dc,
              int H, int W, int d) {
  using K = Cfg<C>;
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);
  float* B_s = A_s + K::KC * K::LDA;
  float* c_s = B_s + K::KC * C;  // [TW][C]

  const int w0 = blockIdx.x * K::TW, r = blockIdx.y, n = blockIdx.z;
  const int cg = threadIdx.x % K::CG, p0 = (threadIdx.x / K::CG) * kMP;

  float acc[kMP][K::MC];
  float bias[K::MC];
  load_slots<C>(b31, cg, bias);

  zero<C>(acc);
  row_conv<C>(A_s, B_s, raw, w31, n, r, w0, K::TW, H, W, d, pa, pb, p0, cg, acc);
#pragma unroll
  for (int i = 0; i < kMP; ++i) {
    const int col = w0 + p0 + i;
    const size_t base = ((static_cast<size_t>(n) * H + r) * W + col) * C;
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j) {
      const int ch = slot_channel(j, cg, K::CG);
      const float4 v = make_float4(fmaxf(acc[i][4 * j + 0] + bias[4 * j + 0], 0.f),
                                   fmaxf(acc[i][4 * j + 1] + bias[4 * j + 1], 0.f),
                                   fmaxf(acc[i][4 * j + 2] + bias[4 * j + 2], 0.f),
                                   fmaxf(acc[i][4 * j + 3] + bias[4 * j + 3], 0.f));
      st4(c_s + (p0 + i) * C + ch, v);
      if (col < W) st4(cbuf + base + ch, v);
    }
  }

  // g = colconv_d^T(gy): the 1x3 conv of gy with the transposed, tap-reversed stack
  zero<C>(acc);
  for (int k = 0; k < 3; ++k) {
    for (int ci0 = 0; ci0 < C; ci0 += K::KC) {
      __syncthreads();
      load_a_global<C>(A_s, gy, n, r, w0 + (k - 1) * d, ci0, K::TW, H, W, nullptr, nullptr);
      load_b<C>(B_s, w13t, k * C + ci0);
      __syncthreads();
      fma_chunk<C>(A_s, B_s, p0, cg, acc);
    }
  }

  // dc = g * [c > 0]
#pragma unroll
  for (int i = 0; i < kMP; ++i) {
    const int col = w0 + p0 + i;
    if (col >= W) continue;
    const size_t base = ((static_cast<size_t>(n) * H + r) * W + col) * C;
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j) {
      const int ch = slot_channel(j, cg, K::CG);
      const float4 cv = ld4(c_s + (p0 + i) * C + ch);
      const float4 v = make_float4(cv.x > 0.f ? acc[i][4 * j + 0] : 0.f,
                                   cv.y > 0.f ? acc[i][4 * j + 1] : 0.f,
                                   cv.z > 0.f ? acc[i][4 * j + 2] : 0.f,
                                   cv.w > 0.f ? acc[i][4 * j + 3] : 0.f);
      st4(dc + base + ch, v);
    }
  }
}

// ---- K3, launch 2: du ------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(kThreads)
bwd_du_kernel(const float* __restrict__ dc, const float* __restrict__ gy,
              const float* __restrict__ w31t, const float* __restrict__ rapt,
              float* __restrict__ du, int H, int W, int d) {
  using K = Cfg<C>;
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);
  float* B_s = A_s + K::KC * K::LDA;

  const int w0 = blockIdx.x * K::TW, r = blockIdx.y, n = blockIdx.z;
  const int cg = threadIdx.x % K::CG, p0 = (threadIdx.x / K::CG) * kMP;

  float acc[kMP][K::MC];
  zero<C>(acc);
  row_conv<C>(A_s, B_s, dc, w31t, n, r, w0, K::TW, H, W, d, nullptr, nullptr, p0, cg, acc);
  if (rapt != nullptr)
    pixel_mm<C>(A_s, B_s, gy, rapt, n, r, w0, K::TW, H, W, nullptr, nullptr, p0, cg, acc);
#pragma unroll
  for (int i = 0; i < kMP; ++i) {
    const int col = w0 + p0 + i;
    if (col >= W) continue;
    const size_t base = ((static_cast<size_t>(n) * H + r) * W + col) * C;
#pragma unroll
    for (int j = 0; j < K::MC / 4; ++j)
      st4(du + base + slot_channel(j, cg, K::CG),
          make_float4(acc[i][4 * j + 0], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]));
  }
}

// ---- K3, launch 3: weight-gradient partials --------------------------------------------------
template <int C>
struct WCfg {
  static constexpr int TI = C >= 64 ? 8 : 4;    // a thread's outputs along ci and along co
  static constexpr int NG = C / TI;             // thread groups along each axis
  static constexpr int OT = NG * NG;            // threads covering one C x C matrix
  static constexpr int G = kThreads / OT;       // pixel lanes (summed in a fixed order at the end)
  static constexpr int TP = C >= 128 ? 32 : 4096 / C;  // pixels per staged tile
  static_assert(kThreads % OT == 0 && TP % G == 0 && TI % 4 == 0, "wgrad tile shape");
};

// Offsets in the gradient vector [dw31 3C^2 | dw13 3C^2 | db31 C | drap C^2].
__host__ __device__ constexpr size_t grad_offset(int mat, int C) {
  return mat < 6 ? static_cast<size_t>(mat) * C * C : static_cast<size_t>(6) * C * C + C;
}

// Matrix `mat` of CTA column blockIdx.y: 0-2 dw31[k] (A = u at row r+(k-1)d, B = dc),
// 3-5 dw13[k] (A = c at column w+(k-1)d, B = gy), 6 drap (A = u, B = gy); matrix 1 also sums
// db31 = sum dc. CTA blockIdx.x of P takes pixel tiles blockIdx.x, blockIdx.x + P, ...
template <int C>
__global__ void __launch_bounds__(kThreads)
bwd_wgrad_kernel(const float* __restrict__ raw, const float* __restrict__ pa,
                 const float* __restrict__ pb, const float* __restrict__ cbuf,
                 const float* __restrict__ dc, const float* __restrict__ gy,
                 float* __restrict__ part, size_t part_len, int N, int H, int W, int d) {
  using K = WCfg<C>;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [TP][C]
  float* Bs = As + K::TP * C;                    // [TP][C]
  float* rb = Bs + K::TP * C;                    // [G][C]    db31 lanes
  float* rm = rb + K::G * C;                     // [G][C*C]  matrix lanes (G > 1)

  const int mat = blockIdx.y, P = gridDim.x;
  const int ot = threadIdx.x % K::OT, lane = threadIdx.x / K::OT;
  const int gi = ot / K::NG, gj = ot % K::NG;
  const long long npx = static_cast<long long>(N) * H * W;
  const long long ntiles = (npx + K::TP - 1) / K::TP;

  const bool a_is_c = mat >= 3 && mat < 6;
  const float* asrc = a_is_c ? cbuf : raw;
  const float* bsrc = mat < 3 ? dc : gy;
  const float* apa = a_is_c ? nullptr : pa;
  const int drow = mat < 3 ? (mat - 1) * d : 0;
  const int dcol = a_is_c ? (mat - 4) * d : 0;

  float acc[K::TI][K::TI];
  float bsum[K::TI];
#pragma unroll
  for (int i = 0; i < K::TI; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int k = 0; k < K::TI; ++k) acc[i][k] = 0.f;
  }

  for (long long tile = blockIdx.x; tile < ntiles; tile += P) {
    const long long p_base = tile * K::TP;
    __syncthreads();
    for (int idx = threadIdx.x; idx < K::TP * (C / 4); idx += kThreads) {
      const int p = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long long flat = p_base + p;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
      if (flat < npx) {
        const int w = static_cast<int>(flat % W);
        const long long nr = flat / W;
        const int r = static_cast<int>(nr % H), n = static_cast<int>(nr / H);
        bv = ld4(bsrc + flat * C + c4);
        const int ar = r + drow, ac = w + dcol;
        if (ar >= 0 && ar < H && ac >= 0 && ac < W) {
          av = ld4(asrc + ((static_cast<long long>(n) * H + ar) * W + ac) * C + c4);
          if (apa != nullptr) av = pre4(av, apa, pb, c4);
        }
      }
      st4(As + p * C + c4, av);
      st4(Bs + p * C + c4, bv);
    }
    __syncthreads();
    for (int p = lane; p < K::TP; p += K::G) {
      float a[K::TI], b[K::TI];
#pragma unroll
      for (int j = 0; j < K::TI / 4; ++j) {
        const float4 va = ld4(As + p * C + slot_channel(j, gi, K::NG));
        const float4 vb = ld4(Bs + p * C + slot_channel(j, gj, K::NG));
        a[4 * j + 0] = va.x; a[4 * j + 1] = va.y; a[4 * j + 2] = va.z; a[4 * j + 3] = va.w;
        b[4 * j + 0] = vb.x; b[4 * j + 1] = vb.y; b[4 * j + 2] = vb.z; b[4 * j + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < K::TI; ++i)
#pragma unroll
        for (int k = 0; k < K::TI; ++k) acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
      if (mat == 1) {
#pragma unroll
        for (int k = 0; k < K::TI; ++k) bsum[k] += b[k];
      }
    }
  }

  float* out = part + static_cast<size_t>(blockIdx.x) * part_len + grad_offset(mat, C);
  if constexpr (K::G == 1) {
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
#pragma unroll
      for (int k = 0; k < K::TI; ++k) {
        const int ci = slot_channel(i / 4, gi, K::NG) + i % 4;
        const int co = slot_channel(k / 4, gj, K::NG) + k % 4;
        out[ci * C + co] = acc[i][k];
      }
  } else {
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
#pragma unroll
      for (int k = 0; k < K::TI; ++k) {
        const int ci = slot_channel(i / 4, gi, K::NG) + i % 4;
        const int co = slot_channel(k / 4, gj, K::NG) + k % 4;
        rm[static_cast<size_t>(lane) * C * C + ci * C + co] = acc[i][k];
      }
    __syncthreads();
    for (int e = threadIdx.x; e < C * C; e += kThreads) {
      float sum = 0.f;
      for (int g = 0; g < K::G; ++g) sum += rm[static_cast<size_t>(g) * C * C + e];
      out[e] = sum;
    }
  }
  if (mat == 1) {
    if (gi == 0) {
#pragma unroll
      for (int k = 0; k < K::TI; ++k) rb[lane * C + slot_channel(k / 4, gj, K::NG) + k % 4] = bsum[k];
    }
    __syncthreads();
    float* db = part + static_cast<size_t>(blockIdx.x) * part_len + static_cast<size_t>(6) * C * C;
    for (int t = threadIdx.x; t < C; t += kThreads) {
      float sum = 0.f;
      for (int g = 0; g < K::G; ++g) sum += rb[g * C + t];
      db[t] = sum;
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

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int C>
dim3 conv_grid(int n, int h, int w) {
  return dim3((w + Cfg<C>::TW - 1) / Cfg<C>::TW, h, n);
}

template <int C>
size_t fwd_partials(int n, int h, int w) {
  const dim3 g = conv_grid<C>(n, h, w);
  return static_cast<size_t>(g.x) * g.y * g.z;
}

template <int C>
int wgrad_ctas(int n, int h, int w) {
  const long long npx = static_cast<long long>(n) * h * w;
  const long long ntiles = (npx + WCfg<C>::TP - 1) / WCfg<C>::TP;
  return static_cast<int>(ntiles < 64 ? ntiles : 64);
}

size_t grad_len(int C, bool rap) {
  return static_cast<size_t>(6) * C * C + C + (rap ? static_cast<size_t>(C) * C : 0);
}

template <int C>
cudaError_t fwd(const float* x, const float* w31, const float* b31, const float* w13,
                const float* rap, const float* pa, const float* pb, float* y, float* stats,
                float* scratch, int n, int h, int w, int d, cudaStream_t s) {
  using K = Cfg<C>;
  const size_t smem = sizeof(float) * (K::AB + static_cast<size_t>(K::TW + 2 * d) * C);
  cudaError_t err = set_smem(fwd_pair_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  fwd_pair_kernel<C><<<conv_grid<C>(n, h, w), kThreads, smem, s>>>(x, w31, b31, w13, rap, pa, pb,
                                                                   y, scratch, h, w, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, static_cast<int>(fwd_partials<C>(n, h, w)), 2 * C, stats, s);
}

template <int C>
cudaError_t bwd(const float* raw, const float* gy, const float* w31, const float* b31,
                const float* w13t, const float* w31t, const float* rapt, const float* pa,
                const float* pb, float* du, float* grads, float* scratch, int n, int h, int w,
                int d, cudaStream_t s) {
  using K = Cfg<C>;
  using WK = WCfg<C>;
  const size_t act = static_cast<size_t>(n) * h * w * C;
  float* cbuf = scratch;
  float* dc = scratch + act;
  float* part = scratch + 2 * act;
  const dim3 grid = conv_grid<C>(n, h, w);

  size_t smem = sizeof(float) * (K::AB + static_cast<size_t>(K::TW) * C);
  cudaError_t err = set_smem(bwd_dc_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  bwd_dc_kernel<C><<<grid, kThreads, smem, s>>>(raw, gy, w31, b31, w13t, pa, pb, cbuf, dc, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = sizeof(float) * K::AB;
  if ((err = set_smem(bwd_du_kernel<C>, smem)) != cudaSuccess) return err;
  bwd_du_kernel<C><<<grid, kThreads, smem, s>>>(dc, gy, w31t, rapt, du, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const bool rap = rapt != nullptr;
  const size_t len = grad_len(C, rap);
  const int P = wgrad_ctas<C>(n, h, w);
  smem = sizeof(float) * (2 * static_cast<size_t>(WK::TP) * C + static_cast<size_t>(WK::G) * C +
                          (WK::G > 1 ? static_cast<size_t>(WK::G) * C * C : 0));
  if ((err = set_smem(bwd_wgrad_kernel<C>, smem)) != cudaSuccess) return err;
  bwd_wgrad_kernel<C><<<dim3(P, rap ? 7 : 6), kThreads, smem, s>>>(raw, pa, pb, cbuf, dc, gy, part,
                                                                  len, n, h, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(part, P, len, grads, s);
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
