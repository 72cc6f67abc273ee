// Fused non-bottleneck-1d (nb1d / nb1d_RAP) inference block for Hopper (sm_90a).
//
// Replaces mdilss_tpu/ops/pallas/nb1d.py::_kernel (entry nb1d_fused_infer),
// the TPU kernel that runs a whole eval-mode block in one program:
//
//   m   = relu(a1 * (colconv_1(relu(rowconv_1(x) + b31a)) [+ x @ rap1]) + b1)
//   out = relu(a2 * (colconv_d(relu(rowconv_d(m) + b31b)) [+ m @ rap2]) + b2 + x)
//
// rowconv_d is the 3x1 conv with row dilation d, colconv_d the 1x3 conv with
// column dilation d, both zero-padded "same" convs; (a, b) is the running-stats
// BN folded with the 1x3 and RAP biases (mdilss_tpu_torch/ops/norm.py fold_bn).
//
// Design: one templated "conv-pair" kernel, launched twice per block.
//   pair 1: u = x, dilation 1, epilogue relu(a1*y + b1)      -> m (global)
//   pair 2: u = m, dilation d, epilogue relu(a2*y + b2 + x)   -> out
// m goes through global memory (<= 4 MB in bf16 per image at 512x1024, so it
// stays in the 50 MB L2). With that split, the JAX kernel's zeroing of mid
// rows outside the image (nb1d.py:118-125) is plain zero padding of pair 2's
// row conv: a tap whose row falls outside the image is skipped.
//
// One CTA owns one image row and TW output columns, all C channels.
//   stage A: c = relu(rowconv_d(u) + b31) for the TW + 2d columns
//            [w0-d, w0+TW+d), kept in shared memory as fp32; columns outside
//            the image are 0 (the zero padding of the 1x3 conv's input).
//   stage B: y = colconv_d(c) [+ u @ rap] for the TW columns, then the
//            epilogue, written in the activation type.
// Each stage is a small GEMM (pixels x 3C) @ (3C x C) done with plain fp32
// FMAs: the K dimension streams through shared memory in chunks of KC input
// channels (the C=128 weights, 3x128x128, do not fit beside the tile), and
// every thread accumulates a 4-pixel x MC-channel tile in registers.
// Activations are fp32 or bf16 (weights in the same type); accumulation and
// the intermediate c are always fp32. Any N, H, W are taken: the last column
// tile masks its ragged edge and a row tile is one row, so no tile has to
// divide H or W. Activations are NHWC (torch.channels_last), C in {16,64,128}.
//
// What bounds it on the H100: per block at batch 1 in bf16, a C=64 or C=128
// RAP block is ~3.76 GFLOP against ~8.5 MB (C=64 at 128x256) or ~4.7 MB
// (C=128 at 64x128) read and written once, 450-800 FLOP/B, so compute-bound
// at the tensor-core rate: ~3.8 us at 989 TFLOP/s. The C=16 decoder block is
// ~0.8 GFLOP against 8.4 MB, memory-bound: ~2.5 us at 3.35 TB/s. The 17
// blocks of one forward are ~57 GFLOP, a bound of ~61 us per image (in fp32
// on the CUDA cores, 67 TFLOP/s: ~0.85 ms). This simple design does little about that bound: it
// keeps c out of device memory and m in L2, but it computes on the CUDA
// cores in fp32 (67 TFLOP/s peak, ~15x below the bf16 tensor-core rate),
// and stage A recomputes 2d halo columns per tile. Tensor cores (mma.sync or
// wgmma with TMA) and a single-launch block are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
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

template <typename T>
cudaError_t dispatch_channels(int channels, const void* u, const void* w31, const void* b31,
                              const void* w13, const void* rap, const void* a, const void* b,
                              const void* res, void* out, int n, int h, int w, int d,
                              cudaStream_t stream) {
  switch (channels) {
    case 16: return launch<T, 16>(u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, stream);
    case 64: return launch<T, 64>(u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, stream);
    case 128: return launch<T, 128>(u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One conv pair on the given stream; allocates nothing and does not
// synchronise. dtype: 0 = float32, 1 = bfloat16 (u, weights, res, out);
// b31, a, b are float32 [C]. Tensors are NHWC-contiguous. rap and res may be
// null. Returns the cudaError_t of the launch (0 on success).
extern "C" int nb1d_pair(int dtype, int channels, const void* u, const void* w31, const void* b31,
                         const void* w13, const void* rap, const void* a, const void* b,
                         const void* res, void* out, int n, int h, int w, int d, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || d <= 0 || h > 65535 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_channels<float>(channels, u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, s);
  else if (dtype == 1)
    err = dispatch_channels<__nv_bfloat16>(channels, u, w31, b31, w13, rap, a, b, res, out, n, h,
                                           w, d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* nb1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
