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
// Design: one "conv-pair" kernel, launched twice per block.
//   pair 1: u = x, dilation 1, epilogue relu(a1*y + b1)      -> m (global)
//   pair 2: u = m, dilation d, epilogue relu(a2*y + b2 + x)   -> out
// m goes through global memory in the activation type (<= 8 MB in fp32 per
// image at 512x1024, so it stays in the 50 MB L2). With that split, the JAX
// kernel's zeroing of mid rows outside the image (nb1d.py:118-125) is plain
// zero padding of pair 2's row conv: a tap whose row falls outside the image
// is skipped, uniformly over the CTA.
//
// One CTA owns one image row and a tile of output columns, all C channels.
//   stage A: c = relu(rowconv_d(u) + b31) for the tile's columns and d more on
//            each side, kept in shared memory; columns outside the image are 0
//            (the zero padding of the 1x3 conv's input).
//   stage B: y = colconv_d(c) [+ u @ rap] for the tile's columns, then the
//            epilogue relu(a*y + b [+ res]) in fp32, written in the activation
//            type.
// Each stage is a small GEMM, (pixels x 3C) @ (3C x C), with K streamed through
// shared memory in chunks of input channels (the C=128 weights, 3x128x128, do
// not fit beside the tile). Any N, H, W are taken: the last column tile masks
// its ragged edge and a row tile is one row, so no tile has to divide H or W.
// Activations are NHWC (torch.channels_last), C in {16, 64, 128}.
//
// Two kernels, one per activation type (weights in the same type), both on the
// tensor cores with mma.sync:
//   float32, nb1d_pair_tf32_kernel<C> (eval, and the train step's eval-mode
//     teacher): the training forward's pair mainloop (tf32_pair.cuh, K2's
//     stage A and stage B, no pre-stage) with K1's epilogue in place of K2's
//     stats. Every product is 3xTF32 mma.sync.m16n8k8 (each operand split
//     into hi = rna_tf32(x) and lo = rna_tf32(x - hi), lo*hi + hi*lo + hi*hi,
//     each K chunk added to a float32 sum to nearest), so it keeps float32
//     accuracy (held to the fp32 plain version at 1e-5 relative L2); c stays
//     in fp32 shared memory. Two CTAs per SM (128 registers, a 2-deep ring), 8
//     warps each, TM = 64 / 128 / 256 output columns at C = 128 / 64 / 16. At
//     C = 64 / 128 ptxas spills six words (24 bytes): u's row addresses of the
//     RAP stages, stored once before stage B and read when those stages fetch
//     u, none in the products. For
//     the same inputs its y equals K2's bit for bit (card test
//     test_k1_fp32_and_k2_compute_the_same_y).
//   bfloat16, nb1d_pair_mma_kernel<C> (the serving default; the bf16 pair
//     mainloop of bf16_pair.cuh, which K2's and K3's bf16 kernels share): every product of
//     both stages is an mma.sync m16n8k16 bf16 tile GEMM with fp32
//     accumulators. u rows and weight chunks reach shared memory through
//     16-byte cp.async in a 3-deep ring (sm90_async.cuh), one barrier per
//     chunk; fragments load with ldmatrix (A [pixel][k] as is, B [k][co]
//     transposed), from rows padded by 8 bf16 so the 8 rows of one ldmatrix
//     fall on distinct banks. c is rounded to bf16 in shared memory, as the
//     Pallas kernel rounds it to the activation type (nb1d.py:112, :128), and
//     stage B reads its A fragments straight from it at the column shifts k*d;
//     RAP is one more K block, taken from u's own row. Eight warps per CTA,
//     each a 32-column x 32-channel tile (x 16 channels at C=16), so a CTA
//     takes TM = 64 / 128 / 256 output columns at C = 128 / 64 / 16. Every
//     CTA streams all the weights through shared memory, so the pixels a CTA
//     owns are what each weight byte is used for: four warps per CTA (TM = 32
//     at C=128, 256 CTAs on the 64x128 map at batch 1) were measured slower on
//     every block at batch 1 and 6 than these 128 CTAs of eight warps
//     (tools_torch/k1_variants.py).
//
// What bounds it on the H100: per block at batch 1 in bf16, a C=64 or C=128
// RAP block is ~3.76 GFLOP against ~8.5 MB (C=64 at 128x256) or ~4.7 MB
// (C=128 at 64x128) read and written once, 450-800 FLOP/B, so compute-bound
// at the tensor-core rate: ~3.8 us at 989 TFLOP/s. The C=16 decoder block is
// ~0.8 GFLOP against 8.4 MB, memory-bound: ~2.5 us at 3.35 TB/s. The 17
// blocks of one forward are ~57 GFLOP, a bound of ~61 us per image in bf16;
// in fp32 the same FLOPs are ~0.35 ms per image as 3xTF32 (3 TF32 products per
// product at 495 TFLOP/s) and ~0.85 ms on the CUDA cores (67 TFLOP/s). Both
// kernels keep c out of device memory and m in L2. Stage A recomputes the 2d
// halo columns of every tile (at d=16, 96 columns for 64 outputs at C=128),
// and a kernel's CTAs are few at batch 1, so launch tails weigh. wgmma with
// TMA, warp specialisation and a single-launch block are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bf16_pair.cuh"
#include "sm90_async.cuh"
#include "tf32_pair.cuh"

namespace {

// ---- float32: 3xTF32 on the tensor cores, on the pair mainloop ------------------------------

// One conv pair in float32: y from the pair mainloop with no pre-stage, then relu(a*y + b
// [+ res]). rap (C x C, [ci][co]) and res may be null. Shared memory: pair_smem_bytes.
template <int C>
__global__ void __launch_bounds__(kThreads, K2_CTAS)
nb1d_pair_tf32_kernel(const float* __restrict__ u, const float* __restrict__ w31,
                      const float* __restrict__ b31, const float* __restrict__ w13,
                      const float* __restrict__ rap, const float* __restrict__ a,
                      const float* __restrict__ b, const float* __restrict__ res,
                      float* __restrict__ out, int H, int W, int d) {
  using B = K2B<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w0 = blockIdx.x * B::TM;
  const size_t row_base = (static_cast<size_t>(blockIdx.z) * H + blockIdx.y) * W;
  Frag<B::MT, B::NT> f;
  pair_mainloop<C>(smem, u, w31, b31, w13, rap, nullptr, nullptr, H, W, d, f);

  // ---- epilogue: relu(a*y + b [+ res]) in fp32, written as float2 pairs ----
  frag_pairs<B>(0, [&](int mt, int nt, int h, int m, int co) {
    if (w0 + m >= W) return;
    const size_t off = (row_base + w0 + m) * C + co;
    const float2 av = *reinterpret_cast<const float2*>(a + co);
    const float2 bv = *reinterpret_cast<const float2*>(b + co);
    float y0 = fmaf(av.x, f.acc[mt][nt][2 * h], bv.x);
    float y1 = fmaf(av.y, f.acc[mt][nt][2 * h + 1], bv.y);
    if (res != nullptr) {
      const float2 rv = *reinterpret_cast<const float2*>(res + off);
      y0 += rv.x;
      y1 += rv.y;
    }
    st2(out + off, fmaxf(y0, 0.f), fmaxf(y1, 0.f));
  });
}

template <int C>
cudaError_t launch_tf32(const void* u, const void* w31, const void* b31, const void* w13,
                        const void* rap, const void* a, const void* b, const void* res,
                        void* out, int n, int h, int w, int d, cudaStream_t stream) {
  // the ring and c; a halo past the card's shared memory per block fails here
  const size_t smem = pair_smem_bytes<C>(d);
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(nb1d_pair_tf32_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  nb1d_pair_tf32_kernel<C><<<pair_grid<C>(n, h, w), kThreads, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(w31),
      static_cast<const float*>(b31), static_cast<const float*>(w13),
      static_cast<const float*>(rap), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(res), static_cast<float*>(out), h,
      w, d);
  return cudaGetLastError();
}

// ---- bfloat16: the tensor-core kernel on the bf16 pair mainloop (bf16_pair.cuh) -------------

// One conv pair in bf16: y from the bf16 pair mainloop with no pre-stage, then relu(a*y + b
// [+ res]). rap (C x C, [ci][co]) and res may be null. Shared memory: bf16_pair_smem_bytes.
template <int C>
__global__ void __launch_bounds__(Mma<C>::THREADS, 512 / Mma<C>::THREADS)  // <= 128 registers
nb1d_pair_mma_kernel(const bf16* __restrict__ u, const bf16* __restrict__ w31,
                     const float* __restrict__ b31, const bf16* __restrict__ w13,
                     const bf16* __restrict__ rap, const float* __restrict__ a,
                     const float* __restrict__ b, const bf16* __restrict__ res,
                     bf16* __restrict__ out, int H, int W, int d) {
  using K = Mma<C>;
  extern __shared__ uint4 smem16[];
  const int w0 = blockIdx.x * K::TM, r = blockIdx.y;
  const size_t img_row0 = static_cast<size_t>(blockIdx.z) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % K::WM, wn = warp / K::WM, g = lane >> 2, t = lane & 3;
  float acc[K::MT][K::NT][4];
  bf16_pair_mainloop<C>(reinterpret_cast<bf16*>(smem16), u, w31, b31, w13, rap, H, W, d, acc);

  // ---- epilogue: relu(a*y + b [+ res]) in fp32, written as bf16 ----
#pragma unroll
  for (int i = 0; i < K::MT; ++i)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w0 + wm * K::MT * 16 + i * 16 + g + 8 * h;
        if (col >= W) continue;
        const int co = wn * K::NT * 8 + nt * 8 + 2 * t;
        const size_t off = ((img_row0 + r) * W + col) * C + co;
        const float2 av = *reinterpret_cast<const float2*>(a + co);
        const float2 bv = *reinterpret_cast<const float2*>(b + co);
        float y0 = fmaf(av.x, acc[i][nt][2 * h], bv.x);
        float y1 = fmaf(av.y, acc[i][nt][2 * h + 1], bv.y);
        if (res != nullptr) {
          const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + off));
          y0 += rv.x;
          y1 += rv.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
      }
}

template <int C>
cudaError_t launch_mma(const void* u, const void* w31, const void* b31, const void* w13,
                       const void* rap, const void* a, const void* b, const void* res, void* out,
                       int n, int h, int w, int d, cudaStream_t stream) {
  const size_t smem = bf16_pair_smem_bytes<C>(d);
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = nb1d_pair_mma_kernel<C>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<bf16_pair_grid<C>(n, h, w), Mma<C>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(w31), static_cast<const float*>(b31),
      static_cast<const bf16*>(w13), static_cast<const bf16*>(rap), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(res), static_cast<bf16*>(out), h, w,
      d);
  return cudaGetLastError();
}

// dtype 0: the float32 3xTF32 kernel; dtype 1: the bf16 kernel
template <int C>
cudaError_t launch_channels(int dtype, const void* u, const void* w31, const void* b31,
                            const void* w13, const void* rap, const void* a, const void* b,
                            const void* res, void* out, int n, int h, int w, int d,
                            cudaStream_t stream) {
  if (dtype == 0) return launch_tf32<C>(u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, stream);
  if (dtype == 1) return launch_mma<C>(u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, stream);
  return cudaErrorInvalidValue;
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
  if (channels == 16)
    err = launch_channels<16>(dtype, u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, s);
  else if (channels == 64)
    err = launch_channels<64>(dtype, u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, s);
  else if (channels == 128)
    err = launch_channels<128>(dtype, u, w31, b31, w13, rap, a, b, res, out, n, h, w, d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* nb1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
