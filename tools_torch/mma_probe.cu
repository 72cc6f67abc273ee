// Throughput of warp-level mma.sync on one NVIDIA card: TF32 m16n8k8 (what K3 runs, three per
// fp32 product) and BF16 m16n8k16, each warp keeping 8 independent accumulators, no memory traffic.
// Prints TFLOP/s and mma per clock per SM at the card's rated SM clock. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_probe tools_torch/mma_probe.cu
//   build/mma_probe
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

template <bool BF16>
__global__ void __launch_bounds__(256) probe(float* out, int iters, uint32_t seed) {
  float acc[8][4] = {};
  const uint32_t a[4] = {seed, seed * 3, seed * 5, seed * 7}, b0 = seed * 11, b1 = seed * 13;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool BF16>
int run(const char* name, int ctas_per_sm) {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int blocks = sms * ctas_per_sm, threads = 256, iters = 4096;
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * threads) != cudaSuccess) return 1;
  probe<BF16><<<blocks, threads>>>(out, 16, 1);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<BF16><<<blocks, threads>>>(out, iters, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  const cudaError_t err = cudaGetLastError();
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = double(blocks) * (threads / 32) * iters * 8;
  const double flop_per_mma = 2.0 * 16 * 8 * (BF16 ? 16 : 8);
  printf("%s, %d CTAs of 256 threads per SM: %.3f ms, %.1f TFLOP/s, %.3f mma/clk/SM at %d MHz (%s)\n",
         name, ctas_per_sm, ms, mmas * flop_per_mma / (ms * 1e-3) / 1e12,
         mmas / sms / (ms * 1e-3) / (khz * 1e3), khz / 1000, cudaGetErrorString(err));
  cudaFree(out);
  return err == cudaSuccess ? 0 : 1;
}

int main() {
  int rc = 0;
  for (int ctas : {1, 2, 4}) rc |= run<false>("mma.sync m16n8k8 tf32", ctas);
  for (int ctas : {1, 2, 4}) rc |= run<true>("mma.sync m16n8k16 bf16", ctas);
  return rc;
}
