// The cost of a warp's 16-byte shared-memory load (LDS.128) by how many
// distinct addresses its 32 lanes read: what bounds a register-blocked fp32
// product fed from shared memory, such as the flash backward's
// (src/repro_torch/kernels/csrc/flash_attention_bwd.cu).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/smem_bench \
//       benchmarks/port/smem_bench.cu && build/smem_bench
//
// One block of 8 warps an SM on every SM; each warp issues 16 independent
// loads an iteration, summed so that none is dead. Prints, per pattern, SM
// cycles (clock64) per warp load: 8 warps' loads over the block's cycles.
// An SM retires 4 warp FMAs a cycle, so a product is bound by shared
// memory when it does fewer than 4 FMAs a warp per cycle of its loads.
#include <cuda_runtime.h>
#include <stdio.h>

namespace {

constexpr int kWords = 1024;  // float4s of shared memory
constexpr int kThreads = 256;
constexpr int kUnroll = 16;

// The float4 a lane reads under each pattern; rows of 33 float4s (132
// floats, as the backward's padded rows at hd 128) put 8 rows on distinct
// banks.
__device__ int lane_index(int pattern, int lane) {
  switch (pattern) {
    case 0: return lane;                 // 32 distinct, contiguous
    case 1: return (lane & 7) * 33;      // 8 distinct rows, distinct banks
    case 2: return lane & 7;             // 8 distinct, contiguous 128 bytes
    case 3: return (lane >> 3) * 33;     // 4 distinct rows
    default: return 0;                   // 1: a broadcast
  }
}

__global__ void __launch_bounds__(kThreads)
bench(int pattern, int iters, float* out, long long* cycles) {
  __shared__ float4 sm[kWords];
  const int tid = threadIdx.x;
  for (int i = tid; i < kWords; i += kThreads)
    sm[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int idx = lane_index(pattern, tid & 31);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float4 x = sm[(idx + 2 * u + (it & 1)) & (kWords - 1)];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
  }
  const long long t1 = clock64();
  out[blockIdx.x * kThreads + tid] = acc.x + acc.y + acc.z + acc.w;
  if (tid == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "smem_bench: no CUDA device\n");
    return 1;
  }
  const int sms = prop.multiProcessorCount, iters = 2000;
  float* out = nullptr;
  long long* cycles = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * kThreads);
  cudaMalloc(&cycles, sizeof(long long) * sms);
  const char* names[] = {"32 distinct, contiguous", "8 distinct rows",
                         "8 distinct, contiguous", "4 distinct rows",
                         "1 (broadcast)"};
  printf("%s, %d SMs\n", prop.name, sms);
  for (int p = 0; p < 5; ++p) {
    bench<<<sms, kThreads>>>(p, iters, out, cycles);
    if (cudaDeviceSynchronize() != cudaSuccess) {
      fprintf(stderr, "smem_bench: the kernel failed\n");
      return 1;
    }
    long long c = 0;
    cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
    printf("LDS.128, %s: %.3f SM cycles a warp load\n", names[p],
           (double)c / ((kThreads / 32.0) * iters * kUnroll));
  }
  cudaFree(out);
  cudaFree(cycles);
  return 0;
}
