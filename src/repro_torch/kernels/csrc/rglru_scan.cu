// RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (pallas_call at :48): h_t = a_t * h_{t-1} + b_t along the sequence, from a
// zero state, elementwise over the W channels, for fp32 a, b of shape
// (B, S, W). The Pallas kernel tiles (bs, bw) blocks and carries h across the
// sequential seq-block axis in VMEM scratch; here one thread owns one (b, w)
// channel for the whole sequence and carries h in a register, so nothing is
// carried between blocks and S and W need not be multiples of any tile.
//
// Each step is one multiply and one add, each rounded (__fmul_rn, __fadd_rn:
// no fused multiply-add), the order of the plain PyTorch loop
// (kernels/ref.py::rglru_scan_ref), so the two agree bit for bit.
//
// What bounds it: each element of a and b is read once and each of h written
// once, 12 bytes per (b, t, w), against 2 flops; the call is bound by bytes,
// and at the serving shape (1, 32, 4096) by far below a launch (1.57 MB, 0.47
// µs at 3.35 TB/s). Threads of a warp take neighbouring w, so every load and
// store of a step is one coalesced 128-byte line per warp. The loads of a few
// steps ahead do not depend on h and are issued early (unrolled loop).
// A log-depth blocked scan across S is later work; at S = 32 there is too
// little to split.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const long long i = base + (long long)t * W;
    h = __fadd_rn(__fmul_rn(__ldg(a + i), h), __ldg(b + i));
    h_out[i] = h;
  }
}

}  // namespace

// a, b, h: device pointers to contiguous fp32 (B, S, W) arrays. Launches on
// `stream` and returns a CUDA error code (0 = launched).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return (int)cudaGetLastError();
}
