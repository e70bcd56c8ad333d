// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (defined at :65, pallas_call at :82). For x (b,s,h,p), dt (b,s,h) fp32,
// A (h,) fp32 and B, C (b,s,g,n), per (batch, head) row and per chunk of L
// positions, with cs the inclusive cumsum of dt·A over the chunk:
//
//   y_i   = Σ_{j≤i} (C_i·B_j) e^{cs_i − cs_j} dt_j x_j  +  e^{cs_i} C_i·state
//   state ← state·e^{cs_{L−1}} + Σ_j (B_j dt_j e^{cs_{L−1} − cs_j}) ⊗ x_j
//
// from a zero state; the final state is not returned. Head hi reads B/C
// group hi / (h/g) in place, so no per-head copies are made (the Pallas
// wrapper repeats B/C to every head). All arithmetic is fp32; x, B and C may
// be fp32 or bf16, and y is rounded once to x's dtype. A ragged last chunk
// (s % L != 0) is processed at its own length, which gives the rows the same
// values as zero-padding to a chunk multiple would. The factor
// e^{cs_i − cs_j} is only ever formed for j ≤ i, where cs_i − cs_j ≤ 0, so it
// cannot overflow however large dt·|A| is (the other triangle would reach
// e^{+88} and overflow fp32 once dt·|A| summed over a chunk passes ~88).
//
// What bounds it: at the serving shape (b,s,h,p,g,n,L) = (1,128,80,64,1,
// 128,128) in fp32 the call moves ~5.4 MB (x, y, B, C, dt; ~1.6 µs at
// 3.35 TB/s) but does ~5.2 M multiply-adds per row — C·Bᵀ L²n, scores·x L²p,
// C·state Lnp, the state update Lnp, counted as the Pallas body does them —
// 0.84 GFLOP over 80 rows, ~12.5 µs at the 67 TFLOP/s fp32 rate outside the
// tensor cores; the least these inputs need (pairs j ≤ i only, no C·state
// before the first chunk, no state update after the last) is 1.59 M per row,
// ~3.8 µs. So it is bound by operations, and the design keeps every operand
// of those products in shared memory and on CUDA cores:
//   - one block of 8 warps per (b·h) row, looping over the chunks and
//     carrying the (n, p) fp32 state in shared memory (the Pallas grid's
//     sequential chunk axis becomes this loop);
//   - the chunk's x (L×p) and B (L×n, rows padded by 4 words so that the
//     float4 reads of lanes j..j+7 hit distinct banks) are staged whole, with
//     the state, in dynamic shared memory: 142,848 bytes at the serving
//     shape, past the 48 KB static limit, so the launch opts in with
//     cudaFuncSetAttribute;
//   - each warp takes one query row i at a time: it stages C_i, lane j forms
//     the score of key j ≤ i (a float4 dot over n), and the warp then sums
//     scores·x and C_i·state, each lane owning p/32 output columns;
//   - after a block barrier, the warps update the state 4 rows at a time,
//     except after the last chunk, whose state nothing reads.
// cs is a sequential sum with no fused multiply-add, the same order as the
// plain version's cumsum over a non-innermost dimension. Tensor cores
// (wgmma for C·Bᵀ, scores·x and the state products), sharing C·Bᵀ across the
// h/g heads of a group, and filling more than b·h SMs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPadB = 4;            // words of padding per staged B row
constexpr int kMaxSmem = 232448;    // 227 KB: the most a Hopper block may use

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Floats of dynamic shared memory for one block (see the layout below).
inline long long smem_floats(int P, int N, int L) {
  return (long long)N * P + (long long)L * P + (long long)L * (N + kPadB) +
         (long long)kWarps * N + (long long)kWarps * L + 3LL * L;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int S, int H,
                int G, int N, int L) {
  constexpr int kPer = (P + 31) / 32;   // output columns owned by each lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // layout (every array starts on a 16-byte boundary: N, P, L % 4 == 0)
  float* state = smem;                          // [N][P]
  float* x_s = state + N * P;                   // [L][P]
  float* b_s = x_s + L * P;                     // [L][N + kPadB]
  float* c_s = b_s + L * (N + kPadB);           // [kWarps][N]
  float* sc_s = c_s + kWarps * N;               // [kWarps][L]
  float* dt_s = sc_s + kWarps * L;              // [L]
  float* cs_s = dt_s + L;                       // [L]
  float* w_s = cs_s + L;                        // [L]
  const int bstride = N + kPadB;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[h];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* c_w = c_s + warp * N;
  float* sc_w = sc_s + warp * L;

  for (int idx = tid; idx < N * P; idx += kThreads) state[idx] = 0.f;

  for (int s0 = 0; s0 < S; s0 += L) {
    const int Lc = min(L, S - s0);      // rows in this chunk
    const long long row0 = (long long)b * S + s0;
    __syncthreads();  // the previous chunk's readers of x_s/b_s are done
    for (int idx = tid; idx < Lc * P; idx += kThreads) {
      const int r = idx / P, d = idx % P;
      x_s[r * P + d] = to_float(x[((row0 + r) * H + h) * P + d]);
    }
    for (int idx = tid; idx < Lc * N; idx += kThreads) {
      const int r = idx / N, k = idx % N;
      b_s[r * bstride + k] = to_float(Bm[((row0 + r) * G + g) * N + k]);
    }
    for (int r = tid; r < Lc; r += kThreads) dt_s[r] = dt[(row0 + r) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int r = 0; r < Lc; ++r) {
        run = __fadd_rn(run, __fmul_rn(dt_s[r], a));
        cs_s[r] = run;
      }
    }
    __syncthreads();
    const float cs_end = cs_s[Lc - 1];
    for (int r = tid; r < Lc; r += kThreads)
      w_s[r] = dt_s[r] * expf(cs_end - cs_s[r]);
    // w_s is read only after the barrier that ends the row loop below

    // y, one query row per warp at a time
    for (int i = warp; i < Lc; i += kWarps) {
      const T* crow = Cm + ((row0 + i) * G + g) * N;
      for (int k = lane; k < N; k += 32) c_w[k] = to_float(crow[k]);
      __syncwarp();
      const float cs_i = cs_s[i];
      for (int j = lane; j <= i; j += 32) {
        const float* brow = b_s + j * bstride;
        float dot = 0.f;
        for (int k = 0; k < N; k += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(c_w + k);
          const float4 b4 = *reinterpret_cast<const float4*>(brow + k);
          dot = fmaf(c4.x, b4.x, dot);
          dot = fmaf(c4.y, b4.y, dot);
          dot = fmaf(c4.z, b4.z, dot);
          dot = fmaf(c4.w, b4.w, dot);
        }
        sc_w[j] = dot * expf(cs_i - cs_s[j]) * dt_s[j];
      }
      __syncwarp();
      float acc[kPer], off[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc[q] = off[q] = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float sj = sc_w[j];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int d = lane + 32 * q;
          if (d < P) acc[q] = fmaf(sj, x_s[j * P + d], acc[q]);
        }
      }
      if (s0 > 0) {  // the state is zero before the first chunk
        for (int k = 0; k < N; ++k) {
          const float ck = c_w[k];
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int d = lane + 32 * q;
            if (d < P) off[q] = fmaf(ck, state[k * P + d], off[q]);
          }
        }
      }
      const float e_i = expf(cs_i);
      T* yrow = y + ((row0 + i) * H + h) * P;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int d = lane + 32 * q;
        if (d < P) store(&yrow[d], acc[q] + e_i * off[q]);
      }
      __syncwarp();  // c_w and sc_w are rewritten for the next row
    }
    __syncthreads();  // every warp has read the state; w_s is complete
    if (s0 + L >= S) break;  // no final state is returned: skip its update

    // state ← state·e^{cs_end} + Σ_j (B_j w_j) ⊗ x_j, 4 state rows a warp
    const float decay = expf(cs_end);
    for (int k0 = 4 * warp; k0 < N; k0 += 4 * kWarps) {
      float acc[4][kPer];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int d = lane + 32 * q;
          acc[r][q] = (d < P) ? state[(k0 + r) * P + d] * decay : 0.f;
        }
      for (int j = 0; j < Lc; ++j) {
        const float4 b4 = *reinterpret_cast<const float4*>(b_s + j * bstride
                                                           + k0);
        const float wj = w_s[j];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int d = lane + 32 * q;
          const float xv = (d < P) ? x_s[j * P + d] * wj : 0.f;
          acc[0][q] = fmaf(b4.x, xv, acc[0][q]);
          acc[1][q] = fmaf(b4.y, xv, acc[1][q]);
          acc[2][q] = fmaf(b4.z, xv, acc[2][q]);
          acc[3][q] = fmaf(b4.w, xv, acc[3][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int d = lane + 32 * q;
          if (d < P) state[(k0 + r) * P + d] = acc[r][q];
        }
    }
  }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int batch, int S, int H, int G, int N,
           int L, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(P, N, L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, P><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H, G, N, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_p(const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, void* y, int batch, int S,
               int H, int P, int G, int N, int L, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, L, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, L, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, L, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, L, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: contiguous (b,s,h,p); dt: (b,s,h) fp32; A: (h,) fp32; Bm, Cm:
// contiguous (b,s,g,n). x, Bm, Cm, y are fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1). Launches on `stream` and returns a CUDA error code
// (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            int batch, int S, int H, int P, int G, int N,
                            int L, int is_bf16, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      N % 4 != 0 || L <= 0 || L % 4 != 0 ||
      (long long)batch * H > 2147483647LL ||
      smem_floats(P, N, L) * (long long)sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, batch, S, H, P, G,
                                     N, L, st);
  return dispatch_p<float>(x, dtf, Af, Bm, Cm, y, batch, S, H, P, G, N, L,
                           st);
}
