// Grouped fp32 expert products of a dropless MoE layer for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package's MoE layer
// (src/repro/models/moe.py) gives each expert a fixed capacity and runs the
// experts as batched einsums over padded slots, which XLA compiles. A
// dropless layer has no fixed capacity: how many of a batch's (token, k)
// entries fall on each expert is known only on the device, and reading it
// back on the host would stall a host-paced decode step once a layer. So
// the wrapper sorts the entries that fall on the experts this device holds
// by expert, on the device, and these kernels read each expert's row range
// (`ends`) themselves:
//
//   1. moe_gate_up: H[r, f] = silu(Σ_d X[tok[r], d]·W1[e, d, f])
//                             · Σ_d X[tok[r], d]·W3[e, d, f]
//   2. moe_down:    Y[r, j] = Σ_f H[r, f]·W2[e, f, j]
//
// for each sorted row r of held expert e (rows ends[e-1] .. ends[e]-1), X
// read where it lies through tok (no gathered copy). Rows past ends[n-1]
// are neither read nor written.
//
// What bounds it on this card, at granite-4.0-h-small's widths (D 4096, F
// 768, 18 experts held of 72, top-10): a 576-token prefill sends ~1,440
// rows, ~80 an expert, 27.2 GFLOP a layer against 0.68 GB of weights: the
// bound is operations (0.41 ms at 67 TFLOP/s against 0.20 ms of bytes). A
// 16-slot decode step sends ~40 rows over ~16.4 experts touched: 0.75
// GFLOP against 0.62 GB, so the bound is bytes (0.18 ms). One design serves
// both, by tile size: a block computes a BM x BN tile of one expert's rows
// and columns over the whole reduction, register-tiled on the CUDA cores
// (fp32, no TF32), staged through shared memory in BK-deep slices with the
// next slice loaded into registers (16-byte loads) while the current one is
// multiplied. Prefill takes 64 x 64 tiles, a thread 4 x 4 outputs (of both
// W1 and W3 in kernel 1); decode, whose experts see a few rows each, takes
// 16 x 32 tiles so that each expert's weights are read once, by more
// blocks. Grid: (N / BN column tiles, a bound on the row tiles). Each block
// finds its expert and row tile by walking `ends`; a block past the last
// tile returns at once, so no host read of the counts is needed. The sums
// run over d (or f) in order, one fused multiply-add at a time, so a row's
// result does not depend on the other rows of its tile or its position.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A block's tile: BM rows x BN columns, BK-deep slices, TM x TN outputs a
// thread (rows ty + i·BM/TM, columns tx + j·BN/TN).
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tiles {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TY = BM / TM, TX = BN / TN, NT = TX * TY;
  static constexpr int A4 = BM * BK / 4;  // float4s of an A slice
  static constexpr int B4 = BK * BN / 4;  // float4s of a W slice
  static constexpr int AP = (A4 + NT - 1) / NT, BP = (B4 + NT - 1) / NT;
};
using Big = Tiles<64, 64, 16, 4, 4>;     // prefill
using Small = Tiles<16, 32, 32, 2, 1>;   // decode

// The expert and first row of row tile `j` (counted over the experts in
// order), or false past the last tile.
template <int BM>
__device__ __forceinline__ bool find_tile(const long long* __restrict__ ends,
                                          int n, int j, int* expert,
                                          long long* row0, int* rows) {
  long long start = 0;
  for (int e = 0; e < n; ++e) {
    const long long end = ends[e];
    const int tiles = (int)((end - start + BM - 1) / BM);
    if (j < tiles) {
      *expert = e;
      *row0 = start + (long long)j * BM;
      *rows = (int)min((long long)BM, end - *row0);
      return true;
    }
    j -= tiles;
    start = end;
  }
  return false;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// out[r, c] for the block's tile: A's rows (a_row(r) = tok[r], or r where
// tok is null) against W1 (and W3: out = silu(A·W1) · A·W3 when GATED), each
// expert's W (Kd, N) row-major.
template <class T, bool GATED>
__global__ void __launch_bounds__(T::NT)
moe_grouped_kernel(const float* __restrict__ A, const long long* __restrict__ tok,
                   const long long* __restrict__ ends,
                   const float* __restrict__ W1, const float* __restrict__ W3,
                   float* __restrict__ out, int n, int Kd, int N) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN;
  constexpr int TX = T::TX, TY = T::TY, NT = T::NT;
  __shared__ __align__(16) float a_s[2][BM][BK];
  __shared__ __align__(16) float b1_s[2][BK][BN];
  __shared__ __align__(16) float b3_s[GATED ? 2 : 1][GATED ? BK : 1]
                                     [GATED ? BN : 4];
  int e, rows;
  long long row0;
  if (!find_tile<BM>(ends, n, blockIdx.y, &e, &row0, &rows)) return;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int col0 = blockIdx.x * BN;
  const long long wbase = (long long)e * Kd * N + col0;

  // the source row of each A float4 this thread stages (−1: past the tile)
  long long a_src[T::AP];
#pragma unroll
  for (int p = 0; p < T::AP; ++p) {
    const int idx = tid + p * NT, m = idx / (BK / 4);
    a_src[p] = -1;
    if (idx < T::A4 && m < rows) {
      const long long r = row0 + m;
      a_src[p] = tok ? tok[r] : r;
    }
  }
  float4 a_reg[T::AP], b1_reg[T::BP], b3_reg[GATED ? T::BP : 1];
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < T::AP; ++p) {
      const int kq = (tid + p * NT) % (BK / 4);
      a_reg[p] = a_src[p] >= 0
                     ? __ldg(reinterpret_cast<const float4*>(
                           A + a_src[p] * Kd + k0 + kq * 4))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int p = 0; p < T::BP; ++p) {
      const int idx = tid + p * NT;
      if (idx < T::B4) {
        const int k = idx / (BN / 4), nq = idx % (BN / 4);
        const long long off = wbase + (long long)(k0 + k) * N + nq * 4;
        b1_reg[p] = __ldg(reinterpret_cast<const float4*>(W1 + off));
        if constexpr (GATED) b3_reg[p] = __ldg(reinterpret_cast<const float4*>(W3 + off));
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < T::AP; ++p) {
      const int idx = tid + p * NT;
      if (idx < T::A4)
        *reinterpret_cast<float4*>(&a_s[buf][idx / (BK / 4)]
                                        [(idx % (BK / 4)) * 4]) = a_reg[p];
    }
#pragma unroll
    for (int p = 0; p < T::BP; ++p) {
      const int idx = tid + p * NT;
      if (idx < T::B4) {
        const int k = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(&b1_s[buf][k][c]) = b1_reg[p];
        if constexpr (GATED)
          *reinterpret_cast<float4*>(&b3_s[buf][k][c]) = b3_reg[p];
      }
    }
  };

  float acc1[TM][TN], acc3[GATED ? TM : 1][GATED ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc1[i][j] = 0.f;
      if constexpr (GATED) acc3[i][j] = 0.f;
    }

  const int slices = Kd / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load((s + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b1[TN], b3[GATED ? TN : 1];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[cur][ty + i * TY][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b1[j] = b1_s[cur][k][tx + j * TX];
        if constexpr (GATED) b3[j] = b3_s[cur][k][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
          if constexpr (GATED) acc3[i][j] = fmaf(a[i], b3[j], acc3[i][j]);
        }
    }
    if (s + 1 < slices) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + i * TY;
    if (m >= rows) continue;
    float* dst = out + (row0 + m) * N + col0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if constexpr (GATED)
        dst[tx + j * TX] = silu(acc1[i][j]) * acc3[i][j];
      else
        dst[tx + j * TX] = acc1[i][j];
    }
  }
}

// Row tiles to launch: the tiles of all experts' rows never exceed
// ceil(R / BM) + n, nor n·ceil(T / BM) (each token sends an expert one row
// at most).
template <class T>
int row_tiles(long long R, long long tokens, int n) {
  const long long a = (R + T::BM - 1) / T::BM + n;
  const long long b = (long long)n * ((tokens + T::BM - 1) / T::BM);
  return (int)(a < b ? a : b);
}

template <class T>
int launch(const float* x, const long long* tok, const long long* ends,
           const float* w1, const float* w3, const float* w2, float* h,
           float* y, long long tokens, long long R, int n, int D, int F,
           cudaStream_t stream) {
  const int tiles = row_tiles<T>(R, tokens, n);
  if (tiles <= 0) return 0;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  moe_grouped_kernel<T, true><<<dim3(F / T::BN, tiles), T::NT, 0, stream>>>(
      x, tok, ends, w1, w3, h, n, D, F);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  moe_grouped_kernel<T, false><<<dim3(D / T::BN, tiles), T::NT, 0, stream>>>(
      h, nullptr, ends, w2, nullptr, y, n, F, D);
  return (int)cudaGetLastError();
}

// x (tokens, D); tok (R,) the token of each sorted row; ends (n,) the end
// of each held expert's rows, ascending, at most R; w1, w3 (n, D, F); w2
// (n, F, D); h (R, F) scratch; y (R, D). All contiguous, fp32 (tok and ends
// int64), 16-byte aligned; D and F multiples of 64. small: the 16 x 32
// tiles. Launches both kernels on `stream`; returns a CUDA error code.
int forward(const void* x, const void* tok, const void* ends, const void* w1,
            const void* w3, const void* w2, void* h, void* y,
            long long tokens, long long R, int n, int D, int F, int small,
            void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w1) |
                        reinterpret_cast<uintptr_t>(w3) |
                        reinterpret_cast<uintptr_t>(w2) |
                        reinterpret_cast<uintptr_t>(h) |
                        reinterpret_cast<uintptr_t>(y);
  if (tokens <= 0 || R <= 0 || n <= 0 || D <= 0 || F <= 0 || D % 64 ||
      F % 64 || (any & 15))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto l = [](const void* p) { return static_cast<const long long*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small)
    return launch<Small>(f(x), l(tok), l(ends), f(w1), f(w3), f(w2),
                         static_cast<float*>(h), static_cast<float*>(y),
                         tokens, R, n, D, F, s);
  return launch<Big>(f(x), l(tok), l(ends), f(w1), f(w3), f(w2),
                     static_cast<float*>(h), static_cast<float*>(y), tokens,
                     R, n, D, F, s);
}

}  // namespace

// The arguments of `forward` above packed in one int64 array, in its order
// (pointers and the stream as addresses).
extern "C" int moe_experts_fwd(const long long* a) {
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  return forward(p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), a[8], a[9],
                 (int)a[10], (int)a[11], (int)a[12], (int)a[13], p(14));
}
