// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call at :90): softmax(q·kᵀ/√hd + mask)·v by online
// softmax, for q (B,S,H,hd) and k, v (B,T,K,hd) with H % K == 0. Query head h
// reads KV head h / (H/K) in place (no KV copy); the queries are the last S of
// T positions (q_off = T - S); `causal` keeps keys t <= q + q_off and
// `window > 0` keeps t > q + q_off - window. fp32 and bf16 inputs; q, k, v,
// the scores, p and the m/l/acc carries are all fp32, and only the output is
// rounded to the input's dtype, as in the Pallas kernel.
//
// Masked scores are the finite -1e30 (flash_attention.py:22), never -inf: a
// row with no visible key (causal with T < S) then ties every score and
// returns the mean of v, exactly as the reference does. Keys past the ragged
// end of T take no part at all (p = 0), so S and T need not be multiples of
// any tile. Every KV tile is visited.
//
// What bounds it: at the serving path's shape (1, 32, 16, 128) in fp32 the
// call reads q, k, v and writes o, about 1 MB, i.e. ~0.3 µs at 3.35 TB/s,
// against ~4 MFLOP of fp32 work; both are far below a kernel launch, so
// launch latency dominates and the design aims to be simple and right:
//   - one block per (b·h, tile of kWarps query rows), one warp per query row;
//   - a loop over KV tiles of kBlockK = 32 keys staged in shared memory as
//     fp32 (k rows padded by one word so that lane j reading key j is free
//     of bank conflicts);
//   - lane j scores key j of the tile; the row's max and sum are warp
//     shuffles; each lane owns hd/32 output columns of acc in registers.
// The three tiles live in dynamic shared memory for every hd (one code path):
// 4·(8·hd + 32·(hd+1) + 32·hd) bytes, 36,992 at hd = 128 and 73,856 at
// hd = 256, past the 48 KB a block may hold statically, so each launch first
// opts in with cudaFuncSetAttribute. At hd = 256 each lane holds 8 output
// accumulators. wgmma, TMA and skipping fully masked causal tiles are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;     // query rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile: one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxSmem = 232448;  // 227 KB: the most one block may use

// floats of dynamic shared memory: q (kWarps x HD), k (kBlockK x (HD + 1),
// padded against bank conflicts) and v (kBlockK x HD)
constexpr int smem_floats(int hd) {
  return kWarps * hd + kBlockK * (hd + 1) + kBlockK * hd;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int H, int K, int causal, int window,
                       float scale) {
  constexpr int kPer = HD / 32;  // output columns owned by each lane
  extern __shared__ float smem[];
  float(*q_s)[HD] = reinterpret_cast<float(*)[HD]>(smem);
  float(*k_s)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(smem + kWarps * HD);
  float(*v_s)[HD] = reinterpret_cast<float(*)[HD]>(
      smem + kWarps * HD + kBlockK * (HD + 1));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.y * kWarps + warp;  // query index in [0, S)
  const bool row_ok = row < S;                 // uniform across the warp
  const int q_pos = row + (Tk - S);            // its position among the T keys

  // (B, S, H, hd) and (B, T, K, hd) layouts, read through their strides
  const long long q_seq = (long long)H * HD;
  const long long kv_seq = (long long)K * HD;
  const long long q_base = ((long long)b * S + row) * q_seq + (long long)h * HD;
  const long long kv_base = (long long)b * Tk * kv_seq + (long long)kh * HD;

  if (row_ok) {
    for (int d = lane; d < HD; d += 32) q_s[warp][d] = to_float(q[q_base + d]);
  }
  __syncwarp();

  float m = kNegInf, l = 0.f, acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < Tk; t0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * HD; idx += kWarps * 32) {
      const int r = idx / HD, d = idx % HD;
      const int t = t0 + r;
      float kx = 0.f, vx = 0.f;  // zero rows past T: p = 0 must meet finite v
      if (t < Tk) {
        kx = to_float(k[kv_base + t * kv_seq + d]);
        vx = to_float(v[kv_base + t * kv_seq + d]);
      }
      k_s[r][d] = kx;
      v_s[r][d] = vx;
    }
    __syncthreads();
    if (!row_ok) continue;

    const int t = t0 + lane;
    float s = -INFINITY;  // a key past T never wins the max
    if (t < Tk) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(q_s[warp][d], k_s[lane][d], dot);
      s = dot * scale;
      bool visible = true;
      if (causal) visible = visible && t <= q_pos;
      if (window > 0) visible = visible && t > q_pos - window;
      if (!visible) s = kNegInf;
    }
    const float m_new = fmaxf(m, warp_max(s));  // finite: m starts at -1e30
    const float p = (t < Tk) ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
    const int nk = min(kBlockK, Tk - t0);
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(pj, v_s[j][lane + 32 * i], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      store(&o[q_base + lane + 32 * i], acc[i] / denom);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int K, int causal, int window,
           cudaStream_t stream) {
  const dim3 grid(B * H, (S + kWarps - 1) / kWarps);
  const float scale = 1.0f / sqrtf((float)HD);
  const size_t smem = (size_t)smem_floats(HD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<HD, T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, K, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int H, int K, int hd, int causal, int window,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, B, S, Tk, H, K, causal, window, stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, S, Tk, H, K, causal, window, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, Tk, H, K, causal, window, stream);
    case 256:
      return launch<256, T>(q, k, v, o, B, S, Tk, H, K, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: device pointers to contiguous (B,S,H,hd) / (B,T,K,hd) /
// (B,T,K,hd) / (B,S,H,hd) arrays of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Tk, int H, int K, int hd, int causal,
                                   int window, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || K <= 0 || H % K != 0 ||
      (long long)B * H > 2147483647LL || (S + kWarps - 1) / kWarps > 65535 ||
      smem_floats(hd) * (long long)sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, K, hd, causal,
                                      window, st);
  return dispatch_hd<float>(q, k, v, o, B, S, Tk, H, K, hd, causal, window,
                            st);
}
