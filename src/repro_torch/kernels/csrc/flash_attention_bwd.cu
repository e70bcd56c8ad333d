// Flash attention backward for Hopper (sm_90a): dq, dk, dv of
// softmax(q·kᵀ/√hd + mask)·v from q, k, v, the forward's output o and its
// per-row log-sum-exp lse, and the output's gradient dO.
//
// What it replaces: nothing in Pallas. The TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention has no backward
// (no custom_vjp); the reference trains on its jnp path and differentiates
// it with jax.grad (src/repro/kernels/ref.py::flash_attention_ref is the
// same function). The port trains with its kernels on, so the forward
// kernel (flash_attention.cu) needs this gradient; its plain version is
// kernels/ref.py::flash_attention_bwd_ref.
//
// Scope: queries and keys at the same positions (T == S, as in training;
// the wrapper refuses T != S), causal, causal with a window, or non-causal;
// GQA with H % K == 0; hd in {32, 64, 80, 128, 256}; fp32 and bf16 inputs,
// outputs in the inputs' dtype, every sum in fp32. Masked pairs get P = 0
// exactly, as the forward's finite -1e30 gives exp(-1e30 - lse) = 0; with
// T == S every row sees at least its own key, so lse is finite.
//
// Three launches, FlashAttention-2's deterministic split, no atomics:
//   1. delta: Δ = rowsum(dO ∘ O) into a (B, H, S) fp32 scratch, a warp a
//      row;
//   2. dkdv: a block per (b, KV head, 32-key tile) keeps its k and v tile
//      in shared memory and loops over the G = H/K query heads of its group
//      and over the 32-row query tiles that see the key tile (the causal
//      diagonal bounds them from below, the window from above). It
//      recomputes S = q·kᵀ and dP = dO·vᵀ, P = exp(S·scale − lse) and
//      dS = P ∘ (dP − Δ), and sums dV += Pᵀ·dO and dK += dSᵀ·q in
//      registers; each dk and dv row is written once, so GQA's sum over
//      query heads needs no atomics;
//   3. dq: a block per (b, query head, 32-row query tile) loops over the key
//      tiles its rows see, recomputes P and dS the same way and sums
//      dQ += dS·k; each dq row is written once.
// Each output element is summed by one thread in a fixed order, so two runs
// give bit-equal gradients.
//
// What bounds it on this card at olmo-1b's training shape, (8, 256, 16,
// 128) causal fp32: five products over the 32,896 visible (query, key)
// pairs of each of the 128 (batch, head) rows, 10·hd flops a pair: 5.39
// GFLOP, 80.4 µs at the 67 TFLOP/s fp32 rate outside the tensor cores;
// q, k, v, o, dO read once and dq, dk, dv written once are 134 MB, 40.1 µs
// at 3.35 TB/s. So the arithmetic bounds it. This first design is simple
// and right before it is fast: fp32 stays on the CUDA cores with no TF32
// (as the forward), bf16 inputs are widened to fp32 as they are staged,
// so both dtypes run the same fp32 arithmetic; each thread computes four
// scores of one query row from 16-byte shared-memory reads (rows padded by
// 4 floats, so the 8 keys of a read phase start on distinct banks), and
// then owns runs of 4 output columns, 8 runs apart, for the accumulation.
// Q·Kᵀ is computed twice (in dkdv and in dq) and the staging is
// synchronous. Tensor-core products (mma.sync or wgmma), TMA staging and a
// single fused pass are later work.
//
// Shared memory: four fp32 tiles of 32 rows of hd + 4 floats (q, dO, k, v),
// the 32×33 P and dS tiles and 64 floats of lse and Δ:
// 4·(4·32·(hd+4) + 2·32·33 + 64) bytes, 76,288 at hd 128 and 141,824 at
// hd 256, in both dtypes: every instantiation fits a block's 227 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;       // query rows of a q tile = keys of a k tile
constexpr int kThreads = 256;   // 8 warps; a thread: 4 scores, then runs
constexpr int kPad = 4;         // floats of padding per staged row
constexpr int kPS = kTile + 1;  // row stride of the P and dS tiles

constexpr long long smem_bytes(int hd) {
  return 4LL * (4 * kTile * (hd + kPad) + 2 * kTile * kPS + 2 * kTile);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T as floats into shared memory (4 fp32 or 8 bf16 values)
__device__ __forceinline__ void put16(float* d, const float* src) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void put16(float* d, const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(d + 4) = make_float4(c.x, c.y, e.x, e.y);
}

// 4 floats to 4 consecutive T in device memory
__device__ __forceinline__ void store4(float* d, const float (&x)[4],
                                       float s) {
  *reinterpret_cast<float4*>(d) =
      make_float4(x[0] * s, x[1] * s, x[2] * s, x[3] * s);
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, const float (&x)[4],
                                       float s) {
  __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(x[0] * s, x[1] * s);
  h[1] = __floats2bfloat162_rn(x[2] * s, x[3] * s);
  *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(h);
}

// Rows [0, kTile) of HD values, device row stride gstride, into shared fp32
// rows of HD + kPad; rows at or past `valid` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long gstride, int valid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int idx = tid; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    float* d = dst + r * (HD + kPad) + c;
    if (r < valid) {
      put16(d, src + r * gstride + c);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = 0.f;
    }
  }
}

__device__ __forceinline__ bool visible(int t, int i, int causal,
                                        int window) {
  return (!causal || t <= i) && (window <= 0 || t > i - window);
}

// Phase 1 of both kernels: for query row si of the staged q/dO tile and the
// keys sj + 8c (c = 0..3) of the staged k/v tile, q·k and dO·v.
template <int HD>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       int si, int sj, float (&sc)[4],
                                       float (&dp)[4]) {
  constexpr int SS = HD + kPad;
#pragma unroll
  for (int c = 0; c < 4; ++c) sc[c] = dp[c] = 0.f;
  const float* qr = q_s + si * SS;
  const float* dr = do_s + si * SS;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(qr + d);
    const float4 e = *reinterpret_cast<const float4*>(dr + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 x =
          *reinterpret_cast<const float4*>(k_s + (sj + 8 * c) * SS + d);
      const float4 y =
          *reinterpret_cast<const float4*>(v_s + (sj + 8 * c) * SS + d);
      sc[c] = fmaf(a.x, x.x, sc[c]);
      sc[c] = fmaf(a.y, x.y, sc[c]);
      sc[c] = fmaf(a.z, x.z, sc[c]);
      sc[c] = fmaf(a.w, x.w, sc[c]);
      dp[c] = fmaf(e.x, y.x, dp[c]);
      dp[c] = fmaf(e.y, y.y, dp[c]);
      dp[c] = fmaf(e.z, y.z, dp[c]);
      dp[c] = fmaf(e.w, y.w, dp[c]);
    }
  }
}

// acc[0..3] += w · row[0..3]
__device__ __forceinline__ void axpy4(float (&acc)[4], float w,
                                      const float* row) {
  const float4 x = *reinterpret_cast<const float4*>(row);
  acc[0] = fmaf(w, x.x, acc[0]);
  acc[1] = fmaf(w, x.y, acc[1]);
  acc[2] = fmaf(w, x.z, acc[2]);
  acc[3] = fmaf(w, x.w, acc[3]);
}

// Δ = rowsum(dO ∘ O): a warp a row of the (B·S·H) rows, into (B, H, S).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, long long rows, int S,
                          int H) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  const T* orow = o + row * HD;
  const T* drow = dout + row * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32)
    s = fmaf(to_f(orow[d]), to_f(drow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    const long long bs = row / H;  // row = (b·S + s)·H + h
    const long long b = bs / S;
    delta[(b * H + row % H) * S + bs % S] = s;
  }
}

// The lse and Δ of the 32 rows from r0 (zeros past the last row).
__device__ __forceinline__ void stage_rows_stats(float* lse_s, float* dl_s,
                                                 const float* lse,
                                                 const float* delta,
                                                 long long off, int nr,
                                                 int tid) {
  if (tid < kTile) {
    lse_s[tid] = tid < nr ? lse[off + tid] : 0.f;
    dl_s[tid] = tid < nr ? delta[off + tid] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int K, int causal,
                         int window, float scale) {
  constexpr int SS = HD + kPad;
  constexpr int NRUN = HD / 4;         // runs of 4 output columns
  constexpr int NR = (NRUN + 7) / 8;   // a thread's runs, 8 apart
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kTile][SS]
  float* do_s = q_s + kTile * SS;
  float* k_s = do_s + kTile * SS;
  float* v_s = k_s + kTile * SS;
  float* p_s = v_s + kTile * SS;                 // [kTile][kPS]
  float* ds_s = p_s + kTile * kPS;
  float* lse_s = ds_s + kTile * kPS;             // [kTile]
  float* dl_s = lse_s + kTile;

  const int G = H / K;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int t0 = blockIdx.y * kTile;
  const int nk = min(kTile, S - t0);
  const int tid = threadIdx.x;
  const int si = tid >> 3, sj = tid & 7;  // phase 1: row si, keys sj + 8c
  const int kj = tid >> 3, kg = tid & 7;  // phase 2: key kj, runs kg + 8r

  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;
  const long long kv_off = ((long long)b * S + t0) * kv_seq + kh * HD;
  stage<T, HD>(k_s, k + kv_off, kv_seq, nk, tid);
  stage<T, HD>(v_s, v + kv_off, kv_seq, nk, tid);

  // the query rows that see a key of this tile (t0 is a multiple of kTile)
  const int r_lo = causal ? t0 : 0;
  const int r_hi = window > 0 ? min(S, t0 + nk - 1 + window) : S;

  float dk_acc[NR][4], dv_acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;

  for (int hq = kh * G; hq < (kh + 1) * G; ++hq) {
    for (int r0 = r_lo; r0 < r_hi; r0 += kTile) {
      const int nr = min(kTile, S - r0);
      __syncthreads();  // the last tile's phase 2 is done with the tiles
      const long long q_off = ((long long)b * S + r0) * q_seq + hq * HD;
      stage<T, HD>(q_s, q + q_off, q_seq, nr, tid);
      stage<T, HD>(do_s, dout + q_off, q_seq, nr, tid);
      stage_rows_stats(lse_s, dl_s, lse, delta,
                       ((long long)b * H + hq) * S + r0, nr, tid);
      __syncthreads();

      float sc[4], dp[4];
      scores<HD>(q_s, do_s, k_s, v_s, si, sj, sc, dp);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = sj + 8 * c;
        const bool vis = si < nr && j < nk &&
                         visible(t0 + j, r0 + si, causal, window);
        const float p = vis ? expf(sc[c] * scale - lse_s[si]) : 0.f;
        p_s[si * kPS + j] = p;
        ds_s[si * kPS + j] = p * (dp[c] - dl_s[si]);
      }
      __syncthreads();

      for (int i = 0; i < nr; ++i) {
        const float p = p_s[i * kPS + kj], ds = ds_s[i * kPS + kj];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int run = kg + 8 * r;
          if (NRUN % 8 == 0 || run < NRUN) {
            axpy4(dv_acc[r], p, do_s + i * SS + 4 * run);
            axpy4(dk_acc[r], ds, q_s + i * SS + 4 * run);
          }
        }
      }
    }
  }

  if (kj < nk) {
    const long long off = ((long long)b * S + t0 + kj) * kv_seq + kh * HD;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int run = kg + 8 * r;
      if (NRUN % 8 == 0 || run < NRUN) {
        store4(dk + off + 4 * run, dk_acc[r], scale);
        store4(dv + off + 4 * run, dv_acc[r], 1.f);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int S, int H, int K, int causal, int window,
                       float scale) {
  constexpr int SS = HD + kPad;
  constexpr int NRUN = HD / 4;
  constexpr int NR = (NRUN + 7) / 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // the same layout as dkdv
  float* do_s = q_s + kTile * SS;
  float* k_s = do_s + kTile * SS;
  float* v_s = k_s + kTile * SS;
  float* ds_s = v_s + kTile * SS + kTile * kPS;
  float* lse_s = ds_s + kTile * kPS;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int r0 = blockIdx.y * kTile;
  const int nr = min(kTile, S - r0);
  const int tid = threadIdx.x;
  const int si = tid >> 3, sj = tid & 7;  // phase 1: row si, keys sj + 8c
  const int qi = tid >> 3, qg = tid & 7;  // phase 2: row qi, runs qg + 8r

  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;
  const long long q_off = ((long long)b * S + r0) * q_seq + h * HD;
  stage<T, HD>(q_s, q + q_off, q_seq, nr, tid);
  stage<T, HD>(do_s, dout + q_off, q_seq, nr, tid);
  stage_rows_stats(lse_s, dl_s, lse, delta, ((long long)b * H + h) * S + r0,
                   nr, tid);

  // the keys that the rows [r0, r0 + nr) see
  const int t_lo =
      window > 0 ? max(0, r0 - window + 1) / kTile * kTile : 0;
  const int t_hi = causal ? r0 + nr : S;

  float dq_acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[r][e] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
    const int nk = min(kTile, S - t0);
    __syncthreads();  // the last tile's phase 2 is done with k_s and ds_s
    const long long kv_off = ((long long)b * S + t0) * kv_seq + kh * HD;
    stage<T, HD>(k_s, k + kv_off, kv_seq, nk, tid);
    stage<T, HD>(v_s, v + kv_off, kv_seq, nk, tid);
    __syncthreads();

    float sc[4], dp[4];
    scores<HD>(q_s, do_s, k_s, v_s, si, sj, sc, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = sj + 8 * c;
      const bool vis = si < nr && j < nk &&
                       visible(t0 + j, r0 + si, causal, window);
      const float p = vis ? expf(sc[c] * scale - lse_s[si]) : 0.f;
      ds_s[si * kPS + j] = p * (dp[c] - dl_s[si]);
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      const float ds = ds_s[qi * kPS + j];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int run = qg + 8 * r;
        if (NRUN % 8 == 0 || run < NRUN)
          axpy4(dq_acc[r], ds, k_s + j * SS + 4 * run);
      }
    }
  }

  if (qi < nr) {
    T* row = dq + q_off + (long long)qi * q_seq;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int run = qg + 8 * r;
      if (NRUN % 8 == 0 || run < NRUN) store4(row + 4 * run, dq_acc[r], scale);
    }
  }
}

// The dynamic shared-memory opt-in, once per kernel and device.
template <typename Kernel>
int opt_in_once(Kernel kernel, long long smem, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  *done |= bit;
  return 0;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int S, int H, int K, int causal, int window,
           cudaStream_t st) {
  static unsigned long long opted_dkdv = 0, opted_dq = 0;
  constexpr long long smem = smem_bytes(HD);
  int rc = opt_in_once(flash_attention_bwd_dkdv<T, HD>, smem, &opted_dkdv);
  if (rc) return rc;
  rc = opt_in_once(flash_attention_bwd_dq<T, HD>, smem, &opted_dq);
  if (rc) return rc;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf((float)HD);
  const long long rows = (long long)B * S * H;
  const int per_block = kThreads / 32;
  flash_attention_bwd_delta<T, HD>
      <<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, st>>>(
          static_cast<const T*>(o), dot, delta, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + kTile - 1) / kTile;
  flash_attention_bwd_dkdv<T, HD><<<dim3(B * K, tiles), kThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq<T, HD><<<dim3(B * H, tiles), kThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, H, K, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const float* lse, const void* dout, void* dq,
              void* dk, void* dv, float* delta, int B, int S, int H, int K,
              int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, K, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, K, causal, window, st);
    case 80: return launch<T, 80>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, K, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, K, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, K, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments packed in one int64 array (pointers and the stream as
// addresses), in this order: q, k, v, o, lse, dO, dq, dk, dv, delta
// (device pointers, 16-byte aligned; q, o, dO, dq contiguous (B,S,H,hd),
// k, v, dk, dv contiguous (B,S,K,hd) of fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); lse and the scratch delta contiguous fp32 (B,H,S)), then B,
// S, H, K, hd, causal, window, is_bf16, stream: 19 values. Launches the
// three kernels on `stream` and returns a CUDA error code (0 = launched).
extern "C" int flash_attention_bwd(const long long* a) {
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const int B = (int)a[10], S = (int)a[11], H = (int)a[12], K = (int)a[13];
  const int hd = (int)a[14], causal = (int)a[15], window = (int)a[16];
  uintptr_t ptrs = 0;
  for (int i = 0; i < 10; ++i) ptrs |= static_cast<uintptr_t>(a[i]);
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || (ptrs & 15) ||
      (long long)B * H > 2147483647LL || (S + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const float* lse = static_cast<const float*>(p(4));
  float* delta = static_cast<float*>(p(9));
  cudaStream_t st = static_cast<cudaStream_t>(p(18));
  if (a[17])
    return launch_hd<__nv_bfloat16>(hd, p(0), p(1), p(2), p(3), lse, p(5),
                                    p(6), p(7), p(8), delta, B, S, H, K,
                                    causal, window, st);
  return launch_hd<float>(hd, p(0), p(1), p(2), p(3), lse, p(5), p(6), p(7),
                          p(8), delta, B, S, H, K, causal, window, st);
}
