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
// What bounds it on this card at olmo-1b's training shape, (8, 256, 16,
// 128) causal: five products over the 32,896 visible (query, key) pairs of
// each of the 128 (batch, head) rows, 10·hd flops a pair, 5.39 GFLOP. fp32:
// 80.4 µs at the 67 TFLOP/s rate outside the tensor cores, against 40.1 µs
// for its 134 MB (q, k, v, o, dO read once, dq, dk, dv written once) at
// 3.35 TB/s: the operations bound it. bf16: 5.4 µs at 989 TFLOP/s against
// 20.1 µs for its 67.2 MB: the bytes bound it.
//
// Three launches, FlashAttention-2's deterministic split, no atomics:
//   1. delta: Δ = rowsum(dO ∘ O) into a (B, H, S) fp32 scratch, a warp a
//      row, 16-byte loads;
//   2. dkdv: a work item is (b, KV head, key tile); its block keeps the k
//      and v tile in shared memory and steps over the G = H/K query heads
//      of its group and the query tiles that see the key tile (the causal
//      diagonal bounds them from below, the window from above). A step
//      computes S = q·kᵀ and dP = dO·vᵀ, P = exp(S·scale − lse) and
//      dS = P ∘ (dP − Δ) into shared memory, then dV += Pᵀ·dO and
//      dK += dSᵀ·q in registers; each dk and dv row is written once, so
//      GQA's sum over query heads needs no atomics;
//   3. dq: a work item is (b, query head, query tile); its block steps over
//      the key tiles its rows see, recomputes S and dP (seven products in
//      all, not five), puts dS in shared memory and sums dQ += dS·k.
// Each output element is summed by one thread in a fixed order, so two runs
// give bit-equal gradients.
//
// The design, in the order the levers mattered (each measured on the card
// with chip_smoke.py's helpers; the numbers are in PERF.md):
//   - fp32 stays on the CUDA cores, never TF32 (the 1e-4 parity holds), and
//     is bound by shared memory, not by the FMAs: a 16-byte shared load
//     costs the SM ~4 cycles when a warp reads 8 distinct addresses and
//     ~2.5 when it reads 4 or fewer, while an SM retires 4 warp-FMAs a
//     cycle. So every product is register-blocked, and a block's two warp
//     groups split each step by product: warps 0-3 compute S (then P, and in
//     dkdv dV), warps 4-7 compute dP (then dS, and in dkdv dK), which gives
//     each thread a 4×4 (dkdv) or 8×4 (dq) tile of S or dP, rows 8 or 16
//     apart, keys 16 or 8 apart, fed by 16-byte reads along hd; a warp is 4
//     row groups × 8 key groups, so a read of q or dO has 4 distinct
//     addresses and of k or v 8 consecutive rows, which rows of hd + 4
//     floats put on distinct banks at every hd. dV, dK and dQ are outer
//     products over a step's rows or keys: a thread owns MR consecutive
//     output rows (8 in dkdv at hd 128) × NU runs of 4 columns, TC = 16
//     runs apart (8 where hd/4 is not a multiple of 16: hd 32 and 80), and a
//     warp is 4 row groups × 8 run groups. dkdv steps over 32 query rows
//     against its 64 keys (64 query rows would not fit 227 KB with a ring
//     of two), dq over 64 keys against its 64 rows, and P goes into dq's
//     dSᵀ tile, which dS then overwrites in place; at hd 256 both take 32 ×
//     32 for shared memory (64 keys of dk and dv would also hold 128
//     accumulators a thread). In dkdv, group 0 starts on dV as soon as P is
//     in, while group 1 forms dS and waits on a barrier of its own. The
//     first step of a causal key tile, whose rows see only its first half of
//     keys, computes only that half of S and dP; a tile every pair of which
//     is visible skips the mask.
//   - fp32 blocks are persistent, one an SM: block n takes the work items
//     n, n + gridDim.x, ..., longest first, and since the products after a
//     step's barrier read no k and v (dkdv) or q, dO, lse and Δ (dq), it
//     stages the next item's there during the last step of the item before.
//     One block an SM, whose tiles fill its shared memory, would otherwise
//     wait for those loads at every item.
//   - bf16 runs on the tensor cores: mma.sync.m16n8k16 with fp32
//     accumulators, every operand loaded with ldmatrix (.trans for the
//     operands that are stored k-major: Pᵀ and dSᵀ from P and dS, and dO, q
//     and k in the accumulating products). Tiles are staged as bf16, rows of
//     hd + 8 values (8 ldmatrix rows on distinct banks at every hd). P and dS
//     are rounded to bf16 as they are put in shared memory, before
//     dV += Pᵀ·dO, dK += dSᵀ·q and dQ += dS·k (FlashAttention-2 does the
//     same); S, dP, the softmax and every sum stay fp32. dkdv steps over 32
//     query rows against its 64 keys (32 at hd 256: dk and dv of 64 keys
//     would need 256 accumulators a thread), dq over 32 keys against its 64
//     rows; two blocks an SM where shared memory allows it (all but hd
//     256), which caps a thread at 128 registers, and they overlap one
//     block's loads and barriers with the other's products.
//   - staging is asynchronous: 16-byte cp.async (4-byte for lse and Δ) into
//     a ring of two buffers, the q/dO/lse/Δ tiles in dkdv and the k/v tiles
//     in dq; the next step's tiles are in flight while this step computes.
//   - causal load balance: work is issued longest first. dkdv's key tile 0,
//     which every query tile sees, comes first; dq walks its query tiles
//     from the last, which sees every key tile.
//
// Shared memory (bytes; the wrapper's smem_bytes_bwd mirrors it and
// chip_smoke.py checks the two agree): fp32 dkdv 4·(2·BC·(hd+4) +
// 4·BR·(hd+4) + 2·BR·(BC+8) + 4·BR), dq 4·(2·BR·(hd+4) + 4·BC·(hd+4) +
// BC·(BR+4) + 2·BR); bf16 dkdv 2·(2·BC·(hd+8) + 4·BR·(hd+8) + 2·BR·(BC+8)) +
// 16·BR, dq 2·(2·BR·(hd+8) + 4·BC·(hd+8) + BR·(BC+8)) + 8·BR, BC and BR a
// block's or a step's keys and query rows as above. At hd 128: fp32 154,112
// / 220,672, bf16 79,360 / 75,264; every instantiation fits a block's
// 227 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps, every kernel
constexpr int kMinTile = 32;   // the smallest tile: bounds the grid's y

// Tiles of each kernel: dkdv takes kKvKeys keys a block and kKvRows query
// rows a step; dq kQRows query rows a block and kQKeys keys a step.
template <typename T, int HD>
struct Tiles;
template <int HD>
struct Tiles<float, HD> {
  static constexpr int kPad = 4;  // floats of padding per staged row
  static constexpr int kKvKeys = HD == 256 ? 32 : 64, kKvRows = 32;
  static constexpr int kQRows = HD == 256 ? 32 : 64;
  static constexpr int kQKeys = HD == 256 ? 32 : 64;
};
template <int HD>
struct Tiles<bf16, HD> {
  static constexpr int kPad = 8;  // bf16 of padding per staged row
  static constexpr int kKvKeys = HD == 256 ? 32 : 64, kKvRows = 32;
  static constexpr int kQRows = 64, kQKeys = 32;
};

template <typename T, int HD>
constexpr long long smem_dkdv() {
  using G = Tiles<T, HD>;
  constexpr int RS = HD + G::kPad, BC = G::kKvKeys, BR = G::kKvRows;
  return (long long)sizeof(T) *
             (2 * BC * RS + 4 * BR * RS + 2 * BR * (BC + 8)) +
         4LL * 4 * BR;
}
template <typename T, int HD>
constexpr long long smem_dq() {
  using G = Tiles<T, HD>;
  constexpr int RS = HD + G::kPad, BR = G::kQRows, BC = G::kQKeys;
  // fp32: Pᵀ, then dSᵀ in its place; bf16: dS
  constexpr int ds = std::is_same<T, float>::value ? BC * (BR + 4)
                                                   : BR * (BC + 8);
  return (long long)sizeof(T) * (2 * BR * RS + 4 * BC * RS + ds) +
         4LL * 2 * BR;
}

// The blocks an SM is built to hold (__launch_bounds__): bf16, two where
// shared memory allows it (228 KB an SM, 1 KB reserved a block), which caps
// a thread at 128 registers; fp32, one, whose micro-tiles need more.
template <typename T>
constexpr int min_blocks(long long smem) {
  return std::is_same<T, float>::value ? 1
         : 2 * (smem + 1024) <= 233472 ? 2
                                       : 1;
}

// ---- asynchronous copies into shared memory ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, ROWS) of HD elements, device row stride gstride, into shared
// rows of HD + pad; rows at or past `valid` are zero-filled.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long gstride, int valid,
                                           int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int RS = HD + Tiles<T, HD>::kPad;
  for (int idx = tid; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const bool ok = r < valid;
    cp_async16(dst + r * RS + c, ok ? src + r * gstride + c : src, ok);
  }
}

// The lse and Δ of ROWS rows from `off` (zeros past the last row).
template <int ROWS>
__device__ __forceinline__ void stage_stats(float* lse_s, float* dl_s,
                                            const float* lse,
                                            const float* delta,
                                            long long off, int nr, int tid) {
  if (tid < ROWS) {
    cp_async4(lse_s + tid, lse + off + (tid < nr ? tid : 0), tid < nr);
  } else if (tid < 2 * ROWS) {
    const int r = tid - ROWS;
    cp_async4(dl_s + r, delta + off + (r < nr ? r : 0), r < nr);
  }
}

// A barrier for the 128 threads of warp group 1 (warps 4-7) alone.
__device__ __forceinline__ void group1_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ bool visible(int t, int i, int causal,
                                        int window) {
  return (!causal || t <= i) && (window <= 0 || t > i - window);
}

// ---- Δ = rowsum(dO ∘ O): a warp a row of the (B·S·H) rows, into (B, H, S)

// the dot product of 16 bytes of o and dO
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}
__device__ __forceinline__ float dot16(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(xh[e]), w = __bfloat1622float2(yh[e]);
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
  }
  return s;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, long long rows, int S,
                          int H) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  const T* orow = o + row * HD;
  const T* drow = dout + row * HD;
  float s = 0.f;
  for (int d = kVec * lane; d < HD; d += 32 * kVec)
    s += dot16(orow + d, drow + d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    const long long bs = row / H;  // row = (b·S + s)·H + h
    const long long b = bs / S;
    delta[(b * H + row % H) * S + bs % S] = s;
  }
}

// ---- fp32 on the CUDA cores ----

// The output layout of dV, dK and dQ over NTH threads: runs of 4 columns,
// TC run groups (16, or 8 where hd/4 is not a multiple of 16: hd 32 and
// 80) and TR = NTH / TC row groups; a thread owns MR consecutive rows and
// NU runs, TC apart. A warp is 4 row groups × 8 run groups: a k-step's read
// of the rows has 4 distinct addresses, of each run 8 consecutive ones.
template <int HD, int NTH>
struct RunLayout {
  static constexpr int NRUN = HD / 4;
  static constexpr int TC = NRUN % 16 == 0 ? 16 : 8;
  static constexpr int NU = (NRUN + TC - 1) / TC;
  static constexpr int TR = NTH / TC;
  __device__ static bool valid(int run) {
    return NRUN % TC == 0 || run < NRUN;
  }
  // the thread's row and run groups from its lane and its warp among NTH/32
  __device__ static int tr(int lane, int w) {
    return (lane >> 3) + 4 * (w / (TC / 8));
  }
  __device__ static int tc(int lane, int w) {
    return (lane & 7) + 8 * (w % (TC / 8));
  }
};

// The layout of S or dP over 128 threads (4 warps): TJ key groups (8 or
// 16) and TI = 128 / TJ row groups; a thread owns rows TI apart and keys TJ
// apart. A warp is 4 row groups × 8 key groups: a read of the row operand
// has 4 distinct addresses, of the key operand 8 consecutive rows, whose
// hd + 4 floats put them on distinct banks at every hd.
template <int TJ>
struct ScoreLayout {
  static constexpr int TI = 128 / TJ;
  __device__ static int ti(int lane, int w) {
    return (lane >> 3) + 4 * (w / (TJ / 8));
  }
  __device__ static int tj(int lane, int w) {
    return (lane & 7) + 8 * (w % (TJ / 8));
  }
};

// acc[a][b] = Σ_d x_s[ti + TI·a][d] · y_s[tj + TJ·b][d] over staged rows of
// hd + 4 floats (q·kᵀ or dO·vᵀ), fed by 16-byte reads along hd.
template <int HD, int MI, int NJ, int TI, int TJ>
__device__ __forceinline__ void dot_tile(const float* x_s, const float* y_s,
                                         int ti, int tj,
                                         float (&acc)[MI][NJ]) {
  constexpr int RS = HD + 4;
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NJ; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; d += 4) {
    float4 x[MI], y[NJ];
#pragma unroll
    for (int a = 0; a < MI; ++a)
      x[a] = *reinterpret_cast<const float4*>(x_s + (ti + TI * a) * RS + d);
#pragma unroll
    for (int b = 0; b < NJ; ++b)
      y[b] = *reinterpret_cast<const float4*>(y_s + (tj + TJ * b) * RS + d);
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NJ; ++b) {
        acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
        acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
        acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
        acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
      }
  }
}

// MR consecutive floats of shared memory (MR = 2, or a multiple of 4)
template <int MR>
__device__ __forceinline__ void ld_rows(const float* p, float (&a)[MR]) {
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MR; m += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + m);
      a[m] = t.x; a[m + 1] = t.y; a[m + 2] = t.z; a[m + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    a[0] = t.x; a[1] = t.y;
  }
}

// acc[m][u][e] += Σ_k a_s[k][MR·tr + m] · b_s[k][4·(tc + TC·u) + e] over
// k < KN: the thread's MR consecutive output rows and NU runs of 4 columns.
template <int HD, int NTH, int MR, int KN>
__device__ __forceinline__ void outer_f32(
    float (&acc)[MR][RunLayout<HD, NTH>::NU][4], const float* a_s, int lda,
    const float* b_s, int ldb, int tr, int tc) {
  using L = RunLayout<HD, NTH>;
  static_assert(MR == 2 || MR % 4 == 0, "a thread's rows: one read");
  const float* ap = a_s + MR * tr;
  const float* bp = b_s + 4 * tc;
#pragma unroll 8
  for (int k = 0; k < KN; ++k) {
    float a[MR];
    ld_rows<MR>(ap + k * lda, a);
#pragma unroll
    for (int u = 0; u < L::NU; ++u) {
      if (!L::valid(tc + L::TC * u)) continue;
      const float4 b =
          *reinterpret_cast<const float4*>(bp + k * ldb + 4 * L::TC * u);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        acc[m][u][0] = fmaf(a[m], b.x, acc[m][u][0]);
        acc[m][u][1] = fmaf(a[m], b.y, acc[m][u][1]);
        acc[m][u][2] = fmaf(a[m], b.z, acc[m][u][2]);
        acc[m][u][3] = fmaf(a[m], b.w, acc[m][u][3]);
      }
    }
  }
}

// The thread's MR rows × NU runs into device rows from `dst` (row stride
// gstride), rows at or past `valid` skipped, each value times `s`.
template <int HD, int NTH, int MR>
__device__ __forceinline__ void store_runs(
    float* dst, long long gstride,
    const float (&acc)[MR][RunLayout<HD, NTH>::NU][4], int valid, int tr,
    int tc, float s) {
  using L = RunLayout<HD, NTH>;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r = MR * tr + m;
    if (r >= valid) continue;
#pragma unroll
    for (int u = 0; u < L::NU; ++u) {
      const int run = tc + L::TC * u;
      if (!L::valid(run)) continue;
      *reinterpret_cast<float4*>(dst + r * gstride + 4 * run) =
          make_float4(acc[m][u][0] * s, acc[m][u][1] * s, acc[m][u][2] * s,
                      acc[m][u][3] * s);
    }
  }
}

template <typename F>
__device__ __forceinline__ void zero_runs(F& acc) {
#pragma unroll
  for (auto& row : acc)
#pragma unroll
    for (auto& run : row)
#pragma unroll
      for (float& x : run) x = 0.f;
}

// dkdv in fp32, persistent: block n takes the work items n, n + gridDim.x,
// ... of the (b, KV head, key tile) items, key tile 0 (the longest under a
// causal mask) first. Its two warp groups split each step by product: warps
// 0-3 compute S, put P in shared memory and sum dV += Pᵀ·dO; warps 4-7
// compute dP, form dS = P ∘ (dP − Δ) from P and sum dK += dSᵀ·q. Group 0
// starts on dV as soon as P is in; group 1 waits on its own barrier for
// dS. The products of dV and dK read no k or v, so the next item's k and v
// tile is staged during the last step's.
template <int HD>
__device__ __forceinline__ void dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int B, int S, int H,
    int K, int causal, int window, float scale) {
  using G = Tiles<float, HD>;
  constexpr int RS = HD + G::kPad, BC = G::kKvKeys, BR = G::kKvRows;
  constexpr int PS = BC + 8;  // P, dS rows: 4 rows × 8 keys on 32 banks
  using SL = ScoreLayout<BC == 64 ? 16 : 8>;
  using L = RunLayout<HD, 128>;
  constexpr int TI = SL::TI, TJ = 128 / TI;
  constexpr int MI = BR / TI, NJ = BC / TJ, MR = BC / L::TR;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [BC][RS]
  float* v_s = k_s + BC * RS;                     // [BC][RS]
  float* q_s = v_s + BC * RS;                     // [2][BR][RS]
  float* do_s = q_s + 2 * BR * RS;                // [2][BR][RS]
  float* p_s = do_s + 2 * BR * RS;                // [BR][PS]
  float* ds_s = p_s + BR * PS;                    // [BR][PS]
  float* lse_s = ds_s + BR * PS;                  // [2][BR]
  float* dl_s = lse_s + 2 * BR;                   // [2][BR]

  const int Gq = H / K;
  const int items = B * K * ((S + BC - 1) / BC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, gw = warp & 3;  // 0: S, P, dV; 1: dP, dK
  const int ti = SL::ti(lane, gw), tj = SL::tj(lane, gw);
  const int tr = L::tr(lane, gw), tc = L::tc(lane, gw);
  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;

  // an item's key tile, and the query rows [r_lo, r_hi) that see it
  struct Item {
    int b, kh, t0, nk, r_lo, per_head, steps;
  };
  auto item_at = [&](int n) {
    Item it;
    it.b = n % (B * K) / K;
    it.kh = n % K;
    it.t0 = n / (B * K) * BC;
    it.nk = min(BC, S - it.t0);
    it.r_lo = causal ? it.t0 / BR * BR : 0;
    const int r_hi = window > 0 ? min(S, it.t0 + it.nk - 1 + window) : S;
    it.per_head = (r_hi - it.r_lo + BR - 1) / BR;
    it.steps = Gq * it.per_head;
    return it;
  };
  auto kv_off = [&](const Item& it) {
    return ((long long)it.b * S + it.t0) * kv_seq + (long long)it.kh * HD;
  };
  auto stage_kv = [&](const Item& it) {
    stage_rows<float, HD, BC>(k_s, k + kv_off(it), kv_seq, it.nk, tid);
    stage_rows<float, HD, BC>(v_s, v + kv_off(it), kv_seq, it.nk, tid);
  };
  // step s of an item into ring buffer buf
  auto stage_step = [&](const Item& it, int s, int buf) {
    const int hq = it.kh * Gq + s / it.per_head;
    const int r0 = it.r_lo + (s % it.per_head) * BR, nr = min(BR, S - r0);
    const long long q_off = ((long long)it.b * S + r0) * q_seq + (long long)hq * HD;
    stage_rows<float, HD, BR>(q_s + buf * BR * RS, q + q_off, q_seq, nr, tid);
    stage_rows<float, HD, BR>(do_s + buf * BR * RS, dout + q_off, q_seq, nr,
                              tid);
    stage_stats<BR>(lse_s + buf * BR, dl_s + buf * BR, lse, delta,
                    ((long long)it.b * H + hq) * S + r0, nr, tid);
  };

  int n = blockIdx.x;
  if (n >= items) return;
  Item cur = item_at(n);
  stage_kv(cur);
  stage_step(cur, 0, 0);
  cp_async_commit();
  int g = 0;  // the block's steps so far: ring buffer g & 1

  for (; n < items; n += (int)gridDim.x) {
    const bool more = n + (int)gridDim.x < items;
    const Item nxt = more ? item_at(n + (int)gridDim.x) : cur;
    float acc[MR][L::NU][4];  // dV (group 0) or dK (group 1)
    zero_runs(acc);
    for (int it = 0; it < cur.steps; ++it, ++g) {
      cp_async_wait_all();
      // step it's tiles are in, and the last step is done with the other
      // buffer and with P and dS
      __syncthreads();
      if (it + 1 < cur.steps)
        stage_step(cur, it + 1, (g + 1) & 1);
      else if (more)
        stage_step(nxt, 0, (g + 1) & 1);
      cp_async_commit();
      const int buf = g & 1;
      const int r0 = cur.r_lo + (it % cur.per_head) * BR;
      const int nr = min(BR, S - r0);
      const float* qt = q_s + buf * BR * RS;
      const float* dot = do_s + buf * BR * RS;
      const float* lt = lse_s + buf * BR;
      const float* dlt = dl_s + buf * BR;
      // every pair of the step visible: no mask to test
      const bool full = nr == BR && cur.nk == BC &&
                        (!causal || r0 >= cur.t0 + BC - 1) &&
                        (window <= 0 || r0 + BR - 1 - window < cur.t0);

      float sc[MI][NJ];  // S (group 0) or dP (group 1)
      if (causal && NJ % 2 == 0 && r0 + BR <= cur.t0 + BC / 2) {
        // the first step of a causal tile: its second half of keys lies
        // past every row, so only the first half is computed
        float h[MI][NJ / 2];
        dot_tile<HD, MI, NJ / 2, TI, TJ>(grp ? dot : qt, grp ? v_s : k_s, ti,
                                         tj, h);
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int c = 0; c < NJ; ++c)
            sc[a][c] = c < NJ / 2 ? h[a][c % (NJ / 2)] : 0.f;
      } else {
        dot_tile<HD, MI, NJ, TI, TJ>(grp ? dot : qt, grp ? v_s : k_s, ti, tj,
                                     sc);
      }
      if (grp == 0) {
#pragma unroll
        for (int a = 0; a < MI; ++a) {
          const int i = ti + TI * a;
          const float li = lt[i];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            const int j = tj + TJ * c;
            const bool vis =
                full || (i < nr && j < cur.nk &&
                         visible(cur.t0 + j, r0 + i, causal, window));
            p_s[i * PS + j] = vis ? expf(sc[a][c] * scale - li) : 0.f;
          }
        }
      }
      __syncthreads();  // P is in; k and v are read no more this step
      if (it + 1 == cur.steps && more) {
        stage_kv(nxt);
        cp_async_commit();
      }
      if (grp == 0) {
        outer_f32<HD, 128, MR, BR>(acc, p_s, PS, dot, RS, tr, tc);
      } else {
#pragma unroll
        for (int a = 0; a < MI; ++a) {
          const int i = ti + TI * a;
          const float di = dlt[i];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            const int j = tj + TJ * c;
            ds_s[i * PS + j] = p_s[i * PS + j] * (sc[a][c] - di);
          }
        }
        group1_sync();
        outer_f32<HD, 128, MR, BR>(acc, ds_s, PS, qt, RS, tr, tc);
      }
    }
    store_runs<HD, 128, MR>((grp ? dk : dv) + kv_off(cur), kv_seq, acc,
                            cur.nk, tr, tc, grp ? scale : 1.f);
    cur = nxt;
  }
}

// dq in fp32, persistent over the (b, query head, query tile) items, the
// last query tile (the longest under a causal mask) first. Warps 0-3
// compute S and put P in the dSᵀ tile, warps 4-7 compute dP and overwrite
// each P with dS; all 8 sum dQ += dS·k. That product reads no q, dO, lse
// or Δ, so the next item's are staged during the last step's.
template <int HD>
__device__ __forceinline__ void dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int B, int S, int H, int K, int causal,
    int window, float scale) {
  using G = Tiles<float, HD>;
  constexpr int RS = HD + G::kPad, BR = G::kQRows, BC = G::kQKeys;
  constexpr int DS = BR + 4;  // dSᵀ rows: 8 keys × 4 rows on 32 banks
  using SL = ScoreLayout<BC == 64 ? 16 : 8>;
  using L = RunLayout<HD, kThreads>;
  constexpr int TI = SL::TI, TJ = 128 / TI;
  constexpr int MI = BR / TI, NJ = BC / TJ, MR = BR / L::TR;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BR][RS]
  float* do_s = q_s + BR * RS;                    // [BR][RS]
  float* k_s = do_s + BR * RS;                    // [2][BC][RS]
  float* v_s = k_s + 2 * BC * RS;                 // [2][BC][RS]
  float* dst_s = v_s + 2 * BC * RS;               // [BC][DS]: Pᵀ, then dSᵀ
  float* lse_s = dst_s + BC * DS;                 // [BR]
  float* dl_s = lse_s + BR;                       // [BR]

  const int row_tiles = (S + BR - 1) / BR;
  const int items = B * H * row_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, gw = warp & 3;  // 0: S, P; 1: dP, dS
  const int ti = SL::ti(lane, gw), tj = SL::tj(lane, gw);
  const int tr = L::tr(lane, warp), tc = L::tc(lane, warp);
  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;

  // an item's query tile, and the keys [t_lo, t_hi) its rows see
  struct Item {
    int b, h, r0, nr, t_lo, steps;
  };
  auto item_at = [&](int n) {
    Item it;
    it.b = n % (B * H) / H;
    it.h = n % H;
    it.r0 = (row_tiles - 1 - n / (B * H)) * BR;
    it.nr = min(BR, S - it.r0);
    it.t_lo = window > 0 ? max(0, it.r0 - window + 1) / BC * BC : 0;
    const int t_hi = causal ? it.r0 + it.nr : S;
    it.steps = (t_hi - it.t_lo + BC - 1) / BC;
    return it;
  };
  auto q_off = [&](const Item& it) {
    return ((long long)it.b * S + it.r0) * q_seq + (long long)it.h * HD;
  };
  auto stage_rows_of = [&](const Item& it) {
    stage_rows<float, HD, BR>(q_s, q + q_off(it), q_seq, it.nr, tid);
    stage_rows<float, HD, BR>(do_s, dout + q_off(it), q_seq, it.nr, tid);
    stage_stats<BR>(lse_s, dl_s, lse, delta,
                    ((long long)it.b * H + it.h) * S + it.r0, it.nr, tid);
  };
  // step s of an item (keys t_lo + s·BC) into ring buffer buf
  auto stage_step = [&](const Item& it, int s, int buf) {
    const int t0 = it.t_lo + s * BC, kh = it.h / (H / K);
    const long long off = ((long long)it.b * S + t0) * kv_seq + (long long)kh * HD;
    stage_rows<float, HD, BC>(k_s + buf * BC * RS, k + off, kv_seq, S - t0,
                              tid);
    stage_rows<float, HD, BC>(v_s + buf * BC * RS, v + off, kv_seq, S - t0,
                              tid);
  };

  int n = blockIdx.x;
  if (n >= items) return;
  Item cur = item_at(n);
  stage_rows_of(cur);
  stage_step(cur, 0, 0);
  cp_async_commit();
  int g = 0;  // the block's steps so far: ring buffer g & 1

  for (; n < items; n += (int)gridDim.x) {
    const bool more = n + (int)gridDim.x < items;
    const Item nxt = more ? item_at(n + (int)gridDim.x) : cur;
    float dq_acc[MR][L::NU][4];
    zero_runs(dq_acc);
    for (int it = 0; it < cur.steps; ++it, ++g) {
      cp_async_wait_all();
      __syncthreads();
      if (it + 1 < cur.steps)
        stage_step(cur, it + 1, (g + 1) & 1);
      else if (more)
        stage_step(nxt, 0, (g + 1) & 1);
      cp_async_commit();
      const int t0 = cur.t_lo + it * BC, nk = min(BC, S - t0);
      const float* kt = k_s + (g & 1) * BC * RS;
      const float* vt = v_s + (g & 1) * BC * RS;
      const bool full = cur.nr == BR && nk == BC &&
                        (!causal || cur.r0 >= t0 + BC - 1) &&
                        (window <= 0 || cur.r0 + BR - 1 - window < t0);

      float sc[MI][NJ];  // S (group 0) or dP (group 1)
      dot_tile<HD, MI, NJ, TI, TJ>(grp ? do_s : q_s, grp ? vt : kt, ti, tj,
                                   sc);
      if (grp == 0) {
#pragma unroll
        for (int a = 0; a < MI; ++a) {
          const int i = ti + TI * a;
          const float li = lse_s[i];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            const int j = tj + TJ * c;
            const bool vis =
                full || (i < cur.nr && j < nk &&
                         visible(t0 + j, cur.r0 + i, causal, window));
            dst_s[j * DS + i] = vis ? expf(sc[a][c] * scale - li) : 0.f;
          }
        }
      }
      __syncthreads();
      if (grp == 1) {
#pragma unroll
        for (int a = 0; a < MI; ++a) {
          const int i = ti + TI * a;
          const float di = dl_s[i];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            const int j = tj + TJ * c;
            dst_s[j * DS + i] *= sc[a][c] - di;
          }
        }
      }
      __syncthreads();
      if (it + 1 == cur.steps && more) {
        stage_rows_of(nxt);  // q, dO, lse and Δ are read no more
        cp_async_commit();
      }
      outer_f32<HD, kThreads, MR, BC>(dq_acc, dst_s, DS, kt, RS, tr, tc);
    }
    store_runs<HD, kThreads, MR>(dq + q_off(cur), q_seq, dq_acc, cur.nr, tr,
                                 tc, scale);
    cur = nxt;
  }
}

// ---- bf16 on the tensor cores ----

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a·b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s = q·kᵀ and dp = dO·vᵀ for one warp: query rows m0..m0+15 and NT 8-key
// column tiles from key n0. Fragment e of tile t: row m0 + g + 8·(e >> 1),
// key n0 + 8t + 2·t4 + (e & 1).
template <int HD, int NT>
__device__ __forceinline__ void scores_bf16(const bf16* q_s, const bf16* do_s,
                                            const bf16* k_s, const bf16* v_s,
                                            int m0, int n0, int lane,
                                            float (&s)[NT][4],
                                            float (&dp)[NT][4]) {
  constexpr int RS = HD + 8;
  const int l8 = lane & 7, q4 = lane >> 3;
  // A, row-major: matrix q4 is rows 8·(q4 & 1), columns 8·(q4 >> 1)
  const int a_off = (m0 + 8 * (q4 & 1) + l8) * RS + 8 * (q4 >> 1);
  // B = kᵀ from rows of k: matrix (q4 & 1) is columns 8·(q4 & 1) of hd
  const int b_off = (n0 + l8) * RS + 8 * (q4 & 1);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll 4
  for (int d0 = 0; d0 < HD; d0 += 16) {
    uint32_t a[4], bb[2];
    ldsm_x4(a, q_s + a_off + d0);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      ldsm_x2(bb, k_s + b_off + 8 * t * RS + d0);
      mma_bf16(s[t], a, bb);
    }
    ldsm_x4(a, do_s + a_off + d0);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      ldsm_x2(bb, v_s + b_off + 8 * t * RS + d0);
      mma_bf16(dp[t], a, bb);
    }
  }
}

// acc += A·B for one warp: output rows m0..m0+15, NT 8-column tiles from
// column c0, inner k < KN. A[m][k] is a_s[k][m] (A_TRANS: Pᵀ, dSᵀ) or
// a_s[m][k] (dS); B[k][n] is b_s[k][n] (dO, q, k rows), loaded transposed.
template <bool A_TRANS, int KN, int NT>
__device__ __forceinline__ void acc_bf16(float (&acc)[NT][4], const bf16* a_s,
                                         int lda, const bf16* b_s, int ldb,
                                         int m0, int c0, int lane) {
  const int l8 = lane & 7, q4 = lane >> 3;
  // A's matrix q4: rows m 8·(q4 & 1), columns k 8·(q4 >> 1)
  const bf16* ap = A_TRANS
                       ? a_s + (8 * (q4 >> 1) + l8) * lda + m0 + 8 * (q4 & 1)
                       : a_s + (m0 + 8 * (q4 & 1) + l8) * lda + 8 * (q4 >> 1);
  // B's matrix (q4 & 1): rows k 8·(q4 & 1)
  const bf16* bp = b_s + (8 * (q4 & 1) + l8) * ldb + c0;
#pragma unroll
  for (int k0 = 0; k0 < KN; k0 += 16) {
    uint32_t a[4];
    if constexpr (A_TRANS) {
      ldsm_x4_trans(a, ap + k0 * lda);
    } else {
      ldsm_x4(a, ap + k0);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t bb[2];
      ldsm_x2_trans(bb, bp + k0 * ldb + 8 * t);
      mma_bf16(acc[t], a, bb);
    }
  }
}

// One warp's 16 rows × NT 8-column tiles from (m0, c0) into device rows
// from `dst` (row stride gstride), rows at or past `valid` skipped, times s.
template <int NT>
__device__ __forceinline__ void store_tiles(bf16* dst, long long gstride,
                                            const float (&acc)[NT][4],
                                            int valid, int m0, int c0,
                                            int lane, float s) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = m0 + g + 8 * rr;
    if (r >= valid) continue;
    bf16* row = dst + r * gstride + c0 + 2 * t4;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * t) = __floats2bfloat162_rn(
          acc[t][2 * rr] * s, acc[t][2 * rr + 1] * s);
  }
}

template <int HD>
__device__ __forceinline__ void dkdv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int K,
    int causal, int window, float scale) {
  using G = Tiles<bf16, HD>;
  constexpr int RS = HD + G::kPad, BC = G::kKvKeys, BR = G::kKvRows;
  constexpr int PS = BC + 8;
  constexpr int RT = BR / 16, SCG = 8 / RT;  // scores: row tiles, key groups
  constexpr int NTS = BC / SCG / 8;          // a warp's 8-key score tiles
  constexpr int MT = BC / 16, CG = 8 / MT;   // dV, dK: key tiles, col groups
  constexpr int NTA = HD / CG / 8;           // a warp's 8-column tiles
  static_assert(BC % (8 * SCG) == 0 && HD % (8 * CG) == 0, "bf16 tiling");
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);  // [BC][RS]
  bf16* v_s = k_s + BC * RS;                    // [BC][RS]
  bf16* q_s = v_s + BC * RS;                    // [2][BR][RS]
  bf16* do_s = q_s + 2 * BR * RS;               // [2][BR][RS]
  bf16* p_s = do_s + 2 * BR * RS;               // [BR][PS]
  bf16* ds_s = p_s + BR * PS;                   // [BR][PS]
  float* lse_s = reinterpret_cast<float*>(ds_s + BR * PS);  // [2][BR]
  float* dl_s = lse_s + 2 * BR;                              // [2][BR]

  const int Gq = H / K;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int t0 = blockIdx.y * BC;  // key tile 0, the longest, first
  const int nk = min(BC, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int sm0 = 16 * (warp % RT), sn0 = (warp / RT) * (BC / SCG);
  const int am0 = 16 * (warp % MT), ac0 = (warp / MT) * (HD / CG);

  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;
  const long long kv_off = ((long long)b * S + t0) * kv_seq + (long long)kh * HD;
  stage_rows<bf16, HD, BC>(k_s, k + kv_off, kv_seq, nk, tid);
  stage_rows<bf16, HD, BC>(v_s, v + kv_off, kv_seq, nk, tid);

  const int r_lo = causal ? t0 / BR * BR : 0;
  const int r_hi = window > 0 ? min(S, t0 + nk - 1 + window) : S;
  const int per_head = (r_hi - r_lo + BR - 1) / BR;
  const int steps = Gq * per_head;
  auto stage_step = [&](int it) {
    const int hq = kh * Gq + it / per_head, r0 = r_lo + (it % per_head) * BR;
    const int nr = min(BR, S - r0), buf = it & 1;
    const long long q_off = ((long long)b * S + r0) * q_seq + (long long)hq * HD;
    stage_rows<bf16, HD, BR>(q_s + buf * BR * RS, q + q_off, q_seq, nr, tid);
    stage_rows<bf16, HD, BR>(do_s + buf * BR * RS, dout + q_off, q_seq, nr,
                             tid);
    stage_stats<BR>(lse_s + buf * BR, dl_s + buf * BR, lse, delta,
                    ((long long)b * H + hq) * S + r0, nr, tid);
  };
  stage_step(0);
  cp_async_commit();

  float dk_acc[NTA][4], dv_acc[NTA][4];
#pragma unroll
  for (int t = 0; t < NTA; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < steps) stage_step(it + 1);
    cp_async_commit();
    const int buf = it & 1;
    const int r0 = r_lo + (it % per_head) * BR, nr = min(BR, S - r0);
    const bf16* qt = q_s + buf * BR * RS;
    const bf16* dot = do_s + buf * BR * RS;
    const float* lt = lse_s + buf * BR;
    const float* dlt = dl_s + buf * BR;

    float s[NTS][4], dp[NTS][4];
    scores_bf16<HD, NTS>(qt, dot, k_s, v_s, sm0, sn0, lane, s, dp);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = sm0 + g + 8 * rr;
      const float li = lt[i], di = dlt[i];
#pragma unroll
      for (int t = 0; t < NTS; ++t) {
        const int j = sn0 + 8 * t + 2 * t4;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = i < nr && j + e < nk &&
                           visible(t0 + j + e, r0 + i, causal, window);
          p[e] = vis ? expf(s[t][2 * rr + e] * scale - li) : 0.f;
          ds[e] = p[e] * (dp[t][2 * rr + e] - di);
        }
        // P and dS rounded to bf16 here, for dV += Pᵀ·dO and dK += dSᵀ·q
        *reinterpret_cast<uint32_t*>(p_s + i * PS + j) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(ds_s + i * PS + j) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();
    acc_bf16<true, BR, NTA>(dv_acc, p_s, PS, dot, RS, am0, ac0, lane);
    acc_bf16<true, BR, NTA>(dk_acc, ds_s, PS, qt, RS, am0, ac0, lane);
  }

  const long long off = ((long long)b * S + t0) * kv_seq + (long long)kh * HD;
  store_tiles<NTA>(dk + off, kv_seq, dk_acc, nk, am0, ac0, lane, scale);
  store_tiles<NTA>(dv + off, kv_seq, dv_acc, nk, am0, ac0, lane, 1.f);
}

template <int HD>
__device__ __forceinline__ void dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int H, int K, int causal, int window,
    float scale) {
  using G = Tiles<bf16, HD>;
  constexpr int RS = HD + G::kPad, BR = G::kQRows, BC = G::kQKeys;
  constexpr int PS = BC + 8;
  constexpr int RT = BR / 16, SCG = 8 / RT;  // scores: row tiles, key groups
  constexpr int NTS = BC / SCG / 8;          // a warp's 8-key score tiles
  constexpr int CG = 8 / RT;                 // dQ: column groups
  constexpr int NTA = HD / CG / 8;           // a warp's 8-column tiles
  static_assert(BC % (8 * SCG) == 0 && HD % (8 * CG) == 0, "bf16 tiling");
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [BR][RS]
  bf16* do_s = q_s + BR * RS;                   // [BR][RS]
  bf16* k_s = do_s + BR * RS;                   // [2][BC][RS]
  bf16* v_s = k_s + 2 * BC * RS;                // [2][BC][RS]
  bf16* ds_s = v_s + 2 * BC * RS;               // [BR][PS]
  float* lse_s = reinterpret_cast<float*>(ds_s + BR * PS);  // [BR]
  float* dl_s = lse_s + BR;                                  // [BR]

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;  // the last tile first
  const int nr = min(BR, S - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int sm0 = 16 * (warp % RT), sn0 = (warp / RT) * (BC / SCG);
  const int am0 = sm0, ac0 = (warp / RT) * (HD / CG);

  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;
  const long long q_off = ((long long)b * S + r0) * q_seq + (long long)h * HD;
  stage_rows<bf16, HD, BR>(q_s, q + q_off, q_seq, nr, tid);
  stage_rows<bf16, HD, BR>(do_s, dout + q_off, q_seq, nr, tid);
  stage_stats<BR>(lse_s, dl_s, lse, delta, ((long long)b * H + h) * S + r0,
                  nr, tid);

  const int t_lo = window > 0 ? max(0, r0 - window + 1) / BC * BC : 0;
  const int t_hi = causal ? r0 + nr : S;
  const int steps = (t_hi - t_lo + BC - 1) / BC;
  const bf16* kg = k + (long long)b * S * kv_seq + (long long)kh * HD;
  const bf16* vg = v + (long long)b * S * kv_seq + (long long)kh * HD;
  auto stage_step = [&](int it) {
    const int t0 = t_lo + it * BC, buf = it & 1;
    stage_rows<bf16, HD, BC>(k_s + buf * BC * RS, kg + t0 * kv_seq, kv_seq,
                             S - t0, tid);
    stage_rows<bf16, HD, BC>(v_s + buf * BC * RS, vg + t0 * kv_seq, kv_seq,
                             S - t0, tid);
  };
  stage_step(0);
  cp_async_commit();

  float dq_acc[NTA][4];
#pragma unroll
  for (int t = 0; t < NTA; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[t][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < steps) stage_step(it + 1);
    cp_async_commit();
    const int t0 = t_lo + it * BC, nk = min(BC, S - t0);
    const bf16* kt = k_s + (it & 1) * BC * RS;
    const bf16* vt = v_s + (it & 1) * BC * RS;

    float s[NTS][4], dp[NTS][4];
    scores_bf16<HD, NTS>(q_s, do_s, kt, vt, sm0, sn0, lane, s, dp);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = sm0 + g + 8 * rr;
      const float li = lse_s[i], di = dl_s[i];
#pragma unroll
      for (int t = 0; t < NTS; ++t) {
        const int j = sn0 + 8 * t + 2 * t4;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = i < nr && j + e < nk &&
                           visible(t0 + j + e, r0 + i, causal, window);
          const float p = vis ? expf(s[t][2 * rr + e] * scale - li) : 0.f;
          ds[e] = p * (dp[t][2 * rr + e] - di);
        }
        // dS rounded to bf16 here, for dQ += dS·k
        *reinterpret_cast<uint32_t*>(ds_s + i * PS + j) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();
    acc_bf16<false, BC, NTA>(dq_acc, ds_s, PS, kt, RS, am0, ac0, lane);
  }

  store_tiles<NTA>(dq + q_off, q_seq, dq_acc, nr, am0, ac0, lane, scale);
}

// ---- the kernels: one per dtype and head dim ----

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<T>(smem_dkdv<T, HD>()))
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int B, int S, int H, int K,
                         int causal, int window, float scale) {
  if constexpr (std::is_same<T, float>::value)
    dkdv_f32<HD>(q, k, v, dout, lse, delta, dk, dv, B, S, H, K, causal,
                 window, scale);
  else
    dkdv_bf16<HD>(q, k, v, dout, lse, delta, dk, dv, S, H, K, causal, window,
                  scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<T>(smem_dq<T, HD>()))
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int B, int S, int H, int K, int causal, int window,
                       float scale) {
  if constexpr (std::is_same<T, float>::value)
    dq_f32<HD>(q, k, v, dout, lse, delta, dq, B, S, H, K, causal, window,
               scale);
  else
    dq_bf16<HD>(q, k, v, dout, lse, delta, dq, S, H, K, causal, window, scale);
}

// Once per kernel and device: the dynamic shared-memory opt-in, and the
// blocks the whole device holds at once (SMs × blocks an SM), the grid of a
// persistent kernel. `resident` caches the latter by device.
template <typename Kernel>
int opt_in_once(Kernel kernel, long long smem, int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& n = resident[dev & 63];
  if (n > 0) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  n = sms * per_sm;
  return 0;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int S, int H, int K, int causal, int window,
           cudaStream_t st) {
  using G = Tiles<T, HD>;
  static int resident_dkdv[64] = {}, resident_dq[64] = {};
  constexpr long long sm_dkdv = smem_dkdv<T, HD>(), sm_dq = smem_dq<T, HD>();
  static_assert(sm_dkdv <= 232448 && sm_dq <= 232448, "a block's 227 KB");
  int rc = opt_in_once(flash_attention_bwd_dkdv<T, HD>, sm_dkdv, resident_dkdv);
  if (rc) return rc;
  rc = opt_in_once(flash_attention_bwd_dq<T, HD>, sm_dq, resident_dq);
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
  const int key_tiles = (S + G::kKvKeys - 1) / G::kKvKeys;
  const int row_tiles = (S + G::kQRows - 1) / G::kQRows;
  dim3 grid_kv(B * K, key_tiles), grid_q(B * H, row_tiles);
  if constexpr (std::is_same<T, float>::value) {
    // persistent: as many blocks as the device holds, each walking its items
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const long long items_kv = (long long)B * K * key_tiles;
    const long long items_q = (long long)B * H * row_tiles;
    grid_kv = dim3((unsigned)min(items_kv, (long long)resident_dkdv[dev & 63]));
    grid_q = dim3((unsigned)min(items_q, (long long)resident_dq[dev & 63]));
  }
  flash_attention_bwd_dkdv<T, HD><<<grid_kv, kThreads, sm_dkdv, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      B, S, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq<T, HD><<<grid_q, kThreads, sm_dq, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), B, S, H, K, causal,
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
      (long long)B * H > 2147483647LL ||
      (S + kMinTile - 1) / kMinTile > 65535)
    return (int)cudaErrorInvalidValue;
  const float* lse = static_cast<const float*>(p(4));
  float* delta = static_cast<float*>(p(9));
  cudaStream_t st = static_cast<cudaStream_t>(p(18));
  if (a[17])
    return launch_hd<bf16>(hd, p(0), p(1), p(2), p(3), lse, p(5), p(6), p(7),
                           p(8), delta, B, S, H, K, causal, window, st);
  return launch_hd<float>(hd, p(0), p(1), p(2), p(3), lse, p(5), p(6), p(7),
                          p(8), delta, B, S, H, K, causal, window, st);
}

// The dynamic shared memory of the larger of the two backward blocks at
// head dim hd in fp32 (is_bf16 = 0) or bf16, or -1 for another head dim:
// what the wrapper's smem_bytes_bwd mirrors.
extern "C" long long flash_attention_bwd_smem(int hd, int is_bf16) {
  auto larger = [](long long a, long long b) { return a > b ? a : b; };
#define FA_BWD_SMEM(HD)                                         \
  case HD:                                                      \
    return is_bf16 ? larger(smem_dkdv<bf16, HD>(), smem_dq<bf16, HD>()) \
                   : larger(smem_dkdv<float, HD>(), smem_dq<float, HD>());
  switch (hd) {
    FA_BWD_SMEM(32)
    FA_BWD_SMEM(64)
    FA_BWD_SMEM(80)
    FA_BWD_SMEM(128)
    FA_BWD_SMEM(256)
    default: return -1;
  }
#undef FA_BWD_SMEM
}
