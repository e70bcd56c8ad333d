// Flash attention forward for Hopper (sm_90a).
//
// The TPU kernel it replaces: src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call at :90), softmax(q·kᵀ/√hd + mask)·v by online
// softmax over 128×128 blocks held in VMEM, with the m/l/acc carries in fp32
// scratch across a sequential KV grid axis. Here q is (B,S,H,hd) and k, v are
// (B,T,K,hd) with H % K == 0; query head h reads KV head h / (H/K) in place
// (no KV copy); the queries are the last S of T positions (q_off = T - S);
// `causal` keeps keys t <= q + q_off and `window > 0` keeps t > q + q_off -
// window. fp32 and bf16 inputs; the output is rounded once to the input's
// dtype.
//
// Masked scores are the finite -1e30 (flash_attention.py:22), never -inf: a
// row with no visible key (causal with T < S) then ties every score and
// returns the mean of v, exactly as the reference does. Keys past the ragged
// end of T take no part (p = 0), so S and T need not be multiples of a tile.
//
// What bounds it on this card. At the serving shapes, (1, 32, 16, 128) and
// (1, 32, 16, 256) with one KV head, a call moves ~1.1 MB (0.31-0.33 µs at
// 3.35 TB/s) and does ~8.7 MFLOP (0.13 µs at 67 TFLOP/s): neither bounds it.
// Latency does: the launch, one round trip to memory per KV tile, and the
// longest dependent chain of arithmetic in a block. The first port
// staged each KV tile in 16-32 rounds of 4-byte loads, each of whose stores
// waited on its load, scored each key with one 128- or 256-long chain of
// dependent FMAs per lane, and opted into its shared memory on every launch;
// 8.9 µs (hd 128) and 14.8 µs (hd 256) of device time on an H100 80GB HBM3 at
// 700 W. This design:
//   - stages with 16-byte asynchronous copies (cp.async.cg with commit/wait
//     groups): a block issues its q tile and the whole first K/V tile at
//     once, into a ring of two tiles, and tile t+1 is in flight while tile t
//     is computed, so a block waits on one memory latency per tile;
//   - visits only the KV tiles that some row of the block sees (the causal
//     diagonal and the window bound the range) when every row of the block
//     sees a key; a block with a row that sees no key (causal, T < S) visits
//     every tile, so that row still returns mean(v). A skipped tile would
//     only have added exact zeros;
//   - fp32 (the serving dtype) stays on CUDA cores, never TF32, to hold the
//     1e-4 parity the serving path relies on. A block of 8 warps takes 8
//     query rows of one (b, h), one warp a row and one lane a key of the
//     32-key tile: the score is four independent chains of hd/4 FMAs fed by
//     16-byte reads (q broadcast, k rows padded by 4 floats so the 8 lanes
//     of a read phase hit distinct banks: rows of 84 floats at hd 80 start
//     the 8 lanes at banks 0, 20, 8, 28, 16, 4, 24, 12), the row's max is a
//     warp shuffle, and each lane then owns runs of W output columns (W = 4
//     from hd 80 up, else hd/32), each key's p a shuffle and its v one
//     W-float read per W FMAs. At hd 80 the 20 runs of 4 leave lanes 20-31
//     idle in p·v (they read lane 19's run, a broadcast, and store
//     nothing), so the output stage has no branch. 8 rows a block give 64
//     blocks at the serving shapes, half the SMs; a first version with 16
//     rows a block and two keys a thread, 32 blocks there, ran 1.4x
//     slower at those shapes (chip_smoke.py);
//   - bf16 runs on the tensor cores: mma.sync.m16n8k16 with fp32
//     accumulation, one warp per 16 query rows, 4 warps a block. p is rounded
//     to bf16 for p·v (the softmax sums stay fp32), which the bf16 2e-2
//     tolerance covers. hd 80 is 5 k-steps of 16 and 10 output n-tiles;
//     its rows of 88 values (44 words) put the 8 fragment rows at banks
//     0, 12, 24, 4, 16, 28, 8, 20, distinct with their 4 columns each;
//   - the dynamic shared-memory opt-in (needed past 48 KB) is made once per
//     instantiation and device, not on every launch;
//   - the arguments come through ctypes packed in one int64 array, which
//     costs the host far less than converted arguments;
//   - training asks for each row's log-sum-exp (an optional fp32 (B,H,S)
//     output, the 15th argument): the backward kernel
//     (flash_attention_bwd.cu) recomputes P from it. A null pointer, which
//     the serving path passes, writes nothing more.
// Shared memory: fp32 4·(8·(hd+4) + 2·32·(hd+4) + 2·32·hd) bytes, 44,672 at
// hd 80, 70,784 at hd 128 and 140,416 at hd 256; bf16 2·(hd+8)·(64 + 4·32)
// bytes. Head dims: 32, 64, 80, 128, 256, each a native instantiation.
// Measured (benchmarks/port/kernel_ab.py, parent and this design in turns on
// one H100 80GB HBM3 at 700 W, fp32, device time a call): (1,32,16,128)
// causal 7.99 µs before, 4.00 now; (1,32,16,256) one KV head, window 2048,
// 12.80 before, 6.43 now; (1,1024,16,128) causal 1088 before, 485 now;
// (1,1024,16,256) window 256 2614 before, 504 now. hd 80 (chip_smoke.py, the
// same card and limit): (1,500,16,80) non-causal 183 µs, 10% of its 19.1 µs
// bound (operations). ptxas (-v): fp32 106-116 registers, bf16 96-227 (227
// at hd 256), 0 bytes of spill in every instantiation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxSmem = 232448;  // 227 KB: the most one block may use
constexpr int kKeys = 32;               // keys per KV tile, both kernels

// fp32: 8 query rows a block, one warp per row, one lane per key of a tile
constexpr int kRowsF = 8;
constexpr int kThreadsF = 32 * kRowsF;
constexpr int kPadF = 4;                // floats of padding per q/k row

// bf16: 4 warps of 16 query rows each
constexpr int kWarpsB = 4;
constexpr int kRowsB = 16 * kWarpsB;
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kPadB = 8;                // bf16 of padding per q/k/v row

constexpr long long smem_bytes_f32(int hd) {
  return 4LL * (kRowsF * (hd + kPadF) + 2 * kKeys * (hd + kPadF) +
                2 * kKeys * hd);
}
constexpr long long smem_bytes_bf16(int hd) {
  return 2LL * (hd + kPadB) * (kRowsB + 4 * kKeys);
}

// ---- 16-byte asynchronous copies into shared memory ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, rows) of HD elements, global row stride gstride, into shared rows
// of stride sstride; rows at or past `valid` are zero-filled.
template <typename T, int HD, int NT>
__device__ __forceinline__ void stage_rows(T* dst, int sstride, const T* src,
                                           long long gstride, int rows,
                                           int valid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int idx = tid; idx < rows * kPerRow; idx += NT) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const bool ok = r < valid;
    cp_async16(dst + r * sstride + c, ok ? src + r * gstride + c : src, ok);
  }
}

// Keys [lo, hi) that the block's rows [row0, row0 + nrows) can see, lo
// rounded down to a tile; every key when some row of the block sees none.
__device__ __forceinline__ void key_range(int row0, int nrows, int S, int Tk,
                                          int causal, int window, int& lo,
                                          int& hi) {
  const int first = row0 + Tk - S, last = first + nrows - 1;  // positions
  lo = 0;
  hi = Tk;
  if (causal && first < 0) return;  // a blind row: every tile, for mean(v)
  if (causal) hi = min(Tk, last + 1);
  if (window > 0) lo = max(0, first - window + 1) / kKeys * kKeys;
}

__device__ __forceinline__ float mask_score(float s, int t, int q_pos, int Tk,
                                            int causal, int window) {
  if (t >= Tk) return -INFINITY;  // past the ragged end: never the max
  const bool vis =
      (!causal || t <= q_pos) && (window <= 0 || t > q_pos - window);
  return vis ? s : kNegInf;
}

// W consecutive floats of shared memory, W in {1, 2, 4}
template <int W>
__device__ __forceinline__ void ld_run(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreadsF, 1)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, int Tk, int H,
                           int K, int causal, int window, float scale) {
  constexpr int QS = HD + kPadF;       // row stride of q_s and k_s (floats)
  constexpr int W = HD >= 80 ? 4 : HD / 32;  // output columns in runs of W
  constexpr int NRUN = HD / W;               // runs of a row
  constexpr int NR = (NRUN + 31) / 32;       // runs of a lane, 32 apart
  static_assert(HD % 4 == 0 && HD % W == 0 && (NRUN % 32 == 0 || NR == 1),
                "a lane's runs must tile the row");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRowsF][QS]
  float* k_s = q_s + kRowsF * QS;                 // [2][kKeys][QS]
  float* v_s = k_s + 2 * kKeys * QS;              // [2][kKeys][HD]

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int tid = threadIdx.x, lane = tid & 31;
  const int r = tid >> 5;   // this warp's query row within the block
  // this lane's first output column; a lane past the last run (hd 80)
  // shadows the last run and stores nothing
  const int col = W * min(lane, NRUN - 1);
  const int row0 = blockIdx.y * kRowsF;
  const int nrows = min(kRowsF, S - row0);
  const int q_pos = row0 + r + (Tk - S);  // the row's position among T keys

  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;
  const float* qg = q + ((long long)b * S + row0) * q_seq + (long long)h * HD;
  const float* kg = k + (long long)b * Tk * kv_seq + (long long)kh * HD;
  const float* vg = v + (long long)b * Tk * kv_seq + (long long)kh * HD;

  int t_lo, t_hi;
  key_range(row0, nrows, S, Tk, causal, window, t_lo, t_hi);
  const int ntiles = (t_hi - t_lo + kKeys - 1) / kKeys;
  auto stage_tile = [&](int i) {
    const int t0 = t_lo + i * kKeys, buf = i & 1;
    stage_rows<float, HD, kThreadsF>(k_s + buf * kKeys * QS, QS,
                                     kg + t0 * kv_seq, kv_seq, kKeys, Tk - t0,
                                     tid);
    stage_rows<float, HD, kThreadsF>(v_s + buf * kKeys * HD, HD,
                                     vg + t0 * kv_seq, kv_seq, kKeys, Tk - t0,
                                     tid);
  };
  stage_rows<float, HD, kThreadsF>(q_s, QS, qg, q_seq, kRowsF, nrows, tid);
  stage_tile(0);
  cp_async_commit();

  float m = kNegInf, l = 0.f, acc[NR][W];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < W; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage_tile(i + 1);  // into the other buffer
    cp_async_commit();                      // (an empty group on the last)
    cp_async_wait<1>();                     // tile i (and q) have landed
    __syncthreads();
    const float* kt = k_s + (i & 1) * kKeys * QS;
    const float* vt = v_s + (i & 1) * kKeys * HD;
    const int t = t_lo + i * kKeys + lane;  // this lane's key

    // q_r·k_t as four independent chains of hd/4 FMAs
    const float* qr = q_s + r * QS;
    const float* kr = kt + lane * QS;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qr + d);
      const float4 x = *reinterpret_cast<const float4*>(kr + d);
      s0 = fmaf(a.x, x.x, s0);
      s1 = fmaf(a.y, x.y, s1);
      s2 = fmaf(a.z, x.z, s2);
      s3 = fmaf(a.w, x.w, s3);
    }
    const float s =
        mask_score(((s0 + s1) + (s2 + s3)) * scale, t, q_pos, Tk, causal,
                   window);
    const float m_new = fmaxf(m, warp_max(s));  // finite: m starts at -1e30
    const float p = t < Tk ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + p;  // this lane's share; summed over the warp at the end
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[j][e] *= alpha;
#pragma unroll
    for (int key = 0; key < kKeys; ++key) {
      const float pk = __shfl_sync(kFull, p, key);
      const float* vr = vt + key * HD + col;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        float x[W];
        ld_run<W>(vr + 32 * W * j, x);
#pragma unroll
        for (int e = 0; e < W; ++e) acc[j][e] = fmaf(pk, x[e], acc[j][e]);
      }
    }
    m = m_new;
    __syncthreads();  // all done with buffer i & 1 before it is refilled
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
  if (r < nrows && lane < NRUN) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* orow = o + ((long long)b * S + row0 + r) * q_seq +
                  (long long)h * HD + col;
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < W; ++e) orow[32 * W * j + e] = acc[j][e] * inv;
  }
  // m is the row's max (one value across the warp), l its sum of e^{s-m}
  if (lse != nullptr && lane == 0 && r < nrows)
    lse[((long long)b * H + h) * S + row0 + r] = m + logf(l);
}

// ---- bf16 on the tensor cores ----

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 t;
  t.x = lo;
  t.y = hi;
  return *reinterpret_cast<const uint32_t*>(&t);
}

// d += a·b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(kThreadsB, 1)
flash_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S, int Tk, int H,
                            int K, int causal, int window, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = HD + kPadB;  // row stride of q_s, k_s, v_s (bf16)
  constexpr int NT = kKeys / 8;   // 8-key column tiles of the scores
  constexpr int ND = HD / 8;      // 8-column tiles of the output
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [kRowsB][RS]
  bf16* k_s = q_s + kRowsB * RS;                // [2][kKeys][RS]
  bf16* v_s = k_s + 2 * kKeys * RS;             // [2][kKeys][RS]

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragment's row, column
  const int row0 = blockIdx.y * kRowsB;
  const int nrows = min(kRowsB, S - row0);
  const int wrow = 16 * warp;              // this warp's rows in the block
  int q_pos[2];                            // rows wrow + g and wrow + g + 8
  q_pos[0] = row0 + wrow + g + (Tk - S);
  q_pos[1] = q_pos[0] + 8;

  const long long q_seq = (long long)H * HD, kv_seq = (long long)K * HD;
  const bf16* qg = q + ((long long)b * S + row0) * q_seq + (long long)h * HD;
  const bf16* kg = k + (long long)b * Tk * kv_seq + (long long)kh * HD;
  const bf16* vg = v + (long long)b * Tk * kv_seq + (long long)kh * HD;

  int t_lo, t_hi;
  key_range(row0, nrows, S, Tk, causal, window, t_lo, t_hi);
  const int ntiles = (t_hi - t_lo + kKeys - 1) / kKeys;
  auto stage_tile = [&](int i) {
    const int t0 = t_lo + i * kKeys, buf = i & 1;
    stage_rows<bf16, HD, kThreadsB>(k_s + buf * kKeys * RS, RS,
                                    kg + t0 * kv_seq, kv_seq, kKeys, Tk - t0,
                                    tid);
    stage_rows<bf16, HD, kThreadsB>(v_s + buf * kKeys * RS, RS,
                                    vg + t0 * kv_seq, kv_seq, kKeys, Tk - t0,
                                    tid);
  };
  stage_rows<bf16, HD, kThreadsB>(q_s, RS, qg, q_seq, kRowsB, nrows, tid);
  stage_tile(0);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* qw = q_s + wrow * RS;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = k_s + (i & 1) * kKeys * RS;
    const bf16* vt = v_s + (i & 1) * kKeys * RS;
    const int t0 = t_lo + i * kKeys;

    // scores: s[n][0..1] row g, keys t0 + 8n + 2·t4 (+1); s[n][2..3] row g+8
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(qw + g * RS + kk + 2 * t4);
      a[1] = ld32(qw + (g + 8) * RS + kk + 2 * t4);
      a[2] = ld32(qw + g * RS + kk + 2 * t4 + 8);
      a[3] = ld32(qw + (g + 8) * RS + kk + 2 * t4 + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = kt + (8 * n + g) * RS + kk + 2 * t4;
        mma_bf16(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * n + 2 * t4 + (e & 1);
        s[n][e] = mask_score(s[n][e] * scale, t, q_pos[e >> 1], Tk, causal,
                             window);
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // a row's 32 scores lie in the 4 threads of its fragment row
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(kFull, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(kFull, mt[rr], 2));
      const float m_new = fmaxf(m[rr], mt[rr]);
      alpha[rr] = expf(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * n + 2 * t4 + (e & 1);
        s[n][e] = t < Tk ? expf(s[n][e] - m[e >> 1]) : 0.f;  // p, fp32
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }
    // p·v: two score tiles of 8 keys make the A fragment of 16 keys; p is
    // rounded to bf16 here
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const bf16* v0 = vt + (16 * kc + 2 * t4) * RS + g;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const bf16* vp = v0 + 8 * j;
        mma_bf16(acc[j], a, pack_bf16(vp[0], vp[RS]),
                 pack_bf16(vp[8 * RS], vp[9 * RS]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
    l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
  }
  // the 4 threads of a fragment row hold its m and l alike
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int rb = wrow + g + 8 * rr;
      if (rb < nrows)
        lse[((long long)b * H + h) * S + row0 + rb] = m[rr] + logf(l[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int rb = wrow + g + 8 * rr;  // row within the block
    if (rb >= nrows) continue;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    bf16* orow = o + ((long long)b * S + row0 + rb) * q_seq +
                 (long long)h * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * rr] * inv,
                                acc[j][2 * rr + 1] * inv);
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

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int Tk, int H, int K, int causal,
               int window, cudaStream_t stream) {
  static unsigned long long opted = 0;
  constexpr long long smem = smem_bytes_f32(HD);
  const int rc = opt_in_once(flash_attention_kernel_f32<HD>, smem, &opted);
  if (rc) return rc;
  const dim3 grid(B * H, (S + kRowsF - 1) / kRowsF);
  flash_attention_kernel_f32<HD><<<grid, kThreadsF, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Tk, H,
      K, causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Tk, int H, int K, int causal,
                int window, cudaStream_t stream) {
  static unsigned long long opted = 0;
  constexpr long long smem = smem_bytes_bf16(HD);
  const int rc = opt_in_once(flash_attention_kernel_bf16<HD>, smem, &opted);
  if (rc) return rc;
  const dim3 grid(B * H, (S + kRowsB - 1) / kRowsB);
  using bf16 = __nv_bfloat16;
  flash_attention_kernel_bf16<HD><<<grid, kThreadsB, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, Tk, H, K,
      causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// q, k, v, o: device pointers, 16-byte aligned, to contiguous (B,S,H,hd) /
// (B,T,K,hd) / (B,T,K,hd) / (B,S,H,hd) arrays of fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); hd in {32, 64, 80, 128, 256}. lse: null, or a contiguous
// fp32 (B,H,S) array that receives each row's log-sum-exp of its scaled,
// masked scores (what the backward recomputes P from). Launches on `stream`
// and returns a CUDA error code (0 = launched).
int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int S, int Tk, int H, int K, int hd, int causal,
            int window, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || K <= 0 || H % K != 0 ||
      (long long)B * H > 2147483647LL || (S + kRowsF - 1) / kRowsF > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (hd) {
      case 32: return launch_bf16<32>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
      case 64: return launch_bf16<64>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
      case 80: return launch_bf16<80>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
      case 128: return launch_bf16<128>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
      case 256: return launch_bf16<256>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
    case 64: return launch_f32<64>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
    case 80: return launch_f32<80>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
    case 128: return launch_f32<128>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
    case 256: return launch_f32<256>(q, k, v, o, lse, B, S, Tk, H, K, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments of `forward` above packed in one int64 array (pointers and
// the stream as addresses): q, k, v, o, B, S, T, H, K, hd, causal, window,
// is_bf16, stream, lse. ctypes passes one pointer far more cheaply than
// fifteen converted arguments. lse = 0 (the serving path) writes nothing
// more than the output.
extern "C" int flash_attention_fwd(const long long* a) {
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  return forward(p(0), p(1), p(2), p(3), static_cast<float*>(p(14)),
                 (int)a[4], (int)a[5], (int)a[6], (int)a[7], (int)a[8],
                 (int)a[9], (int)a[10], (int)a[11], (int)a[12], p(13));
}
