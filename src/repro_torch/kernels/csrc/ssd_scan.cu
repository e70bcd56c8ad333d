// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The TPU kernel it replaces: src/repro/kernels/ssd_scan.py::ssd_scan
// (defined at :65, pallas_call at :82), a grid of (batch·head rows, chunks)
// whose chunk axis runs in order and carries the (n, p) state in VMEM. For
// x (b,s,h,p), dt (b,s,h) fp32, A (h,) fp32 and B, C (b,s,g,n), per (batch,
// head) and chunk of L positions, with cs the inclusive cumsum of dt·A over
// the chunk:
//
//   y_i   = Σ_{j≤i} (C_i·B_j) e^{cs_i − cs_j} dt_j x_j  +  e^{cs_i} C_i·state
//   state ← state·e^{cs_{L−1}} + Σ_j (B_j dt_j e^{cs_{L−1} − cs_j}) ⊗ x_j
//
// from a zero state; the final state is not returned. Head hi reads B/C
// group hi / (h/g) in place (the Pallas wrapper repeats B/C to every head).
// All arithmetic is fp32; x, B and C may be fp32 or bf16, and y is rounded
// once to x's dtype. A ragged last chunk (s % L != 0) is processed at its own
// length, which gives its rows the values zero-padding would. e^{cs_i − cs_j}
// is only formed for j ≤ i, where cs_i − cs_j ≤ 0, so it cannot overflow
// however large dt·|A| is.
//
// What bounds it on this card. At the serving shape (b,s,h,p,g,n,L) =
// (1,128,80,64,1,128,128) in fp32 the least work is C·Bᵀ over the 8,256
// pairs j ≤ i once per group (1.06 M multiply-adds) and scores·x per head
// (42.3 M), 86.7 MFLOP or 1.29 µs at 67 TFLOP/s, against 5,415,232 bytes or
// 1.62 µs at 3.35 TB/s: the bound is bytes. The first port ran one
// block of 8 warps per (b·h) row (80 blocks on 132 SMs), staged x and B in
// 32-64 serial rounds of scalar loads, formed C·Bᵀ once per head (80 times
// at g = 1), did two shared-memory loads per multiply-add and a one-thread
// cumsum: 70.4 µs of device time on an H100 80GB HBM3 at 700 W.
// This design splits one call into up to four kernels (the chunk-parallel
// form); the heavy one, kernel 4, runs 8 blocks per (b·h) at that shape:
//   1. ssd_scan_kernel_prep: C·Bᵀ once per (b, chunk, group), the lower
//      triangle in 16x16 tiles (36 blocks for a 128-chunk), stored
//      transposed in fp32 scratch and shared by the h/g heads of the group;
//      and, in further blocks, one warp per (b, chunk, head) for cs (below),
//      written with dt as contiguous rows so that the other kernels stage
//      them with 16-byte copies and run no chain of their own.
//   2. ssd_scan_kernel_states (only when s > L): each chunk's local state
//      Σ_j (B_j dt_j e^{cs_end − cs_j}) ⊗ x_j, every chunk but the last in
//      parallel, per (b·h, chunk, 32 state rows).
//   3. ssd_scan_kernel_pass (only when s > L): the short pass over chunks,
//      state_c = state_{c−1}·e^{cs_end} + local_c, one thread per state
//      element, loads issued 8 chunks ahead.
//   4. ssd_scan_kernel_out: per (b·h, chunk, 16-row tile), y = (C·Bᵀ ⊙
//      e^{cs_i − cs_j} ⊙ dt_j)·x + e^{cs_i} C·state_in: 640 blocks of 4
//      warps at the serving shape.
// Staging is 16-byte asynchronous copies (cp.async.cg; 8-byte cp.async.ca
// for bf16 rows of n % 8 = 4), issued all at once; only kernel 1 reads dt
// where it lies, strided by h, one 4-byte load per lane. The products are
// register-tiled on CUDA cores (fp32; no TF32): a thread of kernel 1 forms
// one C·Bᵀ entry, of kernel 2 two state rows by p/16 columns, of kernel 4
// four rows by p/16 columns of y from the transposed scores, with the two
// half-warps on alternate keys so that every lane of a 16-byte read gets
// distinct data. cs is one warp's chain in registers, left to right, each
// product dt·A and each sum rounded with no fused multiply-add: the plain
// version's cumsum order. The output sums run in another order than the
// plain version's (alternate keys per half-warp), so the results agree with
// it within fp32 1e-4, not bit for bit. The scratch (C·Bᵀ, cs, dt, chunk states, chunk
// decays) is allocated by the wrapper, one buffer.
// Measured (benchmarks/port/kernel_ab.py, parent and this design in turns on
// one H100 80GB HBM3 at 700 W, fp32, device time a call summed over its
// kernels): the serving shape 69.9 µs before, 12.6 now (3.1 in kernel 1, 9.7
// in kernel 4); (1,2048,16,64,2,128,128), 16 chunks, 1645 before, 117 now.
// ptxas (-v): kernel 1 48-56 registers, 2 53-64, 3 64, 4 64-122 (84 at
// p = 64 fp32), 0 bytes of spill in every instantiation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most a Hopper block may use
constexpr int kPrepThreads = 256; // kernel 1: 16x16 C·Bᵀ tile; 8 cs rows
constexpr int kCbTile = 16;       // rows and columns of a C·Bᵀ tile
constexpr int kStateThreads = 256;
constexpr int kStateRows = 32;    // state rows (of n) per block of kernel 2
constexpr int kPassThreads = 256;
constexpr int kOutThreads = 128;  // kernel 4: 4 warps of 4 rows each
constexpr int kTile = 16;         // rows of an output tile
constexpr int kTileStride = kTile + 4;  // its transposed scores' row stride
constexpr int kRowsPerWarp = kTile / (kOutThreads / 32);

// ---- asynchronous copies into shared memory ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// `rows` rows of `width` elements, global row stride gstride, into shared
// rows of stride sstride, by NT threads; rows at or past `valid` are
// zero-filled. 16-byte copies where every row start is 16-byte aligned,
// else 8-byte copies (bf16 rows of n % 8 = 4; the wrapper guarantees 8).
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int sstride, const T* src,
                                           long long gstride, int rows,
                                           int valid, int width, int tid) {
  const bool by16 =
      (width * sizeof(T)) % 16 == 0 && (sstride * sizeof(T)) % 16 == 0 &&
      (gstride * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0;
  if (by16) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = width / kVec;
    for (int idx = tid; idx < rows * per_row; idx += NT) {
      const int r = idx / per_row, c = (idx % per_row) * kVec;
      const bool ok = r < valid;
      cp_async16(dst + r * sstride + c, ok ? src + r * gstride + c : src, ok);
    }
  } else {
    constexpr int kVec = 8 / sizeof(T);
    const int per_row = width / kVec;
    for (int idx = tid; idx < rows * per_row; idx += NT) {
      const int r = idx / per_row, c = (idx % per_row) * kVec;
      const bool ok = r < valid;
      cp_async8(dst + r * sstride + c, ok ? src + r * gstride + c : src, ok);
    }
  }
}

// Four consecutive values of shared memory as fp32 (8- or 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// W consecutive values of shared memory as fp32, W in {1, 2, 4}
template <int W, typename T>
__device__ __forceinline__ void ld_run(const T* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = load4(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] = to_float(p[e]);
  }
}

// Elements of one row in shared memory: padded by 16 bytes against bank
// conflicts between the rows read together.
template <typename T>
__host__ __device__ constexpr int padded(int width) {
  return width + 16 / (int)sizeof(T);
}

// Columns of p per thread in the kernels that tile p over 16 threads: CP,
// in NR runs of W consecutive columns, 16·W apart.
template <int P>
struct Cols {
  static constexpr int CP = P / 16;
  static constexpr int W = CP < 4 ? CP : 4;
  static constexpr int NR = CP / W;
};

// ------- 1. C·Bᵀ once per (batch, chunk, group); cs and dt rows -------
//
// blockIdx.x = batch·nc + chunk. blockIdx.y < G·ntri: a 16x16 tile of the
// lower triangle of group y / ntri's C·Bᵀ, written transposed (cbT[j][i])
// so that kernel 4 reads a row tile's scores as contiguous rows of j. The
// other blocks: one warp per head, cs = the inclusive cumsum of dt·A over
// the chunk, run in registers by every lane of the warp, left to right with
// each product and sum rounded (no fused multiply-add), the plain cumsum's
// order; cs and dt are written as contiguous rows (b, nc, h, L).

template <typename T>
__global__ void __launch_bounds__(kPrepThreads, 1)
ssd_scan_kernel_prep(const T* __restrict__ Cm, const T* __restrict__ Bm,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     float* __restrict__ cbT, float* __restrict__ cs_out,
                     float* __restrict__ dt_out, int S, int H, int G, int N,
                     int L, int nc) {
  const int bc = blockIdx.x, c = bc % nc, b = bc / nc;
  const int s0 = c * L, Lc = min(L, S - s0);
  const int nq = (L + kCbTile - 1) / kCbTile, ntri = nq * (nq + 1) / 2;
  const int tid = threadIdx.x, lane = tid & 31;
  extern __shared__ float4 smem4[];

  if ((int)blockIdx.y >= G * ntri) {  // cs and dt rows, one warp a head
    const int h = ((int)blockIdx.y - G * ntri) * (kPrepThreads / 32) +
                  (tid >> 5);
    if (h >= H) return;
    float* da_s = reinterpret_cast<float*>(smem4) + (tid >> 5) * L;
    const float a = A[h];
    const long long pos0 = (long long)b * S + s0;
    float* dt_row = dt_out + ((long long)bc * H + h) * L;
    float* cs_row = cs_out + ((long long)bc * H + h) * L;
    for (int r = lane; r < Lc; r += 32) {
      const float d = dt[(pos0 + r) * H + h];
      dt_row[r] = d;
      da_s[r] = __fmul_rn(d, a);
    }
    __syncwarp();
    float run = 0.f;
    int r = 0;
#pragma unroll 4
    for (; r + 4 <= Lc; r += 4) {
      const float4 d = *reinterpret_cast<const float4*>(da_s + r);
      const float c0 = __fadd_rn(run, d.x), c1 = __fadd_rn(c0, d.y);
      const float c2 = __fadd_rn(c1, d.z), c3 = __fadd_rn(c2, d.w);
      if (lane == ((r >> 2) & 31))
        *reinterpret_cast<float4*>(cs_row + r) = make_float4(c0, c1, c2, c3);
      run = c3;
    }
    for (; r < Lc; ++r) {
      run = __fadd_rn(run, da_s[r]);
      if (lane == 0) cs_row[r] = run;
    }
    return;
  }

  const int g = blockIdx.y / ntri;
  int ti = 0, tj = blockIdx.y % ntri;  // the tile (ti, tj), tj <= ti
  while (tj > ti) tj -= ++ti;
  const int i0 = ti * kCbTile, j0 = tj * kCbTile;
  if (i0 >= Lc) return;  // rows past a ragged last chunk

  const int ss = padded<T>(N);
  T* c_s = reinterpret_cast<T*>(smem4);  // [kCbTile][ss]
  T* b_s = c_s + kCbTile * ss;           // [kCbTile][ss]
  const long long gs = (long long)G * N;
  const long long base = ((long long)b * S + s0) * gs + (long long)g * N;
  stage_rows<kPrepThreads>(c_s, ss, Cm + base + i0 * gs, gs, kCbTile,
                           Lc - i0, N, tid);
  stage_rows<kPrepThreads>(b_s, ss, Bm + base + j0 * gs, gs, kCbTile,
                           Lc - j0, N, tid);
  cp_async_wait_all();
  __syncthreads();

  // entry (i0 + ri, j0 + cj), neighbouring threads on neighbouring i (the
  // transposed store is then contiguous): one chain over n in order
  const int ri = tid & 15, cj = tid >> 4;
  const T* cp = c_s + ri * ss;
  const T* bp = b_s + cj * ss;
  float dot = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; n += 4) {
    const float4 c4 = load4(cp + n), b4 = load4(bp + n);
    dot = fmaf(c4.x, b4.x, dot);
    dot = fmaf(c4.y, b4.y, dot);
    dot = fmaf(c4.z, b4.z, dot);
    dot = fmaf(c4.w, b4.w, dot);
  }
  const int i = i0 + ri, j = j0 + cj;
  if (i < Lc && j <= i)
    cbT[((long long)bc * G + g) * L * L + (long long)j * L + i] = dot;
}

// ------- 2. each chunk's local state, all chunks but the last -------

template <typename T, int P>
__global__ void __launch_bounds__(kStateThreads, 1)
ssd_scan_kernel_states(const T* __restrict__ x, const T* __restrict__ Bm,
                       const float* __restrict__ cs_in,
                       const float* __restrict__ dt_in,
                       float* __restrict__ st, float* __restrict__ decay,
                       int S, int H, int G, int N, int L, int nc) {
  using Cl = Cols<P>;
  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const int c = blockIdx.y, nc1 = gridDim.y;  // chunks 0 .. nc - 2, all full
  const int n0 = blockIdx.z * kStateRows, nn = min(kStateRows, N - n0);
  const int tid = threadIdx.x;
  const long long pos0 = (long long)b * S + (long long)c * L;
  const long long row = ((long long)b * nc + c) * H + h;

  extern __shared__ float4 smem4[];
  float* cs_s = reinterpret_cast<float*>(smem4);  // [L]
  float* w_s = cs_s + L;                           // [L]: dt, then weights
  T* x_s = reinterpret_cast<T*>(w_s + L);          // [L][P]
  T* b_s = x_s + L * P;                            // [L][kStateRows]

  stage_rows<kStateThreads>(cs_s, L, cs_in + row * L, L, 1, 1, L, tid);
  stage_rows<kStateThreads>(w_s, L, dt_in + row * L, L, 1, 1, L, tid);
  stage_rows<kStateThreads>(x_s, P, x + (pos0 * H + h) * P, (long long)H * P,
                            L, L, P, tid);
  stage_rows<kStateThreads>(b_s, kStateRows, Bm + (pos0 * G + g) * N + n0,
                            (long long)G * N, L, L, nn, tid);
  cp_async_wait_all();
  __syncthreads();
  const float cs_end = cs_s[L - 1];
  for (int r = tid; r < L; r += kStateThreads)
    w_s[r] = w_s[r] * expf(cs_end - cs_s[r]);
  if (blockIdx.z == 0 && tid == 0)
    decay[((long long)b * nc1 + c) * H + h] = expf(cs_end);
  __syncthreads();

  const int rn = tid >> 4, cq = tid & 15;  // state rows rn, rn+16
  float acc[2][Cl::NR][Cl::W];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q)
#pragma unroll
      for (int e = 0; e < Cl::W; ++e) acc[a][q][e] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float wj = w_s[j];
    const float b0 = to_float(b_s[j * kStateRows + rn]);
    const float b1 = to_float(b_s[j * kStateRows + rn + 16]);
    const T* xr = x_s + j * P + Cl::W * cq;
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q) {
      float xv[Cl::W];
      ld_run<Cl::W>(xr + 16 * Cl::W * q, xv);
#pragma unroll
      for (int e = 0; e < Cl::W; ++e) {
        const float xw = xv[e] * wj;
        acc[0][q][e] = fmaf(b0, xw, acc[0][q][e]);
        acc[1][q][e] = fmaf(b1, xw, acc[1][q][e]);
      }
    }
  }
  float* out = st + (((long long)b * nc1 + c) * H + h) * N * P;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int n = rn + 16 * a;
    if (n >= nn) continue;
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q)
#pragma unroll
      for (int e = 0; e < Cl::W; ++e)
        out[(long long)(n0 + n) * P + Cl::W * cq + 16 * Cl::W * q + e] =
            acc[a][q][e];
  }
}

// ------- 3. the pass over chunks: state entering each chunk -------

__global__ void __launch_bounds__(kPassThreads)
ssd_scan_kernel_pass(float* __restrict__ st, const float* __restrict__ decay,
                     int batch, int H, int NP, int nc1) {
  const long long idx = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= (long long)batch * H * NP) return;
  const int e = idx % NP;
  const int h = (idx / NP) % H;
  const int b = idx / ((long long)NP * H);
  constexpr int kAhead = 8;  // loads in flight before the chain uses them
  float run = 0.f;
  for (int c0 = 0; c0 < nc1; c0 += kAhead) {
    float loc[kAhead], dec[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long bc = (long long)b * nc1 + c0 + i;
      if (c0 + i < nc1) {
        loc[i] = st[(bc * H + h) * NP + e];
        dec[i] = decay[bc * H + h];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc1) {
        run = run * dec[i] + loc[i];
        st[(((long long)b * nc1 + c0 + i) * H + h) * NP + e] = run;
      }
    }
  }
}

// ------- 4. outputs per (batch·head, chunk, 32-row tile) -------

template <typename T, int P>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_scan_kernel_out(const T* __restrict__ x, const T* __restrict__ Cm,
                    const float* __restrict__ cbT,
                    const float* __restrict__ cs_in,
                    const float* __restrict__ dt_in,
                    const float* __restrict__ st, T* __restrict__ y, int S,
                    int H, int G, int N, int L) {
  using Cl = Cols<P>;
  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const int c = blockIdx.y, nc = gridDim.y;
  const int s0 = c * L, Lc = min(L, S - s0);
  const int i0 = blockIdx.z * kTile;
  if (i0 >= Lc) return;
  const int ni = min(kTile, Lc - i0);  // rows of this tile
  const int nj = i0 + ni;              // keys 0 .. nj - 1 reach them
  const int nj4 = (nj + 3) & ~3;       // ... rounded up to float4 reads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long pos0 = (long long)b * S + s0;
  const long long row = ((long long)b * nc + c) * H + h;
  const int cstride = padded<T>(N);

  extern __shared__ float4 smem4[];
  float* sc_s = reinterpret_cast<float*>(smem4);  // [L][kTileStride]: sᵀ
  float* cs_s = sc_s + L * kTileStride;            // [L]
  float* dt_s = cs_s + L;                          // [L]
  float* st_s = dt_s + L;                          // [N][P] if nc > 1
  T* x_s = reinterpret_cast<T*>(st_s + (nc > 1 ? N * P : 0));  // [L][P]
  T* c_s = x_s + L * P;                            // [kTile][N + pad]

  // C·Bᵀ transposed, keys 0 .. nj4 - 1 by rows i0 .. (entries past the
  // diagonal and past the chunk are never written; zeroed below)
  const float* cbg = cbT + (((long long)b * nc + c) * G + g) * L * L;
  stage_rows<kOutThreads>(sc_s, kTileStride, cbg + i0, L, nj4, nj4,
                          min(kTile, L - i0), tid);
  stage_rows<kOutThreads>(cs_s, L, cs_in + row * L, L, 1, 1, nj4, tid);
  stage_rows<kOutThreads>(dt_s, L, dt_in + row * L, L, 1, 1, nj4, tid);
  stage_rows<kOutThreads>(x_s, P, x + (pos0 * H + h) * P, (long long)H * P,
                          nj4, nj, P, tid);  // rows past nj: zeros
  if (c > 0) {
    const long long gs = (long long)G * N;
    stage_rows<kOutThreads>(c_s, cstride, Cm + (pos0 + i0) * gs +
                            (long long)g * N, gs, kTile, ni, N, tid);
    stage_rows<kOutThreads>(st_s, P, st + (((long long)b * (nc - 1) + c - 1)
                            * H + h) * N * P, P, N, N, P, tid);
  }
  cp_async_wait_all();
  __syncthreads();

  // scores sᵀ[j][ii] = (C_i·B_j) e^{cs_i − cs_j} dt_j for j <= i, else 0;
  // one thread per (key, row), kOutThreads / kTile keys at a time
  {
    const int ii = tid % kTile, i = i0 + ii;
    const bool row_ok = ii < ni;
    const float cs_i = row_ok ? cs_s[i] : 0.f;
    for (int j = tid / kTile; j < nj4; j += kOutThreads / kTile) {
      float v = 0.f;
      if (row_ok && j <= i)
        v = sc_s[j * kTileStride + ii] * expf(cs_i - cs_s[j]) * dt_s[j];
      sc_s[j * kTileStride + ii] = v;
    }
  }
  __syncthreads();

  // y rows R·warp .. R·warp + R - 1 of the tile (R = 4), columns
  // Cl::W·cq + 16·Cl::W·q. The two half-warps take the even and the odd
  // keys (summed at the end), so each 16-byte read serves distinct data to
  // every lane: per key, one read of sᵀ and NR of x feed 4·CP FMAs.
  constexpr int R = kRowsPerWarp;
  const int half = lane >> 4, cq = lane & 15;
  float acc[R][Cl::NR][Cl::W], off[R][Cl::NR][Cl::W];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q)
#pragma unroll
      for (int e = 0; e < Cl::W; ++e) acc[a][q][e] = off[a][q][e] = 0.f;
#pragma unroll 2
  for (int j = half; j < nj4; j += 2) {  // past the diagonal the scores are 0
    float sv[R];
#pragma unroll
    for (int a = 0; a < R; a += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          sc_s + j * kTileStride + R * warp + a);
      sv[a] = s4.x; sv[a + 1] = s4.y; sv[a + 2] = s4.z; sv[a + 3] = s4.w;
    }
    const T* xr = x_s + j * P + Cl::W * cq;
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q) {
      float xv[Cl::W];
      ld_run<Cl::W>(xr + 16 * Cl::W * q, xv);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int e = 0; e < Cl::W; ++e)
          acc[a][q][e] = fmaf(sv[a], xv[e], acc[a][q][e]);
    }
  }
  if (c > 0) {  // C_i·state: the half-warps take alternate n
    const T* cr = c_s + R * warp * cstride;
    for (int n = half; n < N; n += 2) {
      const float* sr = st_s + n * P + Cl::W * cq;
#pragma unroll
      for (int q = 0; q < Cl::NR; ++q) {
        float sv[Cl::W];
        ld_run<Cl::W>(sr + 16 * Cl::W * q, sv);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float ck = to_float(cr[a * cstride + n]);
#pragma unroll
          for (int e = 0; e < Cl::W; ++e)
            off[a][q][e] = fmaf(ck, sv[e], off[a][q][e]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q)
#pragma unroll
      for (int e = 0; e < Cl::W; ++e) {
        acc[a][q][e] += __shfl_down_sync(0xffffffffu, acc[a][q][e], 16);
        off[a][q][e] += __shfl_down_sync(0xffffffffu, off[a][q][e], 16);
      }
  if (half) return;  // the low half-warp holds the sums
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int ii = R * warp + a;
    if (ii >= ni) continue;
    const float e_i = expf(cs_s[i0 + ii]);
    T* yrow = y + ((pos0 + i0 + ii) * H + h) * P + Cl::W * cq;
#pragma unroll
    for (int q = 0; q < Cl::NR; ++q)
#pragma unroll
      for (int e = 0; e < Cl::W; ++e)
        store(&yrow[16 * Cl::W * q + e], acc[a][q][e] + e_i * off[a][q][e]);
  }
}

// ---------------- host side ----------------

// Dynamic shared memory of each kernel, as laid out above (bytes).
inline long long smem_prep(int N, int L, int esize) {
  const long long tile = 2LL * kCbTile * (N * esize + 16);
  const long long rows = 4LL * (kPrepThreads / 32) * L;
  return tile > rows ? tile : rows;
}
inline long long smem_states(int P, int L, int esize) {
  return 4LL * 2 * L + (long long)L * P * esize +
         (long long)L * kStateRows * esize;
}
inline long long smem_out(int P, int N, int L, int esize, bool carried) {
  long long bytes = 4LL * L * kTileStride + 4LL * 2 * L +
                    (long long)L * P * esize;
  if (carried) bytes += 4LL * N * P + (long long)kTile * (N * esize + 16);
  return bytes;
}

// Lets the kernel take up to 227 KB of dynamic shared memory (past 48 KB
// only on request), once per kernel and device rather than on every launch.
template <typename Kernel>
int opt_in_once(Kernel kernel, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  *done |= bit;
  return 0;
}

struct Scratch {
  float* cbT;    // (b, nc, g, L, L), C·Bᵀ transposed, lower triangle
  float* cs;     // (b, nc, h, L)
  float* dt;     // (b, nc, h, L)
  float* st;     // (b, nc - 1, h, n, p)
  float* decay;  // (b, nc - 1, h)
};

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, const Scratch& w, int batch, int S,
           int H, int G, int N, int L, cudaStream_t stream) {
  static unsigned long long opted[3] = {0, 0, 0};
  const int esize = sizeof(T);
  const int nc = (S + L - 1) / L;
  const int nq = (L + kCbTile - 1) / kCbTile;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  int rc;

  const long long s1 = smem_prep(N, L, esize);
  if ((rc = opt_in_once(ssd_scan_kernel_prep<T>, &opted[0]))) return rc;
  const int prep_y = G * nq * (nq + 1) / 2 +
                     (H + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  ssd_scan_kernel_prep<T><<<dim3(batch * nc, prep_y), kPrepThreads, s1,
                            stream>>>(ct, bt, dt, A, w.cbT, w.cs, w.dt, S, H,
                                      G, N, L, nc);
  if ((rc = (int)cudaGetLastError())) return rc;

  if (nc > 1) {
    const long long s2 = smem_states(P, L, esize);
    if ((rc = opt_in_once(ssd_scan_kernel_states<T, P>, &opted[1])))
      return rc;
    ssd_scan_kernel_states<T, P>
        <<<dim3(batch * H, nc - 1, (N + kStateRows - 1) / kStateRows),
           kStateThreads, s2, stream>>>(xt, bt, w.cs, w.dt, w.st, w.decay, S,
                                        H, G, N, L, nc);
    if ((rc = (int)cudaGetLastError())) return rc;
    const long long total = (long long)batch * H * N * P;
    ssd_scan_kernel_pass<<<(unsigned)((total + kPassThreads - 1) /
                                      kPassThreads),
                           kPassThreads, 0, stream>>>(w.st, w.decay, batch, H,
                                                      N * P, nc - 1);
    if ((rc = (int)cudaGetLastError())) return rc;
  }

  const long long s4 = smem_out(P, N, L, esize, nc > 1);
  if ((rc = opt_in_once(ssd_scan_kernel_out<T, P>, &opted[2]))) return rc;
  ssd_scan_kernel_out<T, P>
      <<<dim3(batch * H, nc, (L + kTile - 1) / kTile), kOutThreads, s4,
         stream>>>(xt, ct, w.cbT, w.cs, w.dt, w.st, static_cast<T*>(y), S, H,
                   G, N, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_p(const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, void* y, const Scratch& w,
               int batch, int S, int H, int P, int G, int N, int L,
               cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, w, batch, S, H, G, N, L,
                           stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, w, batch, S, H, G, N, L,
                           stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, w, batch, S, H, G, N, L,
                           stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, w, batch, S, H, G, N, L,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory the largest of one call's kernels needs.
long long smem_bytes(int P, int N, int L, int esize, int chunks) {
  long long m = smem_prep(N, L, esize);
  if (chunks > 1 && smem_states(P, L, esize) > m) m = smem_states(P, L, esize);
  const long long o = smem_out(P, N, L, esize, chunks > 1);
  return m > o ? m : o;
}

// x, y: contiguous (b,s,h,p); dt: (b,s,h) fp32; A: (h,) fp32; Bm, Cm:
// contiguous (b,s,g,n); x, Bm, Cm, y fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1), all 16-byte aligned. Scratch, fp32 and 16-byte aligned, nc =
// ceil(s / L): cbT (b, nc, g, L, L); cs and dts (b, nc, h, L); st (b, nc - 1,
// h, n, p) and decay (b, nc - 1, h), unused when nc is 1. Launches on
// `stream` and returns a CUDA error code (0 = launched).
int forward(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, void* y, void* cbT, void* cs, void* dts,
            void* st, void* decay, int batch, int S, int H, int P, int G,
            int N, int L, int is_bf16, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  const int nc = L > 0 ? (S + L - 1) / L : 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(Bm) |
                        reinterpret_cast<uintptr_t>(Cm) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(cbT) |
                        reinterpret_cast<uintptr_t>(cs) |
                        reinterpret_cast<uintptr_t>(dts) |
                        reinterpret_cast<uintptr_t>(st) |
                        reinterpret_cast<uintptr_t>(decay);
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      N % 4 != 0 || L <= 0 || L % 4 != 0 || nc > 65535 ||
      (long long)batch * H > 2147483647LL ||
      (long long)batch * nc > 2147483647LL ||
      smem_bytes(P, N, L, esize, nc) > kMaxSmem || (any & 15))
    return (int)cudaErrorInvalidValue;
  const Scratch w{static_cast<float*>(cbT), static_cast<float*>(cs),
                  static_cast<float*>(dts), static_cast<float*>(st),
                  static_cast<float*>(decay)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, w, batch, S, H, P,
                                     G, N, L, s);
  return dispatch_p<float>(x, dtf, Af, Bm, Cm, y, w, batch, S, H, P, G, N, L,
                           s);
}

}  // namespace

// Bytes of dynamic shared memory the largest of one call's kernels needs
// (the wrapper's sizing is tested against it).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int L, int esize,
                                         int chunks) {
  return smem_bytes(P, N, L, esize, chunks);
}

// The arguments of `forward` above packed in one int64 array, in its order
// (pointers and the stream as addresses): ctypes passes one pointer far
// more cheaply than twenty converted arguments.
extern "C" int ssd_scan_fwd(const long long* a) {
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  return forward(p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9),
                 p(10), (int)a[11], (int)a[12], (int)a[13], (int)a[14],
                 (int)a[15], (int)a[16], (int)a[17], (int)a[18], p(19));
}
