// RG-LRU for Hopper (sm_90a): the linear-recurrence scan, and the whole
// RG-LRU of a recurrent layer (gates, scan and GeLU gating) in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (pallas_call at :48), h_t = a_t * h_{t-1} + b_t along the sequence from a
// zero state, elementwise over W channels, for fp32 a, b of shape (B, S, W);
// and, fused around it, the jnp gate math of src/repro/models/rglru.py
// (_gates at :58, the gelu gating of rglru_forward) that XLA fuses into one
// pass on the TPU but eager PyTorch runs as ~15 launches a layer. One
// templated kernel body (rglru_body), instantiated as two kernels under
// names of their own, so that a profiler trace tells them apart:
//
//   rglru_scan_kernel (rglru_scan_fwd)
//                         a, b -> h (B, S, W) fp32: the TPU kernel's contract.
//   rglru_gated_scan_kernel (rglru_gated_scan_fwd)
//                         r_pre = xc·Wr, i_pre = xc·Wi, xc, gate_pre = x·Wgate
//                         (fp32 or bf16, (B, S, W)), lam (W) fp32 and an
//                         optional fp32 state h0 (B, W) ->
//                           a = exp(-8·softplus(lam)·sigmoid(r_pre))
//                           b = sqrt(clamp(1 - a·a, 1e-12))·sigmoid(i_pre)·xc
//                           h = the scan of (a, b) from h0 (or zero)
//                           y = T(h)·T(gelu_tanh(gate_pre))   (T: the inputs'
//                               dtype, each product rounded to it, as torch)
//                         writing y (B, S, W) in the inputs' dtype and the
//                         final state h[:, S-1] fp32 to a (B, W) buffer, which
//                         may be h0 itself (each thread reads its h0 before
//                         any thread of its block writes). h is never stored.
//                         Arithmetic is fp32 throughout, in the order of
//                         torch's formulas (softplus with threshold 20, gelu
//                         with tanh) and of the port's _gates (a·a, then 1 -,
//                         then clamp, then sqrt), each step rounded.
//
// What bounds it on this card: bytes. Each input element is read once and
// each output written once, against ~2 flops per element (the scan) or ~30
// (the gated form, at most a few % of 67 TFLOP/s). At the serving shape (1,
// 32, 4096) that is 1.57 MB (0.47 µs at 3.35 TB/s) for the scan and 2.65 MB
// (0.79 µs) for the gated form: far below a launch, so latency, the number
// of launches and the spread of the work over the card decide the time.
// The first port ran one thread per channel over all of S (16 blocks of 256
// threads at (1, 32, 4096) on a 132-SM card, one dependent chain of S
// multiply-adds each): 2.78 µs there. This design:
//   - splits S into chunks of L steps as well as W into groups of VEC
//     channels. A warp holds G channel groups by 32/G chunks (lanes g, g+G,
//     ... take the successive chunks of group g); the NW warps of a block
//     take successive runs of chunks; a block covers G·VEC channels and
//     NW·(32/G)·L steps at a time (a tile), and walks over S tile by tile,
//     carrying the state in a register. At (1, 32, 4096): L = 1, G = 4,
//     VEC = 4, NW = 4: 256 blocks of 128 threads, one step each. At (8, 1,
//     4096), the decode: G = 32, 256 blocks of one warp. The host picks the
//     layout (kernels/rglru_scan.py::launch_layout);
//   - each thread scans its chunk from zero with the plain loop's rounded
//     multiply then add (__fmul_rn, __fadd_rn: no fused multiply-add),
//     keeping the chunk's product of a: the pair (A, B) with h_end = A·h_in
//     + B. The pairs combine by the associative operator (A1, B1)∘(A2, B2)
//     = (A1·A2, B1·A2 + B2): across the chunks of a warp by shuffles
//     (Kogge-Stone, log2(32/G) rounds), across warps through shared memory
//     (double-buffered by tile, one barrier a tile), from the state carried
//     into the tile. Each thread then runs its chunk's steps again from its
//     carry-in, with the a and b it kept in registers: the same values as
//     adding (∏ a up to t)·carry to the chunk's local h, in the plain loop's
//     own rounding within the chunk;
//   - loads and stores are 16 bytes a thread for fp32 (8 for bf16) when W
//     and the pointers allow (VEC = 4), else 8 or 4; G lanes of a warp read
//     G·VEC neighbouring channels of one step. Ragged S and W are masked:
//     a step past S is the identity (a = 1, b = 0), a group past W does no
//     memory access. The gated form reads all four inputs of its chunk in
//     one round, so a tile waits on one memory latency.
// The carries reorder the products and sums, so the scan no longer equals
// the plain loop bit for bit: it agrees with it within fp32 1e-4 (absolute
// plus relative), the tolerance every kernel of the port is held to.
// Measured (benchmarks/port/kernel_ab.py, the one-thread-a-channel design
// and this one in turns on one H100 80GB HBM3 at 700 W, fp32, device time
// a call): scan (1, 32, 4096) 1.91-2.56 µs before, 2.24-2.26 now, both at
// the cost of a small launch; (1, 2048, 4096) 223-228 before, 41.6-42.1
// now. The fused form 3.90-3.93 µs at (1, 32, 4096) and 2.98-3.00 at (8,
// 1, 4096), where the unfused torch sequence (gates, scan, gating) took
// 22.7-22.8 and 21.0-21.1 over 15 and 16 kernels. ptxas (-v): 32-162
// registers, 0 bytes of spill in every instantiation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kMaxTile = 128;  // channels of a block: G·VEC <= 32·4

struct Params {
  // scan: in0 = a, in1 = b (fp32), out = h (fp32).
  // gated: in0 = r_pre, in1 = i_pre, in2 = xc, in3 = gate_pre (T), lam (W)
  // fp32, h0 (B, W) fp32 or null, out = y (T), h_last (B, W) fp32.
  const void* in0;
  const void* in1;
  const void* in2;
  const void* in3;
  const float* lam;
  const float* h0;   // may alias h_last: never read through __ldg
  void* out;
  float* h_last;
  int S, W, log_g, nw;
};

// VEC neighbouring values of T at p (aligned to VEC elements), as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else if constexpr (VEC == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      o[0] = v.x; o[1] = v.y;
    } else {
      o[0] = __ldg(p);
    }
  } else {
    if constexpr (VEC == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
    } else if constexpr (VEC == 2) {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u));
      o[0] = f.x; o[1] = f.y;
    } else {
      o[0] = __bfloat162float(__ushort_as_bfloat16(
          __ldg(reinterpret_cast<const unsigned short*>(p))));
    }
  }
}

// store VEC floats at p as T (each rounded to nearest even)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  } else {
    if constexpr (VEC == 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      *p = __float2bfloat16(v[0]);
    }
  }
}

// x rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

// torch's formulas for fp32 (ATen's CUDA kernels): sigmoid 1/(1+e^-x);
// softplus with beta 1 and threshold 20; gelu with tanh
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2/pi)
  constexpr float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

// The one kernel body; the two __global__ entries below instantiate it
// under their own names, so that a profiler trace tells them apart.
template <typename T, int VEC, int L, bool GATED>
__device__ __forceinline__ void rglru_body(const Params& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 1 << p.log_g;
  const int CL = 32 >> p.log_g;          // chunks a warp holds
  const int g = lane & (G - 1), cl = lane >> p.log_g;
  const int S = p.S, W = p.W, NW = p.nw;
  const int b = blockIdx.y;
  const int ch = (blockIdx.x * G + g) * VEC;   // this thread's first channel
  const bool live = ch < W;                    // W % VEC == 0
  const long long row0 = (long long)b * S;     // row of (b, t = 0)
  const int chunk = warp * CL + cl;            // this thread's chunk in a tile
  const int tile = NW * CL * L;                // steps of a tile

  __shared__ float2 totals[2][kMaxWarps][kMaxTile];

  float h_run[VEC];   // the state entering the tile
  float coef[VEC];    // gated: -8·softplus(lam)
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    h_run[v] = 0.f;
    coef[v] = 0.f;
    if constexpr (GATED) {
      if (live) {
        if (p.h0 != nullptr) h_run[v] = p.h0[(long long)b * W + ch + v];
        coef[v] = __fmul_rn(-8.f, softplus(__ldg(p.lam + ch + v)));
      }
    }
  }

  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += tile, buf ^= 1) {
    const int tc = t0 + chunk * L;             // this chunk's first step
    float av[L][VEC], bv[L][VEC], gv[L][VEC];
    // 1) load the chunk (all of it in one round) and form a, b
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int t = tc + j;
      if (live && t < S) {
        const long long off = (row0 + t) * W + ch;
        if constexpr (GATED) {
          float r[VEC], i[VEC], x[VEC];
          load_vec<T, VEC>(static_cast<const T*>(p.in0) + off, r);
          load_vec<T, VEC>(static_cast<const T*>(p.in1) + off, i);
          load_vec<T, VEC>(static_cast<const T*>(p.in2) + off, x);
          load_vec<T, VEC>(static_cast<const T*>(p.in3) + off, gv[j]);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float a = expf(__fmul_rn(coef[v], sigmoid(r[v])));
            const float keep = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)),
                                           1e-12f));
            av[j][v] = a;
            bv[j][v] = __fmul_rn(keep, __fmul_rn(sigmoid(i[v]), x[v]));
          }
        } else {
          load_vec<float, VEC>(static_cast<const float*>(p.in0) + off, av[j]);
          load_vec<float, VEC>(static_cast<const float*>(p.in1) + off, bv[j]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          av[j][v] = 1.f;
          bv[j][v] = 0.f;
          gv[j][v] = 0.f;
        }
      }
    }
    // 2) the chunk from zero: h_end = A·h_in + B
    float A[VEC], Bs[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      A[v] = 1.f;
      Bs[v] = 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        Bs[v] = __fadd_rn(__fmul_rn(av[j][v], Bs[v]), bv[j][v]);
        A[v] = __fmul_rn(A[v], av[j][v]);
      }
    }
    // 3) inclusive scan over the warp's chunks of each channel group
    for (int d = 1; d < CL; d <<= 1) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float pa = __shfl_up_sync(kFull, A[v], d * G);
        const float pb = __shfl_up_sync(kFull, Bs[v], d * G);
        if (cl >= d) {
          Bs[v] = __fadd_rn(__fmul_rn(pb, A[v]), Bs[v]);
          A[v] = __fmul_rn(pa, A[v]);
        }
      }
    }
    float ea[VEC], eb[VEC];   // the chunks before this one in the warp
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (cl == CL - 1) totals[buf][warp][g * VEC + v] = make_float2(A[v], Bs[v]);
      ea[v] = __shfl_up_sync(kFull, A[v], G);
      eb[v] = __shfl_up_sync(kFull, Bs[v], G);
      if (cl == 0) {
        ea[v] = 1.f;
        eb[v] = 0.f;
      }
    }
    __syncthreads();
    // 4) the state entering this warp's chunks, then this chunk, and the
    // state leaving the tile, from the warps' totals in order
    float h[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float hw = h_run[v], h_warp = h_run[v];
      for (int w = 0; w < NW; ++w) {
        if (w == warp) h_warp = hw;
        const float2 tw = totals[buf][w][g * VEC + v];
        hw = __fadd_rn(__fmul_rn(tw.x, hw), tw.y);
      }
      h[v] = __fadd_rn(__fmul_rn(ea[v], h_warp), eb[v]);
      h_run[v] = hw;
    }
    // 5) the chunk's steps again from its carry-in, and the outputs
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int t = tc + j;
      if (live && t < S) {
        const long long off = (row0 + t) * W + ch;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          h[v] = __fadd_rn(__fmul_rn(av[j][v], h[v]), bv[j][v]);
        if constexpr (GATED) {
          float y[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            y[v] = __fmul_rn(round_to<T>(h[v]), round_to<T>(gelu_tanh(gv[j][v])));
          store_vec<T, VEC>(static_cast<T*>(p.out) + off, y);
          if (t == S - 1) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              p.h_last[(long long)b * W + ch + v] = h[v];
          }
        } else {
          store_vec<float, VEC>(static_cast<float*>(p.out) + off, h);
        }
      }
    }
  }
}

template <int VEC, int L>
__global__ void __launch_bounds__(32 * kMaxWarps)
rglru_scan_kernel(const Params p) {
  rglru_body<float, VEC, L, false>(p);
}

template <typename T, int VEC, int L>
__global__ void __launch_bounds__(32 * kMaxWarps)
rglru_gated_scan_kernel(const Params p) {
  rglru_body<T, VEC, L, true>(p);
}

template <typename T, int VEC, int L, bool GATED>
void launch_one(const Params& p, dim3 grid, int threads, cudaStream_t stream) {
  if constexpr (GATED)
    rglru_gated_scan_kernel<T, VEC, L><<<grid, threads, 0, stream>>>(p);
  else
    rglru_scan_kernel<VEC, L><<<grid, threads, 0, stream>>>(p);
}

template <typename T, bool GATED>
int launch(const Params& p, int B, int vec, int L, cudaStream_t stream) {
  const long long G = 1 << p.log_g;
  const long long blocks_x = (p.W + G * vec - 1) / (G * vec);
  if (blocks_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, B);
  const int threads = 32 * p.nw;
  if (L == 1) {
    if (vec == 4) launch_one<T, 4, 1, GATED>(p, grid, threads, stream);
    else if (vec == 2) launch_one<T, 2, 1, GATED>(p, grid, threads, stream);
    else launch_one<T, 1, 1, GATED>(p, grid, threads, stream);
  } else {
    if (vec == 4) launch_one<T, 4, 8, GATED>(p, grid, threads, stream);
    else if (vec == 2) launch_one<T, 2, 8, GATED>(p, grid, threads, stream);
    else launch_one<T, 1, 8, GATED>(p, grid, threads, stream);
  }
  return (int)cudaGetLastError();
}

// the layout's limits (kernels/rglru_scan.py::launch_layout keeps inside them)
bool valid(int B, int S, int W, int vec, int L, int log_g, int nw) {
  return B > 0 && B <= 65535 && S > 0 && W > 0 &&
         (vec == 1 || vec == 2 || vec == 4) && W % vec == 0 &&
         (L == 1 || L == 8) && log_g >= 0 && log_g <= 5 &&
         (1 << log_g) * vec <= kMaxTile && nw >= 1 && nw <= kMaxWarps;
}

}  // namespace

// Arguments packed as int64s (one ctypes argument):
//   a, b, h, B, S, W, vec, L, log2(G), NW, stream.
// Returns a CUDA error code (0 = launched).
extern "C" int rglru_scan_fwd(const long long* a) {
  const int B = (int)a[3], S = (int)a[4], W = (int)a[5], vec = (int)a[6],
            L = (int)a[7], log_g = (int)a[8], nw = (int)a[9];
  if (!valid(B, S, W, vec, L, log_g, nw)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.in0 = reinterpret_cast<const void*>(a[0]);
  p.in1 = reinterpret_cast<const void*>(a[1]);
  p.out = reinterpret_cast<void*>(a[2]);
  p.S = S; p.W = W; p.log_g = log_g; p.nw = nw;
  return launch<float, false>(p, B, vec, L,
                              reinterpret_cast<cudaStream_t>(a[10]));
}

// Arguments packed as int64s:
//   r_pre, i_pre, xc, gate_pre, lam, h0 (0: none), y, h_last, B, S, W,
//   bf16 (0/1), vec, L, log2(G), NW, stream.
extern "C" int rglru_gated_scan_fwd(const long long* a) {
  const int B = (int)a[8], S = (int)a[9], W = (int)a[10], bf16 = (int)a[11],
            vec = (int)a[12], L = (int)a[13], log_g = (int)a[14],
            nw = (int)a[15];
  if (!valid(B, S, W, vec, L, log_g, nw)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.in0 = reinterpret_cast<const void*>(a[0]);
  p.in1 = reinterpret_cast<const void*>(a[1]);
  p.in2 = reinterpret_cast<const void*>(a[2]);
  p.in3 = reinterpret_cast<const void*>(a[3]);
  p.lam = reinterpret_cast<const float*>(a[4]);
  p.h0 = reinterpret_cast<const float*>(a[5]);
  p.out = reinterpret_cast<void*>(a[6]);
  p.h_last = reinterpret_cast<float*>(a[7]);
  p.S = S; p.W = W; p.log_g = log_g; p.nw = nw;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[16]);
  return bf16 ? launch<__nv_bfloat16, true>(p, B, vec, L, stream)
              : launch<float, true>(p, B, vec, L, stream);
}
