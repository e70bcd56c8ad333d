// Dense fp32 matrix product C = X·W on Hopper's tensor cores, at fp32
// accuracy, by split TF32 ("3xTF32"), for sm_90a.
//
// It replaces no TPU kernel: the JAX package leaves its dense products
// (src/repro/models/layers.py `x @ w`) to XLA. On the H100 `x @ w` in fp32
// goes to cuBLAS's SIMT sgemm on the CUDA cores (67 TFLOP/s peak), and a
// served prefill spends most of its device time there. A single TF32 pass
// on the tensor cores keeps 11 bits of each operand: too coarse for the
// served logits. Split TF32 keeps fp32's accuracy on the tensor cores:
//
//   w_hi = rna(w), w_lo = rna(w - w_hi); x_hi = trunc(x), x_lo = rna(x - x_hi)
//   x·w ≈ x_lo·w_hi + x_hi·w_lo + x_hi·w_hi
//
// (rna: to TF32, nearest; trunc: the low 13 bits dropped, which is what the
// tensor cores make of an fp32 operand in shared memory, so x_hi is X as it
// lies. x_lo·w_lo, below 2^-21 of a product, is dropped, and each split
// misses at most 2^-21 of its value.) The tensor cores add in fp32 but
// truncate their sums, so each 32-deep slice of K is summed on them into a
// fresh accumulator and then added to the running one with an fp32 add that
// rounds to nearest: the truncation's bias never builds up over K.
//
// What bounds it: operations. A served prefill's products are 576 rows
// against weights of K 1,024-8,192 and N 1,024-16,768: three TF32 products
// a multiply-add at 495 TFLOP/s dense, so 165 TFLOP/s of fp32 work at best,
// against the bytes of the weight (read once) at 3.35 TB/s, which is at
// most a fifth of that time.
//
// Design. The tensor cores take TF32 operands from shared memory only
// K-major; W (K, N) is N-major, X (M, K) K-major. So the kernel computes
// Cᵀ = Wᵀ·Xᵀ: wgmma's A is a 64 x 8 slice of Wᵀ, held in registers and
// loaded by each thread from the staged W tile (the split into hi and lo is
// done in registers), and its B is 96 rows of X (or of X's lo part), read
// from shared memory through a 128-byte-swizzled descriptor. A block
// computes a 128 (N) x 192 (M) tile of C. Two consumer warpgroups each take
// 64 columns of W against the tile's two 96-row halves of X (wgmma
// m64n96k8, 96 fp32 accumulators a thread and 48 for the slice). Two
// producer warpgroups feed a ring of 3 stages of 32-deep K slices: they
// load X and W with 16-byte cp.async (zero-filled past M, N and K), split
// the stage loaded one before (X's lo part, written beside X) and mark it
// full on an mbarrier; the consumers mark each stage empty once its
// products are done. The producers give up registers to the consumers
// (setmaxnreg). The grid is persistent (one block an SM, 196 KB of shared
// memory). Where whole tiles fill the SMs' waves, each block takes whole
// tiles in turn; else the tiles left after the full waves (all of them at
// N 1,024-8,192 and 576 rows) are shared out stream-K, an equal run of
// their K stages a block (`Work`; the wrapper chooses from the shapes). A
// tile split between blocks is finished by the last of them to arrive,
// which adds the parts' partials, kept in a workspace, in block order, so
// the sum does not depend on which finishes last. Per-tile arrival counters
// return to zero after each use. The epilogue writes C in fp32, masked at
// the ragged edges. No weight is copied or transposed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BNW = 128;            // W columns (of C) a tile: 2 x 64
constexpr int NH = 2;               // wgmma row blocks of X a tile
constexpr int HALF = 96;            // X rows of one wgmma: its N
constexpr int BMX = NH * HALF;      // X rows (of C) a tile
constexpr int BK = 32;              // K a stage: one 128-byte row of fp32
constexpr int WPAD = BNW + 8;       // W stage row pitch, floats: the
                                    // fragment loads hit 32 banks
constexpr int STAGES = 3;
constexpr int LAG = 1;              // stages loaded ahead of the one split
constexpr int PRODUCERS = 256;      // warpgroups 0, 1: loads and splits
constexpr int PRODUCER_REGS = 72;   // the rest of the registers go to the
                                    // consumers' accumulators
constexpr int CONSUMERS = 256;      // warpgroups 2, 3: the products
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int ACC = HALF / 2;       // accumulators a thread a half
constexpr int X_BYTES = BMX * BK * 4;            // X (or its lo) a stage
constexpr int W_BYTES = BK * WPAD * 4;
constexpr int STAGE_BYTES = 2 * X_BYTES + W_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
static_assert(HALF * 128 % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "swizzle atoms must stay 1024-byte aligned");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
template <int ID, int COUNT>
__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// What the tensor cores make of a TF32 operand's fp32 bits: the low 13
// dropped.
__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n96k8(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

struct Args {
  const float* x;     // (M, K), rows lda floats apart
  const float* w;     // (K, N), contiguous
  float* c;           // (M, N), contiguous
  float* ws;          // (blocks, 2, NH·ACC, CONSUMERS) partials of split tiles
  int* counters;      // (tiles,) zero on entry, zero again on exit
  int M, N, K, lda;
  int dp_tiles;       // tiles done whole, before the stream-K ones
};

// The work. The tiles are numbered M tiles fastest, so blocks in flight
// share W's columns. The first `dp_tiles` go whole to the G blocks in turn
// (block b takes tiles b, b + G, ...). The rest are shared out stream-K:
// their stages of K, tile after tile, form one run of I = tiles x stages
// iterations, and block b takes iterations [b·I/G, (b+1)·I/G), which fall
// into segments at the tiles' edges. A tile whose stages fall to more than
// one block is split: each of its segments' partial sum goes to the
// workspace, and the last to finish adds them in block order.
struct Work {
  long long total;    // I: the stream-K tiles x stages
  int blocks, stages, mt_count, dp_tiles;
  __device__ long long start(int b) const { return b * total / blocks; }
  // the block whose run holds iteration i
  __device__ int block_of(long long i) const {
    return (int)(((i + 1) * blocks - 1) / total);
  }
};
struct Seg {
  int tile, m0, n0, kb0, nk;
  int part, parts;    // this segment's place among its tile's, and their number
  int slot;           // 0: the block's first segment; 1: its last
};
__device__ __forceinline__ Seg whole_tile(const Work& w, int tile) {
  Seg s;
  s.tile = tile, s.kb0 = 0, s.nk = w.stages;
  s.m0 = (tile % w.mt_count) * BMX;
  s.n0 = (tile / w.mt_count) * BNW;
  s.part = 0, s.parts = 1, s.slot = 0;
  return s;
}
// The stream-K segment of block b that begins at iteration i (before
// `end`).
__device__ __forceinline__ Seg seg_at(const Work& w, int b, long long i,
                                      long long end) {
  const int k = (int)(i / w.stages);
  Seg s = whole_tile(w, w.dp_tiles + k);
  s.kb0 = (int)(i % w.stages);
  s.nk = (int)min((long long)(w.stages - s.kb0), end - i);
  const long long t0 = (long long)k * w.stages;
  const int b0 = w.block_of(t0);
  s.parts = w.block_of(t0 + w.stages - 1) - b0 + 1;
  s.part = b - b0;
  s.slot = i == w.start(b) ? 0 : 1;
  return s;
}
// Block b's segments in order: its whole tiles, then its stream-K run.
template <class F>
__device__ __forceinline__ void for_each_seg(const Work& w, int b, F&& fn) {
  for (int t = b; t < w.dp_tiles; t += w.blocks) fn(whole_tile(w, t));
  const long long end = w.start(b + 1);
  for (long long i = w.start(b); i < end;) {
    const Seg s = seg_at(w, b, i, end);
    i += s.nk;
    fn(s);
  }
}

// Stage `kb` of a segment (K from kb·BK) into shared memory at `stage`, by the
// producer thread `p`: X's 192 rows into the swizzled hi buffer, W's 32 rows
// into the padded buffer.
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* stage,
                                           const Seg& u, int kb, int p) {
  const int k0 = kb * BK;
  const uint32_t xs = smem_u32(stage);
#pragma unroll
  for (int i = 0; i < BMX * 8 / PRODUCERS; ++i) {
    const int q = p + i * PRODUCERS, r = q >> 3, ch = q & 7;
    const int m = u.m0 + r, k = k0 + 4 * ch;
    const bool ok = m < a.M && k < a.K;
    const float* src = ok ? a.x + (long long)m * a.lda + k : a.x;
    cp_async16(xs + r * 128 + ((ch ^ (r & 7)) << 4), src, ok);
  }
  const uint32_t wsm = xs + 2 * X_BYTES;
#pragma unroll
  for (int i = 0; i < BK * (BNW / 4) / PRODUCERS; ++i) {
    const int q = p + i * PRODUCERS, kr = q >> 5, ch = q & 31;
    const int k = k0 + kr, n = u.n0 + 4 * ch;
    const bool ok = k < a.K && n < a.N;
    const float* src = ok ? a.w + (long long)k * a.N + n : a.w;
    cp_async16(wsm + (kr * WPAD + 4 * ch) * 4, src, ok);
  }
}

// X's stage split: its hi part is X itself (the tensor cores read the fp32
// bits and ignore the low 13), its lo part is written X_BYTES further. The
// swizzle moves whole 16-byte chunks, so the split is elementwise.
__device__ __forceinline__ void split_stage(uint8_t* stage, int p) {
  const float4* x = reinterpret_cast<const float4*>(stage);
  float4* lo = reinterpret_cast<float4*>(stage + X_BYTES);
#pragma unroll
  for (int i = 0; i < X_BYTES / 16 / PRODUCERS; ++i) {
    const int q = p + i * PRODUCERS;
    const float4 v = x[q];
    float4 l;
    l.x = __uint_as_float(tf32_rna(v.x - tf32_trunc(v.x)));
    l.y = __uint_as_float(tf32_rna(v.y - tf32_trunc(v.y)));
    l.z = __uint_as_float(tf32_rna(v.z - tf32_trunc(v.z)));
    l.w = __uint_as_float(tf32_rna(v.w - tf32_trunc(v.w)));
    lo[q] = l;
  }
  // the split is read by the tensor cores (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A fragments of one stage for a consumer thread: for each of the 4
// k-steps, the split of Wᵀ's rows (wcol, wcol + 8) at k (t, t + 4).
__device__ __forceinline__ void load_frags(const uint8_t* stage, int wcol,
                                           int t, uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
  const float* wst = reinterpret_cast<const float*>(stage + 2 * X_BYTES);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float v[4] = {wst[(ks * 8 + t) * WPAD + wcol],
                        wst[(ks * 8 + t) * WPAD + wcol + 8],
                        wst[(ks * 8 + t + 4) * WPAD + wcol],
                        wst[(ks * 8 + t + 4) * WPAD + wcol + 8]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hi[ks][j] = tf32_rna(v[j]);
      lo[ks][j] = tf32_rna(v[j] - __uint_as_float(hi[ks][j]));
    }
  }
}

// One 32-deep slice into a fresh accumulator, small products first.
__device__ __forceinline__ void issue_slice(float (&d)[ACC], uint32_t xhi,
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4]) {
  const uint32_t xlo = xhi + X_BYTES;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_m64n96k8(d, lo[ks], desc_sw128(xhi + ks * 32), ks > 0 ? 1 : 0);
    wgmma_m64n96k8(d, hi[ks], desc_sw128(xlo + ks * 32), 1);
    wgmma_m64n96k8(d, hi[ks], desc_sw128(xhi + ks * 32), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Producer warpgroups: for each of the block's stages in turn, wait until
// the consumers have freed its slot, load it; split the stage loaded LAG
// before and mark it full.
__device__ void produce(const Args& a, const Work& w, uint8_t* smem,
                        uint64_t* full, uint64_t* empty, int p) {
  auto split = [&](int j) {
    named_barrier<1, PRODUCERS>();  // every producer's copies have landed
    split_stage(smem + (j % STAGES) * STAGE_BYTES, p);
    mbar_arrive(full + j % STAGES);
  };
  int j = 0;  // stages loaded so far
  for_each_seg(w, blockIdx.x, [&](const Seg& u) {
    for (int kb = 0; kb < u.nk; ++kb, ++j) {
      mbar_wait(empty + j % STAGES, ((j / STAGES) & 1) ^ 1);
      load_stage(a, smem + (j % STAGES) * STAGE_BYTES, u, u.kb0 + kb, p);
      cp_async_commit();
      if (j >= LAG) {
        cp_async_wait<LAG>();
        split(j - LAG);
      }
    }
  });
  cp_async_wait<0>();
  for (int i = j > LAG ? j - LAG : 0; i < j; ++i) split(i);
}

__global__ void __launch_bounds__(THREADS, 1)
dense_gemm_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ int last_flag;

  const int tid = threadIdx.x;
  Work w;
  w.mt_count = (a.M + BMX - 1) / BMX;
  w.stages = (a.K + BK - 1) / BK;
  w.dp_tiles = a.dp_tiles;
  w.total = ((long long)w.mt_count * ((a.N + BNW - 1) / BNW) - a.dp_tiles) *
            w.stages;
  w.blocks = gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, PRODUCERS);
      mbar_init(empty + s, CONSUMERS / 32);
    }
  }
  __syncthreads();

  if (tid < PRODUCERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    produce(a, w, smem, full, empty, tid);
    return;
  }
  // the registers the producers gave up, shared out
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      (65536 - PRODUCERS * PRODUCER_REGS) / CONSUMERS / 8 * 8) : "memory");

  const int ct = tid - PRODUCERS;  // consumer thread
  const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's W columns within the tile (fragment rows g and g + 8)
  const int wcol = wg * 64 + warp * 16 + g;

  float acc[NH][ACC], tmp[ACC];
  uint32_t fhi[4][4], flo[4][4];
  int j = 0;  // stages consumed so far
  for_each_seg(w, blockIdx.x, [&](const Seg& u) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[h][i] = 0.f;
    for (int kb = 0; kb < u.nk; ++kb, ++j) {
      uint8_t* stage = smem + (j % STAGES) * STAGE_BYTES;
      mbar_wait(full + j % STAGES, (j / STAGES) & 1);
      load_frags(stage, wcol, t, fhi, flo);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        issue_slice(tmp, smem_u32(stage) + h * HALF * 128, fhi, flo);
        if (h == NH - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + j % STAGES);
        }
        // the tensor cores truncate their sums: each slice's is added
        // here, rounded to nearest
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          fence_operand(tmp[i]);
          acc[h][i] += tmp[i];
        }
      }
    }

    // acc[h][4i + r]: C row m0 + 96h + 8i + 2t + (r & 1), column
    // n0 + wcol + 8(r >> 1)
    constexpr int PART = NH * ACC;
    bool store = true;
    if (u.parts > 1) {
      // block b's slot s holds its partial at (2b + s)·PART·CONSUMERS; the
      // tile's part q is block b0 + q's, in slot 1 for q = 0 if the tile
      // is not where b0's run begins, else in slot 0
      auto partial = [&](int b, int slot) {
        return a.ws + ((long long)b * 2 + slot) * PART * CONSUMERS;
      };
      float* mine = partial(blockIdx.x, u.slot);
#pragma unroll
      for (int i = 0; i < PART; ++i)
        __stcg(mine + i * CONSUMERS + ct, acc[i / ACC][i % ACC]);
      __threadfence();
      named_barrier<2, CONSUMERS>();
      if (ct == 0)
        last_flag = atomicAdd(a.counters + u.tile, 1) == u.parts - 1;
      named_barrier<2, CONSUMERS>();
      store = last_flag;
      if (store) {
        // every part's partial, this one's too, added in block order
        __threadfence();
        const int b0 = blockIdx.x - u.part;
        const long long t0 = (long long)u.tile * w.stages;
        const int slot0 = w.start(b0) == t0 ? 0 : 1;
#pragma unroll
        for (int h = 0; h < NH; ++h)
          for (int q = 0; q < u.parts; ++q) {
            const float* src = partial(b0 + q, q ? 0 : slot0);
            float part[ACC];
#pragma unroll
            for (int i = 0; i < ACC; ++i)
              part[i] = __ldcg(src + (h * ACC + i) * CONSUMERS + ct);
#pragma unroll
            for (int i = 0; i < ACC; ++i)
              acc[h][i] = q ? acc[h][i] + part[i] : part[i];
          }
        if (ct == 0) a.counters[u.tile] = 0;
      }
      named_barrier<2, CONSUMERS>();  // last_flag is read before reuse
    }
    if (store) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < ACC / 4; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int m = u.m0 + HALF * h + 8 * i + 2 * t + (r & 1);
            const int n = u.n0 + wcol + 8 * (r >> 1);
            if (m < a.M && n < a.N)
              a.c[(long long)m * a.N + n] = acc[h][4 * i + r];
          }
    }
  });
}

}  // namespace

// The arguments packed in one int64 array: x, w, c, ws, counters (device
// addresses), M, N, K, lda, dp_tiles, grid, stream. x (M, K) with rows lda
// floats apart, w (K, N) and c (M, N) contiguous, fp32, 16-byte aligned; K,
// N and lda multiples of 4. Unless every block's stream-K run begins on a
// tile's edge (the stream-K tiles x stages a multiple of grid, each block's
// share a multiple of the stages), ws holds grid·2·96·256 floats and
// counters one int a tile, all zero. Launches one kernel on `stream`;
// returns a CUDA error code.
extern "C" int dense_gemm_fwd(const long long* p) {
  Args a;
  a.x = reinterpret_cast<const float*>(p[0]);
  a.w = reinterpret_cast<const float*>(p[1]);
  a.c = reinterpret_cast<float*>(p[2]);
  a.ws = reinterpret_cast<float*>(p[3]);
  a.counters = reinterpret_cast<int*>(p[4]);
  a.M = (int)p[5], a.N = (int)p[6], a.K = (int)p[7], a.lda = (int)p[8];
  a.dp_tiles = (int)p[9];
  const int grid = (int)p[10];
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(p[11]);
  const uintptr_t any = (uintptr_t)a.x | (uintptr_t)a.w | (uintptr_t)a.c;
  if (a.M <= 0 || a.N <= 0 || a.K <= 0 || (a.N & 3) || (a.K & 3) ||
      (a.lda & 3) || a.lda < a.K || grid < 1 || (any & 15))
    return (int)cudaErrorInvalidValue;
  const long long stages = (a.K + BK - 1) / BK;
  const long long tiles = (long long)((a.M + BMX - 1) / BMX) *
                          ((a.N + BNW - 1) / BNW);
  const long long total = (tiles - a.dp_tiles) * stages;
  const bool whole = total % grid == 0 && total / grid % stages == 0;
  if (a.dp_tiles < 0 || a.dp_tiles > tiles ||
      (!whole && (!a.ws || !a.counters)))
    return (int)cudaErrorInvalidValue;
  static bool attr[64] = {};  // the shared-memory limit, set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr[dev]) {
    e = cudaFuncSetAttribute(dense_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr[dev] = true;
  }
  dense_gemm_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}
