// One Mamba-2 SSD chunk for every (batch, head) pair on Hopper's tensor
// cores (sm_90a): bf16 wgmma, f32 operands split into two bf16 halves, TMA.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py:_kernel (:30),
// launched by ssd_chunk_pallas (:65, pl.pallas_call at :80), for bf16 x, B
// and C (the serving path's dtype); f32 inputs go to csrc/ssd_chunk.cu.
//
// What it computes, per pair g, with x (c, P), dt (c,), a = A[g] < 0,
// B and C (c, N) of the pair's group and s_prev (P, N), in f32:
//   cum   = cumsum(dt * a)
//   y     = ((C B^T) * causal(exp(cum_i - cum_j)) * dt_j) x
//         + (C * exp(cum)) s_prev^T
//   s_new = exp(cum[-1]) s_prev + x^T (B * exp(cum[-1] - cum) * dt)
//
// Bound on an H100: bytes.  At the serving path's shape (320 pairs, c 256,
// P 64, N 128, B and C per group) the function reads x and s_prev (10.5 MB
// each), B, C and dt (0.9 MB) and writes y and s_new in f32 (31.5 MB):
// 53.3 MB, 15.9 us at 3.35 TB/s.  Its 6.73 GFLOP take 6.8 us at bf16's
// 989 TFLOP/s, 13.6 us even with every product done in two passes.
//
// Precision.  x, B and C are exact in bf16.  Three operands are f32: the
// masked, decayed scores M, s_prev and B * w.  Each is split into
// hi = bf16(v) and lo = bf16(v - hi) and multiplied in two passes against
// its exact bf16 partner, with f32 accumulation: about 16 bits of the f32
// operand survive, which holds y and s_new to the plain version at 2e-4
// (one bf16 rounding misses it by ~50x, one TF32 rounding by ~7x;
// tests/test_torch_ssd_tc.py).
//
// Design.  One launch, grid (pairs, NT + row tiles), one warpgroup (128
// threads) per block; NT = N / 64 rounded up, PT = P / 64 likewise.
//   * state blocks (blockIdx.y < NT, launched first, as heavy as the last
//     row tile): n-tile nt of s_new^T = (B * w)^T x over the whole chunk.
//     The A operand (B * w)^T is built in registers from the swizzled B
//     tile, split hi/lo; x is the MN-major B operand.
//   * y blocks (row tile i, heaviest first): C_i stays resident (TMA); for
//     every j tile up to the diagonal: S = C_i B_j^T (1 pass, SS wgmma),
//     the accumulator masked, decayed and split in registers straight into
//     the A fragments of y += M x_j (2 passes, RS wgmma, x MN-major), as
//     FlashAttention-3 does with P: no round trip through shared memory.
//     Then, over the drained ring, s_prev is split hi/lo into swizzled
//     bf16 tiles and the carried term C_i s_prev^T (2 passes, SS) is added
//     with its rows scaled by exp(cum_i).
//   Each block computes its pair's cum once (a 128-thread scan).  (B_j,
//   x_j) stream through a ring of 2 stages, each filled by TMA (3-D tensor
//   maps (pairs, c, .), so a tile past c reads zeros and never the next
//   pair's rows; 128-byte swizzle) and waited on with an mbarrier; thread 0
//   refills a stage as soon as all 128 threads are done with it.
// Shapes: P and N at most 128 and multiples of 8 (TMA's 16-byte row
// stride); x, B and C 16-byte aligned; any c whose dt and cum fit in
// shared memory beside the tiles.  At the path's shape (PT 1, NT 2): 1,920
// blocks of 67.1 KB of shared memory (the ring 48 KB, C_i 16 KB, dt and
// cum 2 KB, 1 KB of alignment) and 115 registers a thread (154 at PT 2),
// so 3 blocks per SM: 4.85 waves of 396 blocks over 132 SMs.  Blocks in
// flight matter more than depth here: keeping the split s_prev resident
// (99 KB) or a third ring stage leaves 2 blocks per SM, and either ran
// slower; each block waits on its own chain of loads and products.
// The tensor maps come from cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPoint (no -lcuda at link time).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // one warpgroup
constexpr int kStages = 2;             // (B_j, x_j) ring
constexpr int kBox = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box, 8 KB
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` completes; a copy that never
// lands (a wrong byte count) traps after about 2^24 tries instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// 8-row swizzle atoms of 1 KB.  The atom stride goes in both offset fields:
// K-major operands and MN-major ones 64 wide each read only one of them.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accumulator reads across the async product
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) += A (64 x 16) B (16 x 64); both bf16 in shared memory,
// K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64,
// bf16 in shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// hi = bf16(u), lo = bf16(u - hi), for the pair (u0, u1) -> packed bf16x2
__device__ __forceinline__ void split2(float u0, float u1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u0, u1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(u0, __low2float(h)), __fsub_rn(u1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// byte offset of element (r, col) in a 64 x 64 bf16 box, 128-byte swizzle
__device__ __forceinline__ int swz(int r, int col) {
  return r * 128 + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1));
}

// dts[t] = dt[t]; cum[t] = sum_{s <= t} dt[s] * a, each product rounded to
// f32 and the sum kept in f64, so cum is f32 rounded once: at c 2048 |cum|
// reaches ~1600, where an f32 running sum drifts by several ulps and
// exp(cum_i - cum_j) with it.  Each thread sums a contiguous segment; a
// warp scan and the warp totals join the segments.
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int c,
                             double* __restrict__ wsum,
                             float* __restrict__ dts,
                             float* __restrict__ cum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (c + kThreads - 1) / kThreads;
  const int t0 = min(tid * per, c), t1 = min(t0 + per, c);
  double seg = 0.0;
  for (int t = t0; t < t1; ++t) {
    const float d = dt[t];
    dts[t] = d;
    seg += __fmul_rn(d, a);
  }
  double incl = seg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int t = t0; t < t1; ++t) {
    run += __fmul_rn(dts[t], a);
    cum[t] = static_cast<float>(run);
  }
}

template <int PT, int NT>
__global__ void __launch_bounds__(kThreads, PT == 1 ? 3 : 2)
    ssd_chunk_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ s_prev,
                        float* __restrict__ y, float* __restrict__ s_new,
                        int rep, int c, int P, int N) {
  constexpr int kStage = (NT + PT) * kBox;   // B_j boxes, then x_j boxes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  static_assert(2 * PT * NT * kBox <= kStages * kStage,
                "the split s_prev tiles fit over the drained ring");
  uint8_t* c_tile = smem + kStages * kStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(c_tile + NT * kBox);
  double* wsum = reinterpret_cast<double*>(bars + 4);
  const int c_tiles = (c + 63) / 64;
  // cum and dts hold c_tiles * 64 each: no index of a tile reads past them
  float* cum = reinterpret_cast<float*>(wsum + 4);
  float* dts = cum + c_tiles * 64;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x, grp = g / rep;
  const bool state_block = static_cast<int>(blockIdx.y) < NT;
  const int it = state_block ? c_tiles - 1 : c_tiles - 1 - (blockIdx.y - NT);
  const int nb = state_block ? 1 : NT;   // B boxes per stage
  const uint32_t bar_c = smem_u32(bars + kStages);

  auto fill = [&](int stage, int jt) {    // thread 0: TMA (B_j, x_j)
    const uint32_t bar = smem_u32(bars + stage);
    uint8_t* dst = smem + stage * kStage;
    mbar_expect_tx(bar, (nb + PT) * kBox);
    for (int b = 0; b < nb; ++b) {
      const int nt = state_block ? blockIdx.y : b;
      tma_load(smem_u32(dst + b * kBox), &b_map, bar, nt * 64, jt * 64, grp);
    }
    for (int pt = 0; pt < PT; ++pt) {
      tma_load(smem_u32(dst + (NT + pt) * kBox), &x_map, bar, pt * 64,
               jt * 64, g);
    }
  };

  if (tid == 0) {
    for (int b = 0; b <= kStages; ++b) mbar_init(smem_u32(bars + b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (!state_block) {
      mbar_expect_tx(bar_c, NT * kBox);
      for (int nt = 0; nt < NT; ++nt) {
        tma_load(smem_u32(c_tile + nt * kBox), &c_map, bar_c, nt * 64,
                 it * 64, grp);
      }
    }
    for (int s = 0; s < kStages && s <= it; ++s) fill(s, s);
  }
  const float* sg = s_prev + static_cast<int64_t>(g) * P * N;
  chunk_cumsum(dt + static_cast<int64_t>(g) * c, A[g], c, wsum, dts, cum);

  const int q2 = 2 * (lane % 4);          // fragment column pair
  const int r0 = 16 * warp + lane / 4;    // fragment row (and row + 8)
  float acc[PT][32];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pt][i] = 0.f;
  }

  if (state_block) {
    __syncthreads();                          // cum complete
    const float seg = cum[c - 1];
    for (int t = tid; t < c; t += kThreads) {  // w_j in place of dt_j
      dts[t] = __fmul_rn(expf(__fsub_rn(seg, cum[t])), dts[t]);
    }
    __syncthreads();
    for (int jt = 0; jt <= it; ++jt) {
      const int stage = jt % kStages;
      uint8_t* st = smem + stage * kStage;
      mbar_wait(smem_u32(bars + stage), (jt / kStages) & 1);
      // (B_j * w)^T fragments: rows n (r0, r0 + 8), columns j, hi and lo
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int n = r0 + 8 * (h & 1);
          const int jl = 16 * kb + q2 + 8 * (h >> 1);
          float u[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = jt * 64 + jl + e;
            const __nv_bfloat16 b =
                *reinterpret_cast<const __nv_bfloat16*>(st + swz(jl + e, n));
            u[e] = j < c ? __fmul_rn(__bfloat162float(b), dts[j]) : 0.f;
          }
          split2(u[0], u[1], hi[kb][h], lo[kb][h]);
        }
      }
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          const uint64_t bx =
              desc(smem_u32(st + (NT + pt) * kBox + kb * 2048));
          wgmma_rs(acc[pt], hi[kb], bx);
          wgmma_rs(acc[pt], lo[kb], bx);
        }
      }
      wg_commit_wait();
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) fence_regs(acc[pt]);
      __syncthreads();                        // every thread done with it
      if (tid == 0 && jt + kStages <= it) fill(stage, jt + kStages);
    }
    const float decay = expf(cum[c - 1]);
    float* og = s_new + static_cast<int64_t>(g) * P * N;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int n = blockIdx.y * 64 + r0 + 8 * ((i >> 1) & 1);
        const int p = pt * 64 + 8 * (i >> 2) + q2 + (i & 1);
        if (n < N && p < P) {
          const int64_t o = static_cast<int64_t>(p) * N + n;
          og[o] = __fadd_rn(__fmul_rn(sg[o], decay), acc[pt][i]);
        }
      }
    }
    return;
  }

  // y block
  __syncthreads();                            // cum complete
  const int i0 = it * 64 + r0, i1 = i0 + 8;   // this thread's rows
  const float ci0 = i0 < c ? cum[i0] : 0.f, ci1 = i1 < c ? cum[i1] : 0.f;
  mbar_wait(bar_c, 0);

  // intra-chunk: every j tile up to the diagonal
  for (int jt = 0; jt <= it; ++jt) {
    const int stage = jt % kStages;
    uint8_t* st = smem + stage * kStage;
    mbar_wait(smem_u32(bars + stage), (jt / kStages) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss(sc, desc(smem_u32(c_tile + nt * kBox + k * 32)),
                 desc(smem_u32(st + nt * kBox + k * 32)));
      }
    }
    wg_commit_wait();
    fence_regs(sc);
    // M = S * causal exp(cum_i - cum_j) * dt_j, split into A fragments:
    // accumulator element 8 kb + h * 2 + e is fragment kb, register h
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = (h & 1) ? i1 : i0;
        const float ci = (h & 1) ? ci1 : ci0;
        float u[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jt * 64 + 16 * kb + 8 * (h >> 1) + q2 + e;
          const float s = sc[8 * kb + 2 * h + e];
          u[e] = (i < c && j <= i)
                     ? __fmul_rn(__fmul_rn(s, expf(__fsub_rn(ci, cum[j]))),
                                 dts[j])
                     : 0.f;
        }
        split2(u[0], u[1], hi[kb][h], lo[kb][h]);
      }
    }
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const uint64_t bx = desc(smem_u32(st + (NT + pt) * kBox + kb * 2048));
        wgmma_rs(acc[pt], hi[kb], bx);
        wgmma_rs(acc[pt], lo[kb], bx);
      }
    }
    wg_commit_wait();
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) fence_regs(acc[pt]);
    __syncthreads();
    if (tid == 0 && jt + kStages <= it) fill(stage, jt + kStages);
  }

  // carried state, once the ring is drained: s_prev split hi / lo into
  // K-major swizzled tiles (pt, nt) over the ring, C_i s_prev^T over N in
  // two passes, rows times exp(cum_i), added to the intra-chunk sum
  uint8_t* s_hi = smem;
  uint8_t* s_lo = smem + PT * NT * kBox;
  for (int ch = tid; ch < PT * 64 * NT * 8; ch += kThreads) {
    const int p = ch / (NT * 8), n = (ch % (NT * 8)) * 8;
    float v[8] = {};
    if (p < P && n < N) {
      const float4* src =
          reinterpret_cast<const float4*>(sg + static_cast<int64_t>(p) * N + n);
      const float4 a0 = src[0], a1 = src[1];
      v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
      v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
    }
    uint4 h, l;
    split2(v[0], v[1], h.x, l.x);
    split2(v[2], v[3], h.y, l.y);
    split2(v[4], v[5], h.z, l.z);
    split2(v[6], v[7], h.w, l.w);
    const int off = ((p / 64) * NT + n / 64) * kBox + swz(p % 64, n % 64);
    *reinterpret_cast<uint4*>(s_hi + off) = h;
    *reinterpret_cast<uint4*>(s_lo + off) = l;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float cr[PT][32];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) cr[pt][i] = 0.f;
  }
  wg_fence();
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t a = desc(smem_u32(c_tile + nt * kBox + k * 32));
        const int off = (pt * NT + nt) * kBox + k * 32;
        wgmma_ss(cr[pt], a, desc(smem_u32(s_hi + off)));
        wgmma_ss(cr[pt], a, desc(smem_u32(s_lo + off)));
      }
    }
  }
  wg_commit_wait();
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) fence_regs(cr[pt]);
  const float e0 = i0 < c ? expf(ci0) : 0.f, e1 = i1 < c ? expf(ci1) : 0.f;
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[pt][i] = __fadd_rn(acc[pt][i],
                             __fmul_rn(cr[pt][i], ((i >> 1) & 1) ? e1 : e0));
    }
  }

  float* yg = y + static_cast<int64_t>(g) * c * P;
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i >> 1) & 1 ? i1 : i0;
      const int p = pt * 64 + 8 * (i >> 2) + q2;
      if (row < c && p < P) {
        *reinterpret_cast<float2*>(yg + static_cast<int64_t>(row) * P + p) =
            make_float2(acc[pt][i], acc[pt][i + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 3-D map of a contiguous bf16 tensor (batch, rows, inner): 64 x 64 boxes,
// 128-byte swizzle, zeros outside
bool make_map(CUtensorMap* map, const void* base, int inner, int rows,
              int64_t batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * rows * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PT, int NT>
int launch(const CUtensorMap& xm, const CUtensorMap& bm, const CUtensorMap& cm,
           const void* dt, const void* A, const void* s_prev, void* y,
           void* s_new, int64_t bh, int rep, int c, int P, int N,
           cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(
                                 kStages * (NT + PT) + NT) *
                                 kBox +
                      (kStages + 2) * 8 + 4 * 8 +
                      8 * static_cast<size_t>((c + 63) / 64 * 64);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the cap, once per instance: no attribute call while a graph captures
  static const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc_kernel<PT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>(NT + (c + 63) / 64));
  ssd_chunk_tc_kernel<PT, NT><<<grid, kThreads, smem, stream>>>(
      xm, bm, cm, static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(s_prev),
      static_cast<float*>(y), static_cast<float*>(s_new), rep, c, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, B, C: bf16; dt, A, s_prev, y, s_new: f32; all contiguous.  x (bh, c,
// P), dt (bh, c), A (bh,), B and C (bh / rep, c, N), s_prev and s_new (bh,
// P, N), y (bh, c, P).  P and N in 8..128 and multiples of 8; x, B, C and
// s_prev 16-byte aligned.
extern "C" int repro_ssd_chunk_tc(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* s_prev, void* y, void* s_new,
                                  int64_t bh, int rep, int c, int P, int N,
                                  void* stream) {
  if (bh == 0) return 0;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (c < 1 || P < 8 || P > 128 || P % 8 || N < 8 || N > 128 || N % 8 ||
      rep < 1 || bh % rep || bh > 0x7fffffff || misaligned(x) ||
      misaligned(B) || misaligned(C) || misaligned(s_prev)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xm, bm, cm;
  if (!make_map(&xm, x, P, c, bh) || !make_map(&bm, B, N, c, bh / rep) ||
      !make_map(&cm, C, N, c, bh / rep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pt = (P + 63) / 64, nt = (N + 63) / 64;
  if (pt == 1 && nt == 1)
    return launch<1, 1>(xm, bm, cm, dt, A, s_prev, y, s_new, bh, rep, c, P,
                        N, s);
  if (pt == 1)
    return launch<1, 2>(xm, bm, cm, dt, A, s_prev, y, s_new, bh, rep, c, P,
                        N, s);
  if (nt == 1)
    return launch<2, 1>(xm, bm, cm, dt, A, s_prev, y, s_new, bh, rep, c, P,
                        N, s);
  return launch<2, 2>(xm, bm, cm, dt, A, s_prev, y, s_new, bh, rep, c, P, N,
                      s);
}
