// One Mamba-2 SSD chunk for every (batch, head) pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py:_kernel (:30),
// launched by ssd_chunk_pallas (:65, pl.pallas_call at :80).
//
// What it computes, per pair g, with x (c, P), dt (c,), a = A[g] < 0,
// B and C (c, N) of the pair's group and s_prev (P, N), in f32 whatever
// the inputs' dtype:
//   cum   = cumsum(dt * a)                          within-chunk log decay
//   y     = ((C B^T) * causal(exp(cum_i - cum_j)) * dt_j) x
//         + (C * exp(cum)) s_prev^T
//   s_new = exp(cum[-1]) s_prev + x^T (B * exp(cum[-1] - cum) * dt)
//
// Bound on an H100: operations.  Per pair the products need
// c(c+1)(N+P) + 4cPN flops, counting only the causal triangle j <= i of
// the two intra-chunk products (21.0 M at c = 256, P = 64, N = 128),
// against about 0.2 MB read and written; at the serving path's BH = 320
// that is 6.73 GFLOP, 0.100 ms at the 67 TFLOP/s of f32 FMA outside the
// tensor cores.  This kernel skips the score tiles above the diagonal but
// computes the diagonal tiles whole: 24.1 M flops per pair at those
// shapes, 1.15x what the function needs.
//
// Design.  The TPU kernel keeps one pair's whole chunk in VMEM (~0.7 MiB
// at the path's shapes), more than the 227 KB of shared memory a block
// has here.  So the outputs are cut into 64 x 64 tiles, one block each,
// all in one launch (grid: pairs x tiles), the heaviest row tiles first:
//   * y tiles (rows i0.., columns p0..): the carried-state term
//     C s_prev^T over N, rows scaled by exp(cum_i); then, for every j tile
//     up to the diagonal, the scores C B^T over N in registers, masked and
//     decayed in registers, staged in shared memory and multiplied by the
//     x tile;
//   * state tiles (p0.., n0..): x^T (B * w) over the chunk, plus the
//     decayed s_prev.
// Every block computes its pair's prefix cum itself (one warp scan of c
// values), so blocks share nothing and need no order.  Each product is an
// f32 FMA loop over k-major shared-memory tiles: 256 threads, a 4 x 4
// register tile each, float4 reads from shared memory.  bf16 inputs are
// converted to f32 as they are staged (no separate cast pass).  Groups:
// B and C hold one row block per group; pair g reads group g / rep.
// Tensor cores (wgmma) and TMA are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;             // output tile edge
constexpr int kDepth = 32;            // depth of one staged product step
constexpr int kLd = kTile + 4;        // padded tile row, keeps float4 alignment
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTileFloats = kTile * kLd;
constexpr int kDefaultSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[a][b] += sum_{k < Depth} at[k][ty * 4 + a] * bt[k][tx * 4 + b]
template <int Depth>
__device__ __forceinline__ void tile_fma(const float* __restrict__ at,
                                         const float* __restrict__ bt,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int k = 0; k < Depth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(at + k * kLd + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + k * kLd + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// dst[k][r] = src[r0 + r][k0 + k] for r < kTile, k < kDepth (src row-major,
// `rows` x `cols`, leading dimension `cols`), zero outside the source.
template <typename T>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 int rows, int cols, int r0,
                                                 int k0,
                                                 float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < kTile * kDepth; idx += kThreads) {
    const int r = idx / kDepth, k = idx % kDepth;
    const int gr = r0 + r, gk = k0 + k;
    dst[k * kLd + r] =
        (gr < rows && gk < cols)
            ? to_f32(src[static_cast<int64_t>(gr) * cols + gk])
            : 0.f;
  }
}

// dst[k][q] = src[k0 + k][q0 + q] * (scale ? scale[k0 + k] : 1) for
// k < Depth, q < kTile (src row-major, `rows` x `cols`), zero outside.
template <int Depth, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int rows, int cols, int k0,
                                           int q0,
                                           const float* __restrict__ scale,
                                           float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < Depth * kTile; idx += kThreads) {
    const int k = idx / kTile, q = idx % kTile;
    const int gk = k0 + k, gq = q0 + q;
    float v = 0.f;
    if (gk < rows && gq < cols) {
      v = to_f32(src[static_cast<int64_t>(gk) * cols + gq]);
      if (scale != nullptr) v = __fmul_rn(v, scale[gk]);
    }
    dst[k * kLd + q] = v;
  }
}

// dts[t] = dt[t]; cum[t] = sum_{s <= t} dt[s] * a, for t < c.  One warp:
// each lane sums a contiguous segment, a shuffle scan joins the segments.
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int c,
                             float* __restrict__ dts,
                             float* __restrict__ cum) {
  for (int t = threadIdx.x; t < c; t += kThreads) dts[t] = dt[t];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (c + 31) / 32;
    const int t0 = min(lane * per, c), t1 = min(t0 + per, c);
    float seg = 0.f;
    for (int t = t0; t < t1; ++t) seg = __fadd_rn(seg, __fmul_rn(dts[t], a));
    float incl = seg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, v);
    }
    float run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.f;
    for (int t = t0; t < t1; ++t) {
      run = __fadd_rn(run, __fmul_rn(dts[t], a));
      cum[t] = run;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C,
                     const float* __restrict__ s_prev,
                     float* __restrict__ y, float* __restrict__ s_new,
                     int rep, int c, int P, int N) {
  extern __shared__ float4 smem4[];
  float* at = reinterpret_cast<float*>(smem4);   // k-major tile, A operand
  float* bt = at + kTileFloats;                  // k-major tile, B operand
  float* dts = bt + kTileFloats;                 // (c,) dt, later w
  float* cum = dts + c;                          // (c,) prefix of dt * a

  const int64_t g = blockIdx.x;
  const int64_t grp = g / rep;
  const T* xg = x + g * c * P;
  const T* bg = B + grp * c * N;
  const T* cg = C + grp * c * N;
  const float* sg = s_prev + g * P * N;
  chunk_cumsum(dt + g * c, A[g], c, dts, cum);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row_tiles = (c + kTile - 1) / kTile;
  const int p_tiles = (P + kTile - 1) / kTile;
  const int y_tiles = row_tiles * p_tiles;
  float acc[4][4] = {};

  if (static_cast<int>(blockIdx.y) < y_tiles) {
    const int i0 = (row_tiles - 1 - blockIdx.y / p_tiles) * kTile;
    const int p0 = (blockIdx.y % p_tiles) * kTile;
    // carried state: (C s_prev^T)[i, p], then rows scaled by exp(cum_i)
    for (int n0 = 0; n0 < N; n0 += kDepth) {
      stage_transposed(cg, c, N, i0, n0, at);
      stage_transposed(sg, P, N, p0, n0, bt);
      __syncthreads();
      tile_fma<kDepth>(at, bt, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      const float e = i < c ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = __fmul_rn(acc[a][b], e);
    }
    // intra-chunk: every j tile up to the diagonal
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      float sc[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += kDepth) {
        stage_transposed(cg, c, N, i0, n0, at);
        stage_transposed(bg, c, N, j0, n0, bt);
        __syncthreads();
        tile_fma<kDepth>(at, bt, ty, tx, sc);
        __syncthreads();
      }
      // masked, decayed, dt-weighted scores, k-major over j: at[j][i]
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + tx * 4 + b;
          float v = 0.f;
          if (i < c && j <= i) {
            v = __fmul_rn(__fmul_rn(sc[a][b], expf(cum[i] - cum[j])),
                          dts[j]);
          }
          at[(tx * 4 + b) * kLd + ty * 4 + a] = v;
        }
      }
      stage_rows<kTile>(xg, c, P, j0, p0, nullptr, bt);
      __syncthreads();
      tile_fma<kTile>(at, bt, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = p0 + tx * 4 + b;
        if (i < c && p < P) y[(g * c + i) * P + p] = acc[a][b];
      }
    }
  } else {
    const int n_tiles = (N + kTile - 1) / kTile;
    const int st = blockIdx.y - y_tiles;
    const int p0 = (st / n_tiles) * kTile, n0 = (st % n_tiles) * kTile;
    const float seg = cum[c - 1];
    // w_j = exp(seg - cum_j) * dt_j, in place of dt
    for (int t = threadIdx.x; t < c; t += kThreads) {
      dts[t] = __fmul_rn(expf(seg - cum[t]), dts[t]);
    }
    __syncthreads();
    for (int j0 = 0; j0 < c; j0 += kDepth) {
      stage_rows<kDepth>(xg, c, P, j0, p0, nullptr, at);    // at[j][p]
      stage_rows<kDepth>(bg, c, N, j0, n0, dts, bt);        // bt[j][n] B w
      __syncthreads();
      tile_fma<kDepth>(at, bt, ty, tx, acc);
      __syncthreads();
    }
    const float decay = expf(seg);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = p0 + ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = n0 + tx * 4 + b;
        if (p < P && n < N) {
          const int64_t o = static_cast<int64_t>(p) * N + n;
          s_new[g * P * N + o] = __fadd_rn(__fmul_rn(sg[o], decay),
                                           acc[a][b]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* s_prev, void* y, void* s_new,
           int64_t bh, int rep, int c, int P, int N, cudaStream_t stream) {
  const int p_tiles = (P + kTile - 1) / kTile;
  const int64_t tiles =
      static_cast<int64_t>((c + kTile - 1) / kTile) * p_tiles +
      static_cast<int64_t>(p_tiles) * ((N + kTile - 1) / kTile);
  if (bh > 0x7fffffff || tiles > 65535 || rep < 1 || bh % rep != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (2 * kTileFloats + 2 * static_cast<size_t>(c)) *
                      sizeof(float);
  if (smem > kDefaultSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>(tiles));
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(s_prev),
      static_cast<float*>(y), static_cast<float*>(s_new), rep, c, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, B, C: f32 or (bf16 != 0) bf16; dt, A, s_prev, y, s_new: f32; all
// contiguous.  x (bh, c, P), dt (bh, c), A (bh,), B and C (bh / rep, c, N),
// s_prev and s_new (bh, P, N), y (bh, c, P).
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* B, const void* C,
                               const void* s_prev, void* y, void* s_new,
                               int64_t bh, int rep, int c, int P, int N,
                               int bf16, void* stream) {
  if (bh == 0) return 0;
  if (c < 1 || P < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, B, C, s_prev, y, s_new, bh,
                                      rep, c, P, N, s)
              : launch<float>(x, dt, A, B, C, s_prev, y, s_new, bh, rep, c,
                              P, N, s);
}
