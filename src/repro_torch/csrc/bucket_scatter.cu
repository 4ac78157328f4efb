// Per-destination bucket binning in window order, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bucket_scatter.py: _kernel
// (:39), launched by bucket_scatter_pallas (:60, pl.pallas_call at :79).
//
// What it computes, per (batch b, destination d) row: the events of the
// window with dests[b, i] == d keep their window order; the k-th of them
// (k < C) lands in slot k of the row (word and guid), slots from
// min(count, C) to C are zero, and counts[b, d] is the raw count before the
// capacity clip.  A dest of -1 (or any value outside [0, D)) matches no row:
// the wrapper has masked invalid words and out-of-range destinations.
// Words are int32 bit patterns of 30-bit event words.
//
// The TPU kernel builds each row with an O(N * D * C) one-hot integer
// select-reduce on the vector lanes.  Here the same function is the
// ranker of dest_rank.cuh plus a placement, in one pass over the window:
// one thread-block cluster per batch row stages its chunks of the window
// in shared memory (cp.async, read from device memory once) and ranks
// every event among its destination's in window order (__match_any_sync
// inside a warp, a warps x D table across warps, the cluster's chunk
// counts through distributed shared memory); then each block writes the
// accepted events of its chunk to their slots, the cluster's blocks split
// the dead slots, and block 0 writes the raw counts.  No atomic decides a
// slot, so window order is kept.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function reads each input once
// (12 N bytes) and writes each output once (8 D C + 4 D bytes): at N 4096,
// D 64, C 128 that is 114,944 B, about 0.034 us, far below one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "dest_rank.cuh"

namespace {

namespace rk = repro_rank;

__global__ void __launch_bounds__(rk::kThreads)
bucket_scatter_kernel(const int32_t* __restrict__ words,
                      const int32_t* __restrict__ dests,
                      const int32_t* __restrict__ guids,
                      int32_t* __restrict__ data, int32_t* __restrict__ gout,
                      int32_t* __restrict__ counts, int64_t n, int64_t chunk,
                      int n_dest, int capacity) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = n_dest;
  const int C = capacity;
  const int64_t b = blockIdx.y;
  const rk::Chunk c = rk::my_chunk(n, chunk);
  const rk::Shared sh = rk::carve(smem, D);
  int32_t* s_words = reinterpret_cast<int32_t*>(sh.key + chunk);
  int32_t* s_guids = s_words + chunk;
  const int32_t* w_b = words + b * n;
  const int32_t* d_b = dests + b * n;
  const int32_t* g_b = guids + b * n;
  rk::rank_chunk(
      c, D, sh,
      [=](int64_t g, int64_t l) {
        rk::cp_async4(sh.key + l, d_b + g);
        rk::cp_async4(s_words + l, w_b + g);
        rk::cp_async4(s_guids + l, g_b + g);
      },
      [=](int64_t l) -> int {
        const int d = static_cast<int>(sh.key[l]);
        return d >= 0 && d < D ? d : -1;
      });
  rk::cluster_bases(c, D, sh);
  for (int64_t l = threadIdx.x; l < c.len; l += rk::kThreads) {
    const uint32_t key = sh.key[l];
    if (key == rk::kNone) continue;
    const int d = static_cast<int>(key >> rk::kRankBits);
    const int64_t k = sh.base[d] + static_cast<int64_t>(key & rk::kRankMask);
    if (k < C) {
      const int64_t slot = (b * D + d) * C + k;
      data[slot] = s_words[l];
      gout[slot] = s_guids[l];
    }
  }
  const int stride = static_cast<int>(c.blocks) * rk::kThreads;
  for (int j = static_cast<int>(c.rank) * rk::kThreads + threadIdx.x;
       j < D * C; j += stride) {        // D * C < 2^31
    const int d = j / C;
    if (j - d * C >= sh.tot[d]) {
      data[b * D * C + j] = 0;
      gout[b * D * C + j] = 0;
    }
  }
  if (c.rank == 0) {
    for (int d = threadIdx.x; d < D; d += rk::kThreads)
      counts[b * D + d] = sh.tot[d];
  }
  rk::finish();
}

}  // namespace

extern "C" int repro_bucket_scatter(const void* words, const void* dests,
                                    const void* guids, void* data,
                                    void* gout, void* counts, int batch,
                                    int64_t n, int n_dest, int capacity,
                                    void* stream) {
  if (batch == 0 || n_dest == 0) return 0;
  if (n_dest > rk::kMaxDest || n > rk::max_window(n_dest, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rk::launch(
      bucket_scatter_kernel, n, batch, rk::smem_bytes(n, n_dest, 3),
      static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(dests), static_cast<const int32_t*>(guids),
      static_cast<int32_t*>(data), static_cast<int32_t*>(gout),
      static_cast<int32_t*>(counts), n, rk::chunk_of(n), n_dest, capacity));
}
