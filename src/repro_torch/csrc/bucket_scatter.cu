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
// select-reduce on the vector lanes.  Here the same function is an ordered
// compaction: one block per row sweeps the window in tiles of 256 events;
// each warp ranks its matching events with __ballot_sync / __popc, the
// warp totals go through shared memory, and a running base carries the
// count from tile to tile.  Slots come from the prefix count, never from
// an atomicAdd, so window order is kept.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function reads each input once
// (12 N bytes) and writes each output once (8 D C + 4 D bytes): at N 4096,
// D 64, C 128 that is 114,944 B, about 0.034 us, far below one launch.
// Every block reads the whole dests vector (D * 4 N bytes, from L2 after
// the first), which is the price of one block per row and no second pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int32_t* __restrict__ words,
                      const int32_t* __restrict__ dests,
                      const int32_t* __restrict__ guids,
                      int32_t* __restrict__ data, int32_t* __restrict__ gout,
                      int32_t* __restrict__ counts, int64_t n, int n_dest,
                      int capacity) {
  __shared__ int warp_count[kWarps];
  const int d = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t row = b * n_dest + d;
  const int32_t* w_b = words + b * n;
  const int32_t* d_b = dests + b * n;
  const int32_t* g_b = guids + b * n;
  int32_t* data_row = data + row * capacity;
  int32_t* gout_row = gout + row * capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  int base = 0;                       // events of d in the earlier tiles
  for (int64_t start = 0; start < n; start += kThreads) {
    const int64_t i = start + threadIdx.x;
    const bool match = i < n && d_b[i] == d;
    const unsigned ballot = __ballot_sync(0xffffffffu, match);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = base;
    int total = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_count[k];
      before += k < warp ? c : 0;
      total += c;
    }
    if (match) {
      const int slot = before + __popc(ballot & lanes_below);
      if (slot < capacity) {
        data_row[slot] = w_b[i];
        gout_row[slot] = g_b[i];
      }
    }
    base += total;
    __syncthreads();                  // warp_count is rewritten next tile
  }
  for (int j = min(base, capacity) + threadIdx.x; j < capacity;
       j += kThreads) {
    data_row[j] = 0;
    gout_row[j] = 0;
  }
  if (threadIdx.x == 0) counts[row] = base;
}

}  // namespace

extern "C" int repro_bucket_scatter(const void* words, const void* dests,
                                    const void* guids, void* data,
                                    void* gout, void* counts, int batch,
                                    int64_t n, int n_dest, int capacity,
                                    void* stream) {
  if (batch == 0 || n_dest == 0) return 0;
  const dim3 grid(n_dest, batch);
  bucket_scatter_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(dests),
      static_cast<const int32_t*>(guids), static_cast<int32_t*>(data),
      static_cast<int32_t*>(gout), static_cast<int32_t*>(counts), n, n_dest,
      capacity);
  return static_cast<int>(cudaGetLastError());
}
