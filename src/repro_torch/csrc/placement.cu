// Bucket placement of the fused route+aggregate window, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_route_bucket.py:
// _place_kernel (:81) and _place_route_kernel (:94), launched by
// _placement_pallas (:110, pl.pallas_call at :122).
//
// What it computes, per (batch b, destination d) bucket row: the row is a
// slice of the destination-sorted window starting at first[b, d]; slot j
// is live when j < min(counts[b, d], C).  Live slots copy the sorted word
// and its meta (ROUTED = false: per-event meta sorted with the words) or
// the GUID looked up from the word's address (ROUTED = true:
// lut[min(addr, n_lut - 1)]); dead slots are zero.  Words are u32 bit
// patterns of the int32 tensors the wrapper passes.
//
// Bound on an H100 (3.35 TB/s): bytes.  A row reads its 2 int32 indices
// and at most C words + C metas, and writes C words + C metas.  At the
// simulator's full width (S = 4 shards x D = 4 destinations x C = 1024)
// that is at most 16,384 slots x 16 B = 262 KB, about 0.08 us of memory
// time, so a launch (a few microseconds) costs far more than the work.
//
// Design: one block per bucket row, threads stride over the C slots, so
// neighbouring threads read neighbouring words of the sorted window and
// write neighbouring slots (coalesced both ways).  Rows of every shard go
// into one launch (the grid is batch x D), which is all the kernel can do
// about launch latency; fusing it with the sort around it, or capturing
// the window in a CUDA graph, is left to a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTsBits = 15;
constexpr uint32_t kAddrMask = (1u << 14) - 1;

template <bool ROUTED>
__global__ void place_kernel(const int32_t* __restrict__ first,
                             const int32_t* __restrict__ counts,
                             const uint32_t* __restrict__ swords,
                             const int32_t* __restrict__ aux,
                             uint32_t* __restrict__ data,
                             int32_t* __restrict__ meta, int n_dest,
                             int capacity, int64_t n_pad, int64_t n_aux) {
  const int64_t row = blockIdx.x;  // b * n_dest + d
  const int64_t b = row / n_dest;
  const int64_t start = first[row];
  const int live = min(counts[row], capacity);
  const uint32_t* words = swords + b * n_pad + start;
  const int32_t* aux_b = aux + b * n_aux;
  uint32_t* data_row = data + row * capacity;
  int32_t* meta_row = meta + row * capacity;
  for (int slot = threadIdx.x; slot < capacity; slot += blockDim.x) {
    uint32_t w = 0;
    int32_t g = 0;
    if (slot < live) {
      w = words[slot];
      if (ROUTED) {
        const int64_t addr = (w >> kTsBits) & kAddrMask;
        g = aux_b[min(addr, n_aux - 1)];
      } else {
        g = aux_b[start + slot];
      }
    }
    data_row[slot] = w;
    meta_row[slot] = g;
  }
}

}  // namespace

extern "C" int repro_placement(const void* first, const void* counts,
                               const void* swords, const void* aux,
                               void* data, void* meta, int batch, int n_dest,
                               int capacity, int64_t n_pad, int64_t n_aux,
                               int routed, void* stream) {
  const int rows = batch * n_dest;
  if (rows == 0 || capacity == 0) return 0;
  const int threads = capacity >= 256 ? 256 : ((capacity + 31) / 32) * 32;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = static_cast<const int32_t*>(first);
  auto c = static_cast<const int32_t*>(counts);
  auto w = static_cast<const uint32_t*>(swords);
  auto a = static_cast<const int32_t*>(aux);
  auto d = static_cast<uint32_t*>(data);
  auto m = static_cast<int32_t*>(meta);
  if (routed) {
    place_kernel<true><<<rows, threads, 0, s>>>(f, c, w, a, d, m, n_dest,
                                                capacity, n_pad, n_aux);
  } else {
    place_kernel<false><<<rows, threads, 0, s>>>(f, c, w, a, d, m, n_dest,
                                                 capacity, n_pad, n_aux);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
