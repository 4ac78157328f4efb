// Bucket placement of the fused route+aggregate window, for Hopper (sm_90a),
// with the wire codec's encode as an optional epilogue.
//
// Replaces the TPU kernel src/repro/kernels/fused_route_bucket.py:
// _place_kernel (:81) and _place_route_kernel (:94), launched by
// _placement_pallas (:110, pl.pallas_call at :122); with ENCODE it also
// does the work of the codec's encode (src/repro/wire/codec.py:
// _encode_kernel, :153) on the rows it has just placed.
//
// What it computes, per (batch b, destination d) bucket row: the row is a
// slice of the destination-sorted window starting at first[b, d]; slot j
// is live when j < min(counts[b, d], C).  Live slots copy the sorted word
// and its meta (ROUTED = false: per-event meta sorted with the words) or
// the GUID looked up from the word's address (ROUTED = true:
// lut[min(addr, n_lut - 1)]); dead slots are zero.  Words are u32 bit
// patterns of the int32 tensors the wrapper passes.  With ENCODE every
// slot's (word, meta) is also stored as its 64-bit wire word in the
// lane-planar payload row: lo at [row, slot], hi at [row, C + slot], the
// bit layout of wire_word.cuh (a dead slot encodes to (0, 0)).
//
// Bound on an H100 (3.35 TB/s): bytes.  A row reads its 2 int32 indices
// and at most C words + C metas, and writes C words + C metas (+ 2C
// payload lanes with ENCODE).  At the simulator's full width (S = 4 shards
// x D = 4 destinations x C = 1024) that is at most 16,384 slots x 16 B =
// 262 KB, about 0.08 us of memory time (+131 KB, +0.04 us, with ENCODE),
// so a launch (a few microseconds) costs far more than the work.
//
// Design: one block per bucket row, threads stride over the C slots, so
// neighbouring threads read neighbouring words of the sorted window and
// write neighbouring slots (coalesced both ways).  Rows of every shard go
// into one launch (the grid is batch x D).  The encode runs on the word
// and meta already in registers, so the simulator's and the exchange's
// encode costs 8 B of stores a slot instead of a launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "wire_word.cuh"

namespace {

template <bool ROUTED, bool ENCODE>
__global__ void place_kernel(const int32_t* __restrict__ first,
                             const int32_t* __restrict__ counts,
                             const uint32_t* __restrict__ swords,
                             const int32_t* __restrict__ aux,
                             uint32_t* __restrict__ data,
                             int32_t* __restrict__ meta,
                             uint32_t* __restrict__ payload, int n_dest,
                             int capacity, int64_t n_pad, int64_t n_aux,
                             repro_wire::Format fmt) {
  const int64_t row = blockIdx.x;  // b * n_dest + d
  const int64_t b = row / n_dest;
  const int64_t start = first[row];
  const int live = min(counts[row], capacity);
  const uint32_t* words = swords + b * n_pad + start;
  const int32_t* aux_b = aux + b * n_aux;
  uint32_t* data_row = data + row * capacity;
  int32_t* meta_row = meta + row * capacity;
  uint32_t* lanes = ENCODE ? payload + 2 * row * capacity : nullptr;
  for (int slot = threadIdx.x; slot < capacity; slot += blockDim.x) {
    uint32_t w = 0;
    int32_t g = 0;
    if (slot < live) {
      w = words[slot];
      if (ROUTED) {
        const int64_t addr = (w >> repro_wire::kTsBits) &
                             repro_wire::kAddrMask;
        g = aux_b[min(addr, n_aux - 1)];
      } else {
        g = aux_b[start + slot];
      }
    }
    data_row[slot] = w;
    meta_row[slot] = g;
    if (ENCODE) {
      uint32_t lo, hi;
      repro_wire::encode(w, static_cast<uint32_t>(g), fmt, lo, hi);
      lanes[slot] = lo;
      lanes[capacity + slot] = hi;
    }
  }
}

}  // namespace

extern "C" int repro_placement(const void* first, const void* counts,
                               const void* swords, const void* aux,
                               void* data, void* meta, void* payload,
                               int batch, int n_dest, int capacity,
                               int64_t n_pad, int64_t n_aux, int routed,
                               int ts_bits, int label_bits, int meta_bits,
                               void* stream) {
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
  auto p = static_cast<uint32_t*>(payload);  // null: no encode
  const repro_wire::Format fmt{ts_bits, label_bits, meta_bits};
  if (routed && p) {
    place_kernel<true, true><<<rows, threads, 0, s>>>(
        f, c, w, a, d, m, p, n_dest, capacity, n_pad, n_aux, fmt);
  } else if (routed) {
    place_kernel<true, false><<<rows, threads, 0, s>>>(
        f, c, w, a, d, m, p, n_dest, capacity, n_pad, n_aux, fmt);
  } else if (p) {
    place_kernel<false, true><<<rows, threads, 0, s>>>(
        f, c, w, a, d, m, p, n_dest, capacity, n_pad, n_aux, fmt);
  } else {
    place_kernel<false, false><<<rows, threads, 0, s>>>(
        f, c, w, a, d, m, p, n_dest, capacity, n_pad, n_aux, fmt);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
