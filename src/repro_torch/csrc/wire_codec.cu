// 64-bit spike wire-word codec, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/wire/codec.py: _encode_kernel (:153)
// and _decode_kernel (:159), launched by _pallas_map2 (:165,
// pl.pallas_call at :172).
//
// What it computes: encode packs a 30-bit event word and a 32-bit meta
// value into one 64-bit wire word held as two u32 lanes (lo, hi); decode
// is the inverse.  The bit layout lives in wire_word.cuh, which the flush
// window (flush_window.cu) and placement (placement.cu) share for their
// encode.  Rows are lane-planar: a
// (rows, C) input maps to a (rows, 2C) buffer whose first C lanes are lo
// and last C lanes are hi, so the wrapper needs no concatenation around
// the kernel.  Decode also takes the distance between input rows, so it
// reads the payload columns of the exchange's packed (S, S, 2C + 1)
// buffer in place.
//
// Bound on an H100 (3.35 TB/s): bytes.  Each word reads 8 B and writes
// 8 B per direction.  At the simulator's full width one exchange codes
// S x S x C = 4 x 4 x 1024 = 16,384 words: 262 KB per direction, about
// 0.08 us of memory time, far below one launch.
//
// Design: one thread per word with a grid-stride loop; consecutive
// threads touch consecutive words of each lane, so loads and stores are
// coalesced.  The launch dominates, so the simulator and the fused
// exchange encode inside the flush window's launch (the rows it has just
// placed) and launch only the decode; this standalone encode serves every
// other caller.
#include <cstdint>
#include <cuda_runtime.h>

#include "wire_word.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void encode_kernel(const uint32_t* __restrict__ word,
                              const uint32_t* __restrict__ meta,
                              uint32_t* __restrict__ out, int64_t n,
                              int cols, repro_wire::Format fmt) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t lo, hi;
    repro_wire::encode(word[i], meta[i], fmt, lo, hi);
    const int64_t r = i / cols;
    const int64_t j = i - r * cols;
    out[2 * r * cols + j] = lo;
    out[2 * r * cols + cols + j] = hi;
  }
}

__global__ void decode_kernel(const uint32_t* __restrict__ buf,
                              int64_t row_stride,
                              uint32_t* __restrict__ word,
                              uint32_t* __restrict__ meta, int64_t n,
                              int cols, repro_wire::Format fmt) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / cols;
    const int64_t j = i - r * cols;
    repro_wire::decode(buf[r * row_stride + j], buf[r * row_stride + cols + j],
                       fmt, word[i], meta[i]);
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 65535 ? b : 65535);
}

}  // namespace

extern "C" int repro_wire_encode(const void* word, const void* meta,
                                 void* out, int64_t rows, int cols,
                                 int ts_bits, int label_bits, int meta_bits,
                                 void* stream) {
  const int64_t n = rows * cols;
  if (n == 0) return 0;
  encode_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(word), static_cast<const uint32_t*>(meta),
      static_cast<uint32_t*>(out), n, cols,
      repro_wire::Format{ts_bits, label_bits, meta_bits});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_wire_decode(const void* buf, int64_t row_stride,
                                 void* word, void* meta,
                                 int64_t rows, int cols, int ts_bits,
                                 int label_bits, int meta_bits,
                                 void* stream) {
  const int64_t n = rows * cols;
  if (n == 0) return 0;
  decode_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), row_stride,
      static_cast<uint32_t*>(word), static_cast<uint32_t*>(meta), n, cols,
      repro_wire::Format{ts_bits, label_bits, meta_bits});
  return static_cast<int>(cudaGetLastError());
}
