// 64-bit spike wire-word codec, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/wire/codec.py: _encode_kernel (:153)
// and _decode_kernel (:159), launched by _pallas_map2 (:165,
// pl.pallas_call at :172).
//
// What it computes: encode packs a 30-bit event word (ts 15, address 14,
// valid 1) and a 32-bit meta value into one 64-bit wire word held as two
// u32 lanes (lo, hi), fields LSB-first: ts, label, meta, valid.  With the
// default widths meta starts at bit 29 and straddles the lane boundary.
// Decode is the inverse.  The field code mirrors _deposit / _extract
// (codec.py:92-117) with the widths as run-time arguments; every shift
// count stays below 32.  Rows are lane-planar: a (rows, C) input maps to a
// (rows, 2C) buffer whose first C lanes are lo and last C lanes are hi, so
// the wrapper needs no concatenation around the kernel.  Decode also takes
// the distance between input rows, so it reads the payload columns of the
// exchange's packed (S, S, 2C + 1) buffer in place.
//
// Bound on an H100 (3.35 TB/s): bytes.  Each word reads 8 B and writes
// 8 B per direction.  At the simulator's full width one exchange codes
// S x S x C = 4 x 4 x 1024 = 16,384 words: 262 KB per direction, about
// 0.08 us of memory time, far below one launch.
//
// Design: one thread per word with a grid-stride loop; consecutive
// threads touch consecutive words of each lane, so loads and stores are
// coalesced.  Nothing else is worth doing at this size: the launch
// dominates, and fusing the codec with the exchange is a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTsMask = (1u << 15) - 1;
constexpr uint32_t kAddrMask = (1u << 14) - 1;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mask_of(int width) {
  return width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
}

__device__ __forceinline__ void deposit(uint32_t& lo, uint32_t& hi,
                                        uint32_t v, int offset, int width) {
  if (width == 0) return;
  if (offset < 32) {
    lo |= v << offset;
    if (offset + width > 32) hi |= v >> (32 - offset);  // offset >= 1 here
  } else {
    hi |= v << (offset - 32);
  }
}

__device__ __forceinline__ uint32_t extract(uint32_t lo, uint32_t hi,
                                            int offset, int width) {
  if (width == 0) return 0;
  uint32_t v;
  if (offset < 32) {
    v = lo >> offset;
    if (offset + width > 32) v |= hi << (32 - offset);
  } else {
    v = hi >> (offset - 32);
  }
  return v & mask_of(width);
}

__global__ void encode_kernel(const uint32_t* __restrict__ word,
                              const uint32_t* __restrict__ meta,
                              uint32_t* __restrict__ out, int64_t n,
                              int cols, int ts_bits, int label_bits,
                              int meta_bits) {
  const int valid_bit = ts_bits + label_bits + meta_bits;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint32_t w = word[i];
    const uint32_t ts = w & (kTsMask & mask_of(ts_bits));
    const uint32_t label = (w >> 15) & (kAddrMask & mask_of(label_bits));
    const uint32_t valid = (w >> 29) & 1u;
    const uint32_t m = meta[i] & mask_of(meta_bits);
    uint32_t lo = 0, hi = 0;
    deposit(lo, hi, ts, 0, ts_bits);
    deposit(lo, hi, label, ts_bits, label_bits);
    deposit(lo, hi, m, ts_bits + label_bits, meta_bits);
    deposit(lo, hi, valid, valid_bit, 1);
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
                              int cols, int ts_bits, int label_bits,
                              int meta_bits) {
  const int valid_bit = ts_bits + label_bits + meta_bits;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / cols;
    const int64_t j = i - r * cols;
    const uint32_t lo = buf[r * row_stride + j];
    const uint32_t hi = buf[r * row_stride + cols + j];
    const uint32_t ts = extract(lo, hi, 0, ts_bits) & kTsMask;
    const uint32_t label = extract(lo, hi, ts_bits, label_bits) & kAddrMask;
    const uint32_t valid = extract(lo, hi, valid_bit, 1);
    meta[i] = extract(lo, hi, ts_bits + label_bits, meta_bits);
    word[i] = ts | (label << 15) | (valid << 29);
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
      static_cast<uint32_t*>(out), n, cols, ts_bits, label_bits, meta_bits);
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
      static_cast<uint32_t*>(word),
      static_cast<uint32_t*>(meta), n, cols, ts_bits, label_bits, meta_bits);
  return static_cast<int>(cudaGetLastError());
}
