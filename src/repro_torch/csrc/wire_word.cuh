// The 64-bit spike wire word's bit layout, shared by the codec kernels
// (wire_codec.cu), the flush window's encode (flush_window.cu) and
// placement's encode epilogue (placement.cu), so the layout is written
// once.
//
// A 30-bit event word (ts 15, address 14, valid 1) and a 32-bit meta value
// become one 64-bit wire word held as two u32 lanes (lo, hi), fields
// LSB-first: ts, label, meta, valid.  With the default widths meta starts
// at bit 29 and straddles the lane boundary.  The field code mirrors
// _deposit / _extract of src/repro/wire/codec.py (:92-117) with the widths
// as run-time arguments; every shift count stays below 32.
#pragma once

#include <cstdint>

namespace repro_wire {

constexpr uint32_t kTsBits = 15;
constexpr uint32_t kTsMask = (1u << 15) - 1;
constexpr uint32_t kAddrMask = (1u << 14) - 1;

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

// Field widths of the wire word (WireWordFormat).
struct Format {
  int ts_bits, label_bits, meta_bits;
};

// Event word w + meta m -> the wire word's (lo, hi) lanes.  A zero word
// with zero meta encodes to (0, 0).
__device__ __forceinline__ void encode(uint32_t w, uint32_t m, Format f,
                                       uint32_t& lo, uint32_t& hi) {
  const uint32_t ts = w & (kTsMask & mask_of(f.ts_bits));
  const uint32_t label = (w >> kTsBits) & (kAddrMask & mask_of(f.label_bits));
  const uint32_t valid = (w >> 29) & 1u;
  lo = 0;
  hi = 0;
  deposit(lo, hi, ts, 0, f.ts_bits);
  deposit(lo, hi, label, f.ts_bits, f.label_bits);
  deposit(lo, hi, m & mask_of(f.meta_bits), f.ts_bits + f.label_bits,
          f.meta_bits);
  deposit(lo, hi, valid, f.ts_bits + f.label_bits + f.meta_bits, 1);
}

// Inverse of encode -> event word w and meta m.
__device__ __forceinline__ void decode(uint32_t lo, uint32_t hi, Format f,
                                       uint32_t& w, uint32_t& m) {
  const int valid_bit = f.ts_bits + f.label_bits + f.meta_bits;
  const uint32_t ts = extract(lo, hi, 0, f.ts_bits) & kTsMask;
  const uint32_t label = extract(lo, hi, f.ts_bits, f.label_bits) & kAddrMask;
  const uint32_t valid = extract(lo, hi, valid_bit, 1);
  m = extract(lo, hi, f.ts_bits + f.label_bits, f.meta_bits);
  w = ts | (label << kTsBits) | (valid << 29);
}

}  // namespace repro_wire
