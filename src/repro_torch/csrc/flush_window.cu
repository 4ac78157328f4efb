// The flush window of the fused route+aggregate stage in one launch, for
// Hopper (sm_90a): route, per-destination rank, bucket placement, the
// wire encode and the residue of every shard's window.
//
// Replaces the TPU kernel src/repro/kernels/fused_route_bucket.py:
// _place_kernel (:81) and _place_route_kernel (:94), launched by
// _placement_pallas (:110, pl.pallas_call at :122), together with the
// stage around it that the reference leaves to XLA (the destination
// gather of fused_route_aggregate, the stable sort, the run edges and the
// residue of _finish, :166-229), and the codec's encode
// (src/repro/wire/codec.py: _encode_kernel, :153) of the placed rows.
//
// What it computes, per window b (one row of the batch) of n events, bit
// for bit what the reference's fused_aggregate / fused_route_aggregate
// return:
// * route: the destination of event i is dest[b, i], or with a
//   destination table dest_lut[min(address(w), n_lut - 1)]; the event is
//   valid when its valid bit is set and its destination lies in [0, D);
// * rank: k, its rank among the valid events of its destination in window
//   order (dest_rank.cuh);
// * place: k < C puts the word and its meta into slot k of the
//   destination's row: meta[b, i], or with a GUID table
//   guid_lut[min(address(w), n_guid - 1)]; slots from min(count, C) to C
//   are zero;
// * encode: with a payload, every slot, live or dead, is also stored as
//   its 64-bit wire word (wire_word.cuh): lo at [row, slot], hi at
//   [row, C + slot]; a dead slot is (0, 0);
// * residue: k >= C gives the residue position ovf_base[d] + (k - C),
//   ovf_base[d] = sum over d' < d of max(count[d'] - C, 0): the residue
//   is destination-major, as the reference's stable sort of the overflow
//   flag over the destination-sorted window leaves it.  It is written if
//   the position is below r = min(residue_len, n), with its meta when
//   residue_meta is given and its destination d when residue_dest is
//   given (the source address layout, whose words do not name their
//   destination); positions from deferred to residue_len are zero;
// * scalars: counts = min(count, C); offered, overflow, deferred =
//   min(overflow, r), dropped = overflow - deferred.
//
// Bound on an H100 (3.35 TB/s): bytes.  At the crossbar's shape (4
// windows of 4,352 events, D 4, C 1,024, residue 256) the function reads
// the words and meta (139 KB) and the table entries they address, and
// writes rows, metas and payload (262 KB): about 0.12 us, far below a
// launch, so the design is about doing the whole stage in one launch: the
// chain it replaces (route, stable sort, gathers, searchsorted, pads,
// per-row placement, a second sort for the residue, reductions) is ~40
// device functions.
//
// Design: one cluster per window ranks it (dest_rank.cuh: pass 1, the
// window staged in shared memory by cp.async and read from device memory
// once); pass 2 places every event of the block's chunk from shared
// memory, looks the GUID up for accepted events only and encodes the slot
// in registers; the dead slots and the residue's tail are split over the
// cluster's blocks; block 0 of the cluster writes the counts and
// scalars.  All windows go into one launch (grid: cluster x batch).
#include <cstdint>
#include <cuda_runtime.h>

#include "dest_rank.cuh"
#include "wire_word.cuh"

namespace {

namespace rk = repro_rank;

struct Args {
  const uint32_t* words;     // (B, n)
  const int32_t* dest;       // (B, n) destination per event, or null
  const int32_t* dest_lut;   // (B or 1, n_lut) destination per address
  const int32_t* meta;       // (B, n) meta per event, or null
  const int32_t* guid_lut;   // (B or 1, n_guid) meta per address
  uint32_t* data;            // (B, D, C)
  int32_t* meta_out;         // (B, D, C)
  uint32_t* payload;         // (B, D, 2C), or null: no encode
  int32_t* counts;           // (B, D)
  uint32_t* residue;         // (B, R)
  int32_t* residue_meta;     // (B, R), or null
  int32_t* residue_dest;     // (B, R), or null
  int32_t* scalars;          // (4, B): offered, overflow, deferred, dropped
  int64_t n, n_lut, lut_stride, n_guid, guid_stride, residue_len, chunk;
  int n_dest, capacity;
  repro_wire::Format fmt;
};

__device__ __forceinline__ int64_t address(uint32_t w) {
  return (w >> repro_wire::kTsBits) & repro_wire::kAddrMask;
}

__global__ void __launch_bounds__(rk::kThreads)
flush_window_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int offered, overflow;
  const int D = a.n_dest;
  const int C = a.capacity;
  const int64_t b = blockIdx.y;
  const int64_t batch = gridDim.y;
  const rk::Chunk c = rk::my_chunk(a.n, a.chunk);
  const rk::Shared sh = rk::carve(smem, D);
  uint32_t* s_words = sh.key + a.chunk;
  int32_t* s_meta = reinterpret_cast<int32_t*>(s_words + a.chunk);
  const uint32_t* words = a.words + b * a.n;
  const int32_t* dest = a.dest ? a.dest + b * a.n : nullptr;
  const int32_t* meta = a.meta ? a.meta + b * a.n : nullptr;
  const int32_t* dest_lut = a.dest_lut ? a.dest_lut + b * a.lut_stride
                                       : nullptr;
  const int32_t* guid_lut = a.guid_lut ? a.guid_lut + b * a.guid_stride
                                       : nullptr;

  // pass 1: stage and rank (the destination, if per event, lands in key)
  rk::rank_chunk(
      c, D, sh,
      [&](int64_t g, int64_t l) {
        rk::cp_async4(s_words + l, words + g);
        if (dest) rk::cp_async4(sh.key + l, dest + g);
        if (meta) rk::cp_async4(s_meta + l, meta + g);
      },
      [&](int64_t l) -> int {
        const uint32_t w = s_words[l];
        if (!((w >> 29) & 1u)) return -1;
        const int d = dest_lut ? dest_lut[min(address(w), a.n_lut - 1)]
                               : static_cast<int>(sh.key[l]);
        return d >= 0 && d < D ? d : -1;
      });
  rk::cluster_bases(c, D, sh);

  // residue bases, offered and overflow: one warp scans the totals
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (D + 31) / 32;
    int seg = 0, seg_tot = 0;
    for (int j = 0; j < per; ++j) {
      const int d = lane * per + j;
      if (d < D) {
        seg += max(sh.tot[d] - C, 0);
        seg_tot += sh.tot[d];
      }
    }
    int incl = seg;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - seg;
    for (int j = 0; j < per; ++j) {
      const int d = lane * per + j;
      if (d < D) {
        sh.ovf[d] = run;
        run += max(sh.tot[d] - C, 0);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      seg_tot += __shfl_xor_sync(0xFFFFFFFFu, seg_tot, off);
    if (lane == 31) overflow = incl;
    if (lane == 0) offered = seg_tot;
  }
  __syncthreads();

  // pass 2: place, encode, defer
  const int64_t R = a.residue_len;
  const int64_t r = min(R, a.n);
  for (int64_t l = threadIdx.x; l < c.len; l += rk::kThreads) {
    const uint32_t key = sh.key[l];
    if (key == rk::kNone) continue;
    const int d = static_cast<int>(key >> rk::kRankBits);
    const int64_t k = sh.base[d] + static_cast<int64_t>(key & rk::kRankMask);
    const uint32_t w = s_words[l];
    if (k < C) {
      const int32_t m = guid_lut ? guid_lut[min(address(w), a.n_guid - 1)]
                                 : s_meta[l];
      const int64_t row = b * D + d;
      a.data[row * C + k] = w;
      a.meta_out[row * C + k] = m;
      if (a.payload) {
        uint32_t lo, hi;
        repro_wire::encode(w, static_cast<uint32_t>(m), a.fmt, lo, hi);
        a.payload[row * 2 * C + k] = lo;
        a.payload[row * 2 * C + C + k] = hi;
      }
    } else {
      const int64_t pos = sh.ovf[d] + (k - C);
      if (pos < r) {
        a.residue[b * R + pos] = w;
        if (a.residue_meta) a.residue_meta[b * R + pos] = s_meta[l];
        if (a.residue_dest) a.residue_dest[b * R + pos] = d;
      }
    }
  }

  // dead slots and the residue's tail, split over the cluster's blocks
  const int stride = static_cast<int>(c.blocks) * rk::kThreads;
  const int first = static_cast<int>(c.rank) * rk::kThreads + threadIdx.x;
  for (int j = first; j < D * C; j += stride) {   // D * C < 2^31
    const int d = j / C;
    const int s = j - d * C;
    if (s >= sh.tot[d]) {
      const int64_t row = b * D + d;
      a.data[row * C + s] = 0;
      a.meta_out[row * C + s] = 0;
      if (a.payload) {
        a.payload[row * 2 * C + s] = 0;
        a.payload[row * 2 * C + C + s] = 0;
      }
    }
  }
  const int64_t deferred = min(static_cast<int64_t>(overflow), r);
  for (int64_t p = deferred + first; p < R; p += stride) {
    a.residue[b * R + p] = 0;
    if (a.residue_meta) a.residue_meta[b * R + p] = 0;
    if (a.residue_dest) a.residue_dest[b * R + p] = 0;
  }
  if (c.rank == 0) {
    for (int d = threadIdx.x; d < D; d += rk::kThreads)
      a.counts[b * D + d] = min(sh.tot[d], C);
    if (threadIdx.x == 0) {
      a.scalars[b] = offered;
      a.scalars[batch + b] = overflow;
      a.scalars[2 * batch + b] = static_cast<int32_t>(deferred);
      a.scalars[3 * batch + b] = overflow - static_cast<int32_t>(deferred);
    }
  }
  rk::finish();
}

}  // namespace

// The longest window the ranker takes with `arrays` 4-byte values staged
// per event (the wrappers raise above it).
extern "C" int64_t repro_rank_max_window(int n_dest, int arrays) {
  return repro_rank::max_window(n_dest, arrays);
}

extern "C" int repro_flush_window(
    const void* words, const void* dest, const void* dest_lut,
    const void* meta, const void* guid_lut, void* data, void* meta_out,
    void* payload, void* counts, void* residue, void* residue_meta,
    void* residue_dest, void* scalars, int batch, int64_t n, int n_dest,
    int capacity, int64_t residue_len, int64_t n_lut, int64_t lut_stride,
    int64_t n_guid, int64_t guid_stride, int ts_bits, int label_bits,
    int meta_bits, void* stream) {
  if (batch == 0) return 0;
  // The wrapper passes one of dest and dest_lut and one of meta and
  // guid_lut; a per-event operand of an empty window has no storage
  // (null), and the kernel then reads nothing of it.
  const int arrays = meta ? 3 : 2;       // key, word (, meta)
  if (n_dest < 1 || n_dest > rk::kMaxDest ||
      n > rk::max_window(n_dest, arrays))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.words = static_cast<const uint32_t*>(words);
  a.dest = static_cast<const int32_t*>(dest);
  a.dest_lut = static_cast<const int32_t*>(dest_lut);
  a.meta = static_cast<const int32_t*>(meta);
  a.guid_lut = static_cast<const int32_t*>(guid_lut);
  a.data = static_cast<uint32_t*>(data);
  a.meta_out = static_cast<int32_t*>(meta_out);
  a.payload = static_cast<uint32_t*>(payload);
  a.counts = static_cast<int32_t*>(counts);
  a.residue = static_cast<uint32_t*>(residue);
  a.residue_meta = static_cast<int32_t*>(residue_meta);
  a.residue_dest = static_cast<int32_t*>(residue_dest);
  a.scalars = static_cast<int32_t*>(scalars);
  a.n = n;
  a.n_lut = n_lut;
  a.lut_stride = lut_stride;
  a.n_guid = n_guid;
  a.guid_stride = guid_stride;
  a.residue_len = residue_len;
  a.chunk = rk::chunk_of(n);
  a.n_dest = n_dest;
  a.capacity = capacity;
  a.fmt = repro_wire::Format{ts_bits, label_bits, meta_bits};
  return static_cast<int>(rk::launch(flush_window_kernel, n, batch,
                                     rk::smem_bytes(n, n_dest, arrays),
                                     static_cast<cudaStream_t>(stream), a));
}
