// Per-destination ranking of a window of events in window order, for
// Hopper (sm_90a): the core shared by the flush-window kernel
// (flush_window.cu, kernel A's stage) and the legacy binning
// (bucket_scatter.cu, kernel D).
//
// For every event of a window it gives the event's destination (or none:
// the caller's dest_of returns -1 for an invalid event), its rank among the
// events of the same destination in window order, and the window's
// per-destination totals.  Slots, residue positions and counts follow
// from those three.
//
// Design:
//
// * One thread-block cluster per window.  Block r of the cluster takes the
//   contiguous chunk [r * chunk, (r + 1) * chunk) of the window.  The
//   cluster size follows n (cluster_blocks): a block ranks its chunk tile
//   by tile, 512 events a tile with two block barriers each, and that
//   serial chain is what a wider cluster shortens.  A window of one tile
//   takes one block; a longer one is split over 8 blocks (the portable
//   cluster size), so the paths' windows (4,096 to 16,640 events) take 1
//   to 5 tiles a block.  The cluster's own cost, two cluster barriers and
//   8 x D distributed-shared-memory reads issued together, is less than
//   the tiles it saves: on an H100 a window of 4,096 events ranked faster
//   over 8 blocks than over 4.
// * Per-chunk counts, then bases.  A block counts its chunk per
//   destination in shared memory (cnt), then cluster.sync(); it reads the
//   counts of the lower-ranked blocks through distributed shared memory
//   (map_shared_rank), which gives its base for each destination, and the
//   totals come from the same reads.
// * Ranks in window order within a chunk: __match_any_sync on the
//   destination and __popc(peers & lanes_below) inside a warp, a warps x D
//   table of per-warp counts in shared memory scanned across warps, and a
//   running base per destination from tile to tile.  No atomic decides a
//   slot, so window order is kept exactly.
// * The window is read from device memory once: the caller's stage()
//   copies an event's operands into the block's shared-memory chunk with
//   cp.async, tile t + 1 in flight while tile t is ranked; the placement
//   pass reads them from there.
// * A block must not exit while another block of its cluster may still
//   read its shared memory: the kernels end with finish(), a
//   cluster.sync().
//
// Limits: D <= kMaxDest = 256 (the destination takes the key's top 8
// bits, and the two warps x D tables take 2 x 16 x D ints); a chunk holds
// at most what the shared memory that remains takes (max_window below).
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_rank {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;             // one tile of events
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;            // portable cluster size
constexpr int kMaxDest = 256;
constexpr int kRankBits = 24;             // key = dest << 24 | rank
constexpr uint32_t kRankMask = (1u << kRankBits) - 1u;
constexpr uint32_t kNone = 0xFFFFFFFFu;   // key of an event of no row
constexpr int64_t kMaxSmem = 232448;      // shared memory a block can use

// Blocks of the cluster that ranks a window of n events (see above).
// Every window of the batch gets the same cluster size.
inline int cluster_blocks(int64_t n) {
  return n <= kThreads ? 1 : kMaxCluster;
}

inline int64_t chunk_of(int64_t n) {
  const int blocks = cluster_blocks(n);
  return (n + blocks - 1) / blocks;
}

// Shared memory of the tables: tab and pre (warps x D), cnt, base, tot
// and ovf (D each).
inline int64_t table_bytes(int n_dest) {
  return static_cast<int64_t>(sizeof(int)) * (2 * kWarps + 4) * n_dest;
}

// Shared memory of a block for a window of n events, with `arrays` 4-byte
// values staged per event (the key included).
inline int64_t smem_bytes(int64_t n, int n_dest, int arrays) {
  return table_bytes(n_dest) + 4 * arrays * chunk_of(n);
}

// The longest window a cluster ranks with `arrays` values per event.
inline int64_t max_window(int n_dest, int arrays) {
  const int64_t chunk = (kMaxSmem - table_bytes(n_dest)) / (4 * arrays);
  return chunk < 0 ? 0 : chunk * kMaxCluster;
}

// The block's view of its shared memory: the tables, then the chunk's keys
// (the staged per-event destination until it is ranked).
struct Shared {
  int* tab;        // kWarps x D: per-warp counts of the current tile
  int* pre;        // kWarps x D: each warp's base in the chunk
  int* cnt;        // D: the chunk's running count, then its total
  int* base;       // D: events of lower-ranked blocks
  int* tot;        // D: the window's totals
  int* ovf;        // D: free for the caller (flush_window: residue bases)
  uint32_t* key;   // chunk
};

__device__ __forceinline__ Shared carve(unsigned char* smem, int n_dest) {
  int* p = reinterpret_cast<int*>(smem);
  Shared sh;
  sh.tab = p;
  sh.pre = p + kWarps * n_dest;
  sh.cnt = p + 2 * kWarps * n_dest;
  sh.base = sh.cnt + n_dest;
  sh.tot = sh.base + n_dest;
  sh.ovf = sh.tot + n_dest;
  sh.key = reinterpret_cast<uint32_t*>(sh.ovf + n_dest);
  return sh;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This block's chunk [lo, lo + len) of the window (a view of the
// cluster's split).
struct Chunk {
  int64_t lo, len;
  unsigned rank, blocks;
};

__device__ __forceinline__ Chunk my_chunk(int64_t n, int64_t chunk) {
  const cg::cluster_group cluster = cg::this_cluster();
  Chunk c;
  c.rank = cluster.block_rank();
  c.blocks = cluster.num_blocks();
  c.lo = min(n, static_cast<int64_t>(c.rank) * chunk);
  c.len = min(n, c.lo + chunk) - c.lo;
  return c;
}

// Stage and rank the block's chunk.  stage(g, l) issues the cp.async
// copies of event g of the window into chunk slot l (the destination, if
// per event, into key[l]); dest_of(l) is the event's destination in
// [0, D) or -1, called by the thread that staged slot l once its copies
// landed.  On return key[l] = dest << 24 | rank within the chunk (kNone
// for no row), cnt[d] the chunk's count of d, and every staged value is
// visible to the whole block.
template <class Stage, class DestOf>
__device__ void rank_chunk(const Chunk& c, int n_dest, const Shared& sh,
                           Stage stage, DestOf dest_of) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = tid; i < kWarps * n_dest; i += kThreads) sh.tab[i] = 0;
  for (int d = tid; d < n_dest; d += kThreads) sh.cnt[d] = 0;
  const int64_t tiles = (c.len + kThreads - 1) / kThreads;
  if (tid < c.len) stage(c.lo + tid, tid);
  cp_async_commit();
  __syncthreads();                      // tables zeroed
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t i = t * kThreads + tid;
    const int64_t next = i + kThreads;
    if (next < c.len) stage(c.lo + next, next);
    cp_async_commit();                  // tile t + 1 in flight
    cp_async_wait<1>();                 // this thread's tile-t copies landed
    const int d = i < c.len ? dest_of(i) : -1;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const unsigned below = peers & lanes_below;
    if (d >= 0 && below == 0) sh.tab[warp * n_dest + d] = __popc(peers);
    __syncthreads();                    // per-warp counts of tile t
    for (int dd = tid; dd < n_dest; dd += kThreads) {
      int run = sh.cnt[dd];
      for (int w = 0; w < kWarps; ++w) {
        const int k = w * n_dest + dd;
        const int v = sh.tab[k];
        sh.pre[k] = run;
        sh.tab[k] = 0;                  // zeroed for tile t + 1
        run += v;
      }
      sh.cnt[dd] = run;
    }
    __syncthreads();                    // pre and cnt of tile t
    if (i < c.len) {
      sh.key[i] = d < 0 ? kNone
                        : (static_cast<uint32_t>(d) << kRankBits) |
                              static_cast<uint32_t>(sh.pre[warp * n_dest + d] +
                                                    __popc(below));
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // keys and staged values visible
}

// Bases and totals from the cluster's chunk counts: base[d] the events of
// d in lower-ranked blocks, tot[d] the window's.
__device__ __forceinline__ void cluster_bases(const Chunk& c, int n_dest,
                                              const Shared& sh) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                       // every block's cnt is final
  for (int d = threadIdx.x; d < n_dest; d += kThreads) {
    int v[kMaxCluster];                 // the remote reads all in flight
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      v[r] = r < static_cast<int>(c.blocks)
                 ? cluster.map_shared_rank(sh.cnt, r)[d]
                 : 0;
    }
    int base = 0, tot = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      base += r < static_cast<int>(c.rank) ? v[r] : 0;
      tot += v[r];
    }
    sh.base[d] = base;
    sh.tot[d] = tot;
  }
  __syncthreads();
}

// The last call of a kernel: no block leaves while another may still read
// its counts.
__device__ __forceinline__ void finish() { cg::this_cluster().sync(); }

// Launch `kernel` with one cluster of cluster_blocks(n) blocks per window
// (grid: blocks x batch) and `smem` bytes of dynamic shared memory.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int64_t n, int batch,
                   int64_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {               // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = cluster_blocks(n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace repro_rank
