// Fused RSS visibility resolve + aggregate kernels for Hopper (sm_90a).
//
// Hand-written CUDA replacements for the Pallas TPU kernels in
// src/repro/kernels/rss_scan_agg/kernel.py.  Each kernel returns what its
// TPU twin returns, bitwise; the contracts (shapes, lanes, sentinels) are
// documented in src/repro_torch/kernels/rss_scan_agg/kernel.py, which
// loads this file's C entry points with ctypes; its `plan` owns the route
// and launch shape of every entry here, and the entries refuse any other.
//
// Layout: data [P, K, E] int32 (element 0 = codec tag, element 1 = the
// aggregable field), ts [P, K] int32, member_ts [M] int32 sorted
// ascending.  Seven statistic lanes per accumulator row: sum, count,
// count_below, min (INT32_MAX when empty), max (INT32_MIN when empty),
// count_above, sum_below.
//
// Resolve (the TPU's `_resolve_tag_x`): the page's newest visible slot,
// then ONLY elements 0 and 1 of it (the TPU loads the whole [BP, K, E]
// block and reduces a one-hot over K).  Every scan kernel resolves one
// lane a page through rss_resolve.cuh, the gathers' machinery: members
// staged once a block in shared memory (bitmap, sorted array, or device
// memory, by one rule), the lane's K <= 8 timestamps in registers as
// 16-byte vectors where K % 4 == 0 and ts sits on 16 bytes (more slots: 8
// at a time with a running best), then tag and field as one 8-byte load
// where the slot's address allows.
//
// Bound on the card: every kernel here is memory-bound.  Per page a scan
// must read K*4 bytes of ts plus one 32-byte sector of the chosen slot
// (the tag and field), plus 4 bytes of gid for the grouped kernels, and
// write its partial rows; at 3.35 TB/s that is ~7.6 us for P = 400k, K =
// 8.  The grouped kernel's [P/BP, G, 7] output is most of its bound (56 MB
// at P 400k, G 40).  The delta fold reads one 32-byte sector a delta row.
// The arithmetic (a handful of compares per slot) is negligible.  No
// one-hot over K, no intermediate select buffer (the TPU's chunked path
// packs a [rows, 256] stream to device memory between its two stages).
//
// What held the first design back (H100, P 400,000, K 8, M 64: scan 0.0365
// ms, chunked G 40 0.0493, grouped G 40 0.0716, against bounds of 0.0081 /
// 0.0080 / 0.0247; PERF.md): a binary search of the members in device
// memory for every slot above the floor, ~4 x 7 dependent loads ahead of
// the page's data load; K scalar ts loads a page; a BP-page segment
// folded serially by one thread while BP - 1 idled; for the chunked and
// grouped kernels an identity-fill launch before every call, then up to 7
// device-memory atomics a page into the rows the fill had just written.
// The delta fold copied acc into out (cudaMemcpyAsync) before its kernel,
// whose blocks merged their shared tiles into out with device atomics.
//
// Routes (one launch a call, except the chunked global route):
// - rss_scan_agg "warp" (BP divides 32: the main path's 8 and its shrink
//   ladder 4, 2, 1): a persistent grid of 2 blocks of 512 an SM; a warp
//   walks tiles of 32 pages, one lane a page; the next tile's timestamps
//   are loaded before this tile's tag/field loads, so they are in flight
//   under them.  Each BP-lane group reduces in the warp (ballots for the
//   counts, redux.sync for sums, min and max; additive lanes wrap as
//   unsigned), and the warp's 32/BP partial rows, contiguous in out, are
//   written by 7 * 32/BP lanes in one coalesced store.  Staging the
//   members is a cost a block: 4 blocks of 256 an SM were slower at
//   M = 4,096 in a tuning build (PERF.md).
// - rss_scan_agg "segment" (any BP up to 1,024; the only route for BP not
//   dividing 32): a persistent grid of blocks of whole segments, one
//   thread a page with the same staged resolve, segments folded from
//   shared memory by their first thread.
// - rss_scan_agg_grouped "warp" (any BP up to 32: a warp's tile is 32/BP
//   whole segments) and "segment" (any BP; `plan` gives it BP over 32,
//   and G up to 16, where it measured faster):
//   the scan's grids and blocks.  A segment's G rows are contiguous in
//   out; the warp or block stores all of them (the identity), then the
//   pages of a segment that share a group are combined (in the warp:
//   `__match_any_sync`, then redux over the peers; in the block: by the
//   group's first page, from shared memory) and one thread stores the
//   row.  One launch: no fill, no atomics.
// - rss_scan_agg_chunked "cluster" ([G, 7] and the member stage fit the
//   opt-in shared memory): each chunk a thread-block cluster of 8 blocks
//   of 1,024 threads; the cluster's warps walk the chunk's tiles of 32
//   pages, tiles counted from the chunk's first page, so none crosses a
//   chunk boundary; each lane adds its page into the block's [G, 7] tile
//   with shared atomics; after a cluster barrier each block folds a slice
//   of the rows over all 8 tiles through distributed shared memory and
//   writes out[c] with plain stores.  No fill, no global atomics.
//   Combining a warp's lanes by group first (`__match_any_sync`, then
//   redux over the peers) measured slower at every G in a tuning build
//   (PERF.md).
// - rss_scan_agg_chunked "global" (any G; the only route where [G, 7]
//   does not fit): an identity fill, then a persistent grid per chunk
//   whose lanes add their pages into out[c] with device-memory atomics.
//   At G = 7,132 with group ids spread over all G, the route `plan`
//   gives it, combining a warp's lanes first was 10% slower (PERF.md).
// - rss_delta_fold "sliced" (few delta rows, or Lp past the shared
//   memory: each block a slice of the lane rows) and "grid" (many delta
//   rows: a block an SM, a cooperative launch whose blocks fold slices of
//   the partials after a grid barrier): see the kernels below.
//
// More pages a lane (2 or 4, each a chain of its own) were slower on
// both scan routes, and more blocks no faster.  What keeps both routes at
// about 3.5x their byte bound is not yet known (PERF.md).
//
// Integer semantics: additive lanes are computed in uint32, so wraparound
// is two's complement exactly like jnp's int32 (signed overflow is
// undefined behaviour in C++).  Atomic and redux add/min/max are
// order-independent, so results do not depend on scheduling.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "rss_resolve.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 7;
constexpr int kThreads = 256;

// route codes, as the wrappers pass them
constexpr int kRouteWarp = 0, kRouteSegment = 1;  // rsa_scan_agg(_grouped)
constexpr int kRouteCluster = 0, kRouteGlobal = 1;    // rsa_scan_agg_chunked
constexpr int kRouteSliced = 0, kRouteGrid = 1;        // rsa_delta_fold

// launch shapes (rss_scan_agg/kernel.py's `plan` holds the same numbers)
constexpr int kTile = 32;                  // pages a warp's tile, one a lane
constexpr int kWarpThreads = 512, kWarpBlocksPerSm = 2;
// a grouped output (bytes) over which its warps store every identity
// first: four times the 50 MB L2
constexpr long long kWritesFirstBytes = 200LL << 20;
constexpr int kSegThreads = 256, kSegThreadsPerSm = 2048;
constexpr int kMaxBlockPages = 1024;
constexpr int kClusterBlocks = 8, kClusterThreads = 1024;
constexpr int kGlobalThreads = 256, kGlobalBlocksPerSm = 4;
constexpr int kFoldThreads = 1024;
constexpr long long kFoldBlockRows = 1024;  // delta rows a grid-route block
constexpr int kFoldBatch = 16;    // partials a thread loads at once
constexpr int kMaxSmem = 232448;           // opt-in shared memory a block

struct TagX { int tag; int x; };

// Tag and field of slot `slot` of page p: one 8-byte load where the
// address allows (E even), else two.
__device__ __forceinline__ TagX load_tag_x(const int* __restrict__ data,
                                           long long p, int k, int e,
                                           int slot) {
  const int* sel = data + (p * k + slot) * static_cast<long long>(e);
  if ((reinterpret_cast<uintptr_t>(sel) & 7) == 0) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(sel));
    return {v.x, v.y};
  }
  return {__ldcs(sel), __ldcs(sel + 1)};
}

// One page's contribution to a 7-lane accumulator row `o` (shared or
// global memory: atomics work on generic addresses).
__device__ __forceinline__ void accumulate(int* o, int x, int thr) {
  atomicAdd(reinterpret_cast<unsigned*>(o + 0), static_cast<unsigned>(x));
  atomicAdd(o + 1, 1);
  if (x < thr) {
    atomicAdd(o + 2, 1);
    atomicAdd(reinterpret_cast<unsigned*>(o + 6), static_cast<unsigned>(x));
  }
  atomicMin(o + 3, x);
  atomicMax(o + 4, x);
  if (x > thr) atomicAdd(o + 5, 1);
}

__device__ __forceinline__ int identity(int lane) {
  return lane == 3 ? INT_MAX : (lane == 4 ? INT_MIN : 0);
}

// Two partial values of statistic lane `lane` combined.
__device__ __forceinline__ int combine(int lane, int a, int b) {
  return lane == 3   ? min(a, b)
         : lane == 4 ? max(a, b)
                     : static_cast<int>(static_cast<unsigned>(a) +
                                        static_cast<unsigned>(b));
}

__global__ void fill_identity_kernel(int* out, long long rows) {
  long long n = rows * kLanes;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = identity(static_cast<int>(i % kLanes));
}

__device__ __forceinline__ bool ts_vec(const int* ts, int k) {
  return (reinterpret_cast<uintptr_t>(ts) & 15) == 0 && (k & 3) == 0;
}

// ---------------------------------------------------------------------------
// rss_scan_agg: replaces `rss_scan_agg` / `_kernel` (TPU kernel.py:123,189).
// ---------------------------------------------------------------------------
// One 32-page row of a warp's tile into its BP-page partial rows at `o`
// (the row's first page on lane 0; BP divides 32): counts by ballot,
// sums, min and max by redux over each BP-lane group; the group's first
// lane writes the group's 7 lanes.
__device__ __forceinline__ void warp_rows(bool valid, int x, int thr,
                                          unsigned seg, int lane, int bp,
                                          int* o) {
  const bool below = valid && x < thr;
  const unsigned cnt = __popc(__ballot_sync(kFull, valid) & seg);
  const unsigned nbelow = __popc(__ballot_sync(kFull, below) & seg);
  const unsigned nabove = __popc(__ballot_sync(kFull, valid && x > thr) & seg);
  const unsigned sum =
      __reduce_add_sync(seg, valid ? static_cast<unsigned>(x) : 0u);
  const unsigned sumb =
      __reduce_add_sync(seg, below ? static_cast<unsigned>(x) : 0u);
  const int mn = __reduce_min_sync(seg, valid ? x : INT_MAX);
  const int mx = __reduce_max_sync(seg, valid ? x : INT_MIN);
  if (lane & (bp - 1)) return;
  o += (lane / bp) * kLanes;
  o[0] = static_cast<int>(sum);
  o[1] = static_cast<int>(cnt);
  o[2] = static_cast<int>(nbelow);
  o[3] = mn;
  o[4] = mx;
  o[5] = static_cast<int>(nabove);
  o[6] = static_cast<int>(sumb);
}

// warp route: a warp a tile of 32 pages, one a lane; BP-lane groups
// reduced in the warp
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocksPerSm)
scan_agg_warp_kernel(const int* __restrict__ data, const int* __restrict__ ts,
                     const int* __restrict__ mem, int m, long long n_pages,
                     int k, int e, int floor, int tag_main, int tag_alt,
                     int thr, int bp, int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const Members ms = stage_members(mem, m, smem);
  constexpr int kWarps = kWarpThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's partial rows before their coalesced store (32/BP of them)
  int* rows = reinterpret_cast<int*>(smem + (m > 0 ? kStageBytes / 4 : 0)) +
              warp * kLanes * kTile;
  const long long n_tiles = (n_pages + kTile - 1) / kTile;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const bool vec = ts_vec(ts, k);
  const bool held = k <= kTileMaxK;      // ts in registers, next prefetched
  const unsigned seg = bp == 32 ? kFull
                                : ((1u << bp) - 1) << (lane & ~(bp - 1));
  long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  int t[kTileMaxK] = {};
  if (held && tile < n_tiles && tile * kTile + lane < n_pages)
    load_ts(t, ts + (tile * kTile + lane) * k, k, vec);
  for (; tile < n_tiles; tile += warps) {
    const long long p = tile * kTile + lane;
    const bool in = p < n_pages;
    int slot = 0;
    if (in)
      slot = held ? resolve<true>(t, k, floor, ms)
                  : resolve_any_k<true>(t, ts + p * k, k, vec, floor, ms);
    // the next tile's timestamps, in flight under this tile's data loads
    const long long pn = p + warps * kTile;
    if (held && pn < n_pages) load_ts(t, ts + pn * k, k, vec);
    const TagX r = in ? load_tag_x(data, p, k, e, slot) : TagX{0, 0};
    warp_rows(in && (r.tag == tag_main || r.tag == tag_alt), r.x, thr, seg,
              lane, bp, rows);
    __syncwarp();
    // P % BP == 0 and BP divides 32: the tile holds whole segments
    const long long left = n_pages - tile * kTile;
    const int words = static_cast<int>((left < kTile ? left : kTile) / bp) *
                      kLanes;
    int* to = out + tile * (kTile / bp) * kLanes;
    for (int w = lane; w < words; w += 32) to[w] = rows[w];
    __syncwarp();
  }
}

// segment route: a block of whole BP-page segments, one thread a page
__global__ void __launch_bounds__(kMaxBlockPages)
scan_agg_segment_kernel(const int* __restrict__ data,
                        const int* __restrict__ ts,
                        const int* __restrict__ mem, int m,
                        long long n_pages, int k, int e, int floor,
                        int tag_main, int tag_alt, int thr, int bp,
                        int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const Members ms = stage_members(mem, m, smem);
  int* sx = reinterpret_cast<int*>(smem + (m > 0 ? kStageBytes / 4 : 0));
  unsigned char* sv = reinterpret_cast<unsigned char*>(sx + blockDim.x);
  const bool vec = ts_vec(ts, k);
  const int i = threadIdx.x;
  int t[kTileMaxK];
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n_pages; base += static_cast<long long>(gridDim.x) *
                               blockDim.x) {
    const long long p = base + i;
    int x = 0;
    bool valid = false;
    if (p < n_pages) {
      const int slot = resolve_any_k<true>(t, ts + p * k, k, vec, floor, ms);
      const TagX r = load_tag_x(data, p, k, e, slot);
      valid = r.tag == tag_main || r.tag == tag_alt;
      x = r.x;
    }
    sx[i] = x;
    sv[i] = valid;
    __syncthreads();
    if (p < n_pages && i % bp == 0) {
      unsigned sum = 0, sumb = 0;
      int cnt = 0, below = 0, above = 0, mn = INT_MAX, mx = INT_MIN;
      for (int j = i; j < i + bp; ++j) {
        if (!sv[j]) continue;
        const int v = sx[j];
        sum += static_cast<unsigned>(v);
        ++cnt;
        if (v < thr) { ++below; sumb += static_cast<unsigned>(v); }
        if (v > thr) ++above;
        mn = min(mn, v);
        mx = max(mx, v);
      }
      int* o = out + (p / bp) * kLanes;
      o[0] = static_cast<int>(sum);
      o[1] = cnt;
      o[2] = below;
      o[3] = mn;
      o[4] = mx;
      o[5] = above;
      o[6] = static_cast<int>(sumb);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// rss_scan_agg_grouped: replaces `rss_scan_agg_grouped` / `_grouped_kernel`
// (TPU kernel.py:224,260).  Segment s = pages [s*BP, (s+1)*BP) owns the
// G * 7 contiguous words of out[s]; each route writes every one of them
// once with plain stores (the identity), then overwrites the rows that a
// page of the segment reached, one store a word, from the one thread that
// combined the segment's pages of that group.  No fill launch, no
// atomics.  G is unbounded: the chunked path's overflow demotion and
// forced modes send more than 32 groups.
// ---------------------------------------------------------------------------
// Identities of stat lanes stat, stat + 1, ... (mod 7).
__device__ __forceinline__ int4 identity4(int stat) {
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = stat + i;
    v[i] = identity(s < kLanes ? s : s - kLanes);
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

// The identity in every word [0, words) of `to` (word w is stat lane w %
// 7), by the threads first, first + step, ... (step >= 4): 16-byte stores
// from the first word on 16 bytes, single words before it and after the
// last whole vector.
__device__ __forceinline__ void store_identity(int* __restrict__ to,
                                               long long words, int first,
                                               int step) {
  const long long lead =
      ((16 - (reinterpret_cast<uintptr_t>(to) & 15)) & 15) >> 2;
  const long long head = lead < words ? lead : words;
  if (first < head) to[first] = identity(first);
  const long long n4 = (words - head) >> 2;
  int4* v = reinterpret_cast<int4*>(to + head);
  int stat = static_cast<int>((head + 4LL * first) % kLanes);
  const int adv = static_cast<int>((4LL * step) % kLanes);
  for (long long j = first; j < n4; j += step) {
    v[j] = identity4(stat);
    stat += adv;
    if (stat >= kLanes) stat -= kLanes;
  }
  const long long tail = head + 4 * n4 + first;
  if (tail < words) to[tail] = identity(static_cast<int>(tail % kLanes));
}

__device__ __forceinline__ void store_row(int* o, unsigned sum, int cnt,
                                          int below, int mn, int mx,
                                          int above, unsigned sumb) {
  o[0] = static_cast<int>(sum);
  o[1] = cnt;
  o[2] = below;
  o[3] = mn;
  o[4] = mx;
  o[5] = above;
  o[6] = static_cast<int>(sumb);
}

// warp route (BP up to 32): a persistent grid whose warps walk tiles of
// 32/BP whole segments (32/BP * BP pages, one lane a page; lanes past
// them idle), a tile's segments owning 32/BP * G * 7 contiguous words of
// out, the next tile's group ids and timestamps in flight under this
// tile's tag/field loads.  The warp stores the identity in a tile's words
// (16 bytes a lane), then the lanes of a segment that share a group
// combine in the warp (`__match_any_sync`, redux) and the lowest of them
// stores the row.  kWritesFirst (an output over kWritesFirstBytes): the
// warp stores the identity in all of its tiles before it reads a page; a
// write stream that large slows the reads it is mixed with more than the
// rows' stores to lines no longer in L2 cost.
template <bool kWritesFirst>
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocksPerSm)
grouped_warp_kernel(const int* __restrict__ data, const int* __restrict__ ts,
                    const int* __restrict__ gid, const int* __restrict__ mem,
                    int m, long long n_pages, int k, int e, int floor,
                    const int* __restrict__ gprm, int n_groups, int bp,
                    int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const Members ms = stage_members(mem, m, smem);
  constexpr int kWarps = kWarpThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int segs_tile = kTile / bp, tp = segs_tile * bp;   // pages a tile
  const long long n_tiles = (n_pages + tp - 1) / tp;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long seg_words = static_cast<long long>(n_groups) * kLanes;
  const bool vec = ts_vec(ts, k);
  const bool held = k <= kTileMaxK;      // ts in registers, next prefetched
  const unsigned seg = bp == 32 ? kFull
                                : ((1u << bp) - 1) << ((lane / bp) * bp);
  // the tile's words of out, stored the identity
  auto identity_of = [&](long long tile) {
    const long long left = n_pages - tile * tp;
    const int segs = static_cast<int>(left < tp ? left : tp) / bp;
    store_identity(out + tile * segs_tile * seg_words, segs * seg_words,
                   lane, 32);
  };
  // the lane's group id (-1: none, or no page) and, where it names a
  // group and K <= 8, its timestamps, in tile tl
  int g = -1, t[kTileMaxK] = {};
  auto fetch = [&](long long tl) {
    const long long q = tl * tp + lane;
    g = -1;
    if (tl < n_tiles && lane < tp && q < n_pages) {
      g = __ldcs(gid + q);
      if (g < 0 || g >= n_groups) g = -1;
      else if (held) load_ts(t, ts + q * k, k, vec);
    }
  };
  const long long tile0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (kWritesFirst) {
    for (long long tile = tile0; tile < n_tiles; tile += warps)
      identity_of(tile);
    __syncwarp();            // the identity stores land first
  }
  fetch(tile0);
  for (long long tile = tile0; tile < n_tiles; tile += warps) {
    const long long p = tile * tp + lane;
    int grp = g, tag_main = 0, tag_alt = 0, thr = 0, slot = 0;
    if (grp >= 0) {
      const int* prm = gprm + 3 * grp;
      tag_main = __ldg(prm);
      tag_alt = __ldg(prm + 1);
      thr = __ldg(prm + 2);
      slot = held ? resolve<true>(t, k, floor, ms)
                  : resolve_any_k<true>(t, ts + p * k, k, vec, floor, ms);
    }
    fetch(tile + warps);     // in flight under this tile's data loads
    int x = 0;
    if (grp >= 0) {
      const TagX r = load_tag_x(data, p, k, e, slot);
      if (r.tag != tag_main && r.tag != tag_alt) grp = -1;
      x = r.x;
    }
    if (!kWritesFirst) identity_of(tile);
    const bool valid = grp >= 0;
    const unsigned peers = __match_any_sync(kFull, grp) & seg;
    const bool below = valid && x < thr;
    const unsigned sum =
        __reduce_add_sync(peers, valid ? static_cast<unsigned>(x) : 0u);
    const unsigned sumb =
        __reduce_add_sync(peers, below ? static_cast<unsigned>(x) : 0u);
    const int mn = __reduce_min_sync(peers, valid ? x : INT_MAX);
    const int mx = __reduce_max_sync(peers, valid ? x : INT_MIN);
    const int nbelow = __popc(__ballot_sync(kFull, below) & peers);
    const int nabove = __popc(__ballot_sync(kFull, valid && x > thr) & peers);
    if (!kWritesFirst) __syncwarp();   // the identity stores land first
    if (valid && lane == __ffs(peers) - 1)
      store_row(out + ((tile * segs_tile + lane / bp) *
                           static_cast<long long>(n_groups) + grp) * kLanes,
                sum, __popc(peers), nbelow, mn, mx, nabove, sumb);
  }
}

// segment route (any BP up to 1,024): a persistent grid of blocks of
// whole segments, one thread a page with the same staged resolve; the
// block first stores the identity in all of its segments' words, then
// walks its pages, and the first page of each (segment, group) folds the
// segment's pages of that group from shared memory and stores the row.
__global__ void __launch_bounds__(kMaxBlockPages)
grouped_segment_kernel(const int* __restrict__ data,
                       const int* __restrict__ ts,
                       const int* __restrict__ gid,
                       const int* __restrict__ mem, int m, long long n_pages,
                       int k, int e, int floor,
                       const int* __restrict__ gprm, int n_groups, int bp,
                       int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const Members ms = stage_members(mem, m, smem);
  int* sg = reinterpret_cast<int*>(smem + (m > 0 ? kStageBytes / 4 : 0));
  int* sx = sg + blockDim.x;
  const bool vec = ts_vec(ts, k);
  const int i = threadIdx.x;
  const long long seg_words = static_cast<long long>(n_groups) * kLanes;
  int t[kTileMaxK];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // blockDim and base are multiples of BP: whole segments, their words
  // stored (the identity) for every round of the block before any page
  // is read
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n_pages; base += step) {
    const long long left = n_pages - base;
    const int segs = static_cast<int>(left < blockDim.x ? left : blockDim.x)
                     / bp;
    store_identity(out + (base / bp) * seg_words, segs * seg_words, i,
                   blockDim.x);
  }
  __syncthreads();           // the identity stores land first
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n_pages; base += step) {
    int* const to = out + (base / bp) * seg_words;
    const long long p = base + i;
    int grp = -1, x = 0;
    if (p < n_pages) {
      const int g = __ldg(gid + p);
      if (g >= 0 && g < n_groups) {
        const int slot = resolve_any_k<true>(t, ts + p * k, k, vec, floor,
                                             ms);
        const TagX r = load_tag_x(data, p, k, e, slot);
        const int* prm = gprm + 3 * g;
        if (r.tag == __ldg(prm) || r.tag == __ldg(prm + 1)) grp = g;
        x = r.x;
      }
    }
    sg[i] = grp;
    sx[i] = x;
    __syncthreads();         // sg, sx written
    if (grp >= 0) {
      const int first = i - i % bp;
      bool lead = true;
      for (int j = first; j < i && lead; ++j) lead = sg[j] != grp;
      if (lead) {
        const int thr = __ldg(gprm + 3 * grp + 2);
        unsigned sum = 0, sumb = 0;
        int cnt = 0, below = 0, above = 0, mn = INT_MAX, mx = INT_MIN;
        for (int j = i; j < first + bp; ++j) {
          if (sg[j] != grp) continue;
          const int v = sx[j];
          sum += static_cast<unsigned>(v);
          ++cnt;
          if (v < thr) { ++below; sumb += static_cast<unsigned>(v); }
          if (v > thr) ++above;
          mn = min(mn, v);
          mx = max(mx, v);
        }
        store_row(to + ((i / bp) * static_cast<long long>(n_groups) + grp) *
                           kLanes,
                  sum, cnt, below, mn, mx, above, sumb);
      }
    }
    __syncthreads();         // sg, sx free for the next round
  }
}

// ---------------------------------------------------------------------------
// rss_scan_agg_chunked: replaces `rss_scan_agg_chunked` — the TPU's two
// stages `_select_kernel` (resolve + pack to a [rows, 256] stream) and
// `_chunk_reduce_kernel` (tiled-group re-reduce), TPU kernel.py:313,323,405.
// Chunk c = padded pages [c*cp, (c+1)*cp), the `_chunk_shape` boundaries;
// padding pages beyond P contribute nothing and are never materialised.
// grid (blocks a chunk, chunks); a block's warps walk the chunk's tiles.
// ---------------------------------------------------------------------------
// kCluster: the grid's x blocks of a chunk are one cluster, each with a
// [G, 7] shared tile that its lanes add into with shared atomics, folded
// over distributed shared memory at the end; else the pages' groups add
// into out[c] in device memory (identity-filled before the launch).  A
// warp takes tiles of 32 pages of the chunk, one a lane.
template <bool kCluster>
__global__ void __launch_bounds__(kCluster ? kClusterThreads : kGlobalThreads,
                                  1)
scan_agg_chunked_kernel(const int* __restrict__ data,
                        const int* __restrict__ ts,
                        const int* __restrict__ gid,
                        const int* __restrict__ mem, int m,
                        long long n_pages, int k, int e, int floor,
                        const int* __restrict__ gprm, int n_groups,
                        long long cp, int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const Members ms = stage_members(mem, m, smem);
  const int c = blockIdx.y;
  int* const dst = out + static_cast<long long>(c) * n_groups * kLanes;
  int* const acc =
      kCluster ? reinterpret_cast<int*>(smem + (m > 0 ? kStageBytes / 4 : 0))
               : dst;
  if (kCluster) {
    for (int i = threadIdx.x; i < n_groups * kLanes; i += blockDim.x)
      acc[i] = identity(i % kLanes);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const long long lo = static_cast<long long>(c) * cp;
  const long long len = n_pages - lo < cp ? n_pages - lo : cp;  // may be <= 0
  const long long n_tiles = len > 0 ? (len + kTile - 1) / kTile : 0;
  const long long step = static_cast<long long>(gridDim.x) * wpb;
  const bool vec = ts_vec(ts, k);
  const bool held = k <= kTileMaxK;
  // the lane's group id (-1 past the chunk's end) and, where K <= 8, its
  // timestamps, in tile tl of the chunk
  int g = -1, t[kTileMaxK] = {};
  auto fetch = [&](long long tl) {
    const long long q = tl * kTile + lane;
    g = -1;
    if (tl < n_tiles && q < len) {
      g = __ldcs(gid + lo + q);
      if (held) load_ts(t, ts + (lo + q) * k, k, vec);
    }
  };
  long long tl = static_cast<long long>(blockIdx.x) * wpb + warp;
  fetch(tl);
  for (; tl < n_tiles; tl += step) {
    const long long p = lo + tl * kTile + lane;
    int grp = g >= 0 && g < n_groups ? g : -1;
    int slot = 0;
    if (grp >= 0)
      slot = held ? resolve<true>(t, k, floor, ms)
                  : resolve_any_k<true>(t, ts + p * k, k, vec, floor, ms);
    fetch(tl + step);        // in flight under this tile's data loads
    int x = 0, thr = 0;
    if (grp >= 0) {
      const int* prm = gprm + 3 * grp;
      const int tag_main = __ldg(prm), tag_alt = __ldg(prm + 1);
      thr = __ldg(prm + 2);
      const TagX r = load_tag_x(data, p, k, e, slot);
      if (r.tag != tag_main && r.tag != tag_alt) grp = -1;
      x = r.x;
    }
    if (grp >= 0) accumulate(acc + grp * kLanes, x, thr);
  }
  if (!kCluster) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // each block folds a slice of the rows over every block's tile, ranks
  // in order, and writes it once
  const int nb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * blockDim.x + threadIdx.x; i < n_groups * kLanes;
       i += nb * blockDim.x) {
    const int stat = i % kLanes;
    int v = identity(stat);
    for (int r = 0; r < nb; ++r)
      v = combine(stat, v, cluster.map_shared_rank(acc, r)[i]);
    dst[i] = v;
  }
  cluster.sync();            // no block leaves while its tile is read
}

// ---------------------------------------------------------------------------
// rss_delta_fold: replaces `rss_delta_fold` / `_delta_fold_kernel` (TPU
// kernel.py:473,524).  Each delta row (cols 0 lane, 1 old, 2 old-valid, 3
// new, 4 new-valid, 5 threshold) adds its retract-then-apply deltas to the
// additive stats and tightens min/max with an applied (new-valid == 1)
// value; out = acc with stats 0-6 of each lane row combined with the
// folded deltas, lanes 7-127 copied.  One launch writes all of out with
// plain stores (no copy before it).  A lane a delta row: cols 0-5 as one
// 16-byte and one 8-byte load, the next row in flight under this one.
// A block folds into a [rows, 7] tile in shared memory: a sliced-route
// block of at most kFewRows lane rows (every block where Lp <= 1,056)
// combines in each warp the rows aimed at one lane row (a ballot and
// redux a lane row) and keeps the sums in the registers of lane t for
// lane row t, adding them to the tile once at the end; otherwise each
// delta row adds itself with shared atomics.  Bound: one 32-byte sector
// a delta row, acc read and out written once.
// - sliced route (few delta rows, and any Lp; the only route where [Lp,
//   7] is over the shared memory): a block an SM, each owning a slice of
//   the lane rows; every block reads every delta row's sector (from L2
//   after the first) and folds the rows aimed at its slice, then writes
//   its rows of out.
// - grid route (many delta rows): a cooperative launch, a block for each
//   kFoldBlockRows delta rows, at most one an SM, each folding its share
//   of the rows over all Lp lane rows with shared atomics; the tiles go
//   to `part` [grid, Lp, 7], and after a grid barrier each block folds a
//   slice of the words over every tile (kFoldBatch loads in flight a
//   thread, acc's stats loaded before the barrier) and writes it.  Two
//   designs measured slower (PERF.md): the last block to take a ticket
//   folding every tile (8x the copy-and-atomics fold at Lp 2,048, 1.2x
//   at Lp 64), and clusters of 8 blocks folding over distributed shared
//   memory.
// ---------------------------------------------------------------------------
constexpr int kFewRows = 8;

__device__ __forceinline__ unsigned lt(int a, int b) { return a < b; }
__device__ __forceinline__ unsigned gt(int a, int b) { return a > b; }

// One delta row's contribution: the five additive deltas (uint32) and the
// value that min/max take when applied (new-valid == 1).
struct RowDelta {
  unsigned sum, count, below, above, sumb;
  int nw;
  bool applied;
};

__device__ __forceinline__ RowDelta row_delta(int4 a, int2 b) {
  const int old = a.y, ov = a.z, nw = a.w, nv = b.x, thr = b.y;
  const unsigned uo = old, uov = ov, un = nw, unv = nv;
  return {un * unv - uo * uov, unv - uov,
          unv * lt(nw, thr) - uov * lt(old, thr),
          unv * gt(nw, thr) - uov * gt(old, thr),
          un * unv * lt(nw, thr) - uo * uov * lt(old, thr), nw, nv == 1};
}

// A lane row's partial, held by one lane (the few-rows path).
struct RowAcc {
  unsigned sum = 0, count = 0, below = 0, above = 0, sumb = 0;
  int mn = INT_MAX, mx = INT_MIN;
};

__device__ __forceinline__ void add_to_tile(int* o, const RowAcc& r) {
  unsigned* u = reinterpret_cast<unsigned*>(o);
  if (r.sum) atomicAdd(u + 0, r.sum);
  if (r.count) atomicAdd(u + 1, r.count);
  if (r.below) atomicAdd(u + 2, r.below);
  if (r.above) atomicAdd(u + 5, r.above);
  if (r.sumb) atomicAdd(u + 6, r.sumb);
  if (r.mn != INT_MAX) atomicMin(o + 3, r.mn);
  if (r.mx != INT_MIN) atomicMax(o + 4, r.mx);
}

// Delta rows first, first + step, ... (warp-uniform bases, a lane a row)
// folded into `tile`, lane rows [lo, lo + n) (shared memory, identity
// filled), the next row in flight under this one (more rows in flight
// measured slower).  kFew: at most kFewRows lane rows are combined in the
// warp (the sliced route's slices); else every row adds itself with
// shared atomics (faster for the grid route's tile, at Lp 8 too).  Every
// thread of the block calls this.
template <bool kFew>
__device__ __forceinline__ void fold_rows(const int* __restrict__ delta,
                                          long long dp, long long first,
                                          long long step, int lo, int n,
                                          int* tile) {
  const int lane = threadIdx.x & 31;
  int4 a;
  int2 b;
  auto fetch = [&](long long r) {
    a = make_int4(-1, 0, 0, 0);
    b = make_int2(0, 0);
    if (r < dp) {
      const int* row = delta + r * 128;
      a = __ldcs(reinterpret_cast<const int4*>(row));
      b = __ldcs(reinterpret_cast<const int2*>(row + 4));
    }
  };
  fetch(first + lane);
  const bool few = kFew && n <= kFewRows;
  RowAcc mine;                         // lane row `lane`'s, where few
  for (long long r0 = first; r0 < dp; r0 += step) {
    const long long row = static_cast<long long>(a.x) - lo;
    const bool hit = row >= 0 && row < n;
    const RowDelta d = row_delta(a, b);
    fetch(r0 + step + lane);
    if (few) {
      for (int t = 0; t < n; ++t) {
        const bool on = hit && row == t;
        if (!__ballot_sync(kFull, on)) continue;       // warp-uniform
        const unsigned s0 = __reduce_add_sync(kFull, on ? d.sum : 0u);
        const unsigned s1 = __reduce_add_sync(kFull, on ? d.count : 0u);
        const unsigned s2 = __reduce_add_sync(kFull, on ? d.below : 0u);
        const unsigned s5 = __reduce_add_sync(kFull, on ? d.above : 0u);
        const unsigned s6 = __reduce_add_sync(kFull, on ? d.sumb : 0u);
        const bool app = on && d.applied;
        const int mn = __reduce_min_sync(kFull, app ? d.nw : INT_MAX);
        const int mx = __reduce_max_sync(kFull, app ? d.nw : INT_MIN);
        if (lane == t) {
          mine.sum += s0;
          mine.count += s1;
          mine.below += s2;
          mine.above += s5;
          mine.sumb += s6;
          mine.mn = min(mine.mn, mn);
          mine.mx = max(mine.mx, mx);
        }
      }
    } else if (hit) {
      RowAcc one;
      one.sum = d.sum;
      one.count = d.count;
      one.below = d.below;
      one.above = d.above;
      one.sumb = d.sumb;
      if (d.applied) one.mn = one.mx = d.nw;
      add_to_tile(tile + row * kLanes, one);
    }
  }
  if (few && lane < n) add_to_tile(tile + lane * kLanes, mine);
}

// sliced route: the block's slices of `rows` lane rows, each folded from
// every delta row and written to out, 16 bytes at a time.
__global__ void __launch_bounds__(kFoldThreads, 1)
delta_fold_slice_kernel(const int* __restrict__ acc,
                        const int* __restrict__ delta, int lp, long long dp,
                        int rows, int* __restrict__ out) {
  extern __shared__ int tile[];
  const int4* acc4 = reinterpret_cast<const int4*>(acc);
  int4* out4 = reinterpret_cast<int4*>(out);
  const int warp = threadIdx.x >> 5;
  for (long long lo = static_cast<long long>(blockIdx.x) * rows; lo < lp;
       lo += static_cast<long long>(gridDim.x) * rows) {
    const int n = static_cast<int>(lp - lo < rows ? lp - lo : rows);
    store_identity(tile, static_cast<long long>(n) * kLanes, threadIdx.x,
                   blockDim.x);
    __syncthreads();
    fold_rows<true>(delta, dp, warp * 32, blockDim.x, static_cast<int>(lo),
                    n, tile);
    __syncthreads();
    // 16-byte piece c of a row: c 0 holds stats 0-3, c 1 stats 4-6 and
    // lane 7, the rest lanes of acc only
    for (long long i = lo * 32 + threadIdx.x; i < (lo + n) * 32;
         i += blockDim.x) {
      int4 v = __ldcs(acc4 + i);
      const int c = static_cast<int>(i & 31);
      if (c < 2) {
        const int* t = tile + (i / 32 - lo) * kLanes + 4 * c;
        v.x = combine(4 * c, v.x, t[0]);
        v.y = combine(4 * c + 1, v.y, t[1]);
        v.z = combine(4 * c + 2, v.z, t[2]);
        if (c == 0) v.w = combine(3, v.w, t[3]);
      }
      out4[i] = v;
    }
    __syncthreads();               // the tile free for the next slice
  }
}

// grid route (a cooperative launch): each block's tile of all Lp rows
// from its share of the delta rows, to part[block]; after a grid barrier
// each block folds the others' tiles into its own over its slice of the
// words and writes that slice of stats 0-6 of out.
__global__ void __launch_bounds__(kFoldThreads, 1)
delta_fold_grid_kernel(const int* __restrict__ acc,
                       const int* __restrict__ delta, int lp, long long dp,
                       int* __restrict__ part, int* __restrict__ out) {
  extern __shared__ int tile[];
  const int warp = threadIdx.x >> 5;
  const long long tile_words = static_cast<long long>(lp) * kLanes;
  store_identity(tile, tile_words, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  fold_rows<false>(delta, dp,
                   static_cast<long long>(blockIdx.x) * blockDim.x + warp * 32,
                   stride, 0, lp, tile);
  // lanes 7-127 of out: acc's, copied (16 bytes at a time from lane 8)
  const int4* acc4 = reinterpret_cast<const int4*>(acc);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < static_cast<long long>(lp) * 32; i += stride) {
    const int c = static_cast<int>(i & 31);
    if (c >= 2) out4[i] = __ldcs(acc4 + i);
    else if (c == 1) out[i * 4 + 3] = __ldcs(acc + i * 4 + 3);
  }
  // the slice of out's stats words this block writes after the barrier
  const int words = static_cast<int>(tile_words);
  const int per_block = (words + gridDim.x - 1) / gridDim.x;
  const int lo = min(static_cast<int>(blockIdx.x) * per_block, words);
  const int span = min(lo + per_block, words) - lo;
  // this thread's word of acc's stats, loaded now where one word a
  // thread covers the slice (its latency hidden under the barrier)
  const bool held = span <= static_cast<int>(blockDim.x);
  const int wh = lo + static_cast<int>(threadIdx.x);
  const long long o_held = static_cast<long long>(wh / kLanes) * 128 +
                           wh % kLanes;
  const int acc_held = held && static_cast<int>(threadIdx.x) < span
                           ? __ldcs(acc + o_held) : 0;
  __syncthreads();
  int* dst = part + static_cast<long long>(blockIdx.x) * tile_words;
  for (int w = threadIdx.x; w < tile_words; w += blockDim.x) dst[w] = tile[w];
  cg::this_grid().sync();
  // every other block's tile into this one's, over the slice: `per`
  // threads a word, each over every per-th block, kFoldBatch loads in
  // flight at once, then one shared atomic
  const unsigned uspan = static_cast<unsigned>(span);
  const unsigned per =
      uspan > 0 && uspan < blockDim.x ? blockDim.x / uspan : 1;
  for (unsigned i = threadIdx.x; i < uspan * per; i += blockDim.x) {
    const unsigned w = lo + i % uspan, q = i / uspan;
    const int stat = static_cast<int>(w % kLanes);
    int v = identity(stat);
    const int* from = part + w;
    for (unsigned b0 = q; b0 < gridDim.x; b0 += per * kFoldBatch) {
      int x[kFoldBatch];
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) {
        const unsigned blk = b0 + j * per;
        x[j] = blk < gridDim.x && blk != blockIdx.x
                   ? __ldcg(from + static_cast<long long>(blk) * tile_words)
                   : identity(stat);
      }
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) v = combine(stat, v, x[j]);
    }
    if (stat == 3) atomicMin(tile + w, v);
    else if (stat == 4) atomicMax(tile + w, v);
    else if (v) atomicAdd(reinterpret_cast<unsigned*>(tile + w),
                          static_cast<unsigned>(v));
  }
  __syncthreads();
  if (held) {
    if (static_cast<int>(threadIdx.x) < span)
      out[o_held] = combine(wh % kLanes, acc_held, tile[wh]);
  } else {
    for (int w = lo + threadIdx.x; w < lo + span; w += blockDim.x) {
      const int stat = w % kLanes;
      const long long o = static_cast<long long>(w / kLanes) * 128 + stat;
      out[o] = combine(stat, __ldcs(acc + o), tile[w]);
    }
  }
}

int grid_for(long long n, int threads, long long cap) {
  long long g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  return static_cast<int>(g < cap ? g : cap);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

long long cap_at(long long want, long long cap) {
  return want < 1 ? 1 : (want < cap ? want : cap);
}

int sm_count(int* sms) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  return 0;
}

// A planned launch, as `plan` in rss_scan_agg/kernel.py computes it
// (block 0: the route does not take the call).
struct Shape {
  long long grid_x;
  int grid_y, block, cluster, smem;
};

Shape scan_shape(int route, long long n_pages, int bp, int m, int sms) {
  const int stage = m > 0 ? kStageBytes : 0;
  if (route == kRouteWarp && 32 % bp == 0)
    return {cap_at(cdiv(cdiv(n_pages, kTile), kWarpThreads / 32),
                   static_cast<long long>(kWarpBlocksPerSm) * sms),
            1, kWarpThreads, 1,
            stage + (kWarpThreads / 32) * kLanes * kTile * 4};
  if (route == kRouteSegment) {
    const int block = bp * (kSegThreads / bp > 0 ? kSegThreads / bp : 1);
    const int per_sm = kSegThreadsPerSm / block > 0
                           ? kSegThreadsPerSm / block : 1;
    return {cap_at(cdiv(n_pages, block), static_cast<long long>(per_sm) * sms),
            1, block, 1, stage + block * 5};
  }
  return {0, 0, 0, 0, 0};
}

Shape grouped_shape(int route, long long n_pages, int bp, int m, int sms) {
  const int stage = m > 0 ? kStageBytes : 0;
  if (route == kRouteWarp && bp <= kTile) {
    const long long tiles = cdiv(n_pages, (kTile / bp) * bp);
    return {cap_at(cdiv(tiles, kWarpThreads / 32),
                   static_cast<long long>(kWarpBlocksPerSm) * sms),
            1, kWarpThreads, 1, stage};
  }
  const Shape sh = scan_shape(route, n_pages, bp, m, sms);
  if (route != kRouteSegment) return {0, 0, 0, 0, 0};
  return {sh.grid_x, 1, sh.block, 1, stage + sh.block * 8};
}

// The slice kernel's tile holds smem / 28 lane rows.
Shape fold_shape(int route, int lp, long long dp, int sms) {
  const int cap = kMaxSmem / (kLanes * 4);     // lane rows a tile holds
  if (route == kRouteGrid && lp <= cap) {
    return {cap_at(cdiv(dp, kFoldBlockRows), sms), 1, kFoldThreads, 1,
            lp * kLanes * 4};
  }
  if (route == kRouteSliced) {
    const int rows = static_cast<int>(cap_at(cdiv(lp, sms), cap));
    return {sms, 1, kFoldThreads, 1, rows * kLanes * 4};
  }
  return {0, 0, 0, 0, 0};
}

Shape chunked_shape(int route, long long cp, int nc, int n_groups, int m,
                    int sms) {
  const int stage = m > 0 ? kStageBytes : 0;
  if (route == kRouteCluster &&
      static_cast<long long>(n_groups) * kLanes * 4 + stage <= kMaxSmem)
    return {kClusterBlocks, nc, kClusterThreads, kClusterBlocks,
            stage + n_groups * kLanes * 4};
  if (route == kRouteGlobal) {
    const long long per_chunk =
        static_cast<long long>(kGlobalBlocksPerSm) * sms / nc > 0
            ? static_cast<long long>(kGlobalBlocksPerSm) * sms / nc : 1;
    return {cap_at(cdiv(cdiv(cp, kTile), kGlobalThreads / 32), per_chunk),
            nc, kGlobalThreads, 1, stage};
  }
  return {0, 0, 0, 0, 0};
}

}  // namespace

// ------------------------------------------------------------ C entry points
// Each launches on `stream` and returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue (1) for arguments no route takes or a route that
// does not take them, or cudaErrorInvalidConfiguration (9) when the grid,
// block or cluster are not the route's (`plan` in rss_scan_agg/kernel.py).

// route: 0 warp (BP divides 32), 1 segment; grid and block as planned.
extern "C" int rsa_scan_agg(const int* data, const int* ts, const int* mem,
                            int m, long long n_pages, int k, int e, int floor,
                            int tag_main, int tag_alt, int thr, int bp,
                            int* out, int route, long long grid, int block,
                            void* stream) {
  if (n_pages < 1 || k < 1 || e < 2 || bp < 1 || bp > kMaxBlockPages ||
      n_pages % bp || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Shape sh = scan_shape(route, n_pages, bp, m, sms);
  if (sh.block == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (grid != sh.grid_x || block != sh.block)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = route == kRouteWarp ? scan_agg_warp_kernel
                                    : scan_agg_segment_kernel;
  kernel<<<static_cast<unsigned>(grid), block, sh.smem, s>>>(
      data, ts, mem, m, n_pages, k, e, floor, tag_main, tag_alt, thr, bp,
      out);
  return static_cast<int>(cudaGetLastError());
}

// route: 0 warp (BP up to 32), 1 segment; grid and block as planned.
extern "C" int rsa_scan_agg_grouped(const int* data, const int* ts,
                                    const int* gid, const int* mem, int m,
                                    long long n_pages, int k, int e,
                                    int floor, const int* gprm, int n_groups,
                                    int bp, int* out, int route,
                                    long long grid, int block,
                                    void* stream) {
  if (n_pages < 1 || k < 1 || e < 2 || bp < 1 || bp > kMaxBlockPages ||
      n_pages % bp || m < 0 || n_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Shape sh = grouped_shape(route, n_pages, bp, m, sms);
  if (sh.block == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (grid != sh.grid_x || block != sh.block)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool first = (n_pages / bp) * n_groups * kLanes * 4LL >
                     kWritesFirstBytes;
  auto kernel = route == kRouteSegment ? &grouped_segment_kernel
                : first               ? &grouped_warp_kernel<true>
                                      : &grouped_warp_kernel<false>;
  if (sh.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(grid), block, sh.smem, s>>>(
      data, ts, gid, mem, m, n_pages, k, e, floor, gprm, n_groups, bp, out);
  return static_cast<int>(cudaGetLastError());
}

// route: 0 cluster ([G, 7] in shared memory; one launch), 1 global
// (identity fill, then device-memory atomics); grid is the blocks a
// chunk (the launch's x), cluster the blocks a cluster (1: none).
extern "C" int rsa_scan_agg_chunked(const int* data, const int* ts,
                                    const int* gid, const int* mem, int m,
                                    long long n_pages, int k, int e,
                                    int floor, const int* gprm, int n_groups,
                                    long long cp, int nc, int* out,
                                    int route, long long grid, int block,
                                    int cluster, void* stream) {
  if (n_pages < 0 || k < 1 || e < 2 || n_groups < 1 || nc < 1 || cp < 1 ||
      cp * nc < n_pages || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Shape sh = chunked_shape(route, cp, nc, n_groups, m, sms);
  if (sh.block == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (grid != sh.grid_x || block != sh.block || cluster != sh.cluster)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid3(static_cast<unsigned>(grid), static_cast<unsigned>(nc));
  if (route == kRouteGlobal) {
    fill_identity_kernel<<<grid_for(static_cast<long long>(nc) * n_groups *
                                        kLanes, kThreads, 4096),
                           kThreads, 0, s>>>(
        out, static_cast<long long>(nc) * n_groups);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
    scan_agg_chunked_kernel<false><<<grid3, block, sh.smem, s>>>(
        data, ts, gid, mem, m, n_pages, k, e, floor, gprm, n_groups, cp,
        out);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = scan_agg_chunked_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid3;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, data, ts, gid, mem, m, n_pages, k, e,
                           floor, gprm, n_groups, cp, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// route: 0 sliced, 1 grid (a cooperative launch); grid and block as
// planned.  The grid route takes `part` ([grid, Lp, 7] int32), the sliced
// route none (it may be null).  acc, delta and out sit on 16 bytes.
extern "C" int rsa_delta_fold(const int* acc, const int* delta, int lp,
                              long long dp, int* part, int* out, int route,
                              long long grid, int block, void* stream) {
  const auto off16 = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
  };
  if (lp < 1 || dp < 0 || off16(acc) || off16(delta) || off16(out) ||
      (route == kRouteGrid && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Shape sh = fold_shape(route, lp, dp, sms);
  if (sh.block == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (grid != sh.grid_x || block != sh.block)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = route == kRouteGrid
                       ? reinterpret_cast<const void*>(delta_fold_grid_kernel)
                       : reinterpret_cast<const void*>(
                             delta_fold_slice_kernel);
  if (sh.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 g3(static_cast<unsigned>(grid));
  if (route == kRouteSliced) {
    delta_fold_slice_kernel<<<g3, block, sh.smem, s>>>(
        acc, delta, lp, dp, sh.smem / (kLanes * 4), out);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&acc, &delta, &lp, &dp, &part, &out};
  cudaError_t err =
      cudaLaunchCooperativeKernel(fn, g3, dim3(block), args, sh.smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
