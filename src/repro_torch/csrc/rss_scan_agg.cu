// Fused RSS visibility resolve + aggregate kernels for Hopper (sm_90a).
//
// Hand-written CUDA replacements for the Pallas TPU kernels in
// src/repro/kernels/rss_scan_agg/kernel.py.  Each kernel returns what its
// TPU twin returns, bitwise; the contracts (shapes, lanes, sentinels) are
// documented in src/repro_torch/kernels/rss_scan_agg/kernel.py, which
// loads this file's C entry points with ctypes; its `plan` owns the route
// and launch shape of `rsa_scan_agg` and `rsa_scan_agg_chunked`, and the
// entries refuse any other.
//
// Layout: data [P, K, E] int32 (element 0 = codec tag, element 1 = the
// aggregable field), ts [P, K] int32, member_ts [M] int32 sorted
// ascending.  Seven statistic lanes per accumulator row: sum, count,
// count_below, min (INT32_MAX when empty), max (INT32_MIN when empty),
// count_above, sum_below.
//
// Resolve (the TPU's `_resolve_tag_x`): the page's newest visible slot,
// then ONLY elements 0 and 1 of it (the TPU loads the whole [BP, K, E]
// block and reduces a one-hot over K).  `rss_scan_agg` and
// `rss_scan_agg_chunked` resolve one lane a page through
// rss_resolve.cuh, the gathers' machinery: members staged once a block in
// shared memory (bitmap, sorted array, or device memory, by one rule),
// the lane's K <= 8 timestamps in registers as 16-byte vectors where
// K % 4 == 0 and ts sits on 16 bytes (more slots: 8 at a time with a
// running best), then tag and field as one 8-byte load where the slot's
// address allows.  `rss_scan_agg_grouped` keeps the first design's one
// thread a page with members binary-searched in device memory
// (`resolve_page`).
//
// Bound on the card: every scan kernel is memory-bound.  Per page it must
// read K*4 bytes of ts plus one 32-byte sector of the chosen slot (the tag
// and field), plus 4 bytes of gid for the grouped kernels, and write its
// partial rows; at 3.35 TB/s that is ~7.6 us for P = 400k, K = 8.  The
// arithmetic (a handful of compares per slot) is negligible.  No one-hot
// over K, no intermediate select buffer (the TPU's chunked path packs a
// [rows, 256] stream to device memory between its two stages).
//
// What held the first design back (H100, P 400,000, K 8, M 64: scan 0.0365
// ms, chunked G 40 0.0493, against bounds of 0.0081 / 0.0080; PERF.md): a
// binary search of the members in device memory for every slot above the
// floor, ~4 x 7 dependent loads ahead of the page's data load; K scalar
// ts loads a page; a BP-page segment folded serially by one thread while
// BP - 1 idled; for the chunked kernel an identity-fill launch before
// every call, 7 shared atomics a page on a [G, 7] tile that a warp's 32
// lanes hit on the same rows, then global atomics of 128 blocks a chunk
// into the same out[c].
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
//
// More pages a lane (2 or 4, each a chain of its own) were slower on
// both routes, and more blocks no faster.  What keeps both routes at
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
constexpr int kSmemCap = 48 * 1024;   // static shared-memory limit per block

// route codes, as the wrappers pass them
constexpr int kRouteWarp = 0, kRouteSegment = 1;      // rsa_scan_agg
constexpr int kRouteCluster = 0, kRouteGlobal = 1;    // rsa_scan_agg_chunked

// launch shapes (rss_scan_agg/kernel.py's `plan` holds the same numbers)
constexpr int kTile = 32;                  // pages a warp's tile, one a lane
constexpr int kWarpThreads = 512, kWarpBlocksPerSm = 2;
constexpr int kSegThreads = 256, kSegThreadsPerSm = 2048;
constexpr int kMaxBlockPages = 1024;
constexpr int kClusterBlocks = 8, kClusterThreads = 1024;
constexpr int kGlobalThreads = 256, kGlobalBlocksPerSm = 4;
constexpr int kMaxSmem = 232448;           // opt-in shared memory a block

__device__ __forceinline__ bool is_visible(int t, const int* __restrict__ mem,
                                           int m, int floor) {
  if (t <= floor) return true;
  int lo = 0, hi = m;                  // lower_bound over the sorted members
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(mem + mid) < t) lo = mid + 1; else hi = mid;
  }
  return lo < m && __ldg(mem + lo) == t;
}

struct TagX { int tag; int x; };

// RSS visibility resolve of page p, one thread, members in device memory
// (the grouped kernel's): newest member-visible slot (first strict
// maximum of the masked timestamps), then its tag and field.
__device__ __forceinline__ TagX resolve_page(
    const int* __restrict__ data, const int* __restrict__ ts,
    const int* __restrict__ mem, int m, int floor, long long p, int k,
    int e) {
  const int* row = ts + p * k;
  int t0 = __ldg(row);
  int best = is_visible(t0, mem, m, floor) ? t0 : -1;
  int slot = 0;
  for (int j = 1; j < k; ++j) {
    int t = __ldg(row + j);
    int masked = is_visible(t, mem, m, floor) ? t : -1;
    if (masked > best) { best = masked; slot = j; }
  }
  const int* sel = data + (p * k + slot) * (long long)e;
  return {__ldg(sel), __ldg(sel + 1)};
}

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

// Merge a partial row `s` (identity-initialised) into the row `o`.
__device__ __forceinline__ void merge_row(int* o, const int* s) {
  if (s[0]) atomicAdd(reinterpret_cast<unsigned*>(o + 0),
                      static_cast<unsigned>(s[0]));
  if (s[1]) atomicAdd(o + 1, s[1]);
  if (s[2]) atomicAdd(o + 2, s[2]);
  if (s[3] != INT_MAX) atomicMin(o + 3, s[3]);
  if (s[4] != INT_MIN) atomicMax(o + 4, s[4]);
  if (s[5]) atomicAdd(o + 5, s[5]);
  if (s[6]) atomicAdd(reinterpret_cast<unsigned*>(o + 6),
                      static_cast<unsigned>(s[6]));
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
// (TPU kernel.py:224,260).  The output [P/BP, G, 7] is filled with the
// identities first; each page then adds itself into its segment's gid row
// with atomics (at most BP pages share a row, so contention is low).  G is
// unbounded here: the chunked path's overflow demotion and forced modes
// send more than 32 lanes.
// ---------------------------------------------------------------------------
__global__ void scan_agg_grouped_kernel(
    const int* __restrict__ data, const int* __restrict__ ts,
    const int* __restrict__ gid, const int* __restrict__ mem, int m,
    long long n_pages, int k, int e, int floor,
    const int* __restrict__ gprm, int n_groups, int bp,
    int* __restrict__ out) {
  long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n_pages) return;
  int g = __ldg(gid + p);
  if (g < 0 || g >= n_groups) return;          // -1: no group / padding
  TagX r = resolve_page(data, ts, mem, m, floor, p, k, e);
  const int* prm = gprm + 3 * g;
  if (r.tag != __ldg(prm) && r.tag != __ldg(prm + 1)) return;
  accumulate(out + ((p / bp) * n_groups + g) * kLanes, r.x, __ldg(prm + 2));
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
// kernel.py:473,524).  out starts as a copy of acc; each delta row (cols
// 0 lane, 1 old, 2 old-valid, 3 new, 4 new-valid, 5 threshold) adds its
// retract-then-apply deltas to the additive lanes and tightens min/max
// with an applied (new-valid == 1) value.  Blocks stride over the rows and
// reduce into a [Lp, 7] shared-memory tile first (global atomics when it
// does not fit), then merge it into out.  Bound: one 32-byte sector per
// delta row plus acc read and out written once.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned lt(int a, int b) { return a < b; }
__device__ __forceinline__ unsigned gt(int a, int b) { return a > b; }

__global__ void delta_fold_kernel(const int* __restrict__ delta, int lp,
                                  long long dp, int use_smem,
                                  int* __restrict__ out) {
  extern __shared__ int tile[];
  if (use_smem) {
    for (int i = threadIdx.x; i < lp * kLanes; i += blockDim.x)
      tile[i] = identity(i % kLanes);
    __syncthreads();
  }
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       r < dp; r += (long long)gridDim.x * blockDim.x) {
    const int* row = delta + r * 128;
    int tgt = __ldg(row);
    if (tgt < 0 || tgt >= lp) continue;          // -1: padding row
    int old = __ldg(row + 1), ov = __ldg(row + 2);
    int nw = __ldg(row + 3), nv = __ldg(row + 4), thr = __ldg(row + 5);
    unsigned uo = old, uov = ov, un = nw, unv = nv;
    unsigned d_sum = un * unv - uo * uov;
    unsigned d_count = unv - uov;
    unsigned d_below = unv * lt(nw, thr) - uov * lt(old, thr);
    unsigned d_above = unv * gt(nw, thr) - uov * gt(old, thr);
    unsigned d_sumb = un * unv * lt(nw, thr) - uo * uov * lt(old, thr);
    int* o = use_smem ? tile + tgt * kLanes : out + (long long)tgt * 128;
    unsigned* uo_row = reinterpret_cast<unsigned*>(o);
    if (d_sum) atomicAdd(uo_row + 0, d_sum);
    if (d_count) atomicAdd(uo_row + 1, d_count);
    if (d_below) atomicAdd(uo_row + 2, d_below);
    if (d_above) atomicAdd(uo_row + 5, d_above);
    if (d_sumb) atomicAdd(uo_row + 6, d_sumb);
    if (nv == 1) {
      atomicMin(o + 3, nw);
      atomicMax(o + 4, nw);
    }
  }
  if (!use_smem) return;
  __syncthreads();
  for (int l = threadIdx.x; l < lp; l += blockDim.x)
    merge_row(out + (long long)l * 128, tile + l * kLanes);
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

extern "C" int rsa_scan_agg_grouped(const int* data, const int* ts,
                                    const int* gid, const int* mem, int m,
                                    long long n_pages, int k, int e,
                                    int floor, const int* gprm, int n_groups,
                                    int bp, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long rows = (n_pages / bp) * n_groups;
  fill_identity_kernel<<<grid_for(rows * kLanes, kThreads, 4096), kThreads,
                         0, s>>>(out, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  scan_agg_grouped_kernel<<<grid_for(n_pages, kThreads, INT_MAX), kThreads,
                            0, s>>>(data, ts, gid, mem, m, n_pages, k, e,
                                    floor, gprm, n_groups, bp, out);
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

extern "C" int rsa_delta_fold(const int* acc, const int* delta, int lp,
                              long long dp, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t cerr = cudaMemcpyAsync(out, acc,
                                     static_cast<size_t>(lp) * 128 *
                                         sizeof(int),
                                     cudaMemcpyDeviceToDevice, s);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  size_t smem = static_cast<size_t>(lp) * kLanes * sizeof(int);
  int use_smem = smem <= kSmemCap;
  delta_fold_kernel<<<grid_for(dp, kThreads, 264), kThreads,
                      use_smem ? smem : 0, s>>>(delta, lp, dp, use_smem, out);
  return static_cast<int>(cudaGetLastError());
}
