// Fused RSS visibility resolve + aggregate kernels for Hopper (sm_90a).
//
// Hand-written CUDA replacements for the Pallas TPU kernels in
// src/repro/kernels/rss_scan_agg/kernel.py.  Each kernel returns what its
// TPU twin returns, bitwise; the contracts (shapes, lanes, sentinels) are
// documented in src/repro_torch/kernels/rss_scan_agg/kernel.py, which
// loads this file's C entry points with ctypes.
//
// Layout: data [P, K, E] int32 (element 0 = codec tag, element 1 = the
// aggregable field), ts [P, K] int32, member_ts [M] int32 sorted
// ascending.  Seven statistic lanes per accumulator row: sum, count,
// count_below, min (INT32_MAX when empty), max (INT32_MIN when empty),
// count_above, sum_below.
//
// Shared resolve (`resolve_page`, the TPU's `_resolve_tag_x`): one thread
// per page reads the page's K timestamps (contiguous), tests membership
// by `ts <= floor` or a binary search of the sorted member array (the TPU
// broadcast-compares against a 128-lane padded member tile instead), keeps
// the first strict maximum of the visible timestamps (no visible slot ->
// slot 0, exactly as the TPU's all -1 mask resolves), and then reads ONLY
// elements 0 and 1 of the chosen slot (the TPU loads the whole
// [BP, K, E] block and reduces a one-hot over K).
//
// Bound on the card: every scan kernel is memory-bound.  Per page it must
// read K*4 bytes of ts plus one 32-byte sector of the chosen slot (the tag
// and field), plus 4 bytes of gid for the grouped kernels, and write its
// partial rows; at 3.35 TB/s that is ~7.6 us for P = 400k, K = 8.  The
// arithmetic (a handful of compares per slot) is negligible.  The design
// keeps the device traffic at that minimum: no one-hot over K, no
// intermediate select buffer (the TPU's chunked path packs a [rows, 256]
// stream to device memory between its two stages), and reductions in
// shared memory or atomics instead of per-block tiles of 128 lanes.
//
// Integer semantics: additive lanes are computed in uint32, so wraparound
// is two's complement exactly like jnp's int32 (signed overflow is
// undefined behaviour in C++).  Atomic add/min/max are order-independent,
// so results do not depend on scheduling.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 7;
constexpr int kThreads = 256;
constexpr int kSmemCap = 48 * 1024;   // static shared-memory limit per block

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

// RSS visibility resolve of page p: newest member-visible slot (first
// strict maximum of the masked timestamps), then its tag and field.
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

__global__ void fill_identity_kernel(int* out, long long rows) {
  long long n = rows * kLanes;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = identity(static_cast<int>(i % kLanes));
}

// ---------------------------------------------------------------------------
// rss_scan_agg: replaces `rss_scan_agg` / `_kernel` (TPU kernel.py:123,189).
// One thread per page; a block holds whole BP-page segments (blockDim is a
// multiple of BP), and each segment's first thread folds the segment's
// (x, valid) pairs from shared memory into its partial row.
// ---------------------------------------------------------------------------
constexpr int kMaxSegBlock = 1024;

__global__ void scan_agg_kernel(const int* __restrict__ data,
                                const int* __restrict__ ts,
                                const int* __restrict__ mem, int m,
                                long long n_pages, int k, int e, int floor,
                                int tag_main, int tag_alt, int thr, int bp,
                                int* __restrict__ out) {
  __shared__ int sx[kMaxSegBlock];
  __shared__ unsigned char sv[kMaxSegBlock];
  int t = threadIdx.x;
  long long p = blockIdx.x * (long long)blockDim.x + t;
  int x = 0;
  bool valid = false;
  if (p < n_pages) {
    TagX r = resolve_page(data, ts, mem, m, floor, p, k, e);
    valid = r.tag == tag_main || r.tag == tag_alt;
    x = r.x;
  }
  sx[t] = x;
  sv[t] = valid;
  __syncthreads();
  if (p >= n_pages || t % bp) return;
  unsigned sum = 0, sumb = 0;
  int cnt = 0, below = 0, above = 0, mn = INT_MAX, mx = INT_MIN;
  for (int i = t; i < t + bp; ++i) {
    if (!sv[i]) continue;
    int v = sx[i];
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
// One pass: grid (blocks per chunk, chunks); a block resolves pages of ONE
// chunk (chunk c = padded pages [c*cp, (c+1)*cp), the `_chunk_shape`
// boundaries; padding pages beyond P contribute nothing and are never
// materialised), accumulates into a [G, 7] shared-memory tile with shared
// atomics, and merges the tile's touched rows into out[c] with global
// atomics.  When [G, 7] does not fit shared memory, pages add straight
// into global memory.
// ---------------------------------------------------------------------------
__global__ void scan_agg_chunked_kernel(
    const int* __restrict__ data, const int* __restrict__ ts,
    const int* __restrict__ gid, const int* __restrict__ mem, int m,
    long long n_pages, int k, int e, int floor,
    const int* __restrict__ gprm, int n_groups, long long cp, int use_smem,
    int* __restrict__ out) {
  extern __shared__ int tile[];
  int c = blockIdx.y;
  int* dst = out + (long long)c * n_groups * kLanes;
  if (use_smem) {
    for (int i = threadIdx.x; i < n_groups * kLanes; i += blockDim.x)
      tile[i] = identity(i % kLanes);
    __syncthreads();
  }
  long long stop = min((long long)(c + 1) * cp, n_pages);
  for (long long p = c * cp + blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < stop; p += (long long)gridDim.x * blockDim.x) {
    int g = __ldg(gid + p);
    if (g < 0 || g >= n_groups) continue;
    TagX r = resolve_page(data, ts, mem, m, floor, p, k, e);
    const int* prm = gprm + 3 * g;
    if (r.tag != __ldg(prm) && r.tag != __ldg(prm + 1)) continue;
    accumulate((use_smem ? tile : dst) + g * kLanes, r.x, __ldg(prm + 2));
  }
  if (!use_smem) return;
  __syncthreads();
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x)
    if (tile[g * kLanes + 1]) merge_row(dst + g * kLanes, tile + g * kLanes);
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

}  // namespace

// ------------------------------------------------------------ C entry points
// Each launches on `stream` and returns cudaGetLastError() (0 = launched).

extern "C" int rsa_scan_agg(const int* data, const int* ts, const int* mem,
                            int m, long long n_pages, int k, int e, int floor,
                            int tag_main, int tag_alt, int thr, int bp,
                            int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = bp * (kThreads / bp > 0 ? kThreads / bp : 1);
  int blocks = grid_for(n_pages, threads, INT_MAX);
  scan_agg_kernel<<<blocks, threads, 0, s>>>(data, ts, mem, m, n_pages, k, e,
                                             floor, tag_main, tag_alt, thr,
                                             bp, out);
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

extern "C" int rsa_scan_agg_chunked(const int* data, const int* ts,
                                    const int* gid, const int* mem, int m,
                                    long long n_pages, int k, int e,
                                    int floor, const int* gprm, int n_groups,
                                    long long cp, int nc, int* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long rows = (long long)nc * n_groups;
  fill_identity_kernel<<<grid_for(rows * kLanes, kThreads, 4096), kThreads,
                         0, s>>>(out, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  size_t smem = static_cast<size_t>(n_groups) * kLanes * sizeof(int);
  int use_smem = smem <= kSmemCap;
  dim3 grid(grid_for(cp, kThreads, 1024 / nc > 0 ? 1024 / nc : 1), nc);
  scan_agg_chunked_kernel<<<grid, kThreads, use_smem ? smem : 0, s>>>(
      data, ts, gid, mem, m, n_pages, k, e, floor, gprm, n_groups, cp,
      use_smem, out);
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
