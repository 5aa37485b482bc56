// Snapshot-read gather kernels for Hopper (sm_90a): visibility resolve of
// every page of a K-slot multiversion store, then a copy of the chosen
// slot's payload row.
//
// Hand-written CUDA replacements for the Pallas TPU kernels
// `version_gather` (src/repro/kernels/version_gather/kernel.py) and
// `rss_gather` (src/repro/kernels/rss_gather/kernel.py).  The wrappers in
// src/repro_torch/kernels/{version_gather,rss_gather}/kernel.py load this
// file's C entry points with ctypes; `plan` in rss_gather/kernel.py owns
// the route and the launch shape, and the entries refuse any other.
//
// Layout: data [P, K, E] of any element type (row_bytes = E * itemsize),
// ts [P, K] int32, member_ts [M] int32 sorted ascending, out [P, E].
// Visibility of a slot: ts <= floor (version_gather: floor = watermark,
// no members), or ts in member_ts (rss_gather).  A page resolves to the
// first strict maximum of its masked timestamps (visible -> ts, else -1),
// so ties go to the lowest slot and a page with no visible slot reads
// slot 0 — exactly what the references' max/min over the mask give.  The
// copy is raw bytes, so one kernel serves every element type and copies
// NaN, Inf and -0.0 bit for bit.  Offsets are 64-bit.
//
// Bound on the card: memory.  Per page the function must read K*4 bytes
// of ts and one row of row_bytes, and write one row; plus M*4 bytes of
// members.  The arithmetic (a compare, or a bit test, per slot) is
// negligible.  The kernels move no other bytes: no one-hot over K (the
// TPU loads all K slots of a [BP, K, BE] block), no intermediate buffer.
//
// What held the first design (one warp a page for every store) back, on
// an H100 at the mirror's shape (int32, P 400,000, K 8, E 32: 128-byte
// rows; 0.1218 ms against a 0.0344 ms bound, PERF.md): 8 lanes loaded the
// page's ts, the warp reduced with 5 rounds of shuffles, then 8 lanes
// copied the row while 24 idled; every page paid a ts load, then the
// dependent row load; at 48 warps an SM that kept ~6 KB of rows in flight
// where the memory's latency asks for ~20 KB; and rss_gather
// binary-searched the members in global memory, 6-12 dependent loads in
// front of the row (M = 0 / 64 / 4,096: 0.1289 / 0.1614 / 0.1922 ms).
// Wide rows (2 KB, the param store) already kept 2 KB in flight a warp
// and reached 87% of the bound.
//
// Routes (the wrapper's `plan` picks one; one launch a call):
// - tile (rows of at most 512 bytes, on 16 bytes and a multiple of 16
//   bytes long, K <= 8; the mirror): a persistent grid of 3 blocks an SM,
//   each warp walking over tiles of pages (4 KB of rows a tile: 32 pages
//   of 128 bytes).  One lane a page resolves: the lane's K timestamps in
//   registers, loaded as 16-byte vectors where K % 4 == 0 and ts sits on
//   16 bytes, no shuffle.  Then all 32 lanes copy the tile's rows in
//   16-byte units, each lane's 8 loads issued before its stores (~96 KB
//   of rows in flight an SM); the tile's output rows are contiguous, so
//   the stores coalesce in full.  The next tile's timestamps are loaded
//   into the same registers before the copy, so they are in flight while
//   the rows move.  3 blocks an SM is the occupancy of its 72-78
//   registers; more blocks an SM stage the members more often and were
//   measured slower with members, no faster without (PERF.md).  Each
//   block stages the members once, in shared memory (kStageBytes), as
//   `staging_mode` says: a bitmap over [mem[0], mem[M-1]] when that span
//   (computed in 64 bits) is at most kBitmapBits, else the sorted array
//   when M is at most kArrayCap, else they stay in device memory and are
//   binary-searched there.  The kernel reads mem[0] and mem[M-1] itself.
// - warp (everything else: wide rows such as the param store's 2 KB, rows
//   off 16 bytes or of odd length, K > 8): one warp a page, lanes over
//   slots, a shuffle reduction, then the row in 16-byte units where both
//   addresses allow, else the widest unit that divides both addresses and
//   the length.  Its grid covers every page (8 a block; grid-stride
//   beyond 2^20 blocks): at 2 KB rows a persistent grid measured slower,
//   the hardware's block scheduler balancing the last pages better than
//   a fixed split.  Members are binary-searched in device memory, where
//   at 2 KB rows the search hides under the copy.
// A 1-D TMA route (cp.async.bulk through a ring in shared memory) was
// measured and deleted: no faster than the LSU copy (PERF.md).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// route codes, as the wrapper passes them
constexpr int kRouteTile = 0;
constexpr int kRouteWarp = 1;

// launch shapes (rss_gather/kernel.py's `plan` holds the same numbers)
constexpr int kTileThreads = 256, kTileBlocksPerSm = 3;
constexpr int kWarpThreads = 256;
constexpr long long kWarpMaxGrid = 1LL << 20;   // grid-stride beyond ~8M
constexpr long long kTileBytes = 4096;     // rows a warp's tile
constexpr long long kTileMaxRow = 512;     // one warp-wide 16-byte access
constexpr int kTileMaxK = 8;               // ts a lane holds
constexpr int kUnits = 8;                  // 16-byte loads a lane batches

// member staging: a bitmap of up to 256 K bits (32 KB), or the array
constexpr long long kBitmapBits = 1LL << 18;
constexpr int kStageBytes = static_cast<int>(kBitmapBits / 8);
constexpr int kArrayCap = kStageBytes / 4;

// ------------------------------------------------------------- members
enum Staging { kNone = 0, kBitmap = 1, kArray = 2, kGlobal = 3 };

// Where a tile-route block keeps M members whose first and last are lo
// and hi: the one rule, run by the kernel and exported to the wrappers
// (`vg_member_staging`).
__host__ __device__ constexpr int staging_mode(int m, int lo, int hi) {
  return m <= 0 ? kNone
         : static_cast<long long>(hi) - lo + 1 >= 1 &&
                   static_cast<long long>(hi) - lo + 1 <= kBitmapBits
             ? kBitmap
         : m <= kArrayCap ? kArray
                          : kGlobal;
}

struct Members {
  int mode;                  // a Staging
  int lo, hi, m;
  const unsigned* bits;      // bitmap, or the staged array (as int)
  const int* mem;            // global members
};

__device__ __forceinline__ bool lower_bound_has(const int* a, int m, int t,
                                                bool global) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    int v = global ? __ldg(a + mid) : a[mid];
    if (v < t) lo = mid + 1; else hi = mid;
  }
  return lo < m && (global ? __ldg(a + lo) : a[lo]) == t;
}

// Every thread of the block calls this once, before any other use of
// `stage` (kStageBytes of shared memory; unused when m == 0).
__device__ Members stage_members(const int* __restrict__ mem, int m,
                                 unsigned* stage) {
  Members ms{kNone, 0, 0, m, stage, mem};
  if (m == 0) return ms;
  ms.lo = __ldg(mem);
  ms.hi = __ldg(mem + m - 1);
  ms.mode = staging_mode(m, ms.lo, ms.hi);
  if (ms.mode == kBitmap) {
    const long long span = static_cast<long long>(ms.hi) - ms.lo + 1;
    const int words = static_cast<int>((span + 31) >> 5);
    for (int w = threadIdx.x; w < words; w += blockDim.x) stage[w] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const unsigned off = static_cast<unsigned>(__ldg(mem + i)) -
                           static_cast<unsigned>(ms.lo);
      atomicOr(stage + (off >> 5), 1u << (off & 31));
    }
  } else if (ms.mode == kArray) {
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      stage[i] = static_cast<unsigned>(__ldg(mem + i));
  }
  __syncthreads();
  return ms;
}

__device__ __forceinline__ bool is_member(int t, const Members& ms) {
  switch (ms.mode) {
    case kBitmap: {
      if (t < ms.lo || t > ms.hi) return false;
      const unsigned off = static_cast<unsigned>(t) -
                           static_cast<unsigned>(ms.lo);
      return (ms.bits[off >> 5] >> (off & 31)) & 1u;
    }
    case kArray:
      return lower_bound_has(reinterpret_cast<const int*>(ms.bits), ms.m,
                             t, false);
    case kGlobal:
      return lower_bound_has(ms.mem, ms.m, t, true);
    default:
      return false;
  }
}

template <bool kMembers>
__device__ __forceinline__ bool visible(int t, int floor,
                                        const Members& ms) {
  return t <= floor || (kMembers && is_member(t, ms));
}

// ------------------------------------------------- one lane, one page
// The page's K <= kTileMaxK timestamps into t[] (16-byte vectors when
// `vec`: K % 4 == 0 and ts on 16 bytes).
__device__ __forceinline__ void load_ts(int (&t)[kTileMaxK],
                                        const int* __restrict__ row, int k,
                                        bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kTileMaxK / 4; ++q) {
      if (4 * q < k) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(row) + q);
        t[4 * q] = x.x; t[4 * q + 1] = x.y;
        t[4 * q + 2] = x.z; t[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTileMaxK; ++j)
      if (j < k) t[j] = __ldcs(row + j);
  }
}

// The slot of the first strict maximum of the masked timestamps.
template <bool kMembers>
__device__ __forceinline__ int resolve(const int (&t)[kTileMaxK], int k,
                                       int floor, const Members& ms) {
  int best = 0, slot = 0;
#pragma unroll
  for (int j = 0; j < kTileMaxK; ++j) {
    if (j < k) {
      const int masked = visible<kMembers>(t[j], floor, ms) ? t[j] : -1;
      if (j == 0 || masked > best) { best = masked; slot = j; }
    }
  }
  return slot;
}

// ---------------------------------------------------------- tile route
template <bool kMembers>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
gather_tile_kernel(const char* __restrict__ data, const int* __restrict__ ts,
                   const int* __restrict__ mem, int m, int floor,
                   long long n_pages, int k, long long row_bytes, int ppw,
                   char* __restrict__ out) {
  extern __shared__ unsigned stage[];
  const Members ms = kMembers ? stage_members(mem, m, stage)
                              : Members{kNone, 0, 0, 0, stage, mem};
  const int lane = threadIdx.x & 31;
  constexpr int kWarps = kTileThreads / 32;
  const long long n_tiles = (n_pages + ppw - 1) / ppw;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const int r16 = static_cast<int>(row_bytes >> 4);   // 16-byte units a row
  const bool vec = (reinterpret_cast<uintptr_t>(ts) & 15) == 0 &&
                   (k & 3) == 0;
  const uint4* __restrict__ src = reinterpret_cast<const uint4*>(data);
  uint4* __restrict__ dst = reinterpret_cast<uint4*>(out);

  long long tile = static_cast<long long>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
  int t[kTileMaxK] = {};
  if (tile < n_tiles && lane < ppw && tile * ppw + lane < n_pages)
    load_ts(t, ts + (tile * ppw + lane) * k, k, vec);
  for (; tile < n_tiles; tile += warps) {
    const long long base = tile * ppw;
    const int slot = resolve<kMembers>(t, k, floor, ms);
    // the next tile's timestamps, in flight while this tile's rows move
    const long long next = tile + warps;
    if (next < n_tiles && lane < ppw && next * ppw + lane < n_pages)
      load_ts(t, ts + (next * ppw + lane) * k, k, vec);
    const long long left = n_pages - base;
    const int units = static_cast<int>(left < ppw ? left : ppw) * r16;
    uint4* __restrict__ to = dst + base * r16;
    for (int u0 = 0; u0 < units; u0 += 32 * kUnits) {
      uint4 v[kUnits];
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int u = u0 + j * 32 + lane;
        const int pg = u / r16;
        const int s = __shfl_sync(kFull, slot, pg & 31);
        if (u < units)
          v[j] = __ldg(src + ((base + pg) * k + s) * r16 + (u - pg * r16));
      }
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int u = u0 + j * 32 + lane;
        if (u < units) to[u] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------- warp route
template <int U> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = unsigned int; };
template <> struct Unit<2> { using T = unsigned short; };
template <> struct Unit<1> { using T = unsigned char; };

// The warp copies n bytes (a multiple of U) from src to dst in U-byte
// units; src and dst are U-byte aligned.
template <int U>
__device__ __forceinline__ void copy_units(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long n, int lane) {
  using T = typename Unit<U>::T;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (long long i = lane; i < n / U; i += 32) d[i] = __ldg(s + i);
}

// Copy in the widest unit (<= 16 bytes) that divides `align`.
__device__ __forceinline__ void copy_widest(const char* __restrict__ src,
                                            char* __restrict__ dst,
                                            long long n, uintptr_t align,
                                            int lane) {
  if ((align & 7) == 0) copy_units<8>(src, dst, n, lane);
  else if ((align & 3) == 0) copy_units<4>(src, dst, n, lane);
  else if ((align & 1) == 0) copy_units<2>(src, dst, n, lane);
  else copy_units<1>(src, dst, n, lane);
}

template <bool kMembers>
__global__ void __launch_bounds__(kWarpThreads) gather_warp_kernel(
    const char* __restrict__ data, const int* __restrict__ ts,
    const int* __restrict__ mem, int m, int floor, long long n_pages, int k,
    long long row_bytes, int /*ppw: 1*/, char* __restrict__ out) {
  const Members ms{kMembers && m > 0 ? kGlobal : kNone, 0, 0, m, nullptr,
                   mem};
  const int lane = threadIdx.x & 31;
  constexpr int kWarps = kWarpThreads / 32;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long p = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       p < n_pages; p += warps) {
    // each lane's newest visible slot among j = lane, lane + 32, ...; the
    // sentinel slot k loses every tie against a real slot
    const int* row = ts + p * k;
    int best = INT_MIN, slot = k;
    for (int j = lane; j < k; j += 32) {
      int t = __ldg(row + j);
      int masked = visible<kMembers>(t, floor, ms) ? t : -1;
      if (slot == k || masked > best) { best = masked; slot = j; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      int ob = __shfl_xor_sync(kFull, best, off);
      int os = __shfl_xor_sync(kFull, slot, off);
      if (ob > best || (ob == best && os < slot)) { best = ob; slot = os; }
    }
    const char* src = data + (p * k + slot) * row_bytes;
    char* dst = out + p * row_bytes;
    uintptr_t addr = reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst);
    if ((addr & 15) == 0) {
      long long body = row_bytes & ~15LL;
      copy_units<16>(src, dst, body, lane);
      if (body < row_bytes)
        copy_widest(src + body, dst + body, row_bytes - body,
                    static_cast<uintptr_t>(row_bytes), lane);
    } else {
      copy_widest(src, dst, row_bytes,
                  addr | static_cast<uintptr_t>(row_bytes), lane);
    }
  }
}

// ------------------------------------------------------------- launch
using Kernel = void (*)(const char*, const int*, const int*, int, int,
                        long long, int, long long, int, char*);

struct Shape {
  Kernel kernel;
  int block;
  long long ppw;             // pages a warp takes at a time
  long long max_grid;
};

// The route's kernel and launch shape, as `plan` computes them (the grid
// is the blocks the tiles need, at most max_grid); a null kernel for a
// route that does not take this store.
template <bool kMembers>
Shape shape_of(int route, int k, long long row_bytes, bool aligned,
               int sms) {
  switch (route) {
    case kRouteTile: {
      if (!aligned || row_bytes % 16 != 0 || k > kTileMaxK ||
          row_bytes > kTileMaxRow)
        break;
      const long long ppw = kTileBytes / row_bytes;
      return {gather_tile_kernel<kMembers>, kTileThreads,
              ppw > 32 ? 32 : ppw,
              static_cast<long long>(sms) * kTileBlocksPerSm};
    }
    case kRouteWarp:
      return {gather_warp_kernel<kMembers>, kWarpThreads, 1, kWarpMaxGrid};
  }
  return {nullptr, 0, 0, 0};
}

template <bool kMembers>
int launch(const void* data, const int* ts, const int* mem, int m, int floor,
           long long n_pages, int k, long long row_bytes, void* out,
           int route, long long grid, int block, int ppw, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(data) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const Shape sh = shape_of<kMembers>(route, k, row_bytes, aligned, sms);
  if (sh.kernel == nullptr || n_pages < 1 || k < 1 || row_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps_per_block = sh.block / 32;
  const long long tiles = (n_pages + sh.ppw - 1) / sh.ppw;
  const long long want = (tiles + warps_per_block - 1) / warps_per_block;
  if (block != sh.block || ppw != sh.ppw ||
      grid != (want < sh.max_grid ? want : sh.max_grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool staged = kMembers && route == kRouteTile && m > 0;
  sh.kernel<<<dim3(static_cast<unsigned>(grid)), block,
              staged ? kStageBytes : 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(data), ts, mem, m, floor, n_pages, k,
      row_bytes, ppw, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------ C entry points
// Each launches on `stream` and returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue for a route code the store does not take (tile:
// data and out on 16 bytes, rows a multiple of 16 bytes of at most 512,
// K <= 8; warp: any), or cudaErrorInvalidConfiguration when the grid,
// block or pages a warp are not the route's (`plan` in
// rss_gather/kernel.py).  route: 0 tile, 1 warp.  The wrappers never call
// them with n_pages == 0 or row_bytes == 0.

extern "C" int vg_version_gather(const void* data, const int* ts,
                                 long long n_pages, int k,
                                 long long row_bytes, int watermark,
                                 void* out, int route, long long grid,
                                 int block, int ppw, void* stream) {
  return launch<false>(data, ts, nullptr, 0, watermark, n_pages, k,
                       row_bytes, out, route, grid, block, ppw, stream);
}

extern "C" int vg_rss_gather(const void* data, const int* ts, const int* mem,
                             int m, long long n_pages, int k,
                             long long row_bytes, int floor, void* out,
                             int route, long long grid, int block, int ppw,
                             void* stream) {
  return launch<true>(data, ts, mem, m, floor, n_pages, k, row_bytes, out,
                      route, grid, block, ppw, stream);
}

// How a tile-route block keeps M members whose first and last are lo and
// hi (a Staging: 0 none, 1 bitmap, 2 shared array, 3 device memory), and
// the caps of that rule; the warp route always searches device memory.
extern "C" int vg_member_staging(int m, int lo, int hi) {
  return staging_mode(m, lo, hi);
}

extern "C" long long vg_bitmap_bits() { return kBitmapBits; }

extern "C" int vg_array_cap() { return kArrayCap; }
