// RSS visibility resolve shared by every kernel that reads a K-slot
// multiversion store one lane a page: the gathers' tile route
// (gather.cu) and the scan+aggregate kernels (rss_scan_agg.cu).
//
// Layout: ts [P, K] int32, member_ts [M] int32 sorted ascending.  A slot
// is visible when ts <= floor or ts is a member; a page resolves to the
// first strict maximum of its masked timestamps (visible -> ts, else
// -1), so ties go to the lowest slot and a page with no visible slot
// reads slot 0 — what the references' max/min over the mask give.
//
// Members: each block stages them once, in kStageBytes of shared memory,
// as `staging_mode` says: a bitmap over [mem[0], mem[M-1]] when that span
// (computed in 64 bits) is at most kBitmapBits, else the sorted array when
// M is at most kArrayCap, else they stay in device memory and are
// binary-searched there.  The kernel reads mem[0] and mem[M-1] itself.
// gather.cu exports the rule to the wrappers (`vg_member_staging`).
//
// Timestamps: a lane holds at most kTileMaxK of them in registers, loaded
// as 16-byte vectors where K % 4 == 0 and ts sits on 16 bytes.  A page of
// more slots is walked kTileMaxK at a time with a running best
// (`resolve_any_k`).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileMaxK = 8;               // ts a lane holds

// member staging: a bitmap of up to 256 K bits (32 KB), or the array
constexpr long long kBitmapBits = 1LL << 18;
constexpr int kStageBytes = static_cast<int>(kBitmapBits / 8);
constexpr int kArrayCap = kStageBytes / 4;

enum Staging { kNone = 0, kBitmap = 1, kArray = 2, kGlobal = 3 };

// Where a block keeps M members whose first and last are lo and hi: the
// one rule, run by the kernels and exported to the wrappers.
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
// n <= kTileMaxK timestamps from `row` into t[] (16-byte vectors when
// `vec`: n % 4 == 0 and row on 16 bytes).
__device__ __forceinline__ void load_ts(int (&t)[kTileMaxK],
                                        const int* __restrict__ row, int n,
                                        bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kTileMaxK / 4; ++q) {
      if (4 * q < n) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(row) + q);
        t[4 * q] = x.x; t[4 * q + 1] = x.y;
        t[4 * q + 2] = x.z; t[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTileMaxK; ++j)
      if (j < n) t[j] = __ldcs(row + j);
  }
}

// Fold slots base .. base + n - 1 (timestamps t[0..n)) into the running
// first strict maximum (best, slot) of the masked timestamps; slot 0
// seeds it.
template <bool kMembers>
__device__ __forceinline__ void resolve_run(const int (&t)[kTileMaxK], int n,
                                            int base, int floor,
                                            const Members& ms, int& best,
                                            int& slot) {
#pragma unroll
  for (int j = 0; j < kTileMaxK; ++j) {
    if (j < n) {
      const int masked = visible<kMembers>(t[j], floor, ms) ? t[j] : -1;
      if (base + j == 0 || masked > best) { best = masked; slot = base + j; }
    }
  }
}

// The slot of the first strict maximum of the masked timestamps, k <=
// kTileMaxK of them already in t[].
template <bool kMembers>
__device__ __forceinline__ int resolve(const int (&t)[kTileMaxK], int k,
                                       int floor, const Members& ms) {
  int best = 0, slot = 0;
  resolve_run<kMembers>(t, k, 0, floor, ms, best, slot);
  return slot;
}

// The same for a page of any k >= 1 slots whose timestamps start at
// `row`: kTileMaxK at a time through t[] (`vec` as `load_ts`: k % 4 == 0
// and ts on 16 bytes).
template <bool kMembers>
__device__ __forceinline__ int resolve_any_k(int (&t)[kTileMaxK],
                                             const int* __restrict__ row,
                                             int k, bool vec, int floor,
                                             const Members& ms) {
  int best = 0, slot = 0;
  for (int base = 0; base < k; base += kTileMaxK) {
    const int n = k - base < kTileMaxK ? k - base : kTileMaxK;
    load_ts(t, row + base, n, vec);
    resolve_run<kMembers>(t, n, base, floor, ms, best, slot);
  }
  return slot;
}

}  // namespace
