// Snapshot-read gather kernels for Hopper (sm_90a): visibility resolve of
// every page of a K-slot multiversion store, then a copy of the chosen
// slot's payload row.
//
// Hand-written CUDA replacements for the Pallas TPU kernels
// `version_gather` (src/repro/kernels/version_gather/kernel.py) and
// `rss_gather` (src/repro/kernels/rss_gather/kernel.py).  The wrappers in
// src/repro_torch/kernels/{version_gather,rss_gather}/kernel.py load this
// file's C entry points with ctypes.
//
// Layout: data [P, K, E] of any element type (row_bytes = E * itemsize),
// ts [P, K] int32, member_ts [M] int32 sorted ascending, out [P, E].
// Visibility of a slot: ts <= floor (version_gather: floor = watermark,
// no members), or ts in member_ts (rss_gather).  A page resolves to the
// first strict maximum of its masked timestamps (visible -> ts, else -1),
// so ties go to the lowest slot and a page with no visible slot reads
// slot 0 — exactly what the references' max/min over the mask give.
//
// Design (not the TPU's): one warp per page.  The lanes read the page's K
// timestamps (K > 32 loops), test membership by binary search of the
// sorted members and only for slots above the floor (the TPU compares
// against a member tile padded to 128 lanes), reduce (masked ts, slot)
// across the warp with shuffles, and then copy ONLY the chosen slot's row
// (the TPU loads all K slots of a [BP, K, BE] block and sums a one-hot
// product over K).  The copy is raw bytes, so one kernel serves every
// element type and copies NaN, Inf and -0.0 bit for bit; rows whose source
// and destination are 16-byte aligned move in 16-byte vectors with a tail
// in the widest unit the row length allows, other rows in the widest unit
// that divides both addresses and the length.  Offsets are 64-bit.
//
// Bound on the card: memory.  Per page the function must read K*4 bytes
// of ts and one row of row_bytes, and write one row; plus M*4 bytes of
// members.  The arithmetic (a compare or a short binary search per slot)
// is negligible.  The kernel moves no other bytes: no one-hot over K, no
// intermediate buffer.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool in_members(int t, const int* __restrict__ mem,
                                           int m) {
  int lo = 0, hi = m;                  // lower_bound over the sorted members
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(mem + mid) < t) lo = mid + 1; else hi = mid;
  }
  return lo < m && __ldg(mem + lo) == t;
}

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
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const char* __restrict__ data, const int* __restrict__ ts,
    const int* __restrict__ mem, int m, int floor, long long n_pages, int k,
    long long row_bytes, char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long p = (long long)blockIdx.x * kWarpsPerBlock +
                     (threadIdx.x >> 5);
       p < n_pages; p += warps) {
    // each lane's newest visible slot among j = lane, lane + 32, ...; the
    // sentinel slot k loses every tie against a real slot
    const int* row = ts + p * k;
    int best = INT_MIN, slot = k;
    for (int j = lane; j < k; j += 32) {
      int t = __ldg(row + j);
      bool vis = t <= floor || (kMembers && in_members(t, mem, m));
      int masked = vis ? t : -1;
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

int blocks_for(long long n_pages) {
  long long g = (n_pages + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = 1LL << 20;     // grid-stride beyond ~8M pages
  return static_cast<int>(g < cap ? g : cap);
}

}  // namespace

// ------------------------------------------------------------ C entry points
// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// The wrappers never call them with n_pages == 0 or row_bytes == 0.

extern "C" int vg_version_gather(const void* data, const int* ts,
                                 long long n_pages, int k,
                                 long long row_bytes, int watermark,
                                 void* out, void* stream) {
  gather_kernel<false><<<blocks_for(n_pages), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(data), ts, nullptr, 0, watermark, n_pages, k,
      row_bytes, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vg_rss_gather(const void* data, const int* ts, const int* mem,
                             int m, long long n_pages, int k,
                             long long row_bytes, int floor, void* out,
                             void* stream) {
  gather_kernel<true><<<blocks_for(n_pages), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(data), ts, mem, m, floor, n_pages, k,
      row_bytes, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}
