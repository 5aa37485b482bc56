// RWKV6 WKV recurrence for Hopper (sm_90a): the data-dependent,
// per-channel-decay linear attention of RWKV-6 "Finch" (arXiv:2404.05892),
// per (batch, head) with state S [N, N] (rows: the k-dim i, columns: the
// v-dim j):
//
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- exp(w_log_t[i]) * S[i][j] + k_t[i] * v_t[j]
//
// Hand-written CUDA replacement for the Pallas TPU kernel `wkv_scan`
// (src/repro/kernels/wkv_scan/kernel.py).  The wrapper in
// src/repro_torch/kernels/wkv_scan/kernel.py chooses the route and the
// launch shape, and loads this file's C entry point with ctypes.
//
// Bound on the card.  Prefill (B = 8, T = 1,024, H = 40, N = 64, f32):
// r, k, v, w_log 4 x 83.9 MB, o 83.9 MB, S 5.2 MB: 0.425 GB, 0.127 ms at
// 3.35 TB/s; 5 N^2 flops per step and head, 6.7 GFLOP, 0.100 ms at the
// 67 TFLOP/s f32 peak outside the tensor cores: bound by bytes, with the
// FMA pipes close behind.  Decode (T = 1): the state's 2 x 5.2 MB, 3.1 us.
//
// Why f32 FMA and not the tensor cores.  A chunked form (o = (r S) + the
// intra-chunk products, S advanced once a chunk) puts the work in matrix
// products, but the decays make its factors span many decades, so TF32
// would not hold the 1e-4 checks and 3xTF32 would triple the products.
// The FMA pipes already run under the byte floor, so the tensor cores buy
// nothing here: the design instead keeps the FMA pipes fed.
//
// Route "chunked" (T > 1), `wkv_kernel_chunked`.  Column j of S evolves on
// its own: o_t[j] needs only column j and the step's scalar
// sum_i r_i u_i k_i.  One block of 2N threads owns one (b, h).  A lane
// holds kCpl = 4 columns of S over N / 8 rows in registers (i = 32 m +
// 4 g + e for its row group g), and the 8 lanes of a column group split
// the rows, so a step is 3 x 4 x N / 8 FMA-pipe operations a lane on
// broadcast float4 reads of r, k and the decay (the 8 row groups read 8
// adjacent 16-byte words: one shared-memory wavefront), and o is joined
// over the 8 lanes by four shuffles, the first two of which also part the
// four columns.  Four columns a lane halve the shared-memory reads per
// operation against two; whole-head blocks stage each chunk once, where
// splitting a head's columns over 2 or 4 blocks (more warps on the card)
// staged and prepared every row in each block and measured slower.  Each
// chunk of kChunk steps of r, k, w_log and v goes into a two-stage
// shared-memory ring by 16-byte cp.async copies, so the next chunk is in
// flight under the current chunk's arithmetic without holding registers
// (operands whose rows do not start on 16 bytes are staged by plain loads
// instead: `kAsync` false).  Once a chunk has landed, one pass computes
// exp(w_log) once per element per block (and widens 16-bit r and k), and
// each warp reduces a step's bonus scalar over its 32 lanes.  The step
// loop is unrolled by 4, so that one step's shuffle chain overlaps the
// next steps' reads and FMAs.  What bounds it on the card: at B = 8,
// H = 40 the grid is 320 blocks of 4 warps, 2 or 3 an SM: each warp's
// step is a chain of shared-memory reads, FMAs and shuffles that ~10
// warps an SM only partly hide, and the third block on 56 SMs sets the
// pace.
//
// Route "step" (T = 1), `wkv_kernel_step`: one decode token.  The step is
// elementwise over the state: S' = diag(exp w) S + k v^T, and
// o = r^T S + (sum_i r_i u_i k_i) v, which reads the old S.  A block of
// N^2 / 8 threads owns one (b, h); each thread owns two float4s of S
// (rows i0 + m N / 2, four adjacent columns), read and written as
// coalesced 16-byte accesses (element accesses when the state's rows do
// not start on 16 bytes), and o is reduced over rows by shuffles and
// shared memory.  Bound by the state's bytes and one round trip to
// device memory.  Each thread reads its elements before it writes them,
// so s0 may be the output state: a decode step updates it in place.
// The chunked route takes T = 1 too, but stages a whole chunk, computes
// its decays and runs 4 warps a head: at RWKV6-3B's decode shape on an
// H100 the step route takes ~0.71x its time (PERF.md), so it keeps its
// kernel.
//
// Layouts.  Every operand is read and written through element strides
// (the last dim contiguous): r, k, v, w_log as [B, H, T, N] views of the
// model's [B, T, H, N] tensors, u as a stride-0 batch view of [H, N], o
// written in [B, T, H, N] memory order, S in [B, H, N, N].  Element types
// of r, k, v, w_log: f32, bf16, f16, widened to f32; u, s0, o and S are
// f32.  N in {32, 64}; any T >= 1 (the Pallas kernel asserts
// T % chunk == 0).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 16;      // steps per ring stage
constexpr int kStages = 2;      // ring depth (chunks in flight + 1)
constexpr int kCpl = 4;         // columns of S per lane
constexpr int kGroups = 8;      // lanes sharing one lane's columns, by rows

// threads of a chunked block: one (b, h), N / kCpl column groups of 8 lanes
template <int N>
struct Chunked {
  static constexpr int kThreads = N / kCpl * kGroups;
};

template <typename Elt> __device__ __forceinline__ float to_f(Elt x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;              // nullptr: S starts at zero
  float* o;
  float* s;
  // element strides: r, k, v, w (b, h, t); u (b, h); s0 (b, h, i);
  // o (b, h, t); s (b, h, i)
  long long rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt;
  long long ub, uh, s0b, s0h, s0i, ob, oh, ot, sb, sh, si;
  int heads, t_len;
  int vec;                      // step route: the state moves as float4
};

// One 16-byte piece of a ring row: `valid` of its bytes come from `src`,
// the rest are zero.  cp.async when kAsync (src then starts on 16 bytes),
// else element loads and a shared-memory store.
template <typename Elt, bool kAsync>
__device__ __forceinline__ void stage_piece(Elt* dst, const Elt* src,
                                            int valid) {
  if constexpr (kAsync) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid));
  } else {
    constexpr int kVec = 16 / static_cast<int>(sizeof(Elt));
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      dst[e] = e * static_cast<int>(sizeof(Elt)) < valid ? src[e]
                                                          : Elt(0.f);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

template <typename Elt, int N>
struct ChunkSmem {
  static constexpr bool kWide = !std::is_same<Elt, float>::value;
  Elt rkw[kStages][3][kChunk][N];   // raw r, k, w_log rows (the ring)
  Elt v[kStages][kChunk][N];        // raw v
  float decay[kChunk][N];           // exp(w_log) of the current chunk
  float rk[2][kWide ? kChunk : 1][N];   // r, k widened (16-bit types)
  float bonus[kChunk];              // sum_i r_i u_i k_i per step
};

template <typename Elt, int N, bool kAsync>
__global__ void __launch_bounds__(Chunked<N>::kThreads) wkv_kernel_chunked(
    const WkvArgs a) {
  constexpr int kThreads = Chunked<N>::kThreads;
  constexpr int kRows = N / kGroups;                // rows per lane
  constexpr int kVec = 16 / static_cast<int>(sizeof(Elt));
  constexpr int kRowPieces = N / kVec;              // 16-byte pieces a row
  constexpr bool kWide = ChunkSmem<Elt, N>::kWide;
  __shared__ __align__(16) ChunkSmem<Elt, N> sm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & 7;                           // row group
  const int j0 = kCpl * (warp * 4 + (lane >> 3));  // first column
  const long long b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int T = a.t_len;
  const Elt* src[4] = {
      static_cast<const Elt*>(a.r) + b * a.rb + h * a.rh,
      static_cast<const Elt*>(a.k) + b * a.kb + h * a.kh,
      static_cast<const Elt*>(a.w) + b * a.wb + h * a.wh,
      static_cast<const Elt*>(a.v) + b * a.vb + h * a.vh};
  const long long ts[4] = {a.rt, a.kt, a.wt, a.vt};

  // a lane's rows: i = 32 m + 4 g + e (the 8 lanes of a group read 8
  // adjacent 16-byte words: no bank conflict)
  auto row_of = [](int q, int grp) { return 32 * (q / 4) + 4 * grp + q % 4; };
  // u at the rows the bonus pass gives this lane: lane + 32 q
  float up[N / 32];
#pragma unroll
  for (int q = 0; q < N / 32; ++q)
    up[q] = a.u[b * a.ub + h * a.uh + lane + 32 * q];

  // this lane's rows of columns j0 .. j0 + kCpl - 1
  float S[kCpl][kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float* sp = a.s0 + b * a.s0b + h * a.s0h + row_of(q, g) * a.s0i +
                      j0;
#pragma unroll
    for (int j = 0; j < kCpl; ++j)
      S[j][q] = a.s0 != nullptr ? sp[j] : 0.f;
  }

  // copy the chunk at t0 into `stage` (rows past T read as zeros): each
  // of r, k, w_log, v is kChunk rows of kRowPieces 16-byte pieces; one
  // commit group per chunk, empty or not, so the waits count chunks
  auto fetch = [&](int t0, int stage) {
#pragma unroll
    for (int arr = 0; arr < 4; ++arr) {
      for (int p = tid; t0 < T && p < kChunk * kRowPieces; p += kThreads) {
        const int row = p / kRowPieces, q = (p % kRowPieces) * kVec;
        const bool ok = t0 + row < T;
        stage_piece<Elt, kAsync>(
            arr < 3 ? &sm.rkw[stage][arr][row][q] : &sm.v[stage][row][q],
            ok ? src[arr] + (t0 + row) * ts[arr] + q : src[arr],
            ok ? 16 : 0);
      }
    }
    if constexpr (kAsync) cp_commit();
  };

  // after the join below, lane g < kCpl holds column j0 + col
  int col = 0;
#pragma unroll
  for (int n = kCpl, bit = 1; n > 1; n >>= 1, bit <<= 1)
    col += g & bit ? n / 2 : 0;
  float* op = a.o + b * a.ob + h * a.oh + j0 + col;
  // the ring: chunk n in stage n % kStages, kStages - 1 chunks ahead
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) fetch(n * kChunk, n);
  for (int t0 = 0, stage = 0; t0 < T;
       t0 += kChunk, stage = stage + 1 == kStages ? 0 : stage + 1) {
    if constexpr (kAsync) cp_wait<kStages - 2>();
    __syncthreads();            // the chunk has landed; the last is done
    fetch(t0 + (kStages - 1) * kChunk,
          stage == 0 ? kStages - 1 : stage - 1);

    // prep, once per element per block: the decays (and r, k widened),
    // four adjacent elements a thread; then the bonus scalars, a step a
    // warp, over its 32 lanes
    for (int x = tid; x < kChunk * N / 4; x += kThreads) {
      const int c = x / (N / 4), i = 4 * (x % (N / 4));
      float wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wv[e] = expf(to_f(sm.rkw[stage][2][c][i + e]));
      *reinterpret_cast<float4*>(&sm.decay[c][i]) =
          make_float4(wv[0], wv[1], wv[2], wv[3]);
      if constexpr (kWide) {
#pragma unroll
        for (int y = 0; y < 2; ++y)
          *reinterpret_cast<float4*>(&sm.rk[y][c][i]) = make_float4(
              to_f(sm.rkw[stage][y][c][i]), to_f(sm.rkw[stage][y][c][i + 1]),
              to_f(sm.rkw[stage][y][c][i + 2]),
              to_f(sm.rkw[stage][y][c][i + 3]));
      }
    }
    for (int c = warp; c < kChunk; c += kThreads / 32) {
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < N / 32; ++q)
        part = fmaf(to_f(sm.rkw[stage][0][c][lane + 32 * q]) * up[q],
                    to_f(sm.rkw[stage][1][c][lane + 32 * q]), part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (lane == 0) sm.bonus[c] = part;
    }
    __syncthreads();

    const int nc = min(kChunk, T - t0);
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const float* rr;
      const float* kk;
      if constexpr (kWide) {
        rr = sm.rk[0][c];
        kk = sm.rk[1][c];
      } else {
        rr = sm.rkw[stage][0][c];
        kk = sm.rkw[stage][1][c];
      }
      const float* ww = sm.decay[c];
      float v[kCpl], o[kCpl];
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        v[j] = to_f(sm.v[stage][c][j0 + j]);
        o[j] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const int i = 32 * m + 4 * g;
        const float4 r4 = *reinterpret_cast<const float4*>(rr + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + i);
        const float4 w4 = *reinterpret_cast<const float4*>(ww + i);
        const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < kCpl; ++j) {
            o[j] = fmaf(rs[e], S[j][4 * m + e], o[j]);
            S[j][4 * m + e] = fmaf(ws[e], S[j][4 * m + e], ks[e] * v[j]);
          }
        }
      }
      // join the 8 lanes: each shuffle first halves the columns a lane
      // holds (it keeps one half, sends the other), then sums
#pragma unroll
      for (int n = kCpl, bit = 1; n > 1; n >>= 1, bit <<= 1) {
        const bool up = g & bit;
#pragma unroll
        for (int j = 0; j < n / 2; ++j)
          o[j] = (up ? o[j + n / 2] : o[j]) +
                 __shfl_xor_sync(kFull, up ? o[j] : o[j + n / 2], bit);
      }
#pragma unroll
      for (int bit = kCpl; bit < kGroups; bit <<= 1)
        o[0] += __shfl_xor_sync(kFull, o[0], bit);
      if (g < kCpl)
        op[(t0 + c) * a.ot] = fmaf(to_f(sm.v[stage][c][j0 + col]),
                                   sm.bonus[c], o[0]);
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float* sp = a.s + b * a.sb + h * a.sh + row_of(q, g) * a.si + j0;
#pragma unroll
    for (int j = 0; j < kCpl; ++j) sp[j] = S[j][q];
  }
}

template <int N>
struct Step {
  static constexpr int kM = 2;                       // float4s of S a thread
  static constexpr int kThreads = N * N / (4 * kM);
};

template <typename Elt, int N>
__global__ void __launch_bounds__(Step<N>::kThreads) wkv_kernel_step(
    const WkvArgs a) {
  constexpr int kT = Step<N>::kThreads;
  constexpr int Q = N / 4;                  // float4s per row of S
  constexpr int kRowStep = kT / Q;          // row groups: N / kM
  constexpr int kWarps = kT / 32;
  __shared__ __align__(16) float red[kWarps][N];
  __shared__ float sbonus;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int jq = tid % Q, i0 = tid / Q;
  const long long b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const Elt* rp = static_cast<const Elt*>(a.r) + b * a.rb + h * a.rh;
  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.kb + h * a.kh;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.vb + h * a.vh;
  const Elt* wp = static_cast<const Elt*>(a.w) + b * a.wb + h * a.wh;
  const float* up = a.u + b * a.ub + h * a.uh;

  float4 S[Step<N>::kM];
  if (a.s0 != nullptr) {
#pragma unroll
    for (int m = 0; m < Step<N>::kM; ++m) {
      const float* sp = a.s0 + b * a.s0b + h * a.s0h +
                        (i0 + m * kRowStep) * a.s0i + 4 * jq;
      S[m] = a.vec ? *reinterpret_cast<const float4*>(sp)
                   : make_float4(sp[0], sp[1], sp[2], sp[3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < Step<N>::kM; ++m)
      S[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float v4[4] = {to_f(vp[4 * jq]), to_f(vp[4 * jq + 1]),
                       to_f(vp[4 * jq + 2]), to_f(vp[4 * jq + 3])};

  if (warp == 0) {              // the bonus scalar sum_i r_i u_i k_i
    float part = 0.f;
    for (int i = lane; i < N; i += 32)
      part = fmaf(to_f(rp[i]) * up[i], to_f(kp[i]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) sbonus = part;
  }

  float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < Step<N>::kM; ++m) {
    const int i = i0 + m * kRowStep;
    const float ri = to_f(rp[i]), ki = to_f(kp[i]);
    const float wi = expf(to_f(wp[i]));
    float s4[4] = {S[m].x, S[m].y, S[m].z, S[m].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = fmaf(ri, s4[e], o[e]);
      s4[e] = fmaf(wi, s4[e], ki * v4[e]);
    }
    float* sp = a.s + b * a.sb + h * a.sh + i * a.si + 4 * jq;
    if (a.vec) {
      *reinterpret_cast<float4*>(sp) = make_float4(s4[0], s4[1], s4[2],
                                                   s4[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[e] = s4[e];
    }
  }
  // o over rows: the lanes of a warp that share jq, then the warps
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int off = Q; off < 32; off <<= 1)
      o[e] += __shfl_xor_sync(kFull, o[e], off);
  if (lane < Q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * jq + e] = o[e];
  }
  __syncthreads();
  if (tid < N) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sum += red[q][tid];
    a.o[b * a.ob + h * a.oh + tid] = fmaf(to_f(vp[tid]), sbonus, sum);
  }
}

// route codes, as the wrapper passes them
constexpr int kRouteChunkedAsync = 0;
constexpr int kRouteChunkedLoads = 1;
constexpr int kRouteStep = 2;

using Kernel = void (*)(WkvArgs);

template <typename Elt, int N>
Kernel kernel_for(int route) {
  switch (route) {
    case kRouteChunkedAsync: return wkv_kernel_chunked<Elt, N, true>;
    case kRouteChunkedLoads: return wkv_kernel_chunked<Elt, N, false>;
    case kRouteStep: return wkv_kernel_step<Elt, N>;
    default: return nullptr;
  }
}

template <typename Elt>
Kernel kernel_for(int n, int route) {
  switch (n) {
    case 32: return kernel_for<Elt, 32>(route);
    case 64: return kernel_for<Elt, 64>(route);
    default: return nullptr;
  }
}

// the kernel of (dtype, N, route), its block size in *block, and, on the
// chunked routes, the largest shared-memory carveout asked for (the
// default carveout may hold fewer rings than the registers allow blocks
// on an SM); null for a dtype, N or route it does not take
Kernel prepare(int dtype, int n, int route, int* block) {
  Kernel k = dtype == 0 ? kernel_for<float>(n, route)
             : dtype == 1 ? kernel_for<__nv_bfloat16>(n, route)
             : dtype == 2 ? kernel_for<__half>(n, route) : nullptr;
  *block = n == 32 ? (route == kRouteStep ? Step<32>::kThreads
                                           : Chunked<32>::kThreads)
                    : (route == kRouteStep ? Step<64>::kThreads
                                           : Chunked<64>::kThreads);
  if (k != nullptr && route != kRouteStep &&
      cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return nullptr;
  return k;
}

}  // namespace

// ------------------------------------------------------------ C entry point
// Launches on `stream` and returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue for an N, dtype or route code it does not take
// (or the step route at T != 1), or cudaErrorInvalidConfiguration when
// the grid or block the wrapper chose is not the route's: B x H blocks
// on every route, of 2N threads on the chunked ones and N^2 / 8 on the
// step route.  route: 0 chunked with cp.async staging (r, k, v, w_log
// rows and strides on 16 bytes), 1 chunked with element loads, 2 step
// (T = 1; vec: the state moves as float4).  dtype of r, k, v, w_log:
// 0 = f32, 1 = bf16, 2 = f16.  s0 may be null (zeros) and may equal s.
// strides: r, k, v, w (b, h, t); u (b, h); s0 (b, h, i); o (b, h, t);
// s (b, h, i): 23 values.  The wrapper checks shapes, devices and
// strides, and never calls with B * H = 0 or T = 0.
extern "C" int wkv_forward(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* s0,
                           float* o, float* s, const long long* st,
                           int batch, int heads, int t_len, int n,
                           int dtype, int route, long long grid, int block,
                           int vec, void* stream) {
  int want_block = 0;
  const Kernel kern = prepare(dtype, n, route, &want_block);
  if (kern == nullptr || (route == kRouteStep && t_len != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block != want_block ||
      grid != static_cast<long long>(batch) * heads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const WkvArgs a{r, k, v, w, u, s0, o, s,
                  st[0], st[1], st[2], st[3], st[4], st[5],
                  st[6], st[7], st[8], st[9], st[10], st[11],
                  st[12], st[13], st[14], st[15], st[16],
                  st[17], st[18], st[19], st[20], st[21], st[22],
                  heads, t_len, vec};
  kern<<<dim3(static_cast<unsigned>(grid)), block, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
