// Mamba selective scan for Hopper (sm_90a): per batch row b and channel d
// of the inner width Di, with a state h [N] per channel:
//
//     h_t[n] = exp(dt_t[d] * A[d][n]) * h_{t-1}[n] + dt_t[d] * u_t[d] * B_t[n]
//     y_t[d] = sum_n h_t[n] * C_t[n] + D[d] * u_t[d]
//
// Hand-written CUDA replacement for the Pallas TPU kernel `ssm_scan`
// (src/repro/kernels/ssm_scan/kernel.py).  The wrapper in
// src/repro_torch/kernels/ssm_scan/kernel.py chooses the route and the
// launch shape, and loads this file's C entry point with ctypes.
//
// Bound on the card, at Jamba's prefill (Bb = 8, T = 1,024, Di = 16,384,
// N = 16, f32): u, dt and y move 1.61 GB, B, C and h 9.4 MB: 1.62 GB,
// 0.484 ms at 3.35 TB/s.  ~8 f32 operations per (b, t, d, n), 17 GFLOP,
// 0.26 ms at the 67 TFLOP/s f32 peak.  The 2.15 G exponentials run on the
// SFU at 16 a clock per SM, ~0.51 ms at 1.98 GHz, as tight as the bytes,
// and each (b, t, d, n) also takes four FMA-pipe instructions.  Decode
// (T = 1): the state's read and write, 16.8 MB, 5.0 us.
//
// Route "chunked" (T > 1), `ssm_kernel_chunked`.  One thread owns one
// (b, d) channel for the whole sequence: its N state values and its row of
// A (pre-scaled by log2 e, so a decay is one exp2) stay in registers, and
// the state crosses device memory once.  A block is 256 consecutive
// channels of one batch row.  Chunks of kChunk steps of u and dt (the
// block's channels) and of B and C (shared by every channel of the row)
// go into a two-stage shared-memory ring by 16-byte cp.async copies (or
// element loads when an operand's rows do not start on 16 bytes), so the
// next chunk is in flight under the current one's arithmetic without
// holding registers (prefetching u and dt 16 steps deep in registers
// took 230 registers a thread and left 8 warps on an SM); here
// __launch_bounds__ holds a thread to 64 registers, 4 blocks (32 warps)
// an SM, and Jamba's 512 blocks fill the 132 SMs in one wave.  A decay is
// one `ex2.approx.ftz` on the SFU (not exp2f, whose denormal fix-up costs
// three more instructions).  Computing a fixed share of the decays with a
// polynomial on the FMA pipes instead (Cody-Waite split, degree-6
// minimax) measured slower at every share tried: besides the exponential,
// each (b, t, d, n) takes four FMA-pipe instructions and two
// shared-memory broadcast reads of B and C per four states, so the FMA
// pipes and the dispatch slots are not idle.  The step loop is unrolled
// over the chunk.  u and y are read and written along d, coalesced; y is
// written in f32 with D*u fused in, as the Pallas kernel adds it.  What
// bounds it on the card: the per-step arithmetic (the SFU's 16
// exponentials and the FMA pipes' 64 operations a channel, in dependent
// chains) more than the bytes, with the staging only partly hidden.
//
// Route "step" (T = 1), `ssm_kernel_step`: one decode token.  There is no
// chunk to prefetch: lanes map to (b, d, quarter of n) (halves at N = 8),
// so h0, A, B, C and h move as float4, fully coalesced (element accesses
// when one of them does not sit on 16 bytes), and y is joined over the
// quarters by two shuffles.  The chunked route takes T = 1 too, but its
// h0, A and h move as 16 strided scalars a thread and it stages a whole
// chunk: at Jamba's decode shape on an H100 the step route takes ~0.32x
// its time (PERF.md).
//
// Both routes: u is f32 or bf16 (widened on load, which is exact); dt, B,
// C, A, D, h0, y and h are f32.  N in {8, 16}; any T >= 1 and any Di (the
// Pallas kernel asserts T % chunk == 0 and Di % block == 0).  u, dt, y as
// [Bb, T, Di] and B, C as [Bb, T, N] through element strides of (b, t)
// (the last dim contiguous: B and C are slices of the model's x_proj
// output); A [Di, N] through its row stride; D contiguous; h0 and h
// [Bb, Di, N] through strides of (b, d).  h0 may alias h: each thread reads
// its own state elements before it writes them, so a decode step updates
// the layer's state in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;     // channels (threads) per chunked block
constexpr int kChunk = 8;       // steps per ring stage
constexpr int kStages = 2;      // ring depth (chunks in flight + 1)
constexpr int kStepBlock = 256; // threads per step block
constexpr float kLog2e = 1.4426950408889634f;

template <typename U> __device__ __forceinline__ float to_f(U x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2^x on the SFU: one MUFU.EX2; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct SsmArgs {
  const void* u;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;
  const float* D;
  const float* h0;              // nullptr: h starts at zero
  float* y;
  float* h;
  // element strides: u, dt, B, C, y (b, t); A (d); h0, h (b, d)
  long long ub, ut, db, dtt, bb, bt, cb, ct, ad, h0b, h0d, yb, yt, hb, hd;
  int batch, di, t_len;
  int vec;                      // step route: h0, A, B, C, h as float4
};

// One 16-byte piece: `valid` of its bytes come from `src`, the rest are
// zero.  cp.async when kAsync (src then starts on 16 bytes), else element
// loads and a shared-memory store.
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

template <typename U, int N>
struct ChunkSmem {
  U u[kStages][kChunk][kBlock];
  float dt[kStages][kChunk][kBlock];
  float B[kStages][kChunk][N];
  float C[kStages][kChunk][N];
};

template <typename U, int N, bool kAsync>
__global__ void __launch_bounds__(kBlock, 4) ssm_kernel_chunked(
    const SsmArgs a) {
  constexpr int kUVec = 16 / static_cast<int>(sizeof(U));
  constexpr int kUPieces = kBlock / kUVec;        // pieces of a u row
  constexpr int kDtPieces = kBlock / 4;
  constexpr int kNPieces = N / 4;                 // pieces of a B/C row
  __shared__ __align__(16) ChunkSmem<U, N> sm;

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kBlock, d = d0 + tid;
  const long long b = blockIdx.y;
  const bool live = d < a.di;
  const int T = a.t_len;
  const U* ub = static_cast<const U*>(a.u) + b * a.ub + d0;
  const float* dtb = a.dt + b * a.db + d0;
  const float* bp = a.B + b * a.bb;
  const float* cp = a.C + b * a.cb;
  float* yp = a.y + b * a.yb + d;

  float h[N], a2[N];
  float dd = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = a2[n] = 0.f;
  if (live) {
    const float* ap = a.A + d * a.ad;
#pragma unroll
    for (int n = 0; n < N; ++n) a2[n] = ap[n] * kLog2e;
    dd = a.D[d];
    if (a.h0 != nullptr) {
      const float* hp = a.h0 + b * a.h0b + d * a.h0d;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = hp[n];
    }
  }

  // copy the chunk at t0 into `stage` (rows past T, channels past Di read
  // as zeros): kChunk rows each of u and dt (the block's channels) and of
  // B and C; one commit group per chunk, empty or not, so the waits count
  // chunks
  auto fetch = [&](int t0, int stage) {
    for (int p = tid; t0 < T && p < kChunk * kUPieces; p += kBlock) {
      const int row = p / kUPieces, q = (p % kUPieces) * kUVec;
      const int valid = t0 + row < T
          ? min(16, max(0, (a.di - d0 - q) * int(sizeof(U)))) : 0;
      stage_piece<U, kAsync>(&sm.u[stage][row][q],
                             valid ? ub + (t0 + row) * a.ut + q : ub, valid);
    }
    for (int p = tid; t0 < T && p < kChunk * kDtPieces; p += kBlock) {
      const int row = p / kDtPieces, q = (p % kDtPieces) * 4;
      const int valid = t0 + row < T
          ? min(16, max(0, (a.di - d0 - q) * 4)) : 0;
      stage_piece<float, kAsync>(&sm.dt[stage][row][q],
                                 valid ? dtb + (t0 + row) * a.dtt + q : dtb,
                                 valid);
    }
    for (int p = tid; t0 < T && p < 2 * kChunk * kNPieces; p += kBlock) {
      const bool isb = p < kChunk * kNPieces;
      const int pp = isb ? p : p - kChunk * kNPieces;
      const int row = pp / kNPieces, n4 = (pp % kNPieces) * 4;
      const bool ok = t0 + row < T;
      const float* src = isb ? bp + (t0 + row) * a.bt : cp + (t0 + row) * a.ct;
      stage_piece<float, kAsync>(
          isb ? &sm.B[stage][row][n4] : &sm.C[stage][row][n4],
          ok ? src + n4 : (isb ? bp : cp), ok ? 16 : 0);
    }
    if constexpr (kAsync) asm volatile("cp.async.commit_group;\n" ::);
  };

  // the ring: chunk n in stage n % kStages, kStages - 1 chunks ahead
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) fetch(n * kChunk, n);
  for (int t0 = 0, stage = 0; t0 < T;
       t0 += kChunk, stage = stage + 1 == kStages ? 0 : stage + 1) {
    if constexpr (kAsync)
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2)
                   : "memory");
    __syncthreads();            // the chunk has landed; the last is done
    fetch(t0 + (kStages - 1) * kChunk, stage == 0 ? kStages - 1 : stage - 1);
    const int nc = min(kChunk, T - t0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c >= nc) break;
      const float uc = to_f(sm.u[stage][c][tid]);
      const float dtc = sm.dt[stage][c][tid], du = dtc * uc;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.B[stage][c][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sm.C[stage][c][n]);
        const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[n + e] = fmaf(ex2(dtc * a2[n + e]), h[n + e], du * bs[e]);
          if (e % 2 == 0) y0 = fmaf(h[n + e], cs[e], y0);
          else y1 = fmaf(h[n + e], cs[e], y1);
        }
      }
      if (live) yp[(t0 + c) * a.yt] = (y0 + y1) + dd * uc;
    }
  }

  if (live) {
    float* hp = a.h + b * a.hb + d * a.hd;
#pragma unroll
    for (int n = 0; n < N; ++n) hp[n] = h[n];
  }
}

__device__ __forceinline__ float4 load4(const float* p, int vec) {
  return vec ? *reinterpret_cast<const float4*>(p)
             : make_float4(p[0], p[1], p[2], p[3]);
}

template <typename U, int N>
__global__ void __launch_bounds__(kStepBlock) ssm_kernel_step(
    const SsmArgs a) {
  constexpr int kLanes = N / 4;                   // lanes per channel
  const long long gid = static_cast<long long>(blockIdx.x) * kStepBlock +
                        threadIdx.x;
  const long long ch = gid / kLanes;
  const int q = static_cast<int>(gid % kLanes);
  const long long b = ch / a.di;
  const int d = static_cast<int>(ch % a.di);
  const bool live = b < a.batch;

  float yq = 0.f, uc = 0.f;
  float4 hn = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    uc = to_f(static_cast<const U*>(a.u)[b * a.ub + d]);
    const float dtc = a.dt[b * a.db + d], du = dtc * uc;
    const float4 a4 = load4(a.A + d * a.ad + 4 * q, a.vec);
    const float4 b4 = load4(a.B + b * a.bb + 4 * q, a.vec);
    const float4 c4 = load4(a.C + b * a.cb + 4 * q, a.vec);
    if (a.h0 != nullptr)
      hn = load4(a.h0 + b * a.h0b + d * a.h0d + 4 * q, a.vec);
    hn.x = fmaf(ex2(dtc * (a4.x * kLog2e)), hn.x, du * b4.x);
    hn.y = fmaf(ex2(dtc * (a4.y * kLog2e)), hn.y, du * b4.y);
    hn.z = fmaf(ex2(dtc * (a4.z * kLog2e)), hn.z, du * b4.z);
    hn.w = fmaf(ex2(dtc * (a4.w * kLog2e)), hn.w, du * b4.w);
    yq = fmaf(hn.x, c4.x, hn.y * c4.y) + fmaf(hn.z, c4.z, hn.w * c4.w);
    float* hp = a.h + b * a.hb + d * a.hd + 4 * q;
    if (a.vec) {
      *reinterpret_cast<float4*>(hp) = hn;
    } else {
      hp[0] = hn.x;
      hp[1] = hn.y;
      hp[2] = hn.z;
      hp[3] = hn.w;
    }
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    yq += __shfl_xor_sync(kFull, yq, off);
  if (live && q == 0) a.y[b * a.yb + d] = yq + a.D[d] * uc;
}

// route codes, as the wrapper passes them
constexpr int kRouteChunkedAsync = 0;
constexpr int kRouteChunkedLoads = 1;
constexpr int kRouteStep = 2;

using Kernel = void (*)(SsmArgs);

template <typename U, int N>
Kernel kernel_for(int route) {
  switch (route) {
    case kRouteChunkedAsync: return ssm_kernel_chunked<U, N, true>;
    case kRouteChunkedLoads: return ssm_kernel_chunked<U, N, false>;
    case kRouteStep: return ssm_kernel_step<U, N>;
    default: return nullptr;
  }
}

template <typename U>
Kernel kernel_for(int n, int route) {
  switch (n) {
    case 8: return kernel_for<U, 8>(route);
    case 16: return kernel_for<U, 16>(route);
    default: return nullptr;
  }
}

// the kernel of (dtype, N, route), its block size in *block, and, on the
// chunked routes, the largest shared-memory carveout asked for (the
// default carveout may hold fewer rings than the registers allow blocks
// on an SM); null for a dtype, N or route it does not take
Kernel prepare(int dtype, int n, int route, int* block) {
  Kernel k = dtype == 0 ? kernel_for<float>(n, route)
             : dtype == 1 ? kernel_for<__nv_bfloat16>(n, route) : nullptr;
  *block = route == kRouteStep ? kStepBlock : kBlock;
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
// the grid or block the wrapper chose is not the route's (chunked:
// ceil(Di / 256) x Bb blocks of 256; step: ceil(Bb Di N / 4 / 256)
// blocks of 256).  route: 0 chunked with cp.async staging (u, dt, B, C
// rows and strides on 16 bytes), 1 chunked with element loads, 2 step
// (T = 1; vec: h0, A, B, C and h move as float4).  dtype of u: 0 = f32,
// 1 = bf16.  h0 may be null (zeros) and may equal h.  strides: u, dt,
// B, C (b, t); A (d); h0 (b, d); y (b, t); h (b, d): 15 values.  The
// wrapper checks shapes, devices and strides, and never calls with
// Bb * Di = 0 or T = 0.
extern "C" int ssm_forward(const void* u, const float* dt, const float* B,
                           const float* C, const float* A, const float* D,
                           const float* h0, float* y, float* h,
                           const long long* st, int batch, int di,
                           int t_len, int n, int dtype, int route,
                           long long grid, int block, int vec,
                           void* stream) {
  int want_block = 0;
  const Kernel kern = prepare(dtype, n, route, &want_block);
  if (kern == nullptr || (route == kRouteStep && t_len != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want_grid =
      route == kRouteStep
          ? (static_cast<long long>(batch) * di * (n / 4) + kStepBlock - 1) /
                kStepBlock
          : (di + kBlock - 1) / kBlock;
  if (block != want_block || grid != want_grid)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const SsmArgs a{u, dt, B, C, A, D, h0, y, h,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                  batch, di, t_len, vec};
  const dim3 g(static_cast<unsigned>(grid),
               route == kRouteStep ? 1u : static_cast<unsigned>(batch));
  kern<<<g, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
