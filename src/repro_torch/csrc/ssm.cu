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
// Training.  With a non-null `states`, the chunked route also stores h
// before every 8th step (each chunk's start) into f32 [Bb, ceil(T / 8),
// Di, N]: a second instantiation of the kernel (kSave), so the serving
// kernel's code is what it was.  `ssm_backward` (below) is the gradient,
// the counterpart of autodiff through the reference's XLA twin
// `_mamba_scan_chunked` (the Pallas package has no backward kernel).
// Lanes map to (b, d, quarter of n) as in the step route: four lanes a
// channel of four states each (two at N = 8), a block 256 lanes, 64
// channels of one batch row at N = 16 (128 at N = 8), so Jamba's train
// microbatch (Bb 1) runs 256 blocks, two an SM, ~16 warps on each.  A
// lane holds its states' A, A log2 e, adjoint carries and dA sums in
// registers.  For each 8-step chunk, from the last to the first: the
// chunk's rows of u, dt, dy (the block's channels), B and C and the
// block's saved states (512 contiguous bytes a warp) arrive in a two-stage
// ring by 16-byte cp.async copies (element loads where a row does not
// start on 16 bytes), the chunk one step earlier in time in flight under
// the current one; each lane recomputes its h forward from the saved
// state with the forward's own arithmetic (never dividing by a decay),
// h_t in registers, then walks the chunk back with the adjoint G in
// registers, taking the decays again on the SFU (keeping them measured
// slower: it crowds the 128 registers two blocks an SM leave).  ddt and
// du join over a channel's lanes by two xor shuffles.  Each lane's 2 x 4
// dB/dC terms of a step wait in shared memory, and with them ddt and du;
// after the chunk's barrier the block writes the ddt and du rows
// (coalesced) and sums the terms over its channels in a fixed order into
// per-block partials, which a second kernel sums over the blocks; dA and
// dD, per (b, d) partials summed over b the same way.  No atomics: two
// calls give the same bits.  Bound at Jamba's train microbatch (Bb 1, T
// 1,024, Di 16,384, N 16, bf16 u): u, dt, dy read, du, ddt written, B, C,
// dB, dC, A, D, dA, dD and the 134 MB of states, ~0.40 GB, 0.12 ms at
// 3.35 TB/s; 17 flops and one exponential per (b, t, d, n), 4.6 GFLOP
// (0.068 ms) and 0.27 G exponentials (0.064 ms on the SFU): bound by
// bytes.  What bounds the kernel (PERF.md): instruction throughput.
// 128 registers (the most two blocks of 256 threads an SM allow), no
// spill, 88 KB of shared memory at N = 16 with bf16 u; ~1,400
// instructions a lane a chunk, about half of them floating point, at
// close to one a cycle on each scheduler; the partials' 33.5 MB and their
// sum are ~5% of the time.
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
  float* states;                // chunked route: h before every kChunk-th
                                // step, or nullptr
  // element strides: u, dt, B, C, y (b, t); A (d); h0, h (b, d);
  // states (b, chunk, d)
  long long ub, ut, db, dtt, bb, bt, cb, ct, ad, h0b, h0d, yb, yt, hb, hd;
  long long xb, xc, xd;
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

template <typename U, int N, bool kAsync, bool kSave>
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
    if constexpr (kSave) {      // h before step t0: a chunk boundary
      if (live) {
        float* xp = a.states + b * a.xb + (t0 / kChunk) * a.xc + d * a.xd;
#pragma unroll
        for (int n = 0; n < N; ++n) xp[n] = h[n];
      }
    }
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

// ---------------------------------------------------------------- backward
// Four lanes a channel (two at N = 8), as the step kernel maps them: lane
// q of channel ch holds states 4q .. 4q + 3.  A block is kBwdThreads
// lanes: 64 channels of one batch row at N = 16, 128 at N = 8.
constexpr int kBwdThreads = 256;  // threads per backward block

template <typename U> __device__ __forceinline__ U from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct SsmBwdArgs {
  const void* u;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;
  const float* D;
  const float* dy;
  const float* dh;              // nullptr: no gradient on the final state
  const float* states;          // h before every kChunk-th step
  void* du;                     // [Bb, T, Di] in u's dtype
  float* ddt;                   // [Bb, T, Di]
  float* part;                  // [Bb, blocks, T, 2N]: dB, dC per block
  float* dA_part;               // [Bb, Di, N]
  float* dD_part;               // [Bb, Di]
  float* dh0;                   // [Bb, Di, N] or nullptr
  // element strides: u, dt, B, C, dy (b, t); A (d); dh (b, d); states
  // (b, chunk, d)
  long long ub, ut, db, dtt, bb, bt, cb, ct, ad, yb, yt, hb, hd;
  long long xb, xc, xd;
  int batch, di, t_len;
};

// One ring stage holds a chunk's rows of u, dt, dy (the block's
// channels), B and C, and the block's saved states at the chunk's start.
// `terms` holds each lane's dB terms (half 0) and dC terms (half 1) of
// the chunk's steps as float4s, each half padded by 16 floats so that
// the sums over the channels read 32 banks; `ddt` and `du` the chunk's
// rows, written out after its barrier.
constexpr int kTermRow = kBwdThreads * 4 + 16;

template <typename U, int N>
struct SsmBwdSmem {
  static constexpr int kCh = kBwdThreads / (N / 4);
  U u[kStages][kChunk][kCh];
  float dt[kStages][kChunk][kCh];
  float dy[kStages][kChunk][kCh];
  float B[kStages][kChunk][N];
  float C[kStages][kChunk][N];
  float x[kStages][kCh * N];
  float terms[kChunk][2][kTermRow];
  float ddt[kChunk][kCh];
  U du[kChunk][kCh];
};

// f(p) for each p < P of the form tid + i * kBwdThreads: a thread's share
// of P pieces, with a trip count the compiler knows (kept rolled: unrolled,
// the f32 N = 8 kernel's copies spill)
template <int P, typename F>
__device__ __forceinline__ void each_piece(unsigned tid, F&& f) {
#pragma unroll 1
  for (unsigned i = 0; i < (P + kBwdThreads - 1) / kBwdThreads; ++i)
    if (P % kBwdThreads == 0 || tid + i * kBwdThreads < P)
      f(tid + i * kBwdThreads);
}

// Per step t, from the last to the first, with G_t the adjoint of h_t:
//   G_t = dy_t C_t + a_{t+1} G_{t+1}   (G_{T-1} also takes dh)
//   ddt_t = sum_n G_t (A a_t h_{t-1} + u_t B_t)
//   du_t = dt_t sum_n G_t B_t + D dy_t
//   dA += G_t dt_t a_t h_{t-1},  dD += u_t dy_t
//   dB_t, dC_t: sum over d of G_t dt_t u_t and of h_t dy_t.  dh0 = a_0 G_0.
// A chunk's 8 steps: the forward from the chunk's saved state with the
// forward kernel's own arithmetic (never dividing by a decay), h_t in
// registers; then the walk back with G in registers, a_t taken again on
// the SFU.  ddt and du join over the channel's lanes by two shuffles and
// wait in shared memory with the lanes' dB/dC terms; after the chunk's
// barrier the block writes the chunk's ddt and du rows (coalesced) and
// sums the terms over its channels in a fixed order into `part`.  Rows
// past T and channels past Di stage as zeros: such a step has a_t = 1 and
// adds nothing, so the walk needs no bound inside a chunk.  Indices are
// unsigned, so 64-bit offsets take no sign words.
template <typename U, int N, bool kAsync>
__global__ void __launch_bounds__(kBwdThreads, 2) ssm_bwd_kernel(
    const SsmBwdArgs a) {
  constexpr unsigned kLanes = N / 4, kCh = kBwdThreads / kLanes;
  constexpr unsigned kUVec = 16 / sizeof(U);
  constexpr unsigned kUPieces = kCh / kUVec, kFPieces = kCh / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  SsmBwdSmem<U, N>& sm = *reinterpret_cast<SsmBwdSmem<U, N>*>(smem);
  const unsigned tid = threadIdx.x, ch = tid / kLanes, q = tid % kLanes;
  const unsigned d0 = blockIdx.x * kCh, d = d0 + ch;
  const unsigned T = a.t_len, Di = a.di;
  const size_t b = blockIdx.y;
  const bool live = d < Di;
  float A[4], a2[4], carry[4], dA[4];
  float Dd = 0.f, dD = 0.f;
#pragma unroll
  for (unsigned e = 0; e < 4; ++e) {
    const unsigned n = 4 * q + e;
    A[e] = live ? a.A[d * a.ad + n] : 0.f;
    a2[e] = A[e] * kLog2e;
    carry[e] = live && a.dh != nullptr ? a.dh[b * a.hb + d * a.hd + n]
                                       : 0.f;
    dA[e] = 0.f;
  }
  if (live) Dd = a.D[d];

  // copy the chunk at t0 into `stage` (rows past T, channels past Di read
  // as zeros), one commit group a chunk
  auto fetch = [&](unsigned t0, unsigned stage) {
    const U* ub = static_cast<const U*>(a.u) + b * a.ub + d0;
    const float* dtb = a.dt + b * a.db + d0;
    const float* dyb = a.dy + b * a.yb + d0;
    const float* bp = a.B + b * a.bb;
    const float* cp = a.C + b * a.cb;
    const float* xb = a.states + b * a.xb + d0 * a.xd;
    // bytes of a 16-byte piece of a row from channel d0 + c0 on
    auto bytes = [&](unsigned c0, int size) {
      return min(16, max(0, (static_cast<int>(Di) -
                             static_cast<int>(d0 + c0)) * size));
    };
    each_piece<kChunk * kUPieces>(tid, [&](unsigned p) {
      const unsigned row = p / kUPieces, c0 = p % kUPieces * kUVec;
      const int valid = t0 + row < T ? bytes(c0, sizeof(U)) : 0;
      stage_piece<U, kAsync>(&sm.u[stage][row][c0],
                             valid ? ub + (t0 + row) * a.ut + c0 : ub,
                             valid);
    });
    each_piece<2 * kChunk * kFPieces>(tid, [&](unsigned p) {
      const bool isdt = p < kChunk * kFPieces;
      const unsigned pp = isdt ? p : p - kChunk * kFPieces;
      const unsigned row = pp / kFPieces, c0 = pp % kFPieces * 4;
      const int valid = t0 + row < T ? bytes(c0, 4) : 0;
      const float* src = isdt ? dtb + (t0 + row) * a.dtt
                              : dyb + (t0 + row) * a.yt;
      stage_piece<float, kAsync>(
          isdt ? &sm.dt[stage][row][c0] : &sm.dy[stage][row][c0],
          valid ? src + c0 : (isdt ? dtb : dyb), valid);
    });
    each_piece<2 * kChunk * kLanes>(tid, [&](unsigned p) {
      const bool isb = p < kChunk * kLanes;
      const unsigned pp = isb ? p : p - kChunk * kLanes;
      const unsigned row = pp / kLanes, n4 = pp % kLanes * 4;
      const bool ok = t0 + row < T;
      const float* src = isb ? bp + (t0 + row) * a.bt : cp + (t0 + row) * a.ct;
      stage_piece<float, kAsync>(
          isb ? &sm.B[stage][row][n4] : &sm.C[stage][row][n4],
          ok ? src + n4 : (isb ? bp : cp), ok ? 16 : 0);
    });
    const float* xs = xb + t0 / kChunk * a.xc;
    each_piece<kCh * kLanes>(tid, [&](unsigned p) {
      const unsigned j = p / kLanes, n4 = p % kLanes * 4;
      const bool ok = d0 + j < Di;
      stage_piece<float, kAsync>(&sm.x[stage][j * N + n4],
                                 ok ? xs + j * a.xd + n4 : xb, ok ? 16 : 0);
    });
    if constexpr (kAsync) asm volatile("cp.async.commit_group;\n" ::);
  };

  // a walked chunk out: its rows of ddt and du, and its dB and dC over
  // the block's channels (four running sums over the channels ch = r mod
  // 4 in order, then added pairwise)
  auto write_chunk = [&](unsigned t0) {
    float* ddt = a.ddt + (b * T + t0) * Di + d0;
    U* du = static_cast<U*>(a.du) + (b * T + t0) * Di + d0;
    each_piece<kChunk * kCh>(tid, [&](unsigned x) {
      const unsigned c = x / kCh, j = x % kCh;
      if (t0 + c < T && d0 + j < Di) {
        ddt[c * Di + j] = sm.ddt[c][j];
        du[c * Di + j] = sm.du[c][j];
      }
    });
    float* part = a.part + ((b * gridDim.x + blockIdx.x) * T + t0) * (2 * N);
    each_piece<kChunk * 2 * N>(tid, [&](unsigned x) {
      const unsigned c = x / (2 * N), col = x % (2 * N);
      if (t0 + c >= T) return;
      const unsigned n = col % N;      // lane n / 4's term n % 4
      const float* src = &sm.terms[c][col / N][n];
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (unsigned j = 0; j < kCh; ++j) s[j % 4] += src[j * kLanes * 4];
      part[x] = (s[0] + s[1]) + (s[2] + s[3]);
    });
  };

  const int chunks = (T + kChunk - 1) / kChunk;
  fetch((chunks - 1) * kChunk, 0);
  for (int k = chunks - 1, s = 0; k >= 0; --k, s ^= 1) {
    const unsigned t0 = k * kChunk;
    if constexpr (kAsync)
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();            // chunk k landed; chunk k + 1 written out
    if (k > 0) fetch(t0 - kChunk, s ^ 1);

    // the chunk forward, as the forward kernel computes it: h[c] is h
    // after step c; h before the chunk is read from the ring (c = 0)
    const float4* x4 = reinterpret_cast<const float4*>(
        &sm.x[s][ch * N + 4 * q]);
    float h[kChunk][4];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float dtc = sm.dt[s][c][ch];
      const float du = dtc * to_f(sm.u[s][c][ch]);
      const float4 b4 = *reinterpret_cast<const float4*>(
          &sm.B[s][c][4 * q]);
      const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
      const float4 x = *x4;
      const float hp[4] = {c > 0 ? h[c - 1][0] : x.x, c > 0 ? h[c - 1][1] : x.y,
                           c > 0 ? h[c - 1][2] : x.z, c > 0 ? h[c - 1][3] : x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[c][e] = fmaf(ex2(dtc * a2[e]), hp[e], du * bs[e]);
    }
    // and back
#pragma unroll
    for (int c = kChunk - 1; c >= 0; --c) {
      const float uc = to_f(sm.u[s][c][ch]), dtc = sm.dt[s][c][ch];
      const float dyc = sm.dy[s][c][ch], dtu = dtc * uc;
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.B[s][c][4 * q]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sm.C[s][c][4 * q]);
      const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
      const float4 x = *x4;
      const float hp[4] = {c > 0 ? h[c - 1][0] : x.x, c > 0 ? h[c - 1][1] : x.y,
                           c > 0 ? h[c - 1][2] : x.z, c > 0 ? h[c - 1][3] : x.w};
      float v[8];
      float sddt = 0.f, sgb = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float an = ex2(dtc * a2[e]), ahp = an * hp[e];
        const float g = fmaf(dyc, cs[e], carry[e]);
        v[e] = g * dtu;
        v[4 + e] = h[c][e] * dyc;
        sddt = fmaf(g, fmaf(A[e], ahp, uc * bs[e]), sddt);
        sgb = fmaf(g, bs[e], sgb);
        dA[e] = fmaf(g * dtc, ahp, dA[e]);
        carry[e] = an * g;
      }
      dD = fmaf(uc, dyc, dD);
#pragma unroll
      for (unsigned off = 1; off < kLanes; off <<= 1) {
        sddt += __shfl_xor_sync(kFull, sddt, off);
        sgb += __shfl_xor_sync(kFull, sgb, off);
      }
      if (q == 0) sm.ddt[c][ch] = sddt;
      if (q == kLanes - 1) sm.du[c][ch] = from_f<U>(fmaf(dtc, sgb, Dd * dyc));
      *reinterpret_cast<float4*>(&sm.terms[c][0][tid * 4]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&sm.terms[c][1][tid * 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();            // the chunk's outputs are in
    write_chunk(t0);
  }
  if (live) {
    const size_t bd = (b * Di + d) * N + 4 * q;
    *reinterpret_cast<float4*>(a.dA_part + bd) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (a.dh0 != nullptr)
      *reinterpret_cast<float4*>(a.dh0 + bd) =
          make_float4(carry[0], carry[1], carry[2], carry[3]);
    if (q == 0) a.dD_part[b * Di + d] = dD;
  }
}

// out[o][x] = sum over p < q of in[o * in_outer + p * len + x], in p
// order (the deterministic second pass of every sum over blocks or b)
__global__ void sum_leading_kernel(const float* in, float* out, int q,
                                   long long len, long long in_outer) {
  const long long x = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (x >= len) return;
  const float* src = in + blockIdx.y * in_outer + x;
  float s = 0.f;
  for (int p = 0; p < q; ++p) s += src[p * len];
  out[blockIdx.y * len + x] = s;
}

// the backward kernel of (U, N, kAsync) on `stream`, with its shared
// memory (above the 48 KB a launch gets without asking) and the largest
// carveout, so two blocks fit an SM
template <typename U, int N, bool kAsync>
cudaError_t launch_bwd(const SsmBwdArgs& a, dim3 grid, cudaStream_t s) {
  constexpr int kBytes = sizeof(SsmBwdSmem<U, N>);
  const auto kern = ssm_bwd_kernel<U, N, kAsync>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) kern<<<grid, kBwdThreads, kBytes, s>>>(a);
  return e;
}

// route codes, as the wrapper passes them
constexpr int kRouteChunkedAsync = 0;
constexpr int kRouteChunkedLoads = 1;
constexpr int kRouteStep = 2;

using Kernel = void (*)(SsmArgs);

// the kernel of a route; `save`: the chunked kernel that also stores the
// chunk-boundary states (a separate instantiation, so the serving
// kernel's code is untouched)
template <typename U, int N>
Kernel kernel_for(int route, bool save) {
  switch (route) {
    case kRouteChunkedAsync:
      return save ? ssm_kernel_chunked<U, N, true, true>
                  : ssm_kernel_chunked<U, N, true, false>;
    case kRouteChunkedLoads:
      return save ? ssm_kernel_chunked<U, N, false, true>
                  : ssm_kernel_chunked<U, N, false, false>;
    case kRouteStep: return save ? nullptr : ssm_kernel_step<U, N>;
    default: return nullptr;
  }
}

template <typename U>
Kernel kernel_for(int n, int route, bool save) {
  switch (n) {
    case 8: return kernel_for<U, 8>(route, save);
    case 16: return kernel_for<U, 16>(route, save);
    default: return nullptr;
  }
}

// the kernel of (dtype, N, route, save), its block size in *block, and,
// on the chunked routes, the largest shared-memory carveout asked for
// (the default carveout may hold fewer rings than the registers allow
// blocks on an SM); null for a dtype, N or route it does not take (the
// step route stores no states)
Kernel prepare(int dtype, int n, int route, bool save, int* block) {
  Kernel k = dtype == 0 ? kernel_for<float>(n, route, save)
             : dtype == 1 ? kernel_for<__nv_bfloat16>(n, route, save)
                          : nullptr;
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
// 1 = bf16.  h0 may be null (zeros) and may equal h.  states: null, or
// (chunked routes only) f32 [Bb, ceil(T / 8), Di, N] that receives h
// before every 8th step, for the backward.  strides: u, dt, B, C (b,
// t); A (d); h0 (b, d); y (b, t); h (b, d); states (b, chunk, d): 18
// values.  The wrapper checks shapes, devices and strides, and never
// calls with Bb * Di = 0 or T = 0.
extern "C" int ssm_forward(const void* u, const float* dt, const float* B,
                           const float* C, const float* A, const float* D,
                           const float* h0, float* y, float* h,
                           float* states, const long long* st, int batch,
                           int di, int t_len, int n, int dtype, int route,
                           long long grid, int block, int vec,
                           void* stream) {
  int want_block = 0;
  const Kernel kern = prepare(dtype, n, route, states != nullptr,
                              &want_block);
  if (kern == nullptr || (route == kRouteStep && t_len != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want_grid =
      route == kRouteStep
          ? (static_cast<long long>(batch) * di * (n / 4) + kStepBlock - 1) /
                kStepBlock
          : (di + kBlock - 1) / kBlock;
  if (block != want_block || grid != want_grid)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const SsmArgs a{u, dt, B, C, A, D, h0, y, h, states,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                  st[15], st[16], st[17], batch, di, t_len, vec};
  const dim3 g(static_cast<unsigned>(grid),
               route == kRouteStep ? 1u : static_cast<unsigned>(batch));
  kern<<<g, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward: four launches on `stream` (the reverse scan over
// ceil(Di / (1,024 / N)) x Bb blocks of 256 threads, four lanes a channel
// (two at N = 8), then the sums of its per-block and per-row partials
// over blocks or b); returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue for an N or dtype it does not take, or
// cudaErrorInvalidConfiguration when the grid or block the wrapper chose
// is not that.  vec: u, dt, dy, B, C and the states move by 16-byte
// cp.async pieces (their rows and strides on 16 bytes), else by element
// loads.  Inputs as the forward's (u f32 or bf16: dtype 0 or 1), dy f32,
// dh f32 or null, `states` the forward's chunk-boundary states (the last
// dim contiguous).  Outputs: du [Bb, T, Di] in u's dtype, ddt [Bb, T,
// Di], dBC [Bb, T, 2N] (dB then dC), dA [Di, N], dD [Di], dh0 [Bb, Di,
// N] or null, all f32 and contiguous; part [Bb, blocks, T, 2N], dA_part
// [Bb, Di, N] and dD_part [Bb, Di] f32 scratch (dA_part and dh0 on 16
// bytes).  strides: u, dt, B, C, dy (b, t); A (d); dh (b, d); states (b,
// chunk, d): 16 values.  No atomics: two calls give the same bits.
extern "C" int ssm_backward(const void* u, const float* dt, const float* B,
                            const float* C, const float* A, const float* D,
                            const float* dy, const float* dh,
                            const float* states, void* du, float* ddt,
                            float* dBC, float* dA, float* dD, float* dh0,
                            float* part, float* dA_part, float* dD_part,
                            const long long* st, int batch, int di,
                            int t_len, int n, int dtype, long long grid,
                            int block, int vec, void* stream) {
  if ((n != 8 && n != 16) || (dtype != 0 && dtype != 1) || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ch = kBwdThreads / (n / 4);       // channels a block
  if (block != kBwdThreads || grid != (di + ch - 1) / ch)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const SsmBwdArgs a{u, dt, B, C, A, D, dy, dh, states, du, ddt, part,
                     dA_part, dD_part, dh0,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                     st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                     st[15], batch, di, t_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid), static_cast<unsigned>(batch));
  using Launcher = cudaError_t (*)(const SsmBwdArgs&, dim3, cudaStream_t);
  const Launcher launchers[2][2][2] = {
      {{launch_bwd<float, 8, false>, launch_bwd<float, 8, true>},
       {launch_bwd<float, 16, false>, launch_bwd<float, 16, true>}},
      {{launch_bwd<__nv_bfloat16, 8, false>,
        launch_bwd<__nv_bfloat16, 8, true>},
       {launch_bwd<__nv_bfloat16, 16, false>,
        launch_bwd<__nv_bfloat16, 16, true>}}};
  const cudaError_t e = launchers[dtype][n == 16][vec != 0](a, g, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long bc = static_cast<long long>(t_len) * 2 * n;
  sum_leading_kernel<<<dim3(static_cast<unsigned>((bc + 255) / 256),
                            static_cast<unsigned>(batch)), 256, 0, s>>>(
      part, dBC, static_cast<int>(grid), bc, grid * bc);
  const long long dn = static_cast<long long>(di) * n;
  sum_leading_kernel<<<static_cast<unsigned>((dn + 255) / 256), 256, 0,
                       s>>>(dA_part, dA, batch, dn, 0);
  sum_leading_kernel<<<static_cast<unsigned>((di + 255) / 256), 256, 0,
                       s>>>(dD_part, dD, batch, di, 0);
  return static_cast<int>(cudaGetLastError());
}
