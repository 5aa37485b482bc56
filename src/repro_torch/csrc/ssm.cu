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
// `_mamba_scan_chunked` (the Pallas package has no backward kernel).  A
// thread owns one (b, d) channel as in the forward, a block 64 channels
// of one batch row: for each 8-step chunk from the last to the first it
// recomputes h forward from the chunk's saved state into shared memory,
// with the forward's own arithmetic (never dividing by the decay), then
// walks the chunk backward with the adjoint G in registers, writing ddt
// and du and accumulating dA and dD.  dB and dC sum over the channels:
// over a warp by a reduce-scatter of the 2N values (31 shuffles at N =
// 16), over the block's two warps in shared memory, into per-block
// partials that a second kernel sums over the blocks in a fixed order;
// dA and dD, per (b, d) partials summed over b the same way.  No atomics:
// two calls give the same bits.  Bound at Jamba's train microbatch (Bb 1,
// T 1,024, Di 16,384, N 16, bf16 u): u, dt, dy read, du, ddt written,
// B, C, dB, dC, A, D, dA, dD and the 134 MB of states, ~0.40 GB, 0.12 ms
// at 3.35 TB/s; 17 flops and one exponential per (b, t, d, n), 4.6 GFLOP
// (0.068 ms) and 0.27 G exponentials (0.064 ms on the SFU): bound by
// bytes.  What bounds the kernel: at Bb 1 its 256 blocks of two warps
// leave ~4 warps an SM, each a dependent chain a step.
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
// One thread owns one (b, d) channel, as in the chunked forward; a block
// is kBwdBlock channels of one batch row.  For each chunk of kChunk steps,
// from the last to the first, the thread recomputes its N states forward
// from the chunk's saved boundary state into shared memory (the chunk's
// h_{t0-1} .. h_{t0+7}, with the forward's own arithmetic), then walks the
// chunk backward with the adjoint in registers.
constexpr int kBwdBlock = 64;   // channels (threads) per backward block

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

template <int N>
struct SsmBwdSmem {
  float u[kChunk][kBwdBlock], dt[kChunk][kBwdBlock], dy[kChunk][kBwdBlock];
  float B[kChunk][N], C[kChunk][N];
  float hist[kChunk + 1][N][kBwdBlock];   // h_{t0-1} .. h_{t0+kChunk-1}
  float red[kChunk][kBwdBlock / 32][2 * N];
};

// v[0..K) summed over the warp, scattered: lane L ends with the sum of
// v[L % K] in v[0] (K a power of two <= 32).  Each round halves the
// values a lane holds: it keeps one half and sends the other.
template <int K>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[K],
                                                    int lane) {
#pragma unroll
  for (int off = K / 2; off >= 1; off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int j = 0; j < off; ++j)
      v[j] = (up ? v[j + off] : v[j]) +
             __shfl_xor_sync(kFull, up ? v[j] : v[j + off], off);
  }
#pragma unroll
  for (int off = K; off < 32; off <<= 1)
    v[0] += __shfl_xor_sync(kFull, v[0], off);
}

// Per step t, from the last to the first, with G_t the adjoint of h_t:
//   G_t = dy_t C_t + a_{t+1} G_{t+1}   (G_{T-1} also takes dh)
//   ddt_t = sum_n G_t (A a_t h_{t-1} + u_t B_t)
//   du_t = dt_t sum_n G_t B_t + D dy_t
//   dA += G_t dt_t a_t h_{t-1},  dD += u_t dy_t
//   dB_t, dC_t: sum over d of G_t dt_t u_t and of h_t dy_t, over the
//   warp by `warp_reduce_scatter`, then over the block's warps into
//   `part` (a second kernel sums the blocks).  dh0 = a_0 G_0.
template <typename U, int N>
__global__ void __launch_bounds__(kBwdBlock) ssm_bwd_kernel(
    const SsmBwdArgs a) {
  __shared__ __align__(16) SsmBwdSmem<N> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.x * kBwdBlock + tid;
  const long long b = blockIdx.y;
  const bool live = d < a.di;
  const int T = a.t_len, Di = a.di;
  const U* up = static_cast<const U*>(a.u) + b * a.ub + d;
  const float* dtp = a.dt + b * a.db + d;
  const float* dyp = a.dy + b * a.yb + d;
  float A[N], a2[N], carry[N], dA[N];
  float Dd = 0.f, dD = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[d * a.ad + n] : 0.f;
    a2[n] = A[n] * kLog2e;
    carry[n] = live && a.dh != nullptr ? a.dh[b * a.hb + d * a.hd + n] : 0.f;
    dA[n] = 0.f;
  }
  if (live) Dd = a.D[d];
  float* part = a.part + (b * gridDim.x + blockIdx.x) * T * (2 * N);

  for (int t0 = (T - 1) / kChunk * kChunk; t0 >= 0; t0 -= kChunk) {
    const int nc = min(kChunk, T - t0);
    __syncthreads();            // the last chunk's partials are out
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const bool ok = live && c < nc;
      sm.u[c][tid] = ok ? to_f(up[(t0 + c) * a.ut]) : 0.f;
      sm.dt[c][tid] = ok ? dtp[(t0 + c) * a.dtt] : 0.f;
      sm.dy[c][tid] = ok ? dyp[(t0 + c) * a.yt] : 0.f;
    }
    for (int x = tid; x < kChunk * N; x += kBwdBlock) {
      const int c = x / N, n = x % N;
      const long long t = t0 + c;
      sm.B[c][n] = c < nc ? a.B[b * a.bb + t * a.bt + n] : 0.f;
      sm.C[c][n] = c < nc ? a.C[b * a.cb + t * a.ct + n] : 0.f;
    }
    float h[N];
    const float* xp = a.states + b * a.xb + (t0 / kChunk) * a.xc + d * a.xd;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = live ? xp[n] : 0.f;
      sm.hist[0][n][tid] = h[n];
    }
    __syncthreads();            // B and C staged
    // the chunk forward, as the forward kernel computes it
    for (int c = 0; c < nc; ++c) {
      const float dtc = sm.dt[c][tid], du = dtc * sm.u[c][tid];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(ex2(dtc * a2[n]), h[n], du * sm.B[c][n]);
        sm.hist[c + 1][n][tid] = h[n];
      }
    }
    // and back
    for (int c = nc - 1; c >= 0; --c) {
      const float uc = sm.u[c][tid], dtc = sm.dt[c][tid];
      const float dyc = sm.dy[c][tid], dtu = dtc * uc;
      float red[2 * N];
      float sddt = 0.f, sgb = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float an = ex2(dtc * a2[n]);
        const float ahp = an * sm.hist[c][n][tid];
        const float bn = sm.B[c][n];
        const float g = fmaf(dyc, sm.C[c][n], carry[n]);
        red[n] = g * dtu;
        red[N + n] = sm.hist[c + 1][n][tid] * dyc;
        sddt = fmaf(g, fmaf(A[n], ahp, uc * bn), sddt);
        sgb = fmaf(g, bn, sgb);
        dA[n] = fmaf(g * dtc, ahp, dA[n]);
        carry[n] = an * g;
      }
      dD = fmaf(uc, dyc, dD);
      if (live) {
        const long long off = (b * T + t0 + c) * Di + d;
        a.ddt[off] = sddt;
        static_cast<U*>(a.du)[off] = from_f<U>(fmaf(dtc, sgb, Dd * dyc));
      }
      warp_reduce_scatter<2 * N>(red, lane);
      if (lane < 2 * N) sm.red[c][warp][lane] = red[0];
    }
    __syncthreads();
    for (int x = tid; x < nc * 2 * N; x += kBwdBlock) {
      const int c = x / (2 * N), q = x % (2 * N);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdBlock / 32; ++w) s += sm.red[c][w][q];
      part[(t0 + c) * (2 * N) + q] = s;
    }
  }
  if (live) {
    const long long bd = b * Di + d;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a.dA_part[bd * N + n] = dA[n];
      if (a.dh0 != nullptr) a.dh0[bd * N + n] = carry[n];
    }
    a.dD_part[bd] = dD;
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
// ceil(Di / 64) x Bb blocks of 64 threads, then the sums of its
// per-block and per-row partials over blocks or b); returns
// cudaGetLastError() (0 = launched), cudaErrorInvalidValue for an N or
// dtype it does not take, or cudaErrorInvalidConfiguration when the grid
// or block the wrapper chose is not ceil(Di / 64) blocks of 64.  Inputs
// as the forward's (u f32 or bf16: dtype 0 or 1), dy f32, dh f32 or null,
// `states` the forward's chunk-boundary states.  Outputs: du [Bb, T, Di]
// in u's dtype, ddt [Bb, T, Di], dBC [Bb, T, 2N] (dB then dC), dA
// [Di, N], dD [Di], dh0 [Bb, Di, N] or null, all f32 and contiguous;
// part [Bb, blocks, T, 2N], dA_part [Bb, Di, N] and dD_part [Bb, Di] f32
// scratch.  strides: u, dt, B, C, dy (b, t); A (d); dh (b, d); states
// (b, chunk, d): 16 values.  No atomics: two calls give the same bits.
extern "C" int ssm_backward(const void* u, const float* dt, const float* B,
                            const float* C, const float* A, const float* D,
                            const float* dy, const float* dh,
                            const float* states, void* du, float* ddt,
                            float* dBC, float* dA, float* dD, float* dh0,
                            float* part, float* dA_part, float* dD_part,
                            const long long* st, int batch, int di,
                            int t_len, int n, int dtype, long long grid,
                            int block, void* stream) {
  if ((n != 8 && n != 16) || (dtype != 0 && dtype != 1) || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block != kBwdBlock || grid != (di + kBwdBlock - 1) / kBwdBlock)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const SsmBwdArgs a{u, dt, B, C, A, D, dy, dh, states, du, ddt, part,
                     dA_part, dD_part, dh0,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                     st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                     st[15], batch, di, t_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid), static_cast<unsigned>(batch));
  using BwdKernel = void (*)(SsmBwdArgs);
  const BwdKernel kern =
      dtype == 0 ? (n == 8 ? ssm_bwd_kernel<float, 8>
                           : ssm_bwd_kernel<float, 16>)
                 : (n == 8 ? ssm_bwd_kernel<__nv_bfloat16, 8>
                           : ssm_bwd_kernel<__nv_bfloat16, 16>);
  kern<<<g, kBwdBlock, 0, s>>>(a);
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
