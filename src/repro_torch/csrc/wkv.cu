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
// Training.  With a non-null `states`, the chunked route also stores S
// before every 64th step (kStateEvery) into f32 [B, H, ceil(T / 64), N,
// N]: a second instantiation of the kernel (kSave), so the serving
// kernel's code is what it was.  `wkv_backward` (below) is the gradient,
// the counterpart of autodiff through the reference's XLA twin
// `_wkv_chunked` (the Pallas package has no backward kernel).  With G_t
// the adjoint of S_t, G_{t-1} = diag(w_t) G_t + r_t dO_t^T is linear and
// elementwise in (i, j), so it runs over the forward's 64-step segments
// in parallel, each block a (b, h, segment) of N^2 / 8 threads holding 8
// columns of one row.  dw_log_t = w_t rowsum(S_{t-1} * G_t) needs S and
// G at one step; it is taken instead as a running sum through the
// cumulative log decay, dw_log_t = sum_{m >= t} (a_{m+1} - k_m * (G_m
// v_m)) with a_t = r_t * (S_{t-1} dO_t), so no pass holds S and G at once
// and none divides by a decay (w -> 0 stays safe).  Four launches: (1)
// the state pass, forward from each segment's saved state: dr, a, the
// jump into the next segment (delta), the segment's state from zero M,
// its decay product W, and in closed forward forms what it contributes
// from a zero adjoint (the adjoint it leaves at its start, L(c), and its
// running sum) and its du; (2) the carry, per (b, h) over the segments
// from the last: the adjoint entering each segment, G_in(c - 1) =
// diag(W(c)) G_in(c) + L(c) from G_in(last) = dS, and the running sum
// entering each segment's last step (a segment adds its own sum plus
// rowsum(G_in * (delta - M)), the part G_in carries in); (3) the
// gradient pass, backward over each segment from its true G_in and sum,
// writing dk, dv and dw_log once; (4) du summed over b and the segments.
// Everything that carries the recurrences or the dw sum runs in f64 (the
// inputs are read and the gradients written in their own types): at
// RWKV6-3B's initial decays (w ~ 0.9975) S and G sum ~400 steps, and the
// group norm after the scan makes dO orthogonal to o = S^T r, so the dw
// sums cancel; an f32 design that took dw_log directly as w_t
// rowsum(S_{t-1} * G_t) (S kept for 8 steps in registers) missed the
// 1e-4 per-launch check on the real model by 2.7x (PERF.md).  No atomics:
// every sum runs in a fixed order, two calls give the same bits.  Bound
// at RWKV6-3B's train shape (f32, B 4, T 1,024, H 40, N 64): r, k, v,
// w_log, dO read and four gradients written, 377 MB, and the 42 MB of
// states: 0.125 ms at 3.35 TB/s; 9 N^2 flops per step and head (S^T dO,
// G v, G^T k, G's update), 6.0 GFLOP, 0.090 ms at 67 TFLOP/s (f32; f64
// has half that rate): bound by bytes.  The design does more: S
// recomputed from the saved states with M, L and M dO beside it (8 N^2
// flops a step), all in f64, the inputs read twice, and ~300 MB of
// scratch written and read (a, delta, e, gin).  What bounds it on the
// card: the two segment passes, about evenly, which issue ~17 N^2 f64
// flops a step with their widenings from f32 and a chain of f64 shuffle
// sums over a row each step, at one block of 16 warps an SM in the state
// pass (124 registers a thread) and two in the gradient pass (64).
// Staging the chunks in f64 instead (no widening a step) measured
// slower: 64-byte shared rows conflict, and more registers.
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
// the training forward saves S before every kStateEvery-th step (a
// multiple of kChunk; ref.STATE_EVERY), the backward's chunk boundaries
constexpr int kStateEvery = 64;
static_assert(kStateEvery % kChunk == 0, "states sit on chunk starts");

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
  float* states;                // chunked route: S before every
                                // kStateEvery-th step, or nullptr
  // element strides: r, k, v, w (b, h, t); u (b, h); s0 (b, h, i);
  // o (b, h, t); s (b, h, i); states (b, h, chunk, i)
  long long rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt;
  long long ub, uh, s0b, s0h, s0i, ob, oh, ot, sb, sh, si;
  long long xb, xh, xc, xi;
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

template <typename Elt, int N, bool kAsync, bool kSave>
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
    if constexpr (kSave) {      // S before step t0: a chunk boundary
      if (t0 % kStateEvery == 0) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          float* xp = a.states + b * a.xb + h * a.xh +
                      (t0 / kStateEvery) * a.xc + row_of(q, g) * a.xi + j0;
#pragma unroll
          for (int j = 0; j < kCpl; ++j) xp[j] = S[j][q];
        }
      }
    }
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

// ---------------------------------------------------------------- backward
// Layout of the backward kernels: a block of N^2 / 8 threads owns one
// (b, h, 64-step segment) (one (b, h) in the carry); a thread holds 8
// columns of one row i of its N x N matrix (S, M, L or the adjoint G):
// 4 at c0 = 4 g and 4 at c1 = c0 + N / 2 for its lane g of the row's N / 8
// adjacent lanes, so the 16-byte reads of a shared row by a warp cover
// contiguous bytes (no bank conflict); a sum over j is a shuffle
// reduction over the row's lanes, and a sum over i runs over the warp's
// rows by shuffles and over the warps in shared memory.
constexpr int kBwdChunk = 16;   // steps staged in shared memory at once
constexpr int kBwdCols = 8;     // columns a thread holds

template <int N>
struct Bwd {
  static constexpr int kLanes = N / kBwdCols;       // threads of a row
  static constexpr int kThreads = N * kLanes;       // N^2 / 8
  static constexpr int kWarps = kThreads / 32;
};

// the column of a thread's value e (c0 = 4 g, c1 = c0 + N / 2)
__device__ __forceinline__ int col_of(int e, int c0, int c1) {
  return e < 4 ? c0 + e : c1 + e - 4;
}

struct WkvBwdArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* dO;
  const float* dS;              // nullptr: no gradient on the final state
  const float* S;               // the final state (read when dS is given)
  const float* states;          // S before every kStateEvery-th step
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  double* a;                    // [B, H, T, N]: r_t * (S_{t-1} dO_t)
  float* delta;                 // [B, H, segs + 1, N, N]: slot c + 1,
                                // segment c's S continued to its end minus
                                // the saved state of segment c + 1 (the
                                // last: minus the final state, with dS)
  double* e;                    // [B, H, segs, N, N]: delta(c + 1) - M(c),
                                // M(c) the segment's state from zero
  double* gin;                  // [B, H, segs, N, N]: the segment's adjoint
                                // from zero at its start (pass 1), then the
                                // adjoint entering it (pass 2)
  double* wseg;                 // [B, H, segs, N]: the segment's decay
                                // product per row
  double* loc;                  // [B, H, segs, N]: the segment's dw sum
                                // from a zero adjoint (pass 1)
  double* dwin;                 // [B, H, segs, N]: the dw sum entering the
                                // segment's last step (pass 2)
  float* du_part;               // [B, H, segs, N]: du of each segment
  float* du;                    // [H, N]: summed over b and the segments
  float* ds0;                   // [B, H, N, N] or nullptr
  // element strides: r, k, v, w, dO (b, h, t); u (b, h); dS, S (b, h, i);
  // states (b, h, chunk, i); dr, dk, dv, dw (b, h, t), one layout
  long long rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt;
  long long ob, oh, ot, ub, uh, gb, gh, gi, fb, fh, fi;
  long long xb, xh, xc, xi, db, dh, dt;
  int heads, t_len, segs;
};

template <typename Elt> __device__ __forceinline__ Elt from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// a chunk's rows of r, k, v and dO widened to f32 (kept f32: the rows a
// warp reads at once stay 128 contiguous bytes), the decays exp(w_log)
// in f64, and u
template <int N>
struct BwdStage {
  float r[kBwdChunk][N], k[kBwdChunk][N];
  float v[kBwdChunk][N], dO[kBwdChunk][N];
  double w[kBwdChunk][N];
  float u[N];
  double vdo[kBwdChunk];        // v_t . dO_t
  double bonus[kBwdChunk];      // sum_i u_i r_t[i] k_t[i]
  float out0[kBwdChunk][N], out1[kBwdChunk][N];   // per-row outputs
};

template <int N>
struct BwdGradSmem {
  BwdStage<N> st;
  double an[kBwdChunk][N];      // a_{t+1} of each step
  float red[kBwdChunk][Bwd<N>::kWarps][N];   // dv: each warp's rows
};

// stage steps t0 .. t0 + nc - 1 (zeros and decay 1 past nc) and the step
// scalars
template <typename Elt, int N>
__device__ __forceinline__ void bwd_stage(BwdStage<N>& sm,
                                          const WkvBwdArgs& a, long long b,
                                          long long h, int t0, int nc) {
  constexpr int kT = Bwd<N>::kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Elt* rp = static_cast<const Elt*>(a.r) + b * a.rb + h * a.rh;
  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.kb + h * a.kh;
  const Elt* wp = static_cast<const Elt*>(a.w) + b * a.wb + h * a.wh;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.vb + h * a.vh;
  const float* op = a.dO + b * a.ob + h * a.oh;
  for (int x = tid; x < kBwdChunk * N; x += kT) {
    const int c = x / N, i = x % N;
    const bool ok = c < nc;
    const long long t = t0 + c;
    sm.r[c][i] = ok ? to_f(rp[t * a.rt + i]) : 0.f;
    sm.k[c][i] = ok ? to_f(kp[t * a.kt + i]) : 0.f;
    sm.w[c][i] = ok ? exp(static_cast<double>(to_f(wp[t * a.wt + i])))
                    : 1.0;
    sm.v[c][i] = ok ? to_f(vp[t * a.vt + i]) : 0.f;
    sm.dO[c][i] = ok ? op[t * a.ot + i] : 0.f;
  }
  __syncthreads();
  for (int c = warp; c < kBwdChunk; c += kT / 32) {
    double p = 0.0, q = 0.0;
    for (int i = lane; i < N; i += 32) {
      p = fma(static_cast<double>(sm.v[c][i]),
              static_cast<double>(sm.dO[c][i]), p);
      q = fma(static_cast<double>(sm.r[c][i]) * sm.u[i],
              static_cast<double>(sm.k[c][i]), q);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_xor_sync(kFull, p, off);
      q += __shfl_xor_sync(kFull, q, off);
    }
    if (lane == 0) {
      sm.vdo[c] = p;
      sm.bonus[c] = q;
    }
  }
  __syncthreads();
}

// sum over the lanes of a row (adjacent lanes), left in every one
template <int N>
__device__ __forceinline__ double row_sum(double x) {
#pragma unroll
  for (int off = 1; off < Bwd<N>::kLanes; off <<= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// a thread's 8 values of a row (its columns c0 .. c0 + 3, c1 .. c1 + 3;
// 16-byte aligned) as f64, and back
__device__ __forceinline__ void load8(const float* row, int c0, int c1,
                                      double (&x)[kBwdCols]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + c0);
  const float4 hi = *reinterpret_cast<const float4*>(row + c1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
__device__ __forceinline__ void load8(const double* row, int c0, int c1,
                                      double (&x)[kBwdCols]) {
#pragma unroll
  for (int e = 0; e < kBwdCols; e += 2) {
    const double2 d = *reinterpret_cast<const double2*>(
        row + col_of(e, c0, c1));
    x[e] = d.x;
    x[e + 1] = d.y;
  }
}
__device__ __forceinline__ void store8(double* row, int c0, int c1,
                                       const double (&x)[kBwdCols]) {
#pragma unroll
  for (int e = 0; e < kBwdCols; e += 2)
    *reinterpret_cast<double2*>(row + col_of(e, c0, c1)) =
        make_double2(x[e], x[e + 1]);
}

// Pass 1, forward in time, one block per (b, h, segment): S from the
// segment's saved state, and per step
//   dr_t = S_{t-1} dO_t + u * k_t (v_t . dO_t),   a_t = r_t * (S_{t-1} dO_t)
// (a into the scratch, for the dw sums).  Beside S it carries what the
// segment contributes from a zero adjoint, in closed forward forms:
//   M: the segment's state from zero (M_t = diag(w_t) M_{t-1} + k_t v_t^T),
//   L: the adjoint from zero at the segment's start, sum_t diag(P_t) r_t
//      dO_t^T with P_t the decays from the segment's start to step t - 1,
//   loc: the dw running sum from a zero adjoint over the segment,
//      sum_{m in c} (a_{m+1} - k_m * (L_m v_m)) = sum a_{m+1} - sum_t r_t *
//      (M_{t-1} dO_t), a_{t1} (the next segment's first) from its saved
//      state,
// and W = P at the end, the segment's decay product, and du's share
// (sum_t r_t * k_t (v_t . dO_t)).  At the segment's end delta(c + 1) = S -
// saved(c + 1) (the jump into the next segment; after the last segment,
// into the forward's final state, where dS is given), and e(c) = delta(c
// + 1) - M (-M without a jump), which carries the adjoint entering the
// segment into its dw sum.
template <typename Elt, int N>
__global__ void __launch_bounds__(Bwd<N>::kThreads) wkv_bwd_state_kernel(
    const WkvBwdArgs a) {
  constexpr int kT = Bwd<N>::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdStage<N>& sm = *reinterpret_cast<BwdStage<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int i = tid / Bwd<N>::kLanes, g = tid % Bwd<N>::kLanes;
  const int c0 = 4 * g, c1 = c0 + N / 2;
  const long long b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int T = a.t_len;
  const int t_begin = blockIdx.y * kStateEvery;
  const int t_end = min(T, t_begin + kStateEvery);
  const float* xp = a.states + b * a.xb + h * a.xh + blockIdx.y * a.xc +
                    i * a.xi;
  double S[kBwdCols], M[kBwdCols], L[kBwdCols], P = 1.0, loc = 0.0;
  double du = 0.0;
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e) {
    S[e] = xp[col_of(e, c0, c1)];
    M[e] = L[e] = 0.0;
  }
  for (int x = tid; x < N; x += kT) sm.u[x] = a.u[b * a.ub + h * a.uh + x];
  const double ui = a.u[b * a.ub + h * a.uh + i];
  Elt* drp = static_cast<Elt*>(a.dr) + b * a.db + h * a.dh;
  double* ap = a.a + ((b * a.heads + h) * T) * N;

  for (int t0 = t_begin; t0 < t_end; t0 += kBwdChunk) {
    const int nc = min(kBwdChunk, t_end - t0);
    __syncthreads();            // the last chunk's outputs are out
    bwd_stage<Elt, N>(sm, a, b, h, t0, nc);
    for (int c = 0; c < nc; ++c) {
      double dd[kBwdCols], vv[kBwdCols];
      load8(sm.dO[c], c0, c1, dd);
      load8(sm.v[c], c0, c1, vv);
      double sd = 0.0, md = 0.0;
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) {
        sd = fma(S[e], dd[e], sd);
        md = fma(M[e], dd[e], md);
      }
      sd = row_sum<N>(sd);
      md = row_sum<N>(md);
      const double ri = sm.r[c][i], ki = sm.k[c][i], wi = sm.w[c][i];
      const double at = ri * sd;
      if (g == 0) {
        sm.out0[c][i] = static_cast<float>(fma(ui * ki, sm.vdo[c], sd));
        ap[(t0 + c) * N + i] = at;
      }
      loc += (t0 + c > t_begin ? at : 0.0) - ri * md;
      du = fma(ri * ki, sm.vdo[c], du);
      const double pr = P * ri;
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) {
        const double kv = ki * vv[e];
        S[e] = fma(wi, S[e], kv);
        M[e] = fma(wi, M[e], kv);
        L[e] = fma(pr, dd[e], L[e]);
      }
      P *= wi;
    }
    __syncthreads();
    for (int x = tid; x < nc * N; x += kT) {
      const int c = x / N, n = x % N;
      drp[(t0 + c) * a.dt + n] = from_f<Elt>(sm.out0[c][n]);
    }
  }
  const long long s = (b * a.heads + h) * a.segs + blockIdx.y;
  if (t_end < T) {              // a_{t1}, from the next saved state
    const float* np = xp + a.xc;
    const float* op = a.dO + b * a.ob + h * a.oh + t_end * a.ot;
    double x = 0.0;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) {
      const int j = col_of(e, c0, c1);
      x = fma(static_cast<double>(np[j]), static_cast<double>(op[j]), x);
    }
    loc += to_f(static_cast<const Elt*>(a.r)[b * a.rb + h * a.rh +
                                             t_end * a.rt + i]) *
           row_sum<N>(x);
  }
  // the jump into the next segment's saved state, or at the end of the
  // sequence into the forward's final state (read when dS is given)
  const long long seg = (b * a.heads + h) * (a.segs + 1) + blockIdx.y;
  const bool last = blockIdx.y + 1 == a.segs;
  double E[kBwdCols];
  if (!last || a.dS != nullptr) {
    const float* np = last ? a.S + b * a.fb + h * a.fh + i * a.fi
                           : xp + a.xc;
    float* dp = a.delta + ((seg + 1) * N + i) * N;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) {
      const int j = col_of(e, c0, c1);
      const float d = static_cast<float>(S[e] - static_cast<double>(np[j]));
      dp[j] = d;
      E[e] = static_cast<double>(d) - M[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) E[e] = -M[e];
  }
  store8(a.e + (s * N + i) * N, c0, c1, E);
  store8(a.gin + (s * N + i) * N, c0, c1, L);
  if (g == 0) {
    a.wseg[s * N + i] = P;
    a.loc[s * N + i] = loc;
    a.du_part[s * N + i] = static_cast<float>(du);
  }
}

// Pass 3, backward in time, one block per (b, h, segment), the adjoint G
// in registers from the one entering the segment (the carry's), per step
// t from the segment's last to its first
//   dk_t = G_t v_t + u * r_t (v_t . dO_t)
//   dv_t = G_t^T k_t + dO_t (sum_i u_i r_t[i] k_t[i])
//   dw_log_t = sum_{m >= t} (a_{m+1} - k_m * (G_m v_m))   (+ the jumps)
//   G_{t-1} = diag(w_t) G_t + r_t dO_t^T
// writing dk, dv and dw_log once, and ds0 = G_{-1} (segment 0).
// dw_log_t = w_t rowsum(S_{t-1} * G_t) rewritten through the cumulative
// log decay: the loss depends on w_log_t through every c_m = sum_{q <= m}
// w_log_q with m >= t, and dL/dc_m = a_{m+1} - k_m * (G_m v_m), with a_T
// = rowsum(S_{T-1} * dS).  So no step needs S_{t-1} and G_t at once, and
// S is never recovered by dividing by a decay.  The state pass restarts
// each segment from its saved state, which is not exactly the previous
// segment's state continued; at a segment's last step the sum takes
// rowsum(delta * G_t) for that jump (at the last segment's, the jump to
// the final state a_T is taken at), so dw_log is the one the saved
// states imply step by step (as the plain backward computes it).  The sum
// starts at the one the carry left entering the segment's last step.  dv
// is summed over the warp's rows by shuffles, then over the warps in
// shared memory.
template <typename Elt, int N>
__global__ void __launch_bounds__(Bwd<N>::kThreads) wkv_bwd_grad_kernel(
    const WkvBwdArgs a) {
  constexpr int kT = Bwd<N>::kThreads, kLanes = Bwd<N>::kLanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdGradSmem<N>& sm = *reinterpret_cast<BwdGradSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / kLanes, g = tid % kLanes;
  const int c0 = 4 * g, c1 = c0 + N / 2;
  const long long b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int T = a.t_len;
  const int t_begin = blockIdx.y * kStateEvery;
  const int t_end = min(T, t_begin + kStateEvery);
  const long long seg = (b * a.heads + h) * a.segs + blockIdx.y;
  double G[kBwdCols];
  load8(a.gin + (seg * N + i) * N, c0, c1, G);
  double acc = a.dwin[seg * N + i];
  for (int x = tid; x < N; x += kT)
    sm.st.u[x] = a.u[b * a.ub + h * a.uh + x];
  const double ui = a.u[b * a.ub + h * a.uh + i];
  Elt* dkp = static_cast<Elt*>(a.dk) + b * a.db + h * a.dh;
  Elt* dvp = static_cast<Elt*>(a.dv) + b * a.db + h * a.dh;
  Elt* dwp = static_cast<Elt*>(a.dw) + b * a.db + h * a.dh;
  const double* ap = a.a + ((b * a.heads + h) * T) * N;
  const float* jp =                 // the segment's jump, its last step
      a.delta + (((b * a.heads + h) * (a.segs + 1) + blockIdx.y + 1) * N +
                 i) * N;

  for (int t0 = t_begin + (t_end - 1 - t_begin) / kBwdChunk * kBwdChunk;
       t0 >= t_begin; t0 -= kBwdChunk) {
    const int nc = min(kBwdChunk, t_end - t0);
    __syncthreads();            // the last chunk's outputs are out
    for (int x = tid; x < kBwdChunk * N; x += kT) {
      const int c = x / N, n = x % N;
      sm.an[c][n] = c < nc && t0 + c + 1 < T ? ap[(t0 + c + 1) * N + n]
                                             : 0.0;
    }
    bwd_stage<Elt, N>(sm.st, a, b, h, t0, nc);
    for (int c = nc - 1; c >= 0; --c) {
      const int t = t0 + c;
      if (t + 1 == t_end && (t_end < T || a.dS != nullptr)) {
        double jump = 0.0;
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e)
          jump = fma(static_cast<double>(jp[col_of(e, c0, c1)]), G[e], jump);
        acc += row_sum<N>(jump);
      }
      double dd[kBwdCols], vv[kBwdCols];
      load8(sm.st.dO[c], c0, c1, dd);
      load8(sm.st.v[c], c0, c1, vv);
      const double ri = sm.st.r[c][i], ki = sm.st.k[c][i];
      const double wi = sm.st.w[c][i];
      double gv = 0.0;
      float p[kBwdCols];
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) {
        gv = fma(G[e], vv[e], gv);
        p[e] = static_cast<float>(G[e] * ki);
      }
      gv = row_sum<N>(gv);
      // dv: sum over the warp's rows, then (below) over the warps
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e)
          p[e] += __shfl_xor_sync(kFull, p[e], off);
      if (lane < kLanes) {
        *reinterpret_cast<float4*>(&sm.red[c][warp][c0]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&sm.red[c][warp][c1]) =
            make_float4(p[4], p[5], p[6], p[7]);
      }
      acc += sm.an[c][i] - ki * gv;
      if (g == 0) {
        sm.st.out0[c][i] = static_cast<float>(fma(ui * ri, sm.st.vdo[c], gv));
        sm.st.out1[c][i] = static_cast<float>(acc);
      }
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) G[e] = fma(wi, G[e], ri * dd[e]);
    }
    __syncthreads();
    for (int x = tid; x < nc * N; x += kT) {
      const int c = x / N, n = x % N;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < Bwd<N>::kWarps; ++q) s += sm.red[c][q][n];
      const long long off = (t0 + c) * a.dt + n;
      dvp[off] = from_f<Elt>(static_cast<float>(
          fma(static_cast<double>(sm.st.dO[c][n]), sm.st.bonus[c],
              static_cast<double>(s))));
      dkp[off] = from_f<Elt>(sm.st.out0[c][n]);
      dwp[off] = from_f<Elt>(sm.st.out1[c][n]);
    }
  }
  if (blockIdx.y == 0 && a.ds0 != nullptr) {
    float* sp = a.ds0 + ((b * a.heads + h) * N + i) * N;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e)
      sp[col_of(e, c0, c1)] = static_cast<float>(G[e]);
  }
}

// Pass 2, one block per (b, h): from the last segment to the first, the
// adjoint entering each segment, G_in(last) = dS and G_in(c - 1) =
// diag(wseg(c)) G_in(c) + L(c), and the dw sum entering each segment's
// last step, from a_T = rowsum(S_{T-1} * dS): a segment adds loc(c) +
// rowsum(G_in(c) * e(c)) to it (its steps' sum from a zero adjoint, the
// part G_in(c) carries in through M, and its jump).  G_in is written
// over gin (each slot read before it is written), the sums into dwin; the
// next two slots' reads are in flight ahead of their use.
template <int N>
__global__ void __launch_bounds__(Bwd<N>::kThreads) wkv_bwd_carry_kernel(
    const WkvBwdArgs a) {
  constexpr long long NN = static_cast<long long>(N) * N;
  const int tid = threadIdx.x;
  const int i = tid / Bwd<N>::kLanes, g = tid % Bwd<N>::kLanes;
  const int c0 = 4 * g, c1 = c0 + N / 2;
  const long long bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const long long s0 = bh * a.segs;                 // segment 0's slot
  double G[kBwdCols], acc = 0.0;
  if (a.dS != nullptr) {
    const float* gp = a.dS + b * a.gb + h * a.gh + i * a.gi;
    const float* fp = a.S + b * a.fb + h * a.fh + i * a.fi;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) {
      const int j = col_of(e, c0, c1);
      G[e] = gp[j];
      acc = fma(static_cast<double>(fp[j]), G[e], acc);
    }
    acc = row_sum<N>(acc);
  } else {
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) G[e] = 0.0;
  }
  const long long row = i * N;
  double L0[kBwdCols], E0[kBwdCols], L1[kBwdCols] = {}, E1[kBwdCols] = {};
  const int last = a.segs - 1;
  load8(a.gin + (s0 + last) * NN + row, c0, c1, L0);
  load8(a.e + (s0 + last) * NN + row, c0, c1, E0);
  if (last >= 1) {
    load8(a.gin + (s0 + last - 1) * NN + row, c0, c1, L1);
    load8(a.e + (s0 + last - 1) * NN + row, c0, c1, E1);
  }
  for (int c = last; c >= 0; --c) {
    double L2[kBwdCols] = {}, E2[kBwdCols] = {};
    if (c >= 2) {
      load8(a.gin + (s0 + c - 2) * NN + row, c0, c1, L2);
      load8(a.e + (s0 + c - 2) * NN + row, c0, c1, E2);
    }
    const double lc = a.loc[(s0 + c) * N + i];
    const double wc = a.wseg[(s0 + c) * N + i];
    store8(a.gin + (s0 + c) * NN + row, c0, c1, G);
    double x = 0.0;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) x = fma(G[e], E0[e], x);
    x = row_sum<N>(x);
    if (g == 0) a.dwin[(s0 + c) * N + i] = acc;
    acc += lc + x;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) {
      G[e] = fma(wc, G[e], L0[e]);
      L0[e] = L1[e];
      E0[e] = E1[e];
      L1[e] = L2[e];
      E1[e] = E2[e];
    }
  }
}

// du[h, i] = sum over b, then over the segments, of du_part: a fixed
// order
__global__ void wkv_bwd_du_kernel(const WkvBwdArgs a, int batch, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= a.heads * n) return;
  const int h = x / n, i = x % n;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) {
    const float* pp = a.du_part +
                      (static_cast<long long>(b) * a.heads + h) * a.segs * n +
                      i;
#pragma unroll 8
    for (int c = 0; c < a.segs; ++c) s += pp[c * n];
  }
  a.du[x] = s;
}

template <typename Elt, int N>
int launch_backward(const WkvBwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int kT = Bwd<N>::kThreads;
  const int state_smem = sizeof(BwdStage<N>);
  const int grad_smem = sizeof(BwdGradSmem<N>);
  if (cudaFuncSetAttribute(wkv_bwd_state_kernel<Elt, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           state_smem) != cudaSuccess ||
      cudaFuncSetAttribute(wkv_bwd_grad_kernel<Elt, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           grad_smem) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int bh = batch * a.heads;
  const dim3 segs(static_cast<unsigned>(bh), static_cast<unsigned>(a.segs));
  wkv_bwd_state_kernel<Elt, N><<<segs, kT, state_smem, stream>>>(a);
  wkv_bwd_carry_kernel<N><<<bh, kT, 0, stream>>>(a);
  wkv_bwd_grad_kernel<Elt, N><<<segs, kT, grad_smem, stream>>>(a);
  wkv_bwd_du_kernel<<<(a.heads * N + 255) / 256, 256, 0, stream>>>(a, batch,
                                                                  N);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elt>
int launch_backward(const WkvBwdArgs& a, int n, int batch,
                    cudaStream_t stream) {
  return n == 32 ? launch_backward<Elt, 32>(a, batch, stream)
                 : launch_backward<Elt, 64>(a, batch, stream);
}

// route codes, as the wrapper passes them
constexpr int kRouteChunkedAsync = 0;
constexpr int kRouteChunkedLoads = 1;
constexpr int kRouteStep = 2;

using Kernel = void (*)(WkvArgs);

// the kernel of a route; `save`: the chunked kernel that also stores the
// chunk-boundary states (a separate instantiation, so the serving
// kernel's code is untouched)
template <typename Elt, int N>
Kernel kernel_for(int route, bool save) {
  switch (route) {
    case kRouteChunkedAsync:
      return save ? wkv_kernel_chunked<Elt, N, true, true>
                  : wkv_kernel_chunked<Elt, N, true, false>;
    case kRouteChunkedLoads:
      return save ? wkv_kernel_chunked<Elt, N, false, true>
                  : wkv_kernel_chunked<Elt, N, false, false>;
    case kRouteStep: return save ? nullptr : wkv_kernel_step<Elt, N>;
    default: return nullptr;
  }
}

template <typename Elt>
Kernel kernel_for(int n, int route, bool save) {
  switch (n) {
    case 32: return kernel_for<Elt, 32>(route, save);
    case 64: return kernel_for<Elt, 64>(route, save);
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
             : dtype == 2 ? kernel_for<__half>(n, route, save) : nullptr;
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
// states: null, or (chunked routes only) f32 [B, H, ceil(T / 64), N, N]
// that receives S before every 64th step, for the backward.
// strides: r, k, v, w (b, h, t); u (b, h); s0 (b, h, i); o (b, h, t);
// s (b, h, i); states (b, h, chunk, i): 27 values.  The wrapper checks
// shapes, devices and strides, and never calls with B * H = 0 or T = 0.
extern "C" int wkv_forward(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* s0,
                           float* o, float* s, float* states,
                           const long long* st, int batch, int heads,
                           int t_len, int n, int dtype, int route,
                           long long grid, int block, int vec,
                           void* stream) {
  int want_block = 0;
  const Kernel kern = prepare(dtype, n, route, states != nullptr,
                              &want_block);
  if (kern == nullptr || (route == kRouteStep && t_len != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block != want_block ||
      grid != static_cast<long long>(batch) * heads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const WkvArgs a{r, k, v, w, u, s0, o, s, states,
                  st[0], st[1], st[2], st[3], st[4], st[5],
                  st[6], st[7], st[8], st[9], st[10], st[11],
                  st[12], st[13], st[14], st[15], st[16],
                  st[17], st[18], st[19], st[20], st[21], st[22],
                  st[23], st[24], st[25], st[26],
                  heads, t_len, vec};
  kern<<<dim3(static_cast<unsigned>(grid)), block, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward: four launches on `stream`, each a fixed order of sums
// and no atomics, so two calls give the same bits: the state pass over
// B x H x ceil(T / 64) blocks, the carry over B x H blocks, the gradient
// pass over B x H x ceil(T / 64) blocks (all of N^2 / 8 threads), then
// the du sum over ceil(H N / 256) blocks of 256.
// Returns cudaGetLastError() (0 = launched), cudaErrorInvalidValue for an
// N or dtype it does not take, or cudaErrorInvalidConfiguration when the
// grid or block the wrapper chose is not B x H x ceil(T / 64) blocks of
// N^2 / 8 threads.  Inputs as the forward's (dtype 0 = f32, 1 = bf16, 2 =
// f16), dO f32, dS and S f32 (dS null: no gradient on the final state, S
// then unread), `states` the forward's chunk-boundary states.  Outputs:
// dr, dk, dv, dw in the inputs' dtype, all four in one layout; du f32
// [H, N]; ds0 f32 [B, H, N, N] or null.  Scratch: `a` f64 [B, H, T, N],
// delta f32 [B, H, ceil(T / 64) + 1, N, N], e and gin f64 [B, H,
// ceil(T / 64), N, N], wseg,
// loc and dwin f64 [B, H, ceil(T / 64), N], du_part f32 of that shape.
// strides: r, k, v, w, dO (b, h, t); u (b, h); dS, S (b, h, i); states
// (b, h, chunk, i); the gradients (b, h, t): 30 values.
extern "C" int wkv_backward(const void* r, const void* k, const void* v,
                            const void* w, const float* u, const float* dO,
                            const float* dS, const float* S,
                            const float* states, void* dr, void* dk,
                            void* dv, void* dw, double* a_buf, float* delta,
                            double* e, double* gin, double* wseg,
                            double* loc, double* dwin, float* du_part,
                            float* du, float* ds0, const long long* st,
                            int batch, int heads, int t_len, int n,
                            int dtype, long long grid_x, long long grid_y,
                            int block, void* stream) {
  if ((n != 32 && n != 64) || dtype < 0 || dtype > 2 || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want = n == 32 ? Bwd<32>::kThreads : Bwd<64>::kThreads;
  const int segs = (t_len + kStateEvery - 1) / kStateEvery;
  if (block != want || grid_x != static_cast<long long>(batch) * heads ||
      grid_y != segs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const WkvBwdArgs a{r, k, v, w, u, dO, dS, S, states, dr, dk, dv, dw,
                     a_buf, delta, e, gin, wseg, loc, dwin, du_part, du, ds0,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                     st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                     st[15], st[16], st[17], st[18], st[19], st[20], st[21],
                     st[22], st[23], st[24], st[25], st[26], st[27], st[28],
                     st[29], heads, t_len, segs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_backward<float>(a, n, batch, s);
    case 1: return launch_backward<__nv_bfloat16>(a, n, batch, s);
    default: return launch_backward<__half>(a, n, batch, s);
  }
}
