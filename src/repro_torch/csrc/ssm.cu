// Mamba selective scan for Hopper (sm_90a): per batch row b and channel d
// of the inner width Di, with a state h [N] per channel:
//
//     h_t[n] = exp(dt_t[d] * A[d][n]) * h_{t-1}[n] + dt_t[d] * u_t[d] * B_t[n]
//     y_t[d] = sum_n h_t[n] * C_t[n] + D[d] * u_t[d]
//
// Hand-written CUDA replacement for the Pallas TPU kernel `ssm_scan`
// (src/repro/kernels/ssm_scan/kernel.py).  The wrapper in
// src/repro_torch/kernels/ssm_scan/kernel.py loads this file's C entry
// point with ctypes.
//
// Design.  The TPU kernel carries a [bDi, N] state in VMEM scratch across
// a sequential grid axis over time chunks; Hopper has no sequential grid
// axis, so here one thread owns one (b, d) channel for the whole sequence:
// its N state values and its row of A (pre-scaled by log2 e, so each decay
// is one exp2f on the SFU) stay in registers from the first step to the
// last, and the state crosses device memory once (in from h0, out at the
// end).  A block is 128 consecutive channels of one batch row.  B_t and
// C_t are the same for every channel of a row: each chunk of kChunk steps
// of them is staged in shared memory per __syncthreads pair and read as
// broadcasts.  u and dt are read along d, the model's contiguous axis
// (coalesced, through strides: no transpose copy), one chunk ahead in
// registers, so their latency hides behind a chunk of arithmetic; y is
// written coalesced in f32 with D*u fused in, as the Pallas kernel adds
// it.  u is f32 or bf16 (widened on load, which is exact); dt, B, C, A, D,
// h0, y and h are f32.  N in {8, 16}; any T >= 1 and any Di (the last
// chunk and the last block are masked; the Pallas kernel asserts
// T % chunk == 0 and Di % block == 0).
//
// Layouts.  u, dt, y as [Bb, T, Di] and B, C as [Bb, T, N] through
// element strides of (b, t) (the last dim contiguous: B and C are slices
// of the model's x_proj output); A [Di, N] through its row stride; D
// contiguous; h0 and h [Bb, Di, N] through strides of (b, d).  h0 may
// alias h: each thread reads its own channel's state before it writes it
// back, so a decode step (T = 1) updates the layer's state in place.
//
// Bound on the card, at Jamba's prefill (Bb = 8, T = 1,024, Di = 16,384,
// N = 16, f32): u, dt and y move 1.61 GB, B, C and h 9.4 MB: 1.62 GB,
// 0.484 ms at 3.35 TB/s.  ~8 f32 operations per (b, t, d, n), 17 GFLOP,
// 0.26 ms at the 67 TFLOP/s f32 peak: bound by bytes.  The 2.15 G
// exponentials run on the SFU at 16 a clock per SM, ~0.51 ms at 1.98 GHz,
// as tight as the bytes.  Decode (T = 1): the state's read and write,
// 16.8 MB, 5.0 us.  The grid is Di / 128 x Bb = 1,024 blocks of 4 warps at
// the prefill shape, ~8 per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;     // channels (threads) per block
constexpr int kChunk = 16;      // steps staged per __syncthreads pair
constexpr float kLog2e = 1.4426950408889634f;

template <typename U> __device__ __forceinline__ float to_f(U x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
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
  int di, t_len;
};

// This thread's u and dt for steps t0 .. t0+kChunk-1 (0 past T or for a
// channel past Di), and its share of the chunk's B and C rows.
template <typename U, int N, int kPer>
__device__ __forceinline__ void load_chunk(
    const SsmArgs& a, const U* up, const float* dp, const float* bp,
    const float* cp, bool live, int t0, float (&pu)[kChunk],
    float (&pdt)[kChunk], float (&pb)[kPer], float (&pc)[kPer]) {
  const int T = a.t_len;
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = t0 + c;
    const bool ok = live && t < T;
    pu[c] = ok ? to_f(up[t * a.ut]) : 0.f;
    pdt[c] = ok ? dp[t * a.dtt] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kBlock;
    const int t = t0 + idx / N, n = idx % N;
    const bool ok = idx < kChunk * N && t < T;
    pb[i] = ok ? bp[t * a.bt + n] : 0.f;
    pc[i] = ok ? cp[t * a.ct + n] : 0.f;
  }
}

template <typename U, int N>
__global__ void __launch_bounds__(kBlock) ssm_kernel(const SsmArgs a) {
  constexpr int kPer = (kChunk * N + kBlock - 1) / kBlock;
  __shared__ __align__(16) float sb[kChunk][N];
  __shared__ __align__(16) float sc[kChunk][N];

  const int d = blockIdx.x * kBlock + threadIdx.x;
  const long long b = blockIdx.y;
  const bool live = d < a.di;
  const int T = a.t_len;
  const U* up = static_cast<const U*>(a.u) + b * a.ub + d;
  const float* dp = a.dt + b * a.db + d;
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

  float pu[kChunk], pdt[kChunk], pb[kPer], pc[kPer];
  load_chunk<U, N, kPer>(a, up, dp, bp, cp, live, 0, pu, pdt, pb, pc);

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    // stage this chunk: B and C rows to shared memory, u and dt to the
    // registers the steps read
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kBlock;
      if (idx < kChunk * N) {
        sb[idx / N][idx % N] = pb[i];
        sc[idx / N][idx % N] = pc[i];
      }
    }
    float cu[kChunk], cdt[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cu[c] = pu[c];
      cdt[c] = pdt[c];
    }
    __syncthreads();
    if (t0 + kChunk < T)        // the next chunk's loads, in flight now
      load_chunk<U, N, kPer>(a, up, dp, bp, cp, live, t0 + kChunk, pu, pdt,
                             pb, pc);
    const int nc = min(kChunk, T - t0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c >= nc) break;
      const float dtc = cdt[c], uc = cu[c], du = dtc * uc;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sb[c][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sc[c][n]);
        h[n] = fmaf(exp2f(dtc * a2[n]), h[n], du * b4.x);
        y0 = fmaf(h[n], c4.x, y0);
        h[n + 1] = fmaf(exp2f(dtc * a2[n + 1]), h[n + 1], du * b4.y);
        y1 = fmaf(h[n + 1], c4.y, y1);
        h[n + 2] = fmaf(exp2f(dtc * a2[n + 2]), h[n + 2], du * b4.z);
        y0 = fmaf(h[n + 2], c4.z, y0);
        h[n + 3] = fmaf(exp2f(dtc * a2[n + 3]), h[n + 3], du * b4.w);
        y1 = fmaf(h[n + 3], c4.w, y1);
      }
      if (live) yp[(t0 + c) * a.yt] = (y0 + y1) + dd * uc;
    }
    __syncthreads();            // before the next chunk overwrites smem
  }

  if (live) {
    float* hp = a.h + b * a.hb + d * a.hd;
#pragma unroll
    for (int n = 0; n < N; ++n) hp[n] = h[n];
  }
}

template <typename U>
int launch(const SsmArgs& a, int batch, int n, cudaStream_t stream) {
  const dim3 grid((a.di + kBlock - 1) / kBlock, batch);
  switch (n) {
    case 8: ssm_kernel<U, 8><<<grid, kBlock, 0, stream>>>(a); break;
    case 16: ssm_kernel<U, 16><<<grid, kBlock, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------ C entry point
// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an N or dtype code it does not take.  dtype
// of u: 0 = f32, 1 = bf16.  h0 may be null (zeros) and may equal h.
// strides: u, dt, B, C (b, t); A (d); h0 (b, d); y (b, t); h (b, d): 15
// values.  The wrapper checks shapes, devices and strides, and never
// calls with Bb * Di = 0 or T = 0.
extern "C" int ssm_forward(const void* u, const float* dt, const float* B,
                           const float* C, const float* A, const float* D,
                           const float* h0, float* y, float* h,
                           const long long* st, int batch, int di,
                           int t_len, int n, int dtype, void* stream) {
  const SsmArgs a{u, dt, B, C, A, D, h0, y, h,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                  di, t_len};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, batch, n, cs);
    case 1: return launch<__nv_bfloat16>(a, batch, n, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
