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
// src/repro_torch/kernels/wkv_scan/kernel.py loads this file's C entry
// point with ctypes.
//
// Design.  The TPU kernel keeps S in VMEM scratch and carries it across a
// sequential grid axis over time chunks; Hopper has no sequential grid
// axis, so here one block of N threads owns one (b, h) for the whole
// sequence and loops over time inside the block.  Thread j owns column j
// of S: its N f32 values stay in registers from the first step to the
// last, and S is read from (s0) and written to device memory once.  Each
// chunk of kChunk steps is staged in shared memory as f32 — r_t, k_t and
// the decay exp(w_log_t) — so one __syncthreads pair serves kChunk steps;
// thread j loads element j of every staged row (coalesced) and keeps its
// own v_t[j] in registers.  The next chunk's loads are issued into
// registers before the current chunk is computed, so their latency hides
// behind kChunk steps of arithmetic.  The bonus term factors through one
// scalar per step, sum_i r_t[i] u[i] k_t[i], reduced with warp shuffles at
// staging time: a step is then N FMAs for o and N mul+FMA for S per
// thread, reading r, k and the decay from shared memory as broadcast
// float4s.  o is summed in four partial sums.  Element types of r, k, v,
// w_log: f32, bf16, f16, widened to f32 on load; u, s0, o and S are f32.
// N in {32, 64}; any T >= 1 (the Pallas kernel asserts T % chunk == 0).
//
// Layouts.  Every operand is read and written through element strides
// (the last dim must be contiguous): r, k, v, w_log as [B, H, T, N] views
// of the model's [B, T, H, N] tensors, u as a stride-0 batch view of
// [H, N], o written in [B, T, H, N] memory order, S in [B, H, N, N].  So
// the op makes no transpose copies.  s0 may alias the output state: each
// thread reads its column before it writes it back, so a decode step
// updates the layer's state in place.
//
// Bound on the card, at the serve path's prefill (B = 8, T = 1,024,
// H = 40, N = 64, f32): r, k, v, w_log 4 x 83.9 MB, o 83.9 MB, S 5.2 MB:
// 0.425 GB, 0.127 ms at 3.35 TB/s; 5 N^2 flops per step and head, 6.7
// GFLOP, 0.100 ms at the 67 TFLOP/s f32 peak outside the tensor cores:
// bound by bytes.  Decode (T = 1): the state's 2 x 5.2 MB, ~3.1 us.  The
// grid is B x H = 320 blocks of 64 threads (2 warps): few warps per SM,
// so the kernel leans on the in-block ILP (independent S updates, four
// partial sums, loads in flight a chunk ahead) rather than occupancy.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 8;       // steps staged per __syncthreads pair

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
};

// One chunk of column `p` (thread j's element) for steps t0 .. t0+kChunk-1;
// steps at or past T read as 0.
template <typename Elt>
__device__ __forceinline__ void load_chunk(float (&dst)[kChunk],
                                           const Elt* p, long long st,
                                           int t0, int T) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = t0 + c;
    dst[c] = t < T ? to_f(p[t * st]) : 0.f;
  }
}

template <typename Elt, int N>
__global__ void __launch_bounds__(N) wkv_kernel(const WkvArgs a) {
  constexpr int kWarps = N / 32;
  __shared__ __align__(16) float sr[kChunk][N];
  __shared__ __align__(16) float sk[kChunk][N];
  __shared__ __align__(16) float sw[kChunk][N];
  __shared__ float sbonus[kWarps][kChunk];

  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const long long b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int T = a.t_len;
  const Elt* rp = static_cast<const Elt*>(a.r) + b * a.rb + h * a.rh + j;
  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.kb + h * a.kh + j;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.vb + h * a.vh + j;
  const Elt* wp = static_cast<const Elt*>(a.w) + b * a.wb + h * a.wh + j;
  float* op = a.o + b * a.ob + h * a.oh + j;
  const float uj = a.u[b * a.ub + h * a.uh + j];

  float S[N];                   // column j of the state
  if (a.s0 != nullptr) {
    const float* sp = a.s0 + b * a.s0b + h * a.s0h + j;
#pragma unroll
    for (int i = 0; i < N; ++i) S[i] = sp[i * a.s0i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) S[i] = 0.f;
  }

  float pr[kChunk], pk[kChunk], pv[kChunk], pw[kChunk];
  load_chunk(pr, rp, a.rt, 0, T);
  load_chunk(pk, kp, a.kt, 0, T);
  load_chunk(pv, vp, a.vt, 0, T);
  load_chunk(pw, wp, a.wt, 0, T);

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    // stage this chunk: r, k, decay to shared memory, v_j to registers,
    // and the bonus scalars sum_i r_i u_i k_i per step
    float cv[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      sr[c][j] = pr[c];
      sk[c][j] = pk[c];
      sw[c][j] = expf(pw[c]);
      cv[c] = pv[c];
      float part = pr[c] * uj * pk[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (lane == 0) sbonus[warp][c] = part;
    }
    __syncthreads();
    if (t0 + kChunk < T) {      // the next chunk's loads, in flight now
      load_chunk(pr, rp, a.rt, t0 + kChunk, T);
      load_chunk(pk, kp, a.kt, t0 + kChunk, T);
      load_chunk(pv, vp, a.vt, t0 + kChunk, T);
      load_chunk(pw, wp, a.wt, t0 + kChunk, T);
    }
    const int nc = min(kChunk, T - t0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c >= nc) break;
      float bonus = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) bonus += sbonus[q][c];
      const float vj = cv[c];
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[c][i]);
        o0 = fmaf(r4.x, S[i], o0);
        S[i] = fmaf(w4.x, S[i], k4.x * vj);
        o1 = fmaf(r4.y, S[i + 1], o1);
        S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
        o2 = fmaf(r4.z, S[i + 2], o2);
        S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
        o3 = fmaf(r4.w, S[i + 3], o3);
        S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
      }
      op[(t0 + c) * a.ot] = ((o0 + o1) + (o2 + o3)) + vj * bonus;
    }
    __syncthreads();            // before the next chunk overwrites smem
  }

  float* sp = a.s + b * a.sb + h * a.sh + j;
#pragma unroll
  for (int i = 0; i < N; ++i) sp[i * a.si] = S[i];
}

template <typename Elt>
int launch(const WkvArgs& a, int batch, int n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch) * a.heads);
  switch (n) {
    case 32: wkv_kernel<Elt, 32><<<grid, 32, 0, stream>>>(a); break;
    case 64: wkv_kernel<Elt, 64><<<grid, 64, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------ C entry point
// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an N or dtype code it does not take.  dtype
// of r, k, v, w_log: 0 = f32, 1 = bf16, 2 = f16.  s0 may be null (zeros)
// and may equal s.  strides: r, k, v, w (b, h, t); u (b, h); s0 (b, h, i);
// o (b, h, t); s (b, h, i): 23 values.  The wrapper checks shapes,
// devices and strides, and never calls with B * H = 0 or T = 0.
extern "C" int wkv_forward(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* s0,
                           float* o, float* s, const long long* st,
                           int batch, int heads, int t_len, int n,
                           int dtype, void* stream) {
  const WkvArgs a{r, k, v, w, u, s0, o, s,
                  st[0], st[1], st[2], st[3], st[4], st[5],
                  st[6], st[7], st[8], st[9], st[10], st[11],
                  st[12], st[13], st[14], st[15], st[16],
                  st[17], st[18], st[19], st[20], st[21], st[22],
                  heads, t_len};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, batch, n, cs);
    case 1: return launch<__nv_bfloat16>(a, batch, n, cs);
    case 2: return launch<__half>(a, batch, n, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
