// Attention kernels for Hopper (sm_90a): whole-sequence causal /
// sliding-window GQA attention (prefill) and one-token GQA decode over a
// KV cache, both with the online softmax in fp32.
//
// Hand-written CUDA replacements for the Pallas TPU kernels
// `flash_attention` (src/repro/kernels/flash_attention/kernel.py) and
// `decode_attention` (src/repro/kernels/decode_attention/kernel.py).  The
// wrappers in src/repro_torch/kernels/{flash_attention,decode_attention}/
// kernel.py load this file's C entry points with ctypes.
//
// Both kernels read q, k, v and write the output through element strides
// (the head dimension must be contiguous), so the model's [B,S,H,hd] /
// [B,T,K,hd] layout is read as it lies: no transpose copies of q, k, v or
// the cache, and no copy back of the output.  Element types: f32, bf16,
// f16; every value is widened to f32 on load, all arithmetic is f32, and
// the output is rounded once to the input type.  Head dims 32, 64, 128.
//
// flash (grid: 64-row query tiles x H x B, 128 threads).  The block stages
// its query tile (pre-scaled by 1/sqrt(hd), transposed) and one 64-row K
// and V tile at a time in shared memory as f32, and keeps the online
// softmax state (running max m, denominator l, accumulator) in registers:
// thread (ty, tx) of a 16 x 8 grid owns query rows 4ty..4ty+3, score
// columns tx + 8j and output columns tx + 8e; row max and sum reduce over
// the 8 tx lanes with shuffles.  P goes through shared memory (transposed)
// for the PV product.  KV tiles that causal or window masking leaves
// wholly empty are never loaded (the TPU kernel's `pl.when(block_live)`);
// partial tiles, ragged S and ragged T are masked per element (-inf, as
// the references mask; the Pallas kernel's -1e30 gives the same result
// wherever a row has a visible key).  Both products are plain f32 FMA from
// shared memory, not tensor-core MMA: simple and exact to f32 rounding;
// `mma.sync` / `wgmma` with TMA is later work.
//
// decode (grid: ceil(G/NG) x K x B, 256 threads).  One block per (batch,
// kv-head) holds NG of the head's G query rows in registers (NG = 1, 2, 4
// or 8, the least that covers G; G > 8 takes several blocks).  A cache
// row is read by LPR = hd*itemsize/16 lanes, 16 bytes each, so a warp
// streams 32/LPR rows at once, 4 rows per lane group per step (two 16-byte
// loads per row in flight per lane, K and V); each lane group keeps its own
// online-softmax state and the groups are merged with shuffles, the 8
// warps through shared memory.  Slots >= valid_len are never read.
// There is no split over T across blocks (flash-decoding): at B = 8,
// K = 16 the grid is 128 blocks on 132 SMs.
//
// Bounds on the card.  flash at the serve path's prefill (B = 8,
// S = T = 1,024, H = K = 16, hd = 64, bf16, causal): about 17.2 GFLOP of
// QK^T and PV inside the causal triangle (0.017 ms at 989 TFLOP/s) against
// 67 MB of q, k, v and output (0.020 ms at 3.35 TB/s): near the ridge,
// bound by bytes by a little.  This kernel computes in f32 FMA (67 TFLOP/s
// peak outside the tensor cores) and so stays far above that bound.
// decode at B = 8, T = 1,088, K = 16, hd = 64, bf16 reads 35.7 MB of K/V
// (0.011 ms) for 0.07 GFLOP: bound by bytes, which is why the design
// keeps many 16-byte loads in flight and never reads a slot past
// valid_len.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

template <typename Elt> __device__ __forceinline__ Elt from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// ------------------------------------------------------------------ flash
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // KV rows per tile
constexpr int kFlashThreads = 128;
constexpr int kPStride = 68;       // padded row of the transposed P tile

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;      // element strides over (b, s, h)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, KH, S, T, causal, window;
  float scale;
};

template <int HD>
constexpr int flash_smem_floats() {
  return HD * kBQ + kBK * (HD + 1) + kBK * HD + kBK * kPStride;
}

template <typename Elt, int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const FlashArgs a) {
  constexpr int NO = HD / 8;       // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [HD][kBQ]
  float* Ks = Qt + HD * kBQ;                      // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);                // [kBK][HD]
  float* Pt = Vs + kBK * HD;                      // [kBK][kPStride]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const Elt* qp = static_cast<const Elt*>(a.q) + b * a.q_sb + h * a.q_sh;
  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.v_sb + kh * a.v_sh;

#pragma unroll 4
  for (int it = 0; it < kBQ * HD / kFlashThreads; ++it) {
    const int i = tid + it * kFlashThreads, r = i / HD, d = i % HD;
    const int s = q0 + r;
    Qt[d * kBQ + r] =
        s < a.S ? to_f(qp[(long long)s * a.q_ss + d]) * a.scale : 0.f;
  }

  // KV tiles holding at least one key visible to a row of this tile
  const int q_last = min(q0 + kBQ, a.S) - 1;
  const int kv_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float m[4], l[4], o[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NO; ++e) o[i][e] = 0.f;
  }

  for (int k0 = kv_begin / kBK * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();               // the previous tile's reads are done
#pragma unroll 8
    for (int it = 0; it < kBK * HD / kFlashThreads; ++it) {
      const int i = tid + it * kFlashThreads, r = i / HD, d = i % HD;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < a.T) {
        kx = to_f(kp[(long long)t * a.k_st + d]);
        vx = to_f(vp[(long long)t * a.v_st + d]);
      }
      Ks[r * (HD + 1) + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * kBQ +
                                                         ty * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kv = Ks[(tx + 8 * j) * (HD + 1) + d];
        s[0][j] = fmaf(qv.x, kv, s[0][j]);
        s[1][j] = fmaf(qv.y, kv, s[1][j]);
        s[2][j] = fmaf(qv.z, kv, s[2][j]);
        s[3][j] = fmaf(qv.w, kv, s[3][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < a.T && (!a.causal || qpos >= kpos) &&
                        (a.window <= 0 || qpos - kpos < a.window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const bool none = m_new == -INFINITY;     // no visible key yet
      const float corr = none ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = none ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum += __shfl_xor_sync(kFull, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NO; ++e) o[i][e] *= corr;
    }

#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + 8 * j) * kPStride + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * kPStride +
                                                         ty * 4);
#pragma unroll
      for (int e = 0; e < NO; ++e) {
        const float vv = Vs[c * HD + tx + 8 * e];
        o[0][e] = fmaf(pv.x, vv, o[0][e]);
        o[1][e] = fmaf(pv.y, vv, o[1][e]);
        o[2][e] = fmaf(pv.z, vv, o[2][e]);
        o[3][e] = fmaf(pv.w, vv, o[3][e]);
      }
    }
  }

  Elt* op = static_cast<Elt*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= a.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < NO; ++e)
      op[(long long)s * a.o_ss + tx + 8 * e] = from_f<Elt>(o[i][e] * inv);
  }
}

template <typename Elt, int HD>
int launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = flash_smem_floats<HD>() * 4;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<Elt, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_kernel<Elt, HD><<<grid, kFlashThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elt>
int flash_hd(const FlashArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_flash<Elt, 32>(a, B, stream);
    case 64: return launch_flash<Elt, 64>(a, B, stream);
    case 128: return launch_flash<Elt, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ----------------------------------------------------------------- decode
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxG = 8;           // most query rows (of one kv-head) per block
constexpr int kUnroll = 4;         // cache rows per lane group per step

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh;            // element strides over (b, h)
  long long k_sb, k_st, k_sh;      // over (b, t, kv-head)
  long long v_sb, v_st, v_sh;
  long long o_sb, o_sh;
  int H, KH, valid;
  float scale;
};

// The EPL elements of one 16-byte load, widened to f32 (element 0 in the
// low bytes).
template <typename Elt> struct Widen;
template <> struct Widen<float> {
  static __device__ __forceinline__ void run(const uint4& r, float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <> struct Widen<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const uint4& r, float (&x)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Widen<__half> {
  static __device__ __forceinline__ void run(const uint4& r, float (&x)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __half2float(
          __ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
      x[2 * i + 1] = __half2float(
          __ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
    }
  }
};

template <typename Elt, int HD, int NG>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const DecodeArgs a) {
  constexpr int EPL = 16 / sizeof(Elt);  // elements per 16-byte load
  constexpr int LPR = HD / EPL;          // lanes per cache row
  constexpr int GPW = 32 / LPR;          // rows a warp reads at once
  constexpr int NS = kDecWarps * GPW;    // lane groups (streams) per block
  static_assert(LPR >= 1 && LPR <= 32, "row must fit one warp");
  __shared__ float sm_m[kDecWarps][NG];
  __shared__ float sm_l[kDecWarps][NG];
  __shared__ float sm_acc[kDecWarps][NG][HD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, d0 = (lane % LPR) * EPL;
  const int b = blockIdx.z, kh = blockIdx.y, g0 = blockIdx.x * NG;
  const int G = a.H / a.KH, ng = min(NG, G - g0);
  const int h0 = kh * G + g0;

  const Elt* qp = static_cast<const Elt*>(a.q) + b * a.q_sb;
  float q[NG][EPL];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      q[g][e] = g < ng ? to_f(qp[(h0 + g) * a.q_sh + d0 + e]) * a.scale
                       : 0.f;

  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.k_sb + kh * a.k_sh +
                  d0;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.v_sb + kh * a.v_sh +
                  d0;
  float m[NG], l[NG], acc[NG][EPL];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // the loop bound depends on the warp only, so the shuffles below run
  // with every lane of the warp
  for (int base = warp * GPW * kUnroll; base < a.valid;
       base += NS * kUnroll) {
    const int t0 = base + grp * kUnroll;
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < a.valid) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + t * a.k_st));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + t * a.v_st));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[kUnroll][NG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kx[EPL];
      Widen<Elt>::run(kr[u], kx);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(q[g][e], kx[e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        s[u][g] = dot;
      }
    }
    float vx[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Widen<Elt>::run(vr[u], vx[u]);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t0 + u < a.valid) mx = fmaxf(mx, s[u][g]);
      if (mx == -INFINITY) continue;      // this group has no row here
      const float corr = expf(m[g] - mx);
      float p[kUnroll], ps = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = t0 + u < a.valid ? expf(s[u][g] - mx) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * corr + ps;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x = fmaf(p[u], vx[u][e], x);
        acc[g][e] = x;
      }
    }
  }

  // merge the lane groups of a warp (lanes with the same d0)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      float ao[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        ao[e] = __shfl_xor_sync(kFull, acc[g][e], off);
      const float mx = fmaxf(m[g], mo);
      const bool none = mx == -INFINITY;  // neither side has read a row
      const float c1 = none ? 0.f : expf(m[g] - mx);
      const float c2 = none ? 0.f : expf(mo - mx);
      l[g] = l[g] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * c1 + ao[e] * c2;
      m[g] = mx;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (d0 == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps: one thread per (query row, output column)
  Elt* op = static_cast<Elt*>(a.o) + b * a.o_sb;
  for (int i = threadIdx.x; i < ng * HD; i += kDecThreads) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      if (sm_m[w][g] == -INFINITY) continue;
      const float c = expf(sm_m[w][g] - mx);
      den = fmaf(sm_l[w][g], c, den);
      num = fmaf(sm_acc[w][g][d], c, num);
    }
    op[(h0 + g) * a.o_sh + d] = from_f<Elt>(num / fmaxf(den, 1e-30f));
  }
}

template <typename Elt, int HD, int NG>
int launch_decode(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KH;
  dim3 grid((G + NG - 1) / NG, a.KH, B);
  decode_kernel<Elt, HD, NG><<<grid, kDecThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// NG: the query rows a block holds, the smallest of 1, 2, 4, 8 that covers
// G (G > 8: blocks of 8)
template <typename Elt, int HD>
int decode_ng(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KH;
  if (G == 1) return launch_decode<Elt, HD, 1>(a, B, stream);
  if (G == 2) return launch_decode<Elt, HD, 2>(a, B, stream);
  if (G <= 4) return launch_decode<Elt, HD, 4>(a, B, stream);
  return launch_decode<Elt, HD, kMaxG>(a, B, stream);
}

template <typename Elt>
int decode_hd(const DecodeArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return decode_ng<Elt, 32>(a, B, stream);
    case 64: return decode_ng<Elt, 64>(a, B, stream);
    case 128: return decode_ng<Elt, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ------------------------------------------------------------ C entry points
// Each launches on `stream` and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a head dim or dtype code it does not take.
// dtype: 0 = f32, 1 = bf16, 2 = f16.  The wrappers check shapes, devices,
// strides and alignment, and never call with an empty output.

// strides: q (b, s, h), k (b, t, h), v (b, t, h), o (b, s, h); 12 values
extern "C" int fa_flash(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int batch, int heads,
                        int kv_heads, int s_len, int t_len, int hd,
                        int dtype, int causal, int window, float scale,
                        void* stream) {
  const FlashArgs a{q, k, v, o,
                    strides[0], strides[1], strides[2],
                    strides[3], strides[4], strides[5],
                    strides[6], strides[7], strides[8],
                    strides[9], strides[10], strides[11],
                    heads, kv_heads, s_len, t_len, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return flash_hd<float>(a, batch, hd, st);
    case 1: return flash_hd<__nv_bfloat16>(a, batch, hd, st);
    case 2: return flash_hd<__half>(a, batch, hd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q (b, h), k (b, t, h), v (b, t, h), o (b, h); 10 values
extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int batch,
                         int heads, int kv_heads, int valid, int hd,
                         int dtype, float scale, void* stream) {
  const DecodeArgs a{q, k, v, o,
                     strides[0], strides[1],
                     strides[2], strides[3], strides[4],
                     strides[5], strides[6], strides[7],
                     strides[8], strides[9],
                     heads, kv_heads, valid, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return decode_hd<float>(a, batch, hd, st);
    case 1: return decode_hd<__nv_bfloat16>(a, batch, hd, st);
    case 2: return decode_hd<__half>(a, batch, hd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
