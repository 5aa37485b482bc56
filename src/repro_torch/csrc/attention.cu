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
// the cache, and no copy back of the output.  Element types f32, bf16,
// f16; head dims 32, 64, 128; softmax state and accumulators in f32, the
// output rounded once to the input type.
//
// flash, two routes by dtype.
//
// bf16 / f16: `flash_kernel_wgmma`, one warpgroup (4 warps) per 64-row
// query tile.  The 1-D grid issues the query tiles of every (b, h) in
// reverse order, so under a causal mask the longest tiles start first.
// 64-row K and V tiles lie in shared memory in the swizzle that TMA
// writes and wgmma reads (128-byte rows: hd/64 column blocks of
// [rows][64]; at hd 32, 64-byte rows and the 64-byte swizzle), copied
// with 16-byte cp.async whose addresses are fixed per thread (a row step
// is a constant add); K and V are double-buffered, so tile i + 1 is in
// flight while tile i is computed, with one __syncthreads per tile.
// S = Q·Kᵀ is wgmma m64n64k16 with Q and K both K-major in shared
// memory (Q staged once); the online softmax runs on its accumulators in
// f32, with 1/sqrt(hd)·log2 e folded into one FMA before ex2; P is
// rounded to the input type in place and is the register A operand of
// O += P·V, wgmma m64n{hd}k16 reading V through the descriptor's
// transpose (no shared-memory round trip for P).  Only tiles that cross
// the diagonal, a window edge or the end of T are masked per element
// (-inf, as the references mask); a tile that none of the block's rows
// sees is never loaded.  The epilogue stages O in shared memory and
// writes 16-byte pieces in the caller's strides, so every row of q, k, v
// and the output must start on 16 bytes (the wrapper checks).  The
// rounding of P is the one difference in arithmetic from the f32 plain
// version.
//
// f32: `flash_kernel`, plain f32 FMA from shared memory (the on-card
// f32 checks hold it to 2e-5, which the tensor cores' bf16 inputs would
// not meet).  The block stages its query tile (pre-scaled by 1/sqrt(hd),
// transposed) and one 64-row K and V tile at a time in shared memory as
// f32; thread (ty, tx) of a 16 x 8 grid owns query rows 4ty..4ty+3, score
// columns tx + 8j and output columns tx + 8e; P goes through shared
// memory for the PV product.
//
// decode, two routes by dtype, as flash.  A block reduces its share of
// [0, valid_len) to an online-softmax state (m, l, unnormalised acc) per
// query row in shared memory and writes O from it; slots >= valid_len
// are never read.  The wrapper decides the launch's shape and passes it
// in: the query rows a block holds (ng) and, on the bf16 / f16 route, the
// split of the cache (n_split contiguous ranges, their bounds given).
//
// Split-KV inside one launch (bf16 / f16).  The blocks of one
// thread-block cluster (NSPLIT of them, along grid x) share a (batch,
// kv-head, group of query rows); rank r reads range r.  After
// cluster.sync(), rank 0 reads the other ranks' states through
// distributed shared memory, merges them in rank order and writes O; a
// second cluster.sync() keeps the other blocks' shared memory alive until
// it has.  No global scratch, no second launch, and the result does not
// depend on timing.  The wrapper splits only a grid that fills a small
// share of the SMs (one long sequence; `decode_splits`).
//
// bf16 / f16: `decode_kernel_mma` (grid: NSPLIT·ceil(G/16) x K x B, 4
// warps).  The group's query rows (up to 16; q is read with scalar loads,
// since a sliced head axis may leave its rows off 16 bytes) are the A
// operand of mma.sync m16n8k16; the range is cut into 16-row tiles dealt
// to the warps in turn, each warp with its own two-stage cp.async ring,
// the online softmax as in flash.  At G = 8 (Jamba) the
// products that cost FMA and shuffles per cache row on the f32 route are
// a few mma per 16 rows, so the block's time is its loads.  Each cache row
// is read once per call, so its copies carry an L2 evict-first policy:
// they do not push out of L2 what the step's other kernels read again.
//
// f32: `decode_kernel` (grid: ceil(G/NG) x K x B, 256 threads, no
// split).  A block holds NG of the head's G query rows (1, 2, 4 or 8, the
// least that covers G) in registers; a cache row is read by hd/4 lanes,
// 16 bytes each, 4 rows per lane group per step; each lane group keeps
// its own state, merged with shuffles, the 8 warps through shared memory.
//
// Bounds on the card.  flash at Qwen's prefill (B = 8, S = T = 1,024,
// H = K = 16, hd = 64, bf16, causal): 17.2 GFLOP of QK^T and PV inside
// the causal triangle (0.017 ms at 989 TFLOP/s) against 67 MB of q, k, v
// and output (0.020 ms at 3.35 TB/s): bound by bytes by a little.  At
// Jamba's (H = 64, K = 8, hd = 128): 137.6 GFLOP (0.139 ms) against
// 0.30 GB: bound by operations.  This route reaches neither: the kernel
// is bound by issuing instructions (a warpgroup waits on its own wgmma,
// the softmax of tile i does not overlap the products of tile i + 1, and
// the consumer threads issue the tiles' copies); a TMA producer warp and
// a second consumer warpgroup are the next step.  decode at B = 8,
// T = 1,088, K = 16, hd = 64, bf16 reads 35.7 MB of K/V (0.011 ms) for
// 0.07 GFLOP: bound by bytes.
//

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

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

// ------------------------------------------------------------ flash, f32
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
  float* lse;                      // [B, H, S] f32 log-sum-exp, or null
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
    // m is in the scaled units of the pre-scaled Q
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)b * a.H + h) * a.S + s] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < NO; ++e)
      op[(long long)s * a.o_ss + tx + 8 * e] = from_f<Elt>(o[i][e] * inv);
  }
}


template <int HD>
int launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = flash_smem_floats<HD>() * 4;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_kernel<float, HD><<<grid, kFlashThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------- tensor-core and copy building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `bytes` = 0 fills the 16 with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
// the same with an L2 cache policy (`evict_first`: data read once)
__device__ __forceinline__ void cp_async16_hint(uint32_t dst, const void* src,
                                                int bytes, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(dst), "l"(src), "r"(bytes), "l"(policy));
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D += A·B, m16n8k16, f32 accumulate; a pair of values per 32-bit
// register, the lower index in the low half
template <typename Elt> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

// ----------------------------------------------------- flash on wgmma
// The swizzles TMA writes and wgmma reads, for tiles of RB-byte rows
// (8-row groups of 8·RB bytes from an aligned base): 128 bytes, the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8); 64 bytes, at
// c ^ (r / 2 % 4) (address bits 4-6, resp. 4-5, XOR bits 7-9, resp. 7-8).
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(RB == 64 || RB == 128, "64- or 128-byte swizzle");
  return r * RB + ((c ^ (RB == 128 ? r & 7 : r >> 1 & 3)) << 4);
}

// wgmma shared-memory descriptor for RB-byte swizzled rows: start
// address, leading and stride byte offsets in 16-byte units, the layout
// (1 = 128-byte swizzle, 2 = 64-byte)
template <int RB>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * RB >> 4) << 32) |
         (static_cast<uint64_t>(RB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes go through the generic proxy, wgmma reads through the
// async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers
// across the fences and waits around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma with f32 accumulators: the accumulator of row r of the 64, column
// c, lies in warp r / 16 of the warpgroup as mma.sync's C fragment of row
// r % 16 (register 4·(c / 8) + ...); A from registers is mma.sync's A
// fragment of the warp's 16 rows.  The descriptors are `gmma_desc`'s.
// Operand lists: 32 or 64 accumulators, then A (descriptor or 4
// registers), B's descriptor and the predicate that keeps D (scale-d).
#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_R16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15}, "
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}, "
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define WG_OP(shape, T) \
  "wgmma.mma_async.sync.aligned." shape ".f32." T "." T " "

// T: the PTX type of A and B ("bf16", "f16")
#define WG_METHODS(T)                                                   \
  /* D = A·Bᵀ (+ D if acc), m64n64k16, A and B K-major in shared memory */ \
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t da, \
                                              uint64_t db, int acc) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" WG_OP(     \
                     "m64n64k16", T) WG_R32 "%32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : WG_D32                                               \
                 : "l"(da), "l"(db), "r"(acc));                         \
  }                                                                     \
  /* the same at m64n32k16 */                                            \
  static __device__ __forceinline__ void ss32(float (&d)[16], uint64_t da, \
                                              uint64_t db, int acc) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" WG_OP(     \
                     "m64n32k16", T) WG_R16 "%16, %17, p, 1, 1, 0, 0;\n}\n" \
                 : WG_D8(0), WG_D8(8)                                   \
                 : "l"(da), "l"(db), "r"(acc));                         \
  }                                                                     \
  /* D += A·B, m64nNk16 (N = 64, 32, 128), A in registers, B MN-major */ \
  static __device__ __forceinline__ void rs64(                          \
      float (&d)[32], const uint32_t (&a)[4], uint64_t db) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" WG_OP(     \
                     "m64n64k16", T) WG_R32                             \
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"          \
                 : WG_D32                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
                   "r"(1));                                             \
  }                                                                     \
  static __device__ __forceinline__ void rs32(                          \
      float (&d)[16], const uint32_t (&a)[4], uint64_t db) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" WG_OP(     \
                     "m64n32k16", T) WG_R16                             \
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"          \
                 : WG_D8(0), WG_D8(8)                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
                   "r"(1));                                             \
  }                                                                     \
  static __device__ __forceinline__ void rs128(                         \
      float (&d)[64], const uint32_t (&a)[4], uint64_t db) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" WG_OP(     \
                     "m64n128k16", T) WG_R64                            \
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"          \
                 : WG_D64                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
                   "r"(1));                                             \
  }

template <typename Elt> struct Wgmma;
template <> struct Wgmma<__nv_bfloat16> { WG_METHODS("bf16") };
template <> struct Wgmma<__half> { WG_METHODS("f16") };

// Q and two stages of K and V, + alignment to 1,024
template <int HD>
constexpr int flash_wgmma_smem_bytes() {
  return 1024 + (64 + 4 * 64) * HD * 2;
}

// One warpgroup owning 64 query rows; tiles of q, k and v
// stored as HD/64 column halves of [rows][64] with the 128-byte swizzle.
// S = Q·Kᵀ: wgmma m64n64k16, Q and K both K-major in shared memory; O +=
// P·V: wgmma m64nHDk16 with P in registers and V read MN-major (the
// descriptor's transpose) from the same tile layout.
template <typename Elt, int HD>
__global__ void __launch_bounds__(128)
flash_kernel_wgmma(const FlashArgs a) {
  constexpr int BQ = 64, BK = 64, NT = 128, CH = HD / 8;
  constexpr int TILE = BK * HD * 2;          // bytes of one K or V tile
  // tiles as column blocks of [rows][COLS], rows of RB bytes
  constexpr int COLS = HD < 64 ? HD : 64, RB = COLS * 2, CPB = COLS / 8;
  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t base = (raw + 1023) & ~1023u;
  // Q [HD/COLS][BQ][COLS], then [2 stages][K, V][HD/COLS][BK][COLS]
  const uint32_t sQ = base, sKV = base + BQ * HD * 2;
  char* const gO = reinterpret_cast<char*>(smem4) + (base - raw);

  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int BH = gridDim.x / ((a.S + BQ - 1) / BQ);  // B·H
  const int idx = gridDim.x - 1 - blockIdx.x;       // longest tiles first
  const int tile = idx / BH, b = idx % BH / a.H, h = idx % BH % a.H;
  const int q0 = tile * BQ, kh = h / (a.H / a.KH);
  const Elt* qp = static_cast<const Elt*>(a.q) + b * a.q_sb + h * a.q_sh;
  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.v_sb + kh * a.v_sh;

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, cc = i % CH, s = q0 + r;
    cp_async16(sQ + cc / CPB * BQ * RB + swz<RB>(r, cc % CPB),
               qp + (long long)min(s, a.S - 1) * a.q_ss + cc * 8,
               s < a.S ? 16 : 0);
  }
  cp_async_commit();
  // this thread's 16-byte pieces of a K or V tile: piece lc of rows lr,
  // lr + RP, ...; its swizzled place moves by RP rows a pass (RP is a
  // multiple of 8)
  constexpr int RP = NT / CH, PASSES = BK / RP;
  const int lr = tid / CH, lc = tid % CH;
  const uint32_t soff = lc / CPB * BK * RB + swz<RB>(lr, lc % CPB);
  const long long kstep = RP * a.k_st, vstep = RP * a.v_st;
  auto load_kv = [&](int k0, int stage) {
    const uint32_t sk = sKV + stage * 2 * TILE + soff, sv = sk + TILE;
    const Elt* kr = kp + (long long)(k0 + lr) * a.k_st + lc * 8;
    const Elt* vr = vp + (long long)(k0 + lr) * a.v_st + lc * 8;
    if (k0 + BK <= a.T) {
#pragma unroll
      for (int it = 0; it < PASSES; ++it) {
        cp_async16(sk + it * RP * RB, kr + it * kstep, 16);
        cp_async16(sv + it * RP * RB, vr + it * vstep, 16);
      }
    } else {                       // the ragged end of T: zeros past it
#pragma unroll
      for (int it = 0; it < PASSES; ++it) {
        const bool in = k0 + lr + it * RP < a.T;
        cp_async16(sk + it * RP * RB, in ? kr + it * kstep : kp, in ? 16 : 0);
        cp_async16(sv + it * RP * RB, in ? vr + it * vstep : vp, in ? 16 : 0);
      }
    }
  };

  const int q_last = min(q0 + BQ, a.S) - 1;
  const int kv_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_first = kv_begin / BK * BK;
  load_kv(k_first, 0);
  cp_async_commit();

  // the block's rows: qw .. qw + 63; this lane's: r0 and r0 + 8
  const int qw = q0, g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = qw + wq * 16 + g, r1 = r0 + 8;
  const float sl2 = a.scale * 1.4426950408889634f;  // scale · log2 e
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  int stage = 0;
  for (int k0 = k_first; k0 < kv_end; k0 += BK, stage ^= 1) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();     // tile k0 landed; every warp is done with stage ^ 1
    if (k0 + BK < kv_end) load_kv(k0 + BK, stage ^ 1);
    cp_async_commit();
    const bool partial = k0 + BK > a.T || (a.causal && k0 + BK - 1 > qw) ||
                         (a.window > 0 && qw + 63 - k0 >= a.window);

    const uint32_t sk = sKV + stage * 2 * TILE, sv = sk + TILE;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // step kk: 16 columns, 32 bytes into its column block's rows
      const int blk = kk / (COLS / 16), col = kk % (COLS / 16) * 32;
      Wgmma<Elt>::ss64(s, gmma_desc<RB>(sQ + blk * BQ * RB + col, 16),
                       gmma_desc<RB>(sk + blk * BK * RB + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    if (partial) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + c2 + (e & 1);
          const int qpos = e < 2 ? r0 : r1;
          const bool ok = kpos < a.T && (!a.causal || qpos >= kpos) &&
                          (a.window <= 0 || qpos - kpos < a.window);
          if (!ok) s[4 * j + e] = -INFINITY;
        }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float base0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float corr0 = ex2(m0 * sl2 - base0);
    const float corr1 = ex2(m1 * sl2 - base1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], sl2, -base0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -base0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -base1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -base1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= corr0;
      o[4 * n + 1] *= corr0;
      o[4 * n + 2] *= corr1;
      o[4 * n + 3] *= corr1;
    }

    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = Mma<Elt>::pack(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = Mma<Elt>::pack(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = Mma<Elt>::pack(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = Mma<Elt>::pack(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // rows 16kk.. of V: two 8-row groups each step; the column blocks
      // BK·RB bytes apart
      const uint64_t dv = gmma_desc<RB>(sv + kk * 16 * RB, BK * RB);
      if constexpr (HD == 32)
        Wgmma<Elt>::rs32(o, pa[kk], dv);
      else if constexpr (HD == 64)
        Wgmma<Elt>::rs64(o, pa[kk], dv);
      else
        Wgmma<Elt>::rs128(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (a.lse != nullptr && (lane & 3) == 0) {   // m is the raw max of Q·Kᵀ
    float* lp = a.lse + ((long long)b * a.H + h) * a.S;
    if (r0 < a.S)
      lp[r0] = m0 == -INFINITY ? -INFINITY : m0 * a.scale + logf(l0);
    if (r1 < a.S)
      lp[r1] = m1 == -INFINITY ? -INFINITY : m1 * a.scale + logf(l1);
  }
  // stage O over the first tile of shared memory, rows of HD·2 bytes with
  // their 16-byte chunks permuted by the row (no bank conflicts), then
  // write 16-byte pieces
  __syncthreads();                 // the warpgroup is done with Q, K and V
  constexpr int OB = HD * 2;        // bytes of a staged row
  // its 16-byte chunks permuted by the row as the swizzles do
  auto perm = [](int r, int c) { return c ^ (OB == 64 ? r >> 1 & 3 : r & 7); };
  const int w0 = wq * 16;                    // this warp's first tile row
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int ra = w0 + g, rb = ra + 8;
    *reinterpret_cast<uint32_t*>(gO + ra * OB + (perm(ra, n) << 4) +
                                 2 * c2) =
        Mma<Elt>::pack(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(gO + rb * OB + (perm(rb, n) << 4) +
                                 2 * c2) =
        Mma<Elt>::pack(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  __syncwarp();
  Elt* op = static_cast<Elt*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = w0 + i / CH, c = i % CH, s = q0 + r;
    if (s < a.S)
      *reinterpret_cast<uint4*>(op + (long long)s * a.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(gO + r * OB + (perm(r, c) << 4));
  }
}

template <typename Elt, int HD>
int launch_flash_wgmma(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = flash_wgmma_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_wgmma<Elt, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const long long blocks = (long long)((a.S + 63) / 64) * a.H * B;
  flash_kernel_wgmma<Elt, HD><<<static_cast<unsigned>(blocks), 128, bytes,
                                stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 / f16: wgmma
template <typename Elt>
int flash_tc_hd(const FlashArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_flash_wgmma<Elt, 32>(a, B, stream);
    case 64: return launch_flash_wgmma<Elt, 64>(a, B, stream);
    case 128: return launch_flash_wgmma<Elt, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_f32_hd(const FlashArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_flash<32>(a, B, stream);
    case 64: return launch_flash<64>(a, B, stream);
    case 128: return launch_flash<128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -------------------------------------------------------- flash backward
// fa_flash_bwd: the gradients of flash attention from the forward's
// output O and per-row log-sum-exp L (f32 [B, H, S]).  It replaces no
// Pallas kernel: the JAX package's gradients are autodiff of its XLA twin
// `flash_attention_xla`.  Three launches:
//
// 1. `flash_bwd_delta_kernel`: δ = rowsum(dO∘O) per query row into an
//    f32 [B, H, S] buffer (a warp a row), read by both later kernels.
// 2. dK/dV: a block per (64-key tile, KV head, batch, head range).  The
//    G query heads of a KV head are cut into `hsplit` contiguous ranges
//    (the wrapper's plan), one block each, so under GQA and MQA the grid
//    still fills the card.  A block loops over its heads and, for each,
//    over the query tiles that see its keys (a tile the causal mask or
//    the window hides is never loaded), recomputes Sᵀ = K·Qᵀ and
//    Pᵀ = exp(Sᵀ·scale − L), dPᵀ = V·dOᵀ and dSᵀ = Pᵀ∘(dPᵀ − δ), and
//    accumulates dV += Pᵀ·dO and dK += dSᵀ·Q in registers.  With one range
//    (hsplit 1) it writes dK (times scale) and dV once, in the input type;
//    otherwise it writes f32 partials into a [2][hsplit][B, T, KH, hd]
//    scratch.
// 3. dQ: a block per (64-query tile, head, batch) over the key tiles its
//    rows see: S, P, dP and dS as above, dQ += dS·K, written once.  With
//    hsplit > 1 the same launch has more blocks after those, which sum
//    the dK/dV partials over the ranges in range order, scale dK, round
//    to the input type and write dK and dV.
//
// No block writes what another writes, every sum runs in a fixed order
// and no atomics are used, so two calls give the same bits.
//
// bf16 / f16 (`flash_bwd_dkdv_wgmma`, `flash_bwd_dq_wgmma`): 160 threads,
// a consumer warpgroup (warps 0-3) and a producer warp (warp 4).  The
// block's own tile (K and V for dK/dV, Q and dO for dQ) is staged once
// by all threads; the producer then carries the tiles it loops over (Q,
// dO, L and δ for dK/dV; K and V for dQ) into a ring of shared-memory
// stages with cp.async, and marks each stage full on an mbarrier that
// completes when its copies land (cp.async.mbarrier.arrive.noinc); the
// consumers mark it empty on a second mbarrier once their products have
// read it.  Tiles lie in the swizzle the forward's wgmma reads (128-byte
// rows: hd/64 column blocks of [rows][64]; at hd 32, 64-byte rows).  The
// products run on wgmma with f32 accumulators: in the dK/dV kernel
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with K and V the shared-memory A operand and
// Q and dO the K-major B operand (m64 n BQ), then Pᵀ and dSᵀ, rounded in
// registers to the input type, are the register A operand of dV += Pᵀ·dO
// and dK += dSᵀ·Q with dO and Q read MN-major through the descriptor's
// transpose (m64 n hd), as the forward reads V; the consumer waits for
// Sᵀ alone before its exponentials, so dPᵀ finishes under them.  Each
// consumer warpgroup owns the block's 64 keys; BQ, the query rows of a
// stage, is 64, and 32 at hd 128, where dK and dV alone hold 128
// registers a thread.  The dQ kernel is the forward's shape: S = Q·Kᵀ
// and dP = dO·Vᵀ (m64n64), dQ += dS·K with K read MN-major.  The rounding
// of P and dS is the one difference in arithmetic from the f32 plain
// version.  Not built: TMA tensor maps for the loads (the producer warp
// issues cp.async, 16 bytes a lane a copy) and a second consumer
// warpgroup per block.
//
// f32 (`flash_bwd_dkdv_f32`, `flash_bwd_dq_f32`): FMA from shared memory
// (the f32 checks hold it to 2e-5), hsplit 1.  Masked entries take P = 0
// on both routes, as the references' -inf before the exp gives.
//
// Bound at Qwen's train shape (B = 8, S = T = 1,024, H = K = 16, hd 64,
// causal, bf16): 10·pairs·hd·B·H = 43.0 GFLOP (0.043 ms at 989 TFLOP/s)
// against 134 MB of q, k, v, o, dO, dq, dk, dv (0.040 ms): bound by
// operations by a little.  The design issues 14·hd operations a visible
// pair (the dQ kernel recomputes S and dP) on 64 x 64 tiles, whole tiles
// on the diagonal: ~1.5x the bound's products.  What bounds it on the
// card (timings of variants built without parts of the work): a
// consumer warpgroup runs its tile's products, exponentials and dS one
// after another and waits on each, with two warpgroups an SM (the
// producer warp's registers keep dK/dV at 168 a thread, and it spills at
// hd 128); the products, then the exponentials, take the largest shares,
// the waits for loads a small one.  The dQ kernel runs three blocks an
// SM up to hd 64, which measured faster there.  Overlapping one warpgroup's exponentials with another's
// products (two consumer warpgroups a block, register reallocation) is
// the next step.
struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                // [B, H, S]
  float* delta;                    // [B, H, S], written by pass 1
  void* dq;
  void* dk;
  void* dv;
  float* part;                     // hsplit > 1: [2][hsplit][B][T][KH][hd]
  long long q_sb, q_ss, q_sh;      // element strides over (b, s, h)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int B, H, KH, S, T, causal, window;
  float scale;
  int hsplit;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBwdTile = 64;       // key rows (dK/dV) / query rows (dQ)
constexpr int kBwdThreads = 160;   // tensor cores: 4 consumer warps + 1
constexpr int kBwdConsumers = 128;

__device__ __forceinline__ bool visible(const FlashBwdArgs& a, int qpos,
                                        int kpos) {
  return qpos < a.S && kpos < a.T && (!a.causal || qpos >= kpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

// 1. δ: 8 warps a block, a warp a query row
template <typename Elt, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const FlashBwdArgs a) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.H * a.S) return;
  const int s = static_cast<int>(row % a.S);
  const long long bh = row / a.S;
  const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
  const Elt* op = static_cast<const Elt*>(a.o) + b * a.o_sb + s * a.o_ss +
                  h * a.o_sh;
  const Elt* gp = static_cast<const Elt*>(a.dout) + b * a.do_sb +
                  s * a.do_ss + h * a.do_sh;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(op[d]), to_f(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// ------------------------------------------- mbarriers and the load ring
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the barrier counts this thread's arrival once all its earlier cp.async
// copies have landed (its count includes the arrival: .noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// wait for the phase of `parity` to complete; a ring that never completes
// (a fault in the kernel) traps instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins > (1 << 24)) __trap();
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// rows r0 .. r0 + ROWS - 1 of an operand with rows of HD elements `rs`
// apart (rows >= n read as zeros) into a swizzled tile at `dst`, the
// 16-byte pieces dealt to threads t, t + nthr, ...
template <typename Elt, int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const Elt* src,
                                          long long rs, int r0, int n,
                                          int t, int nthr) {
  constexpr int COLS = HD < 64 ? HD : 64, RB = COLS * 2, CPB = COLS / 8;
  constexpr int CH = HD / 8;
  for (int i = t; i < ROWS * CH; i += nthr) {
    const int r = i / CH, cc = i % CH, s = r0 + r;
    const bool ok = s < n;
    cp_async16(dst + cc / CPB * ROWS * RB + swz<RB>(r, cc % CPB),
               ok ? src + (long long)s * rs + cc * 8 : src, ok ? 16 : 0);
  }
}

// query rows a stage of the dK/dV ring holds, and the rings' depths
template <int HD>
__host__ __device__ constexpr int bwd_bq() {
  return HD == 128 ? 32 : 64;
}
constexpr int kDkdvStages = 3;
template <int HD>
__host__ __device__ constexpr int dq_stages() {
  return HD == 128 ? 2 : 3;
}

// K, V; the stages' Q, dO, L and δ; the barriers; + alignment to 1,024
template <int HD>
constexpr int dkdv_smem_bytes() {
  constexpr int BQ = bwd_bq<HD>(), ST = kDkdvStages;
  return 1024 + 2 * kBwdTile * HD * 2 + ST * 2 * BQ * HD * 2 +
         ST * 2 * BQ * 4 + 2 * ST * 8;
}
// Q, dO; the stages' K and V; the barriers; + alignment
template <int HD>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * kBwdTile * HD * 2 + dq_stages<HD>() * 2 * kBwdTile * HD *
         2 + 2 * dq_stages<HD>() * 8;
}

// D (+)= A·Bᵀ with the B rows of a stage: m64 n64 or n32
template <typename Elt, int BQ>
__device__ __forceinline__ void ss_tile(float (&d)[BQ / 2], uint64_t da,
                                        uint64_t db, int acc) {
  if constexpr (BQ == 64)
    Wgmma<Elt>::ss64(d, da, db, acc);
  else
    Wgmma<Elt>::ss32(d, da, db, acc);
}
// D += A·B, A in registers, B MN-major, N = HD
template <typename Elt, int HD>
__device__ __forceinline__ void rs_hd(float (&d)[HD / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32)
    Wgmma<Elt>::rs32(d, a, db);
  else if constexpr (HD == 64)
    Wgmma<Elt>::rs64(d, a, db);
  else
    Wgmma<Elt>::rs128(d, a, db);
}

// the register A operand of a k16 step from accumulator columns 16kk ..
template <typename Elt, int N>
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const float (&s)[N],
                                       int kk) {
  f[0] = Mma<Elt>::pack(s[8 * kk], s[8 * kk + 1]);
  f[1] = Mma<Elt>::pack(s[8 * kk + 2], s[8 * kk + 3]);
  f[2] = Mma<Elt>::pack(s[8 * kk + 4], s[8 * kk + 5]);
  f[3] = Mma<Elt>::pack(s[8 * kk + 6], s[8 * kk + 7]);
}

// 2. dK/dV on wgmma.  The 1-D grid: tile-major (under a causal mask the
// longest tiles, the first, start first), then head range, KV head, batch.
template <typename Elt, int HD>
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dkdv_wgmma(const FlashBwdArgs a) {
  constexpr int BK = kBwdTile, BQ = bwd_bq<HD>(), ST = kDkdvStages;
  constexpr int COLS = HD < 64 ? HD : 64, RB = COLS * 2;
  constexpr int KT = BK * HD * 2, QT = BQ * HD * 2;   // bytes of a tile
  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t base = (raw + 1023) & ~1023u;
  // K, V; stage st: Q at sQ + 2 st QT, dO QT after; L [ST][BQ], δ [ST][BQ];
  // full[ST], empty[ST]
  const uint32_t sK = base, sV = base + KT, sQ = base + 2 * KT;
  const uint32_t sL = sQ + ST * 2 * QT, sD = sL + ST * BQ * 4;
  const uint32_t sFull = sD + ST * BQ * 4, sEmpty = sFull + ST * 8;
  const float* const Ls = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(smem4) + (sL - raw));
  const float* const Ds = Ls + ST * BQ;

  const int tid = threadIdx.x;
  const int G = a.H / a.KH;
  const int per_tile = a.hsplit * a.KH * a.B;
  const int tile = blockIdx.x / per_tile, rem = blockIdx.x % per_tile;
  const int split = rem % a.hsplit, kh = rem / a.hsplit % a.KH;
  const int b = rem / a.hsplit / a.KH;
  const int k0 = tile * BK;
  const int h_lo = kh * G + split * G / a.hsplit;
  const int h_hi = kh * G + (split + 1) * G / a.hsplit;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(sFull + 8 * s, 32);
      mbar_init(sEmpty + 8 * s, kBwdConsumers);
    }
    fence_mbar_init();
  }
  load_tile<Elt, HD, BK>(
      sK, static_cast<const Elt*>(a.k) + b * a.k_sb + kh * a.k_sh, a.k_st,
      k0, a.T, tid, kBwdThreads);
  load_tile<Elt, HD, BK>(
      sV, static_cast<const Elt*>(a.v) + b * a.v_sb + kh * a.v_sh, a.v_st,
      k0, a.T, tid, kBwdThreads);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();      // K, V landed; the barriers are set

  // the query tiles that see a key of this tile, per head of the range
  const int k_last = min(k0 + BK, a.T) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? min(a.S, k_last + a.window) : a.S;
  const int qt_first = q_begin / BQ * BQ;
  const int n_qt = q_end > qt_first ? (q_end - qt_first + BQ - 1) / BQ : 0;
  const int n_iter = (h_hi - h_lo) * n_qt;

  if (tid >= kBwdConsumers) {             // the producer warp
    const int lane = tid - kBwdConsumers;
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % ST;
      mbar_wait(sEmpty + 8 * st, (it / ST & 1) ^ 1);
      const int h = h_lo + it / n_qt, q0 = qt_first + it % n_qt * BQ;
      const uint32_t sq = sQ + st * 2 * QT;
      load_tile<Elt, HD, BQ>(
          sq, static_cast<const Elt*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
          q0, a.S, lane, 32);
      load_tile<Elt, HD, BQ>(
          sq + QT,
          static_cast<const Elt*>(a.dout) + b * a.do_sb + h * a.do_sh,
          a.do_ss, q0, a.S, lane, 32);
      const long long row0 = ((long long)b * a.H + h) * a.S;
      for (int r = lane; r < BQ; r += 32) {
        const bool ok = q0 + r < a.S;
        const long long x = ok ? row0 + q0 + r : 0;
        cp_async4(sL + (st * BQ + r) * 4, a.lse + x, ok ? 4 : 0);
        cp_async4(sD + (st * BQ + r) * 4, a.delta + x, ok ? 4 : 0);
      }
      cp_async_mbar_arrive(sFull + 8 * st);
    }
    cp_async_wait<0>();
    return;
  }

  // consumers: warp wq owns key rows 16wq .. 16wq + 15 of the tile
  const int lane = tid & 31, wq = tid >> 5, g = lane >> 2, c2 = 2 * (lane & 3);
  const int kr0 = k0 + wq * 16 + g, kr1 = kr0 + 8;   // this lane's keys
  const float sl2 = a.scale * kLog2e;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % ST;
    mbar_wait(sFull + 8 * st, it / ST & 1);
    fence_proxy_async();          // cp.async's writes, then wgmma's reads
    const int q0 = qt_first + it % n_qt * BQ;
    const uint32_t sq = sQ + st * 2 * QT, sg = sq + QT;
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int blk = kk / (COLS / 16), col = kk % (COLS / 16) * 32;
      ss_tile<Elt, BQ>(s, gmma_desc<RB>(sK + blk * BK * RB + col, 16),
                       gmma_desc<RB>(sq + blk * BQ * RB + col, 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int blk = kk / (COLS / 16), col = kk % (COLS / 16) * 32;
      ss_tile<Elt, BQ>(dp, gmma_desc<RB>(sV + blk * BK * RB + col, 16),
                       gmma_desc<RB>(sg + blk * BQ * RB + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait1();                // Sᵀ is in; dPᵀ may still run
    fence_regs(s);

    const bool partial = q0 + BQ > a.S || k0 + BK > a.T ||
                         (a.causal && q0 < k0 + BK - 1) ||
                         (a.window > 0 && q0 + BQ - 1 - k0 >= a.window);
    const float* ls = Ls + st * BQ;
    const float* ds = Ds + st * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + c2 + (e & 1);
        const bool ok = !partial || visible(a, q0 + qi, e < 2 ? kr0 : kr1);
        s[4 * j + e] =
            ok ? ex2(fmaf(s[4 * j + e], sl2, -ls[qi] * kLog2e)) : 0.f;
      }
    wgmma_wait0();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + c2 + (e & 1);
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ds[qi]);
      }
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      a_frag<Elt>(pa[kq], s, kq);
      a_frag<Elt>(sa[kq], dp, kq);
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq)   // query rows 16kq .. of dO, Q
      rs_hd<Elt, HD>(dv, pa[kq], gmma_desc<RB>(sg + kq * 16 * RB, BQ * RB));
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq)
      rs_hd<Elt, HD>(dk, sa[kq], gmma_desc<RB>(sq + kq * 16 * RB, BQ * RB));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
    fence_proxy_async();
    mbar_arrive(sEmpty + 8 * st);   // the stage is free to load again
  }

  if (a.hsplit == 1) {
    Elt* dkp = static_cast<Elt*>(a.dk) + b * a.dk_sb + kh * a.dk_sh;
    Elt* dvp = static_cast<Elt*>(a.dv) + b * a.dv_sb + kh * a.dv_sh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (kr0 < a.T) {
        *reinterpret_cast<uint32_t*>(dkp + (long long)kr0 * a.dk_st + 8 * n +
                                     c2) =
            Mma<Elt>::pack(dk[4 * n] * a.scale, dk[4 * n + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvp + (long long)kr0 * a.dv_st + 8 * n +
                                     c2) =
            Mma<Elt>::pack(dv[4 * n], dv[4 * n + 1]);
      }
      if (kr1 < a.T) {
        *reinterpret_cast<uint32_t*>(dkp + (long long)kr1 * a.dk_st + 8 * n +
                                     c2) =
            Mma<Elt>::pack(dk[4 * n + 2] * a.scale, dk[4 * n + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dvp + (long long)kr1 * a.dv_st + 8 * n +
                                     c2) =
            Mma<Elt>::pack(dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
  } else {
    // partials, f32 [2][hsplit][B][T][KH][HD]: dK's, then dV's
    const long long half = (long long)a.hsplit * a.B * a.T * a.KH * HD;
    float* pk = a.part + ((long long)split * a.B + b) * a.T * a.KH * HD +
                (long long)kh * HD + c2;
    float* pv = pk + half;
    const long long row = (long long)a.KH * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (kr0 < a.T) {
        *reinterpret_cast<float2*>(pk + kr0 * row + 8 * n) =
            make_float2(dk[4 * n], dk[4 * n + 1]);
        *reinterpret_cast<float2*>(pv + kr0 * row + 8 * n) =
            make_float2(dv[4 * n], dv[4 * n + 1]);
      }
      if (kr1 < a.T) {
        *reinterpret_cast<float2*>(pk + kr1 * row + 8 * n) =
            make_float2(dk[4 * n + 2], dk[4 * n + 3]);
        *reinterpret_cast<float2*>(pv + kr1 * row + 8 * n) =
            make_float2(dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
  }
}

// the dK/dV partials of the head ranges summed in range order, dK scaled,
// both rounded once and written; block `blk` of the sum, a float4 of dK
// or dV a thread
template <typename Elt, int HD>
__device__ __forceinline__ void flash_bwd_sum(const FlashBwdArgs& a,
                                              int blk) {
  const long long n4 = (long long)a.B * a.T * a.KH * HD / 4;
  const long long x = (long long)blk * kBwdThreads + threadIdx.x;
  if (x >= 2 * n4) return;
  const bool is_v = x >= n4;
  const long long y = is_v ? x - n4 : x;
  const float4* p = reinterpret_cast<const float4*>(a.part) +
                    (is_v ? a.hsplit * n4 : 0) + y;
  float4 acc = p[0];
  for (int s = 1; s < a.hsplit; ++s) {
    const float4 t = p[s * n4];
    acc.x += t.x;
    acc.y += t.y;
    acc.z += t.z;
    acc.w += t.w;
  }
  const float sc = is_v ? 1.f : a.scale;
  const int d = static_cast<int>(y % (HD / 4)) * 4;
  long long r = y / (HD / 4);
  const int kh = static_cast<int>(r % a.KH);
  r /= a.KH;
  const int t = static_cast<int>(r % a.T), b = static_cast<int>(r / a.T);
  Elt* dst = is_v ? static_cast<Elt*>(a.dv) + b * a.dv_sb +
                        (long long)t * a.dv_st + kh * a.dv_sh
                  : static_cast<Elt*>(a.dk) + b * a.dk_sb +
                        (long long)t * a.dk_st + kh * a.dk_sh;
  *reinterpret_cast<uint2*>(dst + d) =
      make_uint2(Mma<Elt>::pack(acc.x * sc, acc.y * sc),
                 Mma<Elt>::pack(acc.z * sc, acc.w * sc));
}

// 3. dQ on wgmma (and, past `nq` blocks, the partials' sum).  The first
// nq blocks issue the query tiles of every (b, h) in reverse order, so
// under a causal mask the longest tiles start first.  Up to hd 64 three
// blocks an SM hold their registers (at most 128 a thread) without
// spilling; at hd 128 two.
template <typename Elt, int HD>
__global__ void __launch_bounds__(kBwdThreads, HD <= 64 ? 3 : 2)
flash_bwd_dq_wgmma(const FlashBwdArgs a, int nq) {
  if (static_cast<int>(blockIdx.x) >= nq) {
    flash_bwd_sum<Elt, HD>(a, blockIdx.x - nq);
    return;
  }
  constexpr int BQ = kBwdTile, BK = kBwdTile, ST = dq_stages<HD>();
  constexpr int COLS = HD < 64 ? HD : 64, RB = COLS * 2;
  constexpr int TT = BK * HD * 2;                 // bytes of a tile
  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t base = (raw + 1023) & ~1023u;
  // Q, dO; stage st: K at sKV + 2 st TT, V TT after; full[ST], empty[ST]
  const uint32_t sQ = base, sG = base + TT, sKV = base + 2 * TT;
  const uint32_t sFull = sKV + ST * 2 * TT, sEmpty = sFull + ST * 8;

  const int tid = threadIdx.x;
  const int BH = a.B * a.H;
  const int idx = nq - 1 - blockIdx.x;           // longest tiles first
  const int q0 = idx / BH * BQ, b = idx % BH / a.H, h = idx % BH % a.H;
  const int kh = h / (a.H / a.KH);
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(sFull + 8 * s, 32);
      mbar_init(sEmpty + 8 * s, kBwdConsumers);
    }
    fence_mbar_init();
  }
  load_tile<Elt, HD, BQ>(
      sQ, static_cast<const Elt*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
      a.S, tid, kBwdThreads);
  load_tile<Elt, HD, BQ>(
      sG, static_cast<const Elt*>(a.dout) + b * a.do_sb + h * a.do_sh,
      a.do_ss, q0, a.S, tid, kBwdThreads);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();      // Q, dO landed; the barriers are set

  const int q_last = min(q0 + BQ, a.S) - 1;
  const int kv_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_first = kv_begin / BK * BK;
  const int n_iter = kv_end > k_first ? (kv_end - k_first + BK - 1) / BK : 0;

  if (tid >= kBwdConsumers) {             // the producer warp
    const int lane = tid - kBwdConsumers;
    const Elt* kp = static_cast<const Elt*>(a.k) + b * a.k_sb + kh * a.k_sh;
    const Elt* vp = static_cast<const Elt*>(a.v) + b * a.v_sb + kh * a.v_sh;
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % ST;
      mbar_wait(sEmpty + 8 * st, (it / ST & 1) ^ 1);
      const int k0 = k_first + it * BK;
      const uint32_t sk = sKV + st * 2 * TT;
      load_tile<Elt, HD, BK>(sk, kp, a.k_st, k0, a.T, lane, 32);
      load_tile<Elt, HD, BK>(sk + TT, vp, a.v_st, k0, a.T, lane, 32);
      cp_async_mbar_arrive(sFull + 8 * st);
    }
    cp_async_wait<0>();
    return;
  }

  // consumers: warp wq owns query rows 16wq .. 16wq + 15 of the tile
  const int lane = tid & 31, wq = tid >> 5, g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = q0 + wq * 16 + g, r1 = r0 + 8;   // this lane's rows
  const long long row0 = ((long long)b * a.H + h) * a.S;
  const float l0 = r0 < a.S ? a.lse[row0 + r0] * kLog2e : 0.f;
  const float l1 = r1 < a.S ? a.lse[row0 + r1] * kLog2e : 0.f;
  const float d0 = r0 < a.S ? a.delta[row0 + r0] : 0.f;
  const float d1 = r1 < a.S ? a.delta[row0 + r1] : 0.f;
  const float sl2 = a.scale * kLog2e;
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % ST;
    mbar_wait(sFull + 8 * st, it / ST & 1);
    fence_proxy_async();
    const int k0 = k_first + it * BK;
    const uint32_t sk = sKV + st * 2 * TT, sv = sk + TT;
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int blk = kk / (COLS / 16), col = kk % (COLS / 16) * 32;
      Wgmma<Elt>::ss64(s, gmma_desc<RB>(sQ + blk * BQ * RB + col, 16),
                       gmma_desc<RB>(sk + blk * BK * RB + col, 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int blk = kk / (COLS / 16), col = kk % (COLS / 16) * 32;
      Wgmma<Elt>::ss64(dp, gmma_desc<RB>(sG + blk * BQ * RB + col, 16),
                       gmma_desc<RB>(sv + blk * BK * RB + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait1();
    fence_regs(s);

    const bool partial = k0 + BK > a.T || (a.causal && k0 + BK - 1 > q0) ||
                         (a.window > 0 && q0 + BQ - 1 - k0 >= a.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + c2 + (e & 1);
        const bool ok = !partial || visible(a, e < 2 ? r0 : r1, kpos);
        s[4 * j + e] =
            ok ? ex2(fmaf(s[4 * j + e], sl2, -(e < 2 ? l0 : l1))) : 0.f;
      }
    wgmma_wait0();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] *= dp[4 * j + e] - (e < 2 ? d0 : d1);   // dS
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_frag<Elt>(sa[kk], s, kk);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // key rows 16kk .. of K
      rs_hd<Elt, HD>(dq, sa[kk], gmma_desc<RB>(sk + kk * 16 * RB, BK * RB));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq);
    fence_proxy_async();
    mbar_arrive(sEmpty + 8 * st);
  }

  Elt* dqp = static_cast<Elt*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < a.S)
      *reinterpret_cast<uint32_t*>(dqp + (long long)r0 * a.dq_ss + 8 * n +
                                   c2) =
          Mma<Elt>::pack(dq[4 * n] * a.scale, dq[4 * n + 1] * a.scale);
    if (r1 < a.S)
      *reinterpret_cast<uint32_t*>(dqp + (long long)r1 * a.dq_ss + 8 * n +
                                   c2) =
          Mma<Elt>::pack(dq[4 * n + 2] * a.scale, dq[4 * n + 3] * a.scale);
  }
}

// f32 on FMA.  Thread (ty, tx) of a 16 x 8 grid owns the block's rows
// 4ty..4ty+3 (keys for dK/dV, queries for dQ), score columns tx + 8j and
// output columns tx + 8e; the row operand of the score products is
// staged transposed ([HD][64]) for float4 reads, the column operand as
// [64][HD + 1] rows; Pᵀ / dSᵀ go through shared memory ([64][68]) for the
// output products.
constexpr int kBwdPS = 68;         // padded row of a staged P / dS tile

template <int HD>
constexpr int bwd_f32_smem_floats() {
  return 2 * HD * kBwdTile + 2 * kBwdTile * (HD + 1) +
         2 * kBwdTile * kBwdPS + 2 * kBwdTile;
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_f32(const FlashBwdArgs a) {
  constexpr int BK = kBwdTile, BQ = kBwdTile, NO = HD / 8, LDR = HD + 1;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [HD][BK]
  float* Vt = Kt + HD * BK;                     // [HD][BK]
  float* Qs = Vt + HD * BK;                     // [BQ][LDR]
  float* Gs = Qs + BQ * LDR;                    // [BQ][LDR] (dO)
  float* Pt = Gs + BQ * LDR;                    // [BQ][kBwdPS]: Pᵀ
  float* St = Pt + BQ * kBwdPS;                 // [BQ][kBwdPS]: dSᵀ
  float* Ls = St + BQ * kBwdPS;                 // [BQ]
  float* Ds = Ls + BQ;                          // [BQ]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  for (int i = tid; i < BK * HD; i += 128) {
    const int r = i / HD, d = i % HD, t = k0 + r;
    Kt[d * BK + r] = t < a.T ? kp[(long long)t * a.k_st + d] : 0.f;
    Vt[d * BK + r] = t < a.T ? vp[(long long)t * a.v_st + d] : 0.f;
  }

  const int k_last = min(k0 + BK, a.T) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? min(a.S, k_last + a.window) : a.S;
  const int qt_first = q_begin / BQ * BQ;
  float dk[4][NO], dv[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NO; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* gp =
        static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long row0 = ((long long)b * a.H + h) * a.S;
    for (int q0 = qt_first; q0 < q_end; q0 += BQ) {
      __syncthreads();             // the previous tile's reads are done
      for (int i = tid; i < BQ * HD; i += 128) {
        const int r = i / HD, d = i % HD, s = q0 + r;
        Qs[r * LDR + d] = s < a.S ? qp[(long long)s * a.q_ss + d] : 0.f;
        Gs[r * LDR + d] = s < a.S ? gp[(long long)s * a.do_ss + d] : 0.f;
      }
      for (int r = tid; r < BQ; r += 128) {
        const int s = q0 + r;
        Ls[r] = s < a.S ? a.lse[row0 + s] : 0.f;
        Ds[r] = s < a.S ? a.delta[row0 + s] : 0.f;
      }
      __syncthreads();

      float st[4][8], dpt[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float4 kv = *reinterpret_cast<const float4*>(Kt + d * BK +
                                                           ty * 4);
        const float4 vv = *reinterpret_cast<const float4*>(Vt + d * BK +
                                                           ty * 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float qx = Qs[(tx + 8 * j) * LDR + d];
          const float gx = Gs[(tx + 8 * j) * LDR + d];
          st[0][j] = fmaf(kv.x, qx, st[0][j]);
          st[1][j] = fmaf(kv.y, qx, st[1][j]);
          st[2][j] = fmaf(kv.z, qx, st[2][j]);
          st[3][j] = fmaf(kv.w, qx, st[3][j]);
          dpt[0][j] = fmaf(vv.x, gx, dpt[0][j]);
          dpt[1][j] = fmaf(vv.y, gx, dpt[1][j]);
          dpt[2][j] = fmaf(vv.z, gx, dpt[2][j]);
          dpt[3][j] = fmaf(vv.w, gx, dpt[3][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = tx + 8 * j;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = visible(a, q0 + qi, k0 + ty * 4 + i);
          p[i] = ok ? expf(st[i][j] * a.scale - Ls[qi]) : 0.f;
          ds[i] = p[i] * (dpt[i][j] - Ds[qi]);
        }
        *reinterpret_cast<float4*>(Pt + qi * kBwdPS + ty * 4) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(St + qi * kBwdPS + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(Pt + c * kBwdPS +
                                                           ty * 4);
        const float4 sv = *reinterpret_cast<const float4*>(St + c * kBwdPS +
                                                           ty * 4);
#pragma unroll
        for (int e = 0; e < NO; ++e) {
          const float gx = Gs[c * LDR + tx + 8 * e];
          const float qx = Qs[c * LDR + tx + 8 * e];
          dv[0][e] = fmaf(pv.x, gx, dv[0][e]);
          dv[1][e] = fmaf(pv.y, gx, dv[1][e]);
          dv[2][e] = fmaf(pv.z, gx, dv[2][e]);
          dv[3][e] = fmaf(pv.w, gx, dv[3][e]);
          dk[0][e] = fmaf(sv.x, qx, dk[0][e]);
          dk[1][e] = fmaf(sv.y, qx, dk[1][e]);
          dk[2][e] = fmaf(sv.z, qx, dk[2][e]);
          dk[3][e] = fmaf(sv.w, qx, dk[3][e]);
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk) + b * a.dk_sb + kh * a.dk_sh;
  float* dvp = static_cast<float*>(a.dv) + b * a.dv_sb + kh * a.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= a.T) continue;
#pragma unroll
    for (int e = 0; e < NO; ++e) {
      dkp[(long long)t * a.dk_st + tx + 8 * e] = dk[i][e] * a.scale;
      dvp[(long long)t * a.dv_st + tx + 8 * e] = dv[i][e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_bwd_dq_f32(const FlashBwdArgs a) {
  constexpr int BK = kBwdTile, BQ = kBwdTile, NO = HD / 8, LDR = HD + 1;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][BQ]
  float* Gt = Qt + HD * BQ;                     // [HD][BQ] (dO)
  float* Ks = Gt + HD * BQ;                     // [BK][LDR]
  float* Vs = Ks + BK * LDR;                    // [BK][LDR]
  float* St = Vs + BK * LDR;                    // [BK][kBwdPS]: dSᵀ

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y;
  const int b = blockIdx.z, kh = h / (a.H / a.KH);
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* gp =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  for (int i = tid; i < BQ * HD; i += 128) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qt[d * BQ + r] = s < a.S ? qp[(long long)s * a.q_ss + d] : 0.f;
    Gt[d * BQ + r] = s < a.S ? gp[(long long)s * a.do_ss + d] : 0.f;
  }
  const long long row0 = ((long long)b * a.H + h) * a.S;
  float lse[4], del[4], dq[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    lse[i] = s < a.S ? a.lse[row0 + s] : 0.f;
    del[i] = s < a.S ? a.delta[row0 + s] : 0.f;
#pragma unroll
    for (int e = 0; e < NO; ++e) dq[i][e] = 0.f;
  }

  const int q_last = min(q0 + BQ, a.S) - 1;
  const int kv_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = kv_begin / BK * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();               // the previous tile's reads are done
    for (int i = tid; i < BK * HD; i += 128) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      Ks[r * LDR + d] = t < a.T ? kp[(long long)t * a.k_st + d] : 0.f;
      Vs[r * LDR + d] = t < a.T ? vp[(long long)t * a.v_st + d] : 0.f;
    }
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * BQ +
                                                         ty * 4);
      const float4 gv = *reinterpret_cast<const float4*>(Gt + d * BQ +
                                                         ty * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kx = Ks[(tx + 8 * j) * LDR + d];
        const float vx = Vs[(tx + 8 * j) * LDR + d];
        s[0][j] = fmaf(qv.x, kx, s[0][j]);
        s[1][j] = fmaf(qv.y, kx, s[1][j]);
        s[2][j] = fmaf(qv.z, kx, s[2][j]);
        s[3][j] = fmaf(qv.w, kx, s[3][j]);
        dp[0][j] = fmaf(gv.x, vx, dp[0][j]);
        dp[1][j] = fmaf(gv.y, vx, dp[1][j]);
        dp[2][j] = fmaf(gv.z, vx, dp[2][j]);
        dp[3][j] = fmaf(gv.w, vx, dp[3][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = tx + 8 * j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = visible(a, q0 + ty * 4 + i, k0 + kj);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        ds[i] = p * (dp[i][j] - del[i]);
      }
      *reinterpret_cast<float4*>(St + kj * kBwdPS + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 sv = *reinterpret_cast<const float4*>(St + c * kBwdPS +
                                                         ty * 4);
#pragma unroll
      for (int e = 0; e < NO; ++e) {
        const float kx = Ks[c * LDR + tx + 8 * e];
        dq[0][e] = fmaf(sv.x, kx, dq[0][e]);
        dq[1][e] = fmaf(sv.y, kx, dq[1][e]);
        dq[2][e] = fmaf(sv.z, kx, dq[2][e]);
        dq[3][e] = fmaf(sv.w, kx, dq[3][e]);
      }
    }
  }

  float* dqp = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= a.S) continue;
#pragma unroll
    for (int e = 0; e < NO; ++e)
      dqp[(long long)s * a.dq_ss + tx + 8 * e] = dq[i][e] * a.scale;
  }
}

template <typename K>
int set_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

// the blocks of the three launches (δ, dK/dV, dQ with the partials' sum
// after it) for a.hsplit head ranges, as the wrapper's plan gives them
void bwd_grids(const FlashBwdArgs& a, int hd, bool f32, long long (&g)[3]) {
  const long long n_kt = (a.T + kBwdTile - 1) / kBwdTile;
  const long long n_qt = (a.S + kBwdTile - 1) / kBwdTile;
  g[0] = ((long long)a.B * a.H * a.S + 7) / 8;
  g[1] = n_kt * a.hsplit * a.KH * a.B;
  g[2] = n_qt * a.H * a.B;
  if (!f32 && a.hsplit > 1)
    g[2] += (2LL * a.B * a.T * a.KH * hd / 4 + kBwdThreads - 1) /
            kBwdThreads;
}

// the three launches, in order; Elt float takes the FMA kernels
template <typename Elt, int HD>
int launch_flash_bwd(const FlashBwdArgs& a, const long long (&g)[3],
                     cudaStream_t stream) {
  flash_bwd_delta_kernel<Elt, HD>
      <<<static_cast<unsigned>(g[0]), 256, 0, stream>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  static bool dkdv_set = false, dq_set = false;
  if constexpr (sizeof(Elt) == 4) {
    const dim3 gk((a.T + kBwdTile - 1) / kBwdTile, a.KH, a.B);
    const dim3 gq((a.S + kBwdTile - 1) / kBwdTile, a.H, a.B);
    constexpr int bytes = bwd_f32_smem_floats<HD>() * 4;
    if ((err = set_smem(flash_bwd_dkdv_f32<HD>, bytes, dkdv_set))) return err;
    if ((err = set_smem(flash_bwd_dq_f32<HD>, bytes, dq_set))) return err;
    flash_bwd_dkdv_f32<HD><<<gk, 128, bytes, stream>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    flash_bwd_dq_f32<HD><<<gq, 128, bytes, stream>>>(a);
  } else {
    constexpr int bk = dkdv_smem_bytes<HD>(), bq = dq_smem_bytes<HD>();
    if ((err = set_smem(flash_bwd_dkdv_wgmma<Elt, HD>, bk, dkdv_set)))
      return err;
    if ((err = set_smem(flash_bwd_dq_wgmma<Elt, HD>, bq, dq_set))) return err;
    flash_bwd_dkdv_wgmma<Elt, HD>
        <<<static_cast<unsigned>(g[1]), kBwdThreads, bk, stream>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    const int nq = (a.S + kBwdTile - 1) / kBwdTile * a.H * a.B;
    flash_bwd_dq_wgmma<Elt, HD>
        <<<static_cast<unsigned>(g[2]), kBwdThreads, bq, stream>>>(a, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Elt>
int flash_bwd_hd(const FlashBwdArgs& a, int hd, const long long (&g)[3],
                 cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_flash_bwd<Elt, 32>(a, g, stream);
    case 64: return launch_flash_bwd<Elt, 64>(a, g, stream);
    case 128: return launch_flash_bwd<Elt, 128>(a, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ----------------------------------------------------------------- decode
constexpr int kMaxSplit = 8;       // blocks per cluster (portable at most 8)

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh;            // element strides over (b, h)
  long long k_sb, k_st, k_sh;      // over (b, t, kv-head)
  long long v_sb, v_st, v_sh;
  long long o_sb, o_sh;
  int H, KH;
  int bounds[kMaxSplit + 1];       // rank r: slots [bounds[r], bounds[r+1])
  float scale;
};

// The block's share of the cache, [lo, hi): its rank's range as the
// wrapper cut it (`split_ranges`)
template <int NSPLIT>
__device__ __forceinline__ int2 split_range(const DecodeArgs& a) {
  const int r = blockIdx.x % NSPLIT;   // == the block's rank in its cluster
  return make_int2(a.bounds[r], a.bounds[r + 1]);
}

// Writes O rows h0 .. h0 + ng - 1 from the blocks' softmax states: each
// block's running max m[g], denominator l[g] and unnormalised acc[g][d]
// (rows of HD), in its shared memory.  With one split the block's own;
// else rank 0 of the cluster reads every rank's through distributed
// shared memory and merges them in rank order (an empty range has
// m = -inf and adds nothing), and a second cluster.sync() keeps the other
// blocks' shared memory alive until it has.
template <typename Elt, int HD, int NSPLIT, int NTHREADS>
__device__ __forceinline__ void merge_store(const DecodeArgs& a,
                                            float* blk_m, float* blk_l,
                                            float* blk_acc, int ng, int h0) {
  Elt* op = static_cast<Elt*>(a.o) + blockIdx.z * a.o_sb;
  if constexpr (NSPLIT == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < ng * HD; i += NTHREADS) {
      const int g = i / HD;
      op[(h0 + g) * a.o_sh + i % HD] =
          from_f<Elt>(blk_acc[i] / fmaxf(blk_l[g], 1e-30f));
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      const float* rm[NSPLIT];
      const float* rl[NSPLIT];
      const float* ra[NSPLIT];
#pragma unroll
      for (int r = 0; r < NSPLIT; ++r) {
        rm[r] = cluster.map_shared_rank(blk_m, r);
        rl[r] = cluster.map_shared_rank(blk_l, r);
        ra[r] = cluster.map_shared_rank(blk_acc, r);
      }
      for (int i = threadIdx.x; i < ng * HD; i += NTHREADS) {
        const int g = i / HD;
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < NSPLIT; ++r) mx = fmaxf(mx, rm[r][g]);
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int r = 0; r < NSPLIT; ++r) {
          if (rm[r][g] == -INFINITY) continue;
          const float c = expf(rm[r][g] - mx);
          den = fmaf(rl[r][g], c, den);
          num = fmaf(ra[r][i], c, num);
        }
        op[(h0 + g) * a.o_sh + i % HD] =
            from_f<Elt>(num / fmaxf(den, 1e-30f));
      }
    }
    cluster.sync();
  }
}

// Merges NW per-warp softmax states (wm, wl [NW][NGP], wa [NW][NGP][HD]
// in shared memory) into the block's (blk_m, blk_l, blk_acc): one thread
// per (query row, output column) of the ng rows.
template <int HD, int NW, int NGP, int NTHREADS>
__device__ __forceinline__ void merge_warps(const float* wm, const float* wl,
                                            const float* wa, float* blk_m,
                                            float* blk_l, float* blk_acc,
                                            int ng) {
  for (int i = threadIdx.x; i < ng * HD; i += NTHREADS) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * NGP + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (wm[w * NGP + g] == -INFINITY) continue;
      const float c = expf(wm[w * NGP + g] - mx);
      den = fmaf(wl[w * NGP + g], c, den);
      num = fmaf(wa[(w * NGP + g) * HD + d], c, num);
    }
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = den;
    }
    blk_acc[i] = num;
  }
}

// bf16 / f16: the group's query rows (at most 16, zero rows past G) are
// the A operand of mma.sync m16n8k16; the block's range is cut into
// 16-row tiles dealt to its 4 warps in turn, each warp with its own
// two-stage cp.async ring of K and V tiles (only __syncwarp between its
// stages).  S = Q·Kᵀ and O += P·V (K through ldmatrix, V through
// ldmatrix.trans, P from S's accumulators as they lie), the online
// softmax as in flash_kernel_wgmma; the
// warps' states merge through shared memory (reusing the ring), then the
// cluster's.
constexpr int kDecMmaWarps = 4;
constexpr int kDecTK = 16;         // cache rows per warp tile

template <int HD>
constexpr int decode_mma_smem_bytes() {
  constexpr int LD = HD + 8;
  constexpr int ring = (16 + kDecMmaWarps * 4 * kDecTK) * LD * 2;
  constexpr int merge = ((kDecMmaWarps + 1) * 16 * (HD + 2)) * 4;
  return ring > merge ? ring : merge;
}

template <typename Elt, int HD, int NSPLIT>
__global__ void __launch_bounds__(kDecMmaWarps * 32)
decode_kernel_mma(const DecodeArgs a) {
  constexpr int LD = HD + 8, CH = HD / 8, NW = kDecMmaWarps, NT = NW * 32;
  extern __shared__ float4 smem4[];
  Elt* Qs = reinterpret_cast<Elt*>(smem4);   // [16][LD]
  Elt* ring = Qs + 16 * LD;          // [NW][2 stages][K, V][kDecTK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kh = blockIdx.y, g0 = blockIdx.x / NSPLIT * 16;
  const int G = a.H / a.KH, ng = min(16, G - g0), h0 = kh * G + g0;
  const int2 range = split_range<NSPLIT>(a);

  const Elt* kp = static_cast<const Elt*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const Elt* vp = static_cast<const Elt*>(a.v) + b * a.v_sb + kh * a.v_sh;
  Elt* wring = ring + warp * 4 * kDecTK * LD;
  // each cache row is read once per call: keep it from pushing data that
  // is read again out of L2
  const uint64_t policy = l2_evict_first();
  auto load = [&](int t0, int stage) {
    Elt* kd = wring + stage * 2 * kDecTK * LD;
    Elt* vd = kd + kDecTK * LD;
    for (int i = lane; i < kDecTK * CH; i += 32) {
      const int r = i / CH, c = i % CH, t = t0 + r;
      const long long tt = min(t, range.y - 1);
      const int n = t < range.y ? 16 : 0;
      cp_async16_hint(smem_u32(kd + r * LD + c * 8), kp + tt * a.k_st + c * 8,
                      n, policy);
      cp_async16_hint(smem_u32(vd + r * LD + c * 8), vp + tt * a.v_st + c * 8,
                      n, policy);
    }
  };
  const int first = range.x + warp * kDecTK, stride = NW * kDecTK;
  if (first < range.y) load(first, 0);
  cp_async_commit();
  // q rows may lie off 16 bytes (a sliced head axis): scalar loads, after
  // the cache's first tiles are in flight
  const Elt* qp = static_cast<const Elt*>(a.q) + b * a.q_sb;
  for (int i = tid; i < 16 * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    Qs[g * LD + d] = g < ng ? qp[(h0 + g) * a.q_sh + d] : from_f<Elt>(0.f);
  }
  __syncthreads();                 // Q is in shared memory
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qf[kk], smem_u32(Qs + (lane & 15) * LD + kk * 16 +
                             (lane >> 4) * 8));

  const float sl2 = a.scale * 1.4426950408889634f;  // scale · log2 e
  const int c2 = 2 * (lane & 3);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int stage = 0;
  for (int t0 = first; t0 < range.y; t0 += stride, stage ^= 1) {
    if (t0 + stride < range.y) load(t0 + stride, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();            // this tile has landed
    __syncwarp();
    const Elt* kt = wring + stage * 2 * kDecTK * LD;
    const Elt* vt = kt + kDecTK * LD;

    float s[kDecTK / 8][4];
#pragma unroll
    for (int j = 0; j < kDecTK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; kk += 2)
#pragma unroll
      for (int j = 0; j < kDecTK / 8; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(kt + (8 * j + (lane & 7)) * LD + kk * 16 +
                             (lane >> 3) * 8));
        Mma<Elt>::run(s[j], qf[kk], kb[0], kb[1]);
        Mma<Elt>::run(s[j], qf[kk + 1], kb[2], kb[3]);
      }
    if (t0 + kDecTK > range.y) {   // the range's ragged end
#pragma unroll
      for (int j = 0; j < kDecTK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + 8 * j + c2 + (e & 1) >= range.y) s[j][e] = -INFINITY;
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kDecTK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float base0 = mx0 * sl2, base1 = mx1 * sl2;  // a tile has a key
    const float corr0 = ex2(m0 * sl2 - base0);
    const float corr1 = ex2(m1 * sl2 - base1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kDecTK / 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], sl2, -base0));
      s[j][1] = ex2(fmaf(s[j][1], sl2, -base0));
      s[j][2] = ex2(fmaf(s[j][2], sl2, -base1));
      s[j][3] = ex2(fmaf(s[j][3], sl2, -base1));
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < kDecTK / 16; ++kk) {
      const uint32_t pa[4] = {Mma<Elt>::pack(s[2 * kk][0], s[2 * kk][1]),
                              Mma<Elt>::pack(s[2 * kk][2], s[2 * kk][3]),
                              Mma<Elt>::pack(s[2 * kk + 1][0],
                                             s[2 * kk + 1][1]),
                              Mma<Elt>::pack(s[2 * kk + 1][2],
                                             s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_u32(vt + (16 * kk + (lane & 15)) * LD + 16 * n +
                               (lane >> 4) * 8));
        Mma<Elt>::run(o[2 * n], pa, vb[0], vb[1]);
        Mma<Elt>::run(o[2 * n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();                  // every lane is done with this stage
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);

  // the warps' states, then the block's, over the ring
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem4);     // [NW][16]
  float* wl = wm + NW * 16;                        // [NW][16]
  float* wa = wl + NW * 16;                        // [NW][16][HD]
  float* blk_m = wa + NW * 16 * HD;                // [16]
  float* blk_l = blk_m + 16;                       // [16]
  float* blk_acc = blk_l + 16;                     // [16][HD]
  const int g = lane >> 2;
  if ((lane & 3) == 0) {           // the max in the units of l's exponents
    wm[warp * 16 + g] = m0 * a.scale;
    wm[warp * 16 + g + 8] = m1 * a.scale;
    wl[warp * 16 + g] = l0;
    wl[warp * 16 + g + 8] = l1;
  }
  float* wo = wa + warp * 16 * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(wo + g * HD + 8 * n + c2) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(wo + (g + 8) * HD + 8 * n + c2) =
        make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  merge_warps<HD, NW, 16, NT>(wm, wl, wa, blk_m, blk_l, blk_acc, ng);
  merge_store<Elt, HD, NSPLIT, NT>(a, blk_m, blk_l, blk_acc, ng, h0);
}

// f32: the cache streamed through registers with f32 FMA (the on-card f32
// checks hold decode to 2e-5).  A block holds NG of the head's G query
// rows (1, 2, 4 or 8, the least that covers G); a cache row is read by
// LPR = hd/4 lanes, 16 bytes each, 4 rows per lane group per step; each
// lane group keeps its own online-softmax state, merged with shuffles,
// the 8 warps through shared memory.
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxG = 8;           // most query rows (of one kv-head) per block
constexpr int kUnroll = 4;         // cache rows per lane group per step

template <int HD, int NG>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const DecodeArgs a) {
  constexpr int EPL = 4;                 // floats per 16-byte load
  constexpr int LPR = HD / EPL;          // lanes per cache row
  constexpr int GPW = 32 / LPR;          // rows a warp reads at once
  constexpr int NS = kDecWarps * GPW;    // lane groups (streams) per block
  static_assert(LPR >= 1 && LPR <= 32, "row must fit one warp");
  __shared__ float sm_m[kDecWarps][NG];
  __shared__ float sm_l[kDecWarps][NG];
  __shared__ float sm_acc[kDecWarps][NG][HD];
  __shared__ float blk_m[NG], blk_l[NG], blk_acc[NG][HD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, d0 = (lane % LPR) * EPL;
  const int b = blockIdx.z, kh = blockIdx.y, g0 = blockIdx.x * NG;
  const int G = a.H / a.KH, ng = min(NG, G - g0);
  const int h0 = kh * G + g0;
  const int2 range = split_range<1>(a);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb;
  float q[NG][EPL];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      q[g][e] = g < ng ? qp[(h0 + g) * a.q_sh + d0 + e] * a.scale : 0.f;

  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb +
                    kh * a.k_sh + d0;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb +
                    kh * a.v_sh + d0;
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
  for (int base = range.x + warp * GPW * kUnroll; base < range.y;
       base += NS * kUnroll) {
    const int t0 = base + grp * kUnroll;
    float4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < range.y) {
        kr[u] = __ldg(reinterpret_cast<const float4*>(kp + t * a.k_st));
        vr[u] = __ldg(reinterpret_cast<const float4*>(vp + t * a.v_st));
      } else {
        kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float s[kUnroll][NG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float kx[EPL] = {kr[u].x, kr[u].y, kr[u].z, kr[u].w};
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
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t0 + u < range.y) mx = fmaxf(mx, s[u][g]);
      if (mx == -INFINITY) continue;      // this group has no row here
      const float corr = expf(m[g] - mx);
      float p[kUnroll], ps = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = t0 + u < range.y ? expf(s[u][g] - mx) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * corr + ps;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float vx[EPL] = {vr[u].x, vr[u].y, vr[u].z, vr[u].w};
          x = fmaf(p[u], vx[e], x);
        }
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
  merge_warps<HD, kDecWarps, NG, kDecThreads>(&sm_m[0][0], &sm_l[0][0],
                                              &sm_acc[0][0][0], blk_m, blk_l,
                                              &blk_acc[0][0], ng);
  merge_store<float, HD, 1, kDecThreads>(a, blk_m, blk_l, &blk_acc[0][0],
                                         ng, h0);
}

// one launch: clusters of NSPLIT blocks along x when NSPLIT > 1
template <typename Kernel>
int launch_clustered(Kernel kernel, dim3 grid, int threads, int smem,
                     int nsplit, const DecodeArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elt, int HD, int NSPLIT>
int launch_decode_mma(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = decode_mma_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel_mma<Elt, HD, NSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int G = a.H / a.KH;
  return launch_clustered(decode_kernel_mma<Elt, HD, NSPLIT>,
                          dim3((G + 15) / 16 * NSPLIT, a.KH, B),
                          kDecMmaWarps * 32, bytes, NSPLIT, a, stream);
}

// bf16 / f16: 16 query rows a block, n_split blocks a cluster
template <typename Elt, int HD>
int decode_mma(const DecodeArgs& a, int B, int n_split, int ng,
               cudaStream_t stream) {
  if (ng != 16) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_split) {
    case 1: return launch_decode_mma<Elt, HD, 1>(a, B, stream);
    case 2: return launch_decode_mma<Elt, HD, 2>(a, B, stream);
    case 4: return launch_decode_mma<Elt, HD, 4>(a, B, stream);
    case 8: return launch_decode_mma<Elt, HD, 8>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD, int NG>
int launch_decode(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KH;
  decode_kernel<HD, NG>
      <<<dim3((G + NG - 1) / NG, a.KH, B), kDecThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// f32: ng (1, 2, 4 or kMaxG) query rows a block, no split
template <int HD>
int decode_f32(const DecodeArgs& a, int B, int n_split, int ng,
               cudaStream_t stream) {
  if (n_split != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (ng) {
    case 1: return launch_decode<HD, 1>(a, B, stream);
    case 2: return launch_decode<HD, 2>(a, B, stream);
    case 4: return launch_decode<HD, 4>(a, B, stream);
    case kMaxG: return launch_decode<HD, kMaxG>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype 0 = f32 (FMA), 1 = bf16, 2 = f16 (tensor cores)
template <int HD>
int decode_dtype(const DecodeArgs& a, int B, int dtype, int n_split, int ng,
                 cudaStream_t stream) {
  switch (dtype) {
    case 0: return decode_f32<HD>(a, B, n_split, ng, stream);
    case 1: return decode_mma<__nv_bfloat16, HD>(a, B, n_split, ng, stream);
    case 2: return decode_mma<__half, HD>(a, B, n_split, ng, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ------------------------------------------------------------ C entry points
// Each launches on `stream` and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a head dim, dtype code, split or row count
// it does not take.  dtype: 0 = f32, 1 = bf16, 2 = f16.  The wrappers
// check shapes, devices, strides and alignment, and never call with an
// empty output.

// strides: q (b, s, h), k (b, t, h), v (b, t, h), o (b, s, h); 12 values.
// lse: null, or f32 [batch, heads, s_len] that receives each query row's
// log-sum-exp of its scaled scores (-inf for a row that sees no key).
// *route: the kernel launched, 0 = flash_kernel (f32 FMA), 1 =
// flash_kernel_wgmma.
extern "C" int fa_flash(const void* q, const void* k, const void* v, void* o,
                        float* lse, const long long* strides, int batch,
                        int heads, int kv_heads, int s_len, int t_len,
                        int hd, int dtype, int causal, int window,
                        float scale, int* route, void* stream) {
  const FlashArgs a{q, k, v, o,
                    strides[0], strides[1], strides[2],
                    strides[3], strides[4], strides[5],
                    strides[6], strides[7], strides[8],
                    strides[9], strides[10], strides[11],
                    heads, kv_heads, s_len, t_len, causal, window, scale,
                    lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *route = dtype == 0 ? 0 : 1;
  switch (dtype) {
    case 0: return flash_f32_hd(a, batch, hd, st);
    case 1: return flash_tc_hd<__nv_bfloat16>(a, batch, hd, st);
    case 2: return flash_tc_hd<__half>(a, batch, hd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q (b, s, h), k (b, t, h), v (b, t, h), o (b, s, h), dout
// (b, s, h), dq (b, s, h), dk (b, t, h), dv (b, t, h); 24 values.  lse:
// the forward's f32 [batch, heads, s_len]; delta: f32 scratch of the same
// shape; part: with hsplit > 1, f32 scratch [2][hsplit][batch][t_len]
// [kv_heads][hd] (else unread).  hsplit: the contiguous ranges the query
// heads of a KV head are cut into for dK/dV, 1 <= hsplit <= heads /
// kv_heads (1 for f32).  grid: the blocks of the three launches (delta,
// dK/dV, dQ with the partials' sum after its blocks); block: the threads
// of the dK/dV and dQ blocks (160 on the tensor cores, 128 for f32).  A
// launch shape other than the plan's for hsplit is refused
// (cudaErrorInvalidConfiguration).  dq, dk, dv in q's dtype.
extern "C" int fa_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, float* part,
                            const long long* st, int batch, int heads,
                            int kv_heads, int s_len, int t_len, int hd,
                            int dtype, int causal, int window, float scale,
                            int hsplit, const long long* grid, int block,
                            void* stream) {
  const FlashBwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                       st[0], st[1], st[2], st[3], st[4], st[5],
                       st[6], st[7], st[8], st[9], st[10], st[11],
                       st[12], st[13], st[14], st[15], st[16], st[17],
                       st[18], st[19], st[20], st[21], st[22], st[23],
                       batch, heads, kv_heads, s_len, t_len, causal, window,
                       scale, hsplit};
  if (dtype < 0 || dtype > 2 || (hd != 32 && hd != 64 && hd != 128) ||
      kv_heads < 1 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == 0;
  long long want[3];
  bwd_grids(a, hd, f32, want);
  if (hsplit < 1 || hsplit > heads / kv_heads || (f32 && hsplit != 1) ||
      block != (f32 ? 128 : kBwdThreads) || grid[0] != want[0] ||
      grid[1] != want[1] || grid[2] != want[2])
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return flash_bwd_hd<float>(a, hd, want, s);
    case 1: return flash_bwd_hd<__nv_bfloat16>(a, hd, want, s);
    default: return flash_bwd_hd<__half>(a, hd, want, s);
  }
}

// strides: q (b, h), k (b, t, h), v (b, t, h), o (b, h); 10 values.
// n_split: 1, 2, 4 or 8 blocks (one cluster) per group of query rows, rank
// r reading cache slots [bounds[r], bounds[r + 1]) (n_split + 1 values);
// ng: query rows a block (16 for bf16 / f16; 1, 2, 4 or 8 for f32, which
// takes n_split 1 only).
extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         void* o, const long long* strides,
                         const int* bounds, int batch, int heads,
                         int kv_heads, int hd, int dtype, float scale,
                         int n_split, int ng, void* stream) {
  if (n_split < 1 || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, k, v, o,
               strides[0], strides[1],
               strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7],
               strides[8], strides[9],
               heads, kv_heads, {}, scale};
  for (int r = 0; r <= n_split; ++r) a.bounds[r] = bounds[r];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return decode_dtype<32>(a, batch, dtype, n_split, ng, st);
    case 64: return decode_dtype<64>(a, batch, dtype, n_split, ng, st);
    case 128: return decode_dtype<128>(a, batch, dtype, n_split, ng, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
