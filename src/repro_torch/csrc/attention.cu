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
// *route: the kernel launched, 0 = flash_kernel (f32 FMA), 1 =
// flash_kernel_wgmma.
extern "C" int fa_flash(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int batch, int heads,
                        int kv_heads, int s_len, int t_len, int hd,
                        int dtype, int causal, int window, float scale,
                        int* route, void* stream) {
  const FlashArgs a{q, k, v, o,
                    strides[0], strides[1], strides[2],
                    strides[3], strides[4], strides[5],
                    strides[6], strides[7], strides[8],
                    strides[9], strides[10], strides[11],
                    heads, kv_heads, s_len, t_len, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *route = dtype == 0 ? 0 : 1;
  switch (dtype) {
    case 0: return flash_f32_hd(a, batch, hd, st);
    case 1: return flash_tc_hd<__nv_bfloat16>(a, batch, hd, st);
    case 2: return flash_tc_hd<__half>(a, batch, hd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
