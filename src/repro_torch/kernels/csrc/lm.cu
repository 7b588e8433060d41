// LM-lane kernels for Hopper (sm_90a): rmsnorm, flash attention and the
// Mamba2 SSD chunk scan, each with a plain C interface loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// They replace the Pallas TPU kernels of the JAX package:
//   repro_rmsnorm          <- repro/kernels/rmsnorm.py          _rmsnorm_kernel
//   repro_flash_attention  <- repro/kernels/flash_attention.py  _fa_kernel
//                             (its Hopper route: flash_hopper.cu)
//   repro_ssd_chunk_scan   <- repro/kernels/ssd.py              _ssd_kernel
// and two replace no TPU kernel, gradients the JAX package leaves to
// autodiff: repro_rmsnorm_backward (two kernels), rmsnorm's, and
// repro_flash_attention_backward (three kernels: D, dK / dV, dQ; its
// Hopper route for 16-bit d 128 and 256: flash_hopper_bwd.cu), flash
// attention's,
// from the lse that repro_flash_attention writes.
//
// Arithmetic.  rmsnorm (both ways) computes in float32 on the CUDA cores,
// from and to float32, bfloat16 or float16 tensors.  Flash attention, both
// ways (float32 inputs), and the SSD scan (float32 math from float32,
// bfloat16 or float16 inputs) run every matrix product on the tensor cores
// with the 3xTF32 split (mma.sync m16n8k8 on tf32 operands): each
// float32 operand x becomes big = tf32(x) and small = tf32(x - big)
// (cvt.rna), and a.b is summed as a_small.b_big + a_big.b_small +
// a_big.b_big into float32 accumulators.  The dropped a_small.b_small is
// ~2^-22 of each product, so the results keep float32 accuracy (the port
// holds the card to the CPU's float32 results at unchanged tolerances) at a
// third of the TF32 rate, 495 / 3 = 165 TFLOP/s against 67 on the CUDA
// cores.  Flash attention on bfloat16 / float16 inputs multiplies the 16-bit
// values as they are (mma.sync m16n8k16, float32 accumulators: a product of
// two 16-bit values is exact in float32), and splits the float32
// probabilities p into hi = T(p) and lo = T(p - hi) for p.v (see the
// kernel), and its backward splits p and dS the same way.  Their tiles are
// staged in shared memory with cp.async, double-buffered where a loop walks
// them.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  Built without --use_fast_math: expf / rsqrtf keep their IEEE-ish
// accuracy, which the tolerances against the plain versions rely on.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// reductions across the 4 lanes of an mma quad (lanes differ in bits 0-1),
// which hold the same rows of an accumulator tile
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// ------------------------------------------------------ 3xTF32 on mma.sync
// Fragments of mma.m16n8k8 (tf32), lane = 4 * gq + tq:
//   A (16 x 8, row-major): a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4),
//                          a3 (gq + 8, tq + 4)
//   B (8 x 8, k x n):      b0 (tq, gq), b1 (tq + 4, gq)
//   C (16 x 8):            c0 (gq, 2tq), c1 (gq, 2tq + 1), c2 (gq + 8, 2tq),
//                          c3 (gq + 8, 2tq + 1)
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, 10
// mantissa bits) for finite x: an add and a mask of the bits, two
// instructions where cvt compiles to four with its inf / NaN guard
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// x ~ big + small, both tf32 (x - big is exact; small keeps 11 more bits)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: the two correction products first, the large last
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// acc[t] += a.b[t] for t < nt in 3xTF32, the same order as mma3; each pass
// walks every tile, so a product never waits on the one just issued into
// the same accumulator
template <int N>
__device__ __forceinline__ void mma3_row(float (&acc)[N][4], const FragA& a,
                                         const FragB (&b)[N], int nt = N) {
#pragma unroll
  for (int t = 0; t < N; ++t)
    if (t < nt) mma_tf32(acc[t], a.small, b[t].big);
#pragma unroll
  for (int t = 0; t < N; ++t)
    if (t < nt) mma_tf32(acc[t], a.big, b[t].small);
#pragma unroll
  for (int t = 0; t < N; ++t)
    if (t < nt) mma_tf32(acc[t], a.big, b[t].big);
}

// ------------------------------------------- mma.sync on 16-bit operands
// Fragments of mma.m16n8k16 (bf16 / f16), lane = 4 * gq + tq, each register
// two values (the lower index in the low half):
//   A (16 x 16, row-major): a0 (gq, 2tq..+1), a1 (gq + 8, 2tq..+1),
//                           a2 (gq, 2tq + 8..+9), a3 (gq + 8, 2tq + 8..+9)
//   B (16 x 8, k x n):      b0 (2tq..+1, gq), b1 (2tq + 8..+9, gq)
//   C (16 x 8):             as m16n8k8's
template <typename T>
__device__ __forceinline__ void mma_16(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 tiles of 16-bit values, transposed: lanes 8i .. 8i + 7 give
// the rows of tile i (16-byte aligned); r[i] holds, in each lane, tile i's
// (rows 2tq, 2tq + 1; column gq), the B fragment of a row-major k x n tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// ------------------------------------------------------------- cp.async
// With ok false the copy reads nothing (src-size 0) and zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage a rows x cols tile of T (row r at src + r * ld, columns contiguous)
// in shared memory with row stride sld, asynchronously; rows >= nrows and
// columns >= ncols are zero-filled.  vec: 16-byte copies (cols, ncols, ld
// and src multiples of 16 bytes); else 4-byte ones for float32, and for a
// 16-bit T (cp.async copies no 2 bytes) plain loads and stores, which the
// __syncthreads after the cp.async wait orders as well.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int sld, const T* src,
                                           long long ld, int rows, int cols,
                                           int nrows, int ncols, bool vec) {
  constexpr int E = 16 / sizeof(T);    // values a 16-byte copy
  if (vec) {
    const int ce = cols / E;
    for (int e = threadIdx.x; e < rows * ce; e += THREADS) {
      const int r = e / ce, c = (e - r * ce) * E;
      const bool ok = r < nrows && c < ncols;
      cp_async16(dst + r * sld + c, ok ? src + r * ld + c : src, ok);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e - r * cols;
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * sld + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    auto* d16 = reinterpret_cast<unsigned short*>(dst);
    const auto* s16 = reinterpret_cast<const unsigned short*>(src);
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e - r * cols;
      d16[r * sld + c] = r < nrows && c < ncols ? s16[r * ld + c] : 0;
    }
  }
}

inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ================================================================= rmsnorm
// Forward: replaces _rmsnorm_kernel, y = x * rsqrt(mean(x^2) + eps) * scale
// per row, in float32, y in x's type (T: float32, bfloat16 or float16;
// the scale S: float32 or T), rounded to nearest even as the reference's
// astype.  Backward: replaces no TPU kernel (the JAX package differentiates
// rmsnorm_ref by autodiff); it replaces the port's plain vjp, which
// recomputed the forward in about ten elementwise launches.  Per row, with
// r = rsqrt(mean(x^2) + eps):
//   dx = r * (dy * scale) - x * r^3 * sum(dy * scale * x) / d,
//   dscale = sum over the rows of dy * x * r.
// Bound: bytes, both ways.  The forward reads x and writes y, the backward
// reads x and dy and writes dx (and d-wide scale / dscale), with ~3 and
// ~12 flops a value, far below the card's f32 ridge of ~20 flops a byte.
// So each row is read from device memory exactly once and held in
// registers between its reduction and its write, in 16-byte vectors (4
// float32 or 8 bfloat16 / float16 values a load):
//   - short rows (at most 32 x 8 vectors: float32 d <= 1024, 16-bit d <=
//     2048): one warp a row, NV vectors a lane, the sums by warp shuffles
//     alone (no shared memory, no __syncthreads); 8 warps a block, a
//     persistent grid of as many blocks as stay resident, each warp walking
//     rows with the scale held in its registers;
//   - long rows (up to 256 x 8 vectors: float32 d <= 8192): one block a
//     row, NV <= 8 vectors a thread, blockDim a multiple of 32 sized so that
//     NV is the smallest power of two that fits; one shared-memory step and
//     one __syncthreads a row (the backward's persistent blocks walk rows
//     with two parity buffers, its scale in registers);
//   - anything else (d not a multiple of the vector, an unaligned pointer,
//     wider rows): one block a row with scalar loads, reading the row again
//     for the write.
// The backward keeps dscale's partial sums in registers while a warp
// (short) or block (long) walks its rows, combines a block's warps in a
// fixed order and writes one row of partials a block to a (groups, blocks,
// d) float32 workspace; rmsnorm_dscale_kernel sums it over the blocks in a
// fixed order.  No atomics: two runs give the same bits.  A group is a
// replica of a torch.func.vmap fold (rows of group g are contiguous, its
// scale row g or the shared scale), whose dscale stays its own.
constexpr int RMS_WARPS = 8;                  // short route: warps a block
constexpr int RMS_THREADS = 32 * RMS_WARPS;   // also the scalar route's
constexpr int RMS_MAX_NV = 8;                 // vectors a lane / a thread

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// a 16-byte vector of W = 16 / sizeof(T) values <-> W floats (widening is
// exact; narrowing rounds to nearest even)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __uint_as_float(w[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned short lo = (unsigned short)(w[k] & 0xffffu);
      const unsigned short hi = (unsigned short)(w[k] >> 16);
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        f[2 * k] = __bfloat162float(__ushort_as_bfloat16(lo));
        f[2 * k + 1] = __bfloat162float(__ushort_as_bfloat16(hi));
      } else {
        f[2 * k] = __half2float(__ushort_as_half(lo));
        f[2 * k + 1] = __half2float(__ushort_as_half(hi));
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ uint32_t bits16(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    return __half_as_ushort(__float2half_rn(v));
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bits16<T>(f[2 * k]) | (bits16<T>(f[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the sum over a block's warps (each warp's value in part[warp]) in warp
// order, the same in every thread
__device__ __forceinline__ float block_total(const float* part, int warps) {
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t += part[w];
  return t;
}

// ---- forward
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_warp_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int W = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nvec = d / W;
  float g[NV][W];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * 32 + lane;
#pragma unroll
    for (int e = 0; e < W; ++e)
      g[i][e] = v < nvec ? to_f32<S>(scale[v * W + e]) : 0.f;
  }
  const long long stride = (long long)gridDim.x * RMS_WARPS;
  for (long long row = (long long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 u[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) u[i] = __ldg(xr + i * 32 + lane);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float f[W];
        unpack<T>(u[i], f);
#pragma unroll
        for (int e = 0; e < W; ++e) ss += f[e] * f[e];
      }
    ss = warp_sum(ss);
    const float r = rsqrtf(ss / (float)d + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float f[W];
        unpack<T>(u[i], f);
#pragma unroll
        for (int e = 0; e < W; ++e) f[e] = f[e] * r * g[i][e];
        yr[i * 32 + lane] = pack<T>(f);
      }
  }
}

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_block_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                     T* __restrict__ y, int d, float eps) {
  constexpr int W = 16 / sizeof(T);
  __shared__ float part[RMS_WARPS];
  const int t = threadIdx.x, nt = blockDim.x, nvec = d / W;
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 u[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i * nt + t < nvec) u[i] = __ldg(xr + i * nt + t);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i * nt + t < nvec) {
      float f[W];
      unpack<T>(u[i], f);
#pragma unroll
      for (int e = 0; e < W; ++e) ss += f[e] * f[e];
    }
  ss = warp_sum(ss);
  if ((t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  const float r = rsqrtf(block_total(part, nt >> 5) / (float)d + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * nt + t;
    if (v < nvec) {
      float f[W];
      unpack<T>(u[i], f);
#pragma unroll
      for (int e = 0; e < W; ++e)
        f[e] = f[e] * r * to_f32<S>(scale[v * W + e]);
      yr[v] = pack<T>(f);
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                      T* __restrict__ y, int d, float eps) {
  __shared__ float part[RMS_WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += RMS_THREADS) {
    const float v = to_f32<T>(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  const float r = rsqrtf(block_total(part, RMS_WARPS) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += RMS_THREADS)
    yr[i] = from_f32<T>(to_f32<T>(xr[i]) * r * to_f32<S>(scale[i]));
}

// ---- backward
// Per value: ss += x^2, dot += (dy * g) * x, and after the row's sums
// dx = r * (dy * g) - x * c with c = r^3 * dot / d, acc += dy * x * r.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, long long rows, int d,
                        long long scale_gstride, float eps) {
  constexpr int W = 16 / sizeof(T);
  __shared__ float red[RMS_WARPS][32 * W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / W;
  const long long off = (long long)blockIdx.y * rows * d;
  scale += blockIdx.y * scale_gstride;
  float g[NV][W], acc[NV][W];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * 32 + lane;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      g[i][e] = v < nvec ? to_f32<S>(scale[v * W + e]) : 0.f;
      acc[i][e] = 0.f;
    }
  }
  const long long stride = (long long)gridDim.x * RMS_WARPS;
  for (long long row = (long long)blockIdx.x * RMS_WARPS + warp; row < rows;
       row += stride) {
    const long long base = off + row * d;
    const uint4* xr = reinterpret_cast<const uint4*>(x + base);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + base);
    uint4 ux[NV], ud[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        ux[i] = __ldg(xr + i * 32 + lane);
        ud[i] = __ldg(dr + i * 32 + lane);
      }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float fx[W], fd[W];
        unpack<T>(ux[i], fx);
        unpack<T>(ud[i], fd);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ss += fx[e] * fx[e];
          dot += fd[e] * g[i][e] * fx[e];
        }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(FULL, ss, o);
      dot += __shfl_xor_sync(FULL, dot, o);
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float c = r * r * r * dot / (float)d;
    uint4* outr = reinterpret_cast<uint4*>(dx + base);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float fx[W], fd[W];
        unpack<T>(ux[i], fx);
        unpack<T>(ud[i], fd);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          acc[i][e] += fd[e] * fx[e] * r;
          fd[e] = r * (fd[e] * g[i][e]) - fx[e] * c;
        }
        outr[i * 32 + lane] = pack<T>(fd);
      }
  }
  // the block's warps, summed in warp order, one vector slot at a time
  float* out = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < W; ++e) red[warp][lane * W + e] = acc[i][e];
    __syncthreads();
    for (int k = threadIdx.x; k < 32 * W; k += RMS_THREADS) {
      const int col = i * 32 * W + k;
      if (col < d) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < RMS_WARPS; ++w) s += red[w][k];
        out[col] = s;
      }
    }
  }
}

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_bwd_block_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ part, long long rows, int d,
                         long long scale_gstride, float eps) {
  constexpr int W = 16 / sizeof(T);
  __shared__ float red[2][2][RMS_WARPS];    // parity x (ss, dot) x warp
  const int t = threadIdx.x, nt = blockDim.x, nw = nt >> 5, nvec = d / W;
  const long long off = (long long)blockIdx.y * rows * d;
  scale += blockIdx.y * scale_gstride;
  float g[NV][W], acc[NV][W];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * nt + t;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      g[i][e] = v < nvec ? to_f32<S>(scale[v * W + e]) : 0.f;
      acc[i][e] = 0.f;
    }
  }
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = off + row * d;
    const uint4* xr = reinterpret_cast<const uint4*>(x + base);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + base);
    uint4 ux[NV], ud[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * nt + t < nvec) {
        ux[i] = __ldg(xr + i * nt + t);
        ud[i] = __ldg(dr + i * nt + t);
      }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * nt + t < nvec) {
        float fx[W], fd[W];
        unpack<T>(ux[i], fx);
        unpack<T>(ud[i], fd);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ss += fx[e] * fx[e];
          dot += fd[e] * g[i][e] * fx[e];
        }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(FULL, ss, o);
      dot += __shfl_xor_sync(FULL, dot, o);
    }
    if ((t & 31) == 0) {
      red[parity][0][t >> 5] = ss;
      red[parity][1][t >> 5] = dot;
    }
    __syncthreads();
    const float r =
        rsqrtf(block_total(red[parity][0], nw) / (float)d + eps);
    const float c = r * r * r * block_total(red[parity][1], nw) / (float)d;
    parity ^= 1;
    uint4* outr = reinterpret_cast<uint4*>(dx + base);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * nt + t < nvec) {
        float fx[W], fd[W];
        unpack<T>(ux[i], fx);
        unpack<T>(ud[i], fd);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          acc[i][e] += fd[e] * fx[e] * r;
          fd[e] = r * (fd[e] * g[i][e]) - fx[e] * c;
        }
        outr[i * nt + t] = pack<T>(fd);
      }
  }
  // each column belongs to one thread: no combine
  float* out = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * nt + t;
    if (v < nvec)
#pragma unroll
      for (int e = 0; e < W; ++e) out[v * W + e] = acc[i][e];
  }
}

// any d or alignment: the block's row of partials lives in the workspace
// itself (each column read and written by the one thread that owns it)
template <typename T, typename S>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, long long rows, int d,
                          long long scale_gstride, float eps) {
  __shared__ float red[2][2][RMS_WARPS];
  const int t = threadIdx.x;
  const long long off = (long long)blockIdx.y * rows * d;
  scale += blockIdx.y * scale_gstride;
  float* out = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * d;
  for (int i = t; i < d; i += RMS_THREADS) out[i] = 0.f;
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = off + row * d;
    float ss = 0.f, dot = 0.f;
    for (int i = t; i < d; i += RMS_THREADS) {
      const float fx = to_f32<T>(x[base + i]);
      ss += fx * fx;
      dot += to_f32<T>(dy[base + i]) * to_f32<S>(scale[i]) * fx;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(FULL, ss, o);
      dot += __shfl_xor_sync(FULL, dot, o);
    }
    if ((t & 31) == 0) {
      red[parity][0][t >> 5] = ss;
      red[parity][1][t >> 5] = dot;
    }
    __syncthreads();
    const float r =
        rsqrtf(block_total(red[parity][0], RMS_WARPS) / (float)d + eps);
    const float c =
        r * r * r * block_total(red[parity][1], RMS_WARPS) / (float)d;
    parity ^= 1;
    for (int i = t; i < d; i += RMS_THREADS) {
      const float fx = to_f32<T>(x[base + i]);
      const float fd = to_f32<T>(dy[base + i]);
      out[i] += fd * fx * r;
      dx[base + i] = from_f32<T>(r * (fd * to_f32<S>(scale[i])) - fx * c);
    }
  }
}

// dscale[g][col] = sum over the blocks b of part[g][b][col]: 32 columns a
// block, its 32 rows of threads each summing every 32nd block, then one
// row of threads summing those 32 in order
template <typename S>
__global__ void __launch_bounds__(1024)
rmsnorm_dscale_kernel(const float* __restrict__ part, S* __restrict__ dscale,
                      int blocks, int d) {
  __shared__ float red[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < d) {
    const float* p = part + (long long)blockIdx.y * blocks * d + col;
#pragma unroll 4
    for (int b = threadIdx.y; b < blocks; b += 32) s += p[(long long)b * d];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) total += red[j][threadIdx.x];
    dscale[(long long)blockIdx.y * d + col] = from_f32<S>(total);
  }
}

// ---- launch plans
enum RmsRoute { RMS_WARP, RMS_BLOCK, RMS_SCALAR };

struct RmsPlan {
  RmsRoute route;
  int nv;        // vectors a lane (warp) or a thread (block)
  int threads;   // a block
};

// the route for a row of d values of `size`-byte elements: vectors need d
// a multiple of W = 16 / size and `vec` (16-byte aligned pointers)
inline RmsPlan rms_plan(int d, int size, bool vec) {
  const int w = 16 / size;
  if (!vec || d % w != 0 || d / w > RMS_THREADS * RMS_MAX_NV)
    return {RMS_SCALAR, 0, RMS_THREADS};
  const int nvec = d / w;
  if (nvec <= 32 * RMS_MAX_NV) {
    int nv = 1;
    while (32 * nv < nvec) nv <<= 1;
    return {RMS_WARP, nv, RMS_THREADS};
  }
  int nv = 1;
  while (RMS_THREADS * nv < nvec) nv <<= 1;
  const int per = (nvec + nv - 1) / nv;
  return {RMS_BLOCK, nv, (int)round_up(per, 32)};
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int n = dev >= 0 && dev < 64 ? cached[dev] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n < 1)
      n = 1;
    if (dev >= 0 && dev < 64) cached[dev] = n;
  }
  return n;
}

template <typename K>
int resident_blocks(K kernel, int threads) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0) !=
          cudaSuccess ||
      n < 1)
    n = 1;
  return n;
}

// Calls f(nv constant) for nv in {1, 2, 4, 8}.
template <typename F>
void with_nv(int nv, F f) {
  switch (nv) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

// Calls f with null (T*, S*) for x's dtype code and scale's (0 float32,
// 1 bfloat16, 2 float16; scale float32 or x's type); false otherwise.
template <typename F>
bool with_rms_types(int xcode, int scode, F f) {
  if (scode != 0 && scode != xcode) return false;
  switch (xcode) {
    case 0: f((float*)nullptr, (float*)nullptr); return true;
    case 1:
      if (scode == 0) f((__nv_bfloat16*)nullptr, (float*)nullptr);
      else f((__nv_bfloat16*)nullptr, (__nv_bfloat16*)nullptr);
      return true;
    case 2:
      if (scode == 0) f((__half*)nullptr, (float*)nullptr);
      else f((__half*)nullptr, (__half*)nullptr);
      return true;
    default: return false;
  }
}

// the backward's blocks a group: as many as stay resident across the card
// (split between the groups), but no more than its rows can feed
template <typename T, typename S>
int rms_bwd_blocks(long long rows, int d, int groups, bool vec) {
  const RmsPlan p = rms_plan(d, sizeof(T), vec);
  int resident = 1;
  long long per_block = 1;   // rows a block takes in one pass
  if (p.route == RMS_WARP) {
    per_block = RMS_WARPS;
    with_nv(p.nv, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      resident = resident_blocks(rmsnorm_bwd_warp_kernel<T, S, NV>,
                                 p.threads);
    });
  } else if (p.route == RMS_BLOCK) {
    with_nv(p.nv, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      resident = resident_blocks(rmsnorm_bwd_block_kernel<T, S, NV>,
                                 p.threads);
    });
  } else {
    resident = resident_blocks(rmsnorm_bwd_scalar_kernel<T, S>, p.threads);
  }
  long long cap = (long long)resident * sm_count() / (groups > 0 ? groups : 1);
  const long long need = (rows + per_block - 1) / per_block;
  if (cap > need) cap = need;
  return (int)(cap > 1 ? cap : 1);
}

template <typename T, typename S>
void launch_rmsnorm(const T* x, const S* scale, T* y, long long rows, int d,
                    float eps, bool vec, cudaStream_t st) {
  const RmsPlan p = rms_plan(d, sizeof(T), vec);
  if (p.route == RMS_WARP) {
    with_nv(p.nv, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      static const int resident =
          resident_blocks(rmsnorm_warp_kernel<T, S, NV>, RMS_THREADS);
      long long blocks = (rows + RMS_WARPS - 1) / RMS_WARPS;
      const long long cap = (long long)resident * sm_count();
      if (blocks > cap) blocks = cap;
      rmsnorm_warp_kernel<T, S, NV><<<(unsigned)blocks, RMS_THREADS, 0, st>>>(
          x, scale, y, rows, d, eps);
    });
  } else if (p.route == RMS_BLOCK) {
    with_nv(p.nv, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      rmsnorm_block_kernel<T, S, NV><<<(unsigned)rows, p.threads, 0, st>>>(
          x, scale, y, d, eps);
    });
  } else {
    rmsnorm_scalar_kernel<T, S><<<(unsigned)rows, RMS_THREADS, 0, st>>>(
        x, scale, y, d, eps);
  }
}

template <typename T, typename S>
cudaError_t launch_rmsnorm_bwd(const T* x, const S* scale, const T* dy,
                               T* dx, S* dscale, float* work, long long rows,
                               int d, int groups, int blocks,
                               long long scale_gstride, float eps, bool vec,
                               cudaStream_t st) {
  const RmsPlan p = rms_plan(d, sizeof(T), vec);
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  if (p.route == RMS_WARP) {
    with_nv(p.nv, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      rmsnorm_bwd_warp_kernel<T, S, NV><<<grid, RMS_THREADS, 0, st>>>(
          x, scale, dy, dx, work, rows, d, scale_gstride, eps);
    });
  } else if (p.route == RMS_BLOCK) {
    with_nv(p.nv, [&](auto nv) {
      constexpr int NV = decltype(nv)::value;
      rmsnorm_bwd_block_kernel<T, S, NV><<<grid, p.threads, 0, st>>>(
          x, scale, dy, dx, work, rows, d, scale_gstride, eps);
    });
  } else {
    rmsnorm_bwd_scalar_kernel<T, S><<<grid, RMS_THREADS, 0, st>>>(
        x, scale, dy, dx, work, rows, d, scale_gstride, eps);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<S><<<dim3((unsigned)((d + 31) / 32), (unsigned)groups),
                             dim3(32, 32), 0, st>>>(work, dscale, blocks, d);
  return cudaGetLastError();
}

// ========================================================= flash attention
// Replaces _fa_kernel: softmax(q k^T * scale + mask) v with causal and
// sliding-window masks and GQA (kv head = head / group), from and to
// float32, bfloat16 or float16 (T; the output in q's type, as the
// reference's), the arithmetic in float32 as the reference's, which
// upcasts its q, k and v tiles and keeps p in float32 for p.v.
// This is the "mma" route of repro_flash_attention: float32, 16-bit at
// d 32 / 256, and 16-bit views TMA cannot map.  16-bit inputs at d 64 or
// 128 that TMA can map (the bfloat16 archs' prefills, a float16 smollm's
// forward) take the "hopper" route, flash_hopper.cu (wgmma, TMA,
// warp-specialised), with the same arithmetic; the Python wrapper's
// flash_route picks one before the launch.
// Bound: operations.  At the serving path's prefill (b 8, s 1024, 15 heads,
// d 64) the causal triangle needs ~1.6e10 flops against ~84 MB of q/k/v/o.
// Design: FlashAttention-2's warp layout on the tensor cores.  A block owns
// BQ query rows of one (batch, head), one warp per MT m tiles of 16 rows
// (MT 2 at d 64, so each K / V fragment feeds two products; 1 elsewhere),
// the scores, m, l and the warp's output rows in registers.  P never
// touches shared memory: the score accumulators are the A operand of p.v.
//   - float32: q.k^T and p.v are mma.sync m16n8k8 in 3xTF32.  A lane holds
//     keys 2tq and 2tq + 1 of each 8-key step, so the step's k order is
//     permuted (k = tq <-> key 2tq, k = tq + 4 <-> key 2tq + 1) and V's rows
//     are read in the same order; the sum does not depend on it.
//   - bfloat16 / float16: q.k^T is one mma.sync m16n8k16 on the 16-bit
//     values as they are, which matches the float32 scores of the upcast
//     values but for the order of the sums.  p.v: the accumulators of two
//     8-key tiles are the A fragment of a 16-key step as they lie (FA-2's
//     register trick, no permutation); p is float32, so it is split into hi
//     = T(p) and lo = T(p - hi) (p - hi is exact) and summed as lo.v + hi.v
//     (v is exact in T): 16 bits of p's significand in bfloat16, 22 in
//     float16, within flash's float32 tolerance of the float32 p.v.  V's B
//     fragments come transposed from row-major tiles by ldmatrix.trans.
//     Rows are padded by 8 values (16 bytes): Q / K fragment loads and the
//     ldmatrix rows hit distinct banks.
// K and V tiles are double-buffered with cp.async (two stages), read
// through their strides (16-byte copies when aligned), the ragged edge
// (kpos >= sk) zero-filled and masked.  Key tiles wholly above the diagonal
// or left of the window are skipped by the block, and by a warp whose rows
// see none of their keys, and a tile every row sees whole skips the mask;
// query tiles are ordered longest causal row first.  float32 rows are
// padded to D + 4 floats, so every fragment load hits 32 distinct banks.
// BQ / BK per head dim keep two stages in shared memory up to d 256
// (float32 195 KB, 16-bit 99 KB).  A row with no visible key outputs 0.

template <typename T, int D, int BQ, int BK, int MT>
struct FaCfg {
  static constexpr int ROWS = 16 * MT;           // query rows per warp
  static constexpr int WARPS = BQ / ROWS, THREADS = 32 * WARPS;
  static constexpr int LD = D + 16 / (int)sizeof(T);   // 16 bytes of pad
  static constexpr int BYTES = (BQ + 4 * BK) * LD * (int)sizeof(T);
  // two 256-thread blocks per SM (shared memory allows it at d 64) need
  // <= 128 registers a thread
  static constexpr int MIN_BLOCKS = THREADS == 256 ? 2 : 1;
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the 16-bit value whose bits are the low half of b, as float32 (exact)
template <typename T>
__device__ __forceinline__ float from_bits16(uint32_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __uint_as_float(b << 16);
  else
    return __half2float(__ushort_as_half((unsigned short)b));
}

// p0, p1 -> (hi, lo) registers of two T values each, p ~ hi + lo
template <typename T>
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h0 = bits16<T>(p0), h1 = bits16<T>(p1);
  hi = h0 | (h1 << 16);
  lo = bits16<T>(p0 - from_bits16<T>(h0)) |
       (bits16<T>(p1 - from_bits16<T>(h1)) << 16);
}

template <typename T, int D, int BQ, int BK, int MT>
__global__ void __launch_bounds__(FaCfg<T, D, BQ, BK, MT>::THREADS,
                                  FaCfg<T, D, BQ, BK, MT>::MIN_BLOCKS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int sq,
                       int sk, int h, int group, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, int causal,
                       int window, float scale, int vec) {
  using Cfg = FaCfg<T, D, BQ, BK, MT>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int LD = Cfg::LD, THREADS = Cfg::THREADS, ROWS = Cfg::ROWS;
  constexpr int NT = BK / 8, DT = D / 8;  // score / output n-tiles per warp
  static_assert(F32 || (NT % 2 == 0 && DT % 2 == 0), "16-key steps");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Qs = reinterpret_cast<T*>(fa_smem);   // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int hi = blockIdx.x % h, bi = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // long rows first
  const int kvh = hi / group;
  const T* qb = q + bi * q_sb + hi * q_sh + (long long)q0 * q_ss;
  const T* kb = k + bi * k_sb + kvh * k_sh;
  const T* vb = v + bi * v_sb + kvh * v_sh;

  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + BQ);            // keys <= the last row
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);  // keys > row 0 - window
  k_lo = (k_lo / BK) * BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  stage_tile<THREADS>(Qs, LD, qb, q_ss, BQ, D, sq - q0, D, vec);
  if (ntiles > 0) {
    stage_tile<THREADS>(Ks, LD, kb + (long long)k_lo * k_ss, k_ss, BK, D,
                        sk - k_lo, D, vec);
    stage_tile<THREADS>(Vs, LD, vb + (long long)k_lo * v_ss, v_ss, BK, D,
                        sk - k_lo, D, vec);
  }
  cp_async_commit();

  const int w0 = q0 + ROWS * warp;  // the warp's first query row
  const T* Qw = Qs + ROWS * warp * LD;
  // m tile mt holds rows w0 + 16 mt + gq (c0 / c1) and + 8 (c2 / c3)
  float m_r[MT][2], l_r[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[mt][r] = -INFINITY;
      l_r[mt][r] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < DT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int kt = k_lo + t * BK;
    if (t + 1 < ntiles) {           // prefetch the next tile
      const int st = (t + 1) & 1, kn = kt + BK;
      stage_tile<THREADS>(Ks + st * BK * LD, LD, kb + (long long)kn * k_ss,
                          k_ss, BK, D, sk - kn, D, vec);
      stage_tile<THREADS>(Vs + st * BK * LD, LD, vb + (long long)kn * v_ss,
                          v_ss, BK, D, sk - kn, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();             // this tile (and Q) has landed
    __syncthreads();
    const T* Kt = Ks + (t & 1) * BK * LD;
    const T* Vt = Vs + (t & 1) * BK * LD;
    const bool live = w0 < sq && (!causal || kt <= w0 + ROWS - 1) &&
                      (window <= 0 || kt + BK - 1 > w0 - window);
    if (live) {
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
      if constexpr (F32) {
#pragma unroll 2
        for (int kk = 0; kk < D; kk += 8) {
          FragA a[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* qr = Qw + (16 * mt + gq) * LD + kk + tq;
            a[mt] = frag_a(qr[0], qr[8 * LD], qr[4], qr[8 * LD + 4]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* kr = Kt + (n * 8 + gq) * LD + kk + tq;
            const FragB kf = frag_b(kr[0], kr[4]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma3(s[mt][n], a[mt], kf);
          }
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const T* qr = Qw + (16 * mt + gq) * LD + kk + 2 * tq;
            a[mt][0] = ld32(qr);
            a[mt][1] = ld32(qr + 8 * LD);
            a[mt][2] = ld32(qr + 8);
            a[mt][3] = ld32(qr + 8 * LD + 8);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const T* kr = Kt + (n * 8 + gq) * LD + kk + 2 * tq;
            const uint32_t kf[2] = {ld32(kr), ld32(kr + 8)};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_16<T>(s[mt][n], a[mt], kf);
          }
        }
      }
      // every key of the tile visible to every row of the warp: no mask
      const bool full = kt + BK <= sk && (!causal || kt + BK - 1 <= w0) &&
                        (window <= 0 || kt > w0 + ROWS - 1 - window);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = w0 + 16 * mt + gq;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * (e >> 1);
            const int key = kt + n * 8 + 2 * tq + (e & 1);
            const bool ok =
                full || (key < sk && (!causal || key <= row) &&
                         (window <= 0 || key > row - window));
            s[mt][n][e] = ok ? s[mt][n][e] * scale : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
          }
        float m_use[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_r[mt][r], quad_max(mx[r]));
          m_use[r] = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = expf(m_r[mt][r] - m_use[r]);  // 0 while nothing seen
          m_r[mt][r] = m_new;
          l_r[mt][r] *= alpha[r];                  // this lane's share of l
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][n][e] = expf(s[mt][n][e] - m_use[e >> 1]);  // masked: 0
            l_r[mt][e >> 1] += s[mt][n][e];
          }
#pragma unroll
        for (int t2 = 0; t2 < DT; ++t2) {
          acc[mt][t2][0] *= alpha[0];
          acc[mt][t2][1] *= alpha[0];
          acc[mt][t2][2] *= alpha[1];
          acc[mt][t2][3] *= alpha[1];
        }
      }
      if constexpr (F32) {
        // p.v: step n covers keys n*8 .. n*8+7 in the permuted order
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          FragA pa[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            pa[mt] = frag_a(s[mt][n][0], s[mt][n][2], s[mt][n][1],
                            s[mt][n][3]);
          const float* vr = Vt + (n * 8 + 2 * tq) * LD + gq;
#pragma unroll
          for (int t2 = 0; t2 < DT; ++t2) {
            const FragB vf = frag_b(vr[t2 * 8], vr[LD + t2 * 8]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][t2], pa[mt], vf);
          }
        }
      } else {
        // p.v: step j covers keys 16j .. 16j+15 (score tiles 2j and 2j+1);
        // lane l gives ldmatrix row (l & 7) + 8 ((l >> 3) & 1) of the step,
        // columns 8 (l >> 4) on: tiles (keys 0-7 | 8-15) x (d 0-7 | 8-15)
        const T* vrow = Vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                        (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            split_pair<T>(s[mt][2 * j][0], s[mt][2 * j][1], ph[mt][0],
                          pl[mt][0]);
            split_pair<T>(s[mt][2 * j][2], s[mt][2 * j][3], ph[mt][1],
                          pl[mt][1]);
            split_pair<T>(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1],
                          ph[mt][2], pl[mt][2]);
            split_pair<T>(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3],
                          ph[mt][3], pl[mt][3]);
          }
#pragma unroll
          for (int t2 = 0; t2 < DT; t2 += 2) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vrow + 16 * j * LD + t2 * 8);
            const uint32_t v0[2] = {vf[0], vf[1]}, v1[2] = {vf[2], vf[3]};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16<T>(acc[mt][t2], pl[mt], v0);
              mma_16<T>(acc[mt][t2 + 1], pl[mt], v1);
              mma_16<T>(acc[mt][t2], ph[mt], v0);
              mma_16<T>(acc[mt][t2 + 1], ph[mt], v1);
            }
          }
        }
      }
    }
    __syncthreads();                // the stage is refilled next iteration
  }
  cp_async_wait<0>();               // nothing in flight at exit

  // output is contiguous (b, sq, h, D), rounded once to T; each row's
  // log-sum-exp of the scaled scores m + log(l) to lse (b, h, sq), +inf
  // where the row sees no key (the backward's p = exp(s - lse) is then 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + 16 * mt + gq + 8 * r;
      const float l = quad_sum(l_r[mt][r]);
      if (row >= sq) continue;
      if (tq == 0)
        lse[((long long)bi * h + hi) * sq + row] =
            l > 0.f ? m_r[mt][r] + logf(l) : INFINITY;
      T* orow = o + (((long long)bi * sq + row) * h + hi) * D + 2 * tq;
#pragma unroll
      for (int t2 = 0; t2 < DT; ++t2) {
        const float o0 = l > 0.f ? acc[mt][t2][2 * r] / l : 0.f;
        const float o1 = l > 0.f ? acc[mt][t2][2 * r + 1] / l : 0.f;
        if constexpr (F32)
          *reinterpret_cast<float2*>(orow + t2 * 8) = make_float2(o0, o1);
        else
          *reinterpret_cast<uint32_t*>(orow + t2 * 8) =
              bits16<T>(o0) | (bits16<T>(o1) << 16);
      }
    }
}

template <typename T, int D, int BQ, int BK, int MT>
int launch_flash(const T* q, const T* k, const T* v, T* o, float* lse,
                 int b, int sq,
                 int sk, int h, int kv, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, int causal, int window, float scale,
                 cudaStream_t stream) {
  using Cfg = FaCfg<T, D, BQ, BK, MT>;
  auto kern = flash_attention_kernel<T, D, BQ, BK, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::BYTES);
  if (err != cudaSuccess) return (int)err;
  constexpr long long E = 16 / sizeof(T);     // values a 16-byte copy
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss |
                    v_sh) % E == 0;
  dim3 grid(b * h, (sq + BQ - 1) / BQ);
  kern<<<grid, Cfg::THREADS, Cfg::BYTES, stream>>>(
      q, k, v, o, lse, sq, sk, h, h / kv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, causal, window, scale, (int)vec);
  return (int)cudaGetLastError();
}

// the tiles per head dim: float32 as tuned on the 3xTF32 route; 16-bit
// values take half the shared memory, so d 128 doubles BK
template <typename T>
int launch_flash_d(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int kv, int d,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, int causal,
                   int window, float scale, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
#define REPRO_FA(D, BQ, BK, MT)                                              \
  launch_flash<T, D, BQ, BK, MT>(qt, kt, vt, ot, lse, b, sq, sk, h, kv,     \
                                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   \
                                 v_ss, v_sh, causal, window, scale, st)
  switch (d) {
    case 32: return REPRO_FA(32, 64, 64, 1);
    case 64: return REPRO_FA(64, 128, 64, 2);
    case 128: return REPRO_FA(128, 64, sizeof(T) == 4 ? 32 : 64, 1);
    case 256: return REPRO_FA(256, 64, 32, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA
}

// ================================================ flash attention backward
// Replaces no TPU kernel: the JAX package's flash_attention has no
// custom_vjp (JAX differentiates attention_ref), and the port's backward
// was torch.func.vjp of the plain version, which kept the float32 (b, kv,
// g, sq, sk) scores and their gradients (8.4 GB a layer at qwen3-14b's
// bfloat16 training shape).  This is FlashAttention-2's backward: from q,
// k, v, the cotangent dO and the forward's lse (each row's log-sum-exp of
// its scaled scores), P = exp(S scale - lse) is recomputed tile by tile and
// never stored, and
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  dK = scale dS^T Q,
//   dQ = scale dS K,  D = rowsum(P o dP),
// in float32, the gradients rounded once to the inputs' type.  This is the
// "mma" route of repro_flash_attention_backward: float32, 16-bit at d 32 /
// 64 and 16-bit views TMA cannot map; 16-bit d 128 or 256 that TMA can map
// takes the "hopper" route (flash_hopper_bwd.cu) with the same arithmetic.
// D is the softmax backward's sum over the visible keys, as the plain vjp forms it:
// FlashAttention-2's rowsum(dO o O) is the same sum only for the unrounded
// O, and from a 16-bit O it puts the gradients 10-20x flash's float32
// tolerance off the plain vjp's.  Three launches a call, no atomics (the
// same inputs give the same bits on every run):
//   (a) flash_bwd_rows_kernel<.., false>: D, a block per (batch, head,
//       query tile) walking the key tiles its rows see;
//   (b) flash_bwd_kv_kernel: dK and dV, a block per (batch, kv head, key
//       tile) walking the group's heads and the query tiles that see its
//       keys (causal: from the diagonal down; under a window: to the last
//       key + window - 1), so a GQA group's sum stays in the block;
//   (c) flash_bwd_rows_kernel<.., true>: dQ, on (a)'s blocks.
// Bound: operations.  The five products take 10 d flops a visible (query,
// key) pair and head; the kernels run nine (S and dP in each of (a), (b)
// and (c)), 18 d, and on 16-bit inputs the three with a float32 left
// operand (P^T dO, dS^T Q, dS K) twice each, on P / dS split into hi = T(x)
// and lo = T(x - hi) as the forward's p.v: 24 d of 16-bit products.
// float32 runs every product in 3xTF32, as the forward.
// Design: the forward's mma route turned around.  A warp owns 16 rows
// (queries in (a) / (c), keys in (b)) and holds its S (S^T) and dP tiles
// in registers; those accumulators are the left operand of the next
// product as they lie (FA-2's register trick), the right operand a
// row-major tile transposed by ldmatrix.trans (16-bit) or read in the
// permuted key order (float32).  The block's own tile (Q and dO, or K and
// V) is staged once; the walked one (K and V, or Q, dO, lse and D) is
// double-buffered with cp.async.  Where 16 rows' output accumulators would
// not fit in registers (16-bit d 256, float32 d 128 and 256), SPLIT warps
// share the 16 rows, each owning D / SPLIT output columns: at most 128
// accumulator floats a lane for dK and dV together.  In float32 each warp
// also takes D / SPLIT columns of S's and dP's contraction, and the
// partial sums meet in shared memory (split_sum), added in a fixed order,
// so every warp of the group holds the same S and dP; in 16 bits each warp
// computes the whole S and dP, which took less time on the card than the
// shared-memory sums (a 16-bit product is a third of a 3xTF32 one).
template <typename T, int D>
struct FbCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int DW_MAX = F32 ? 64 : 128;
  static constexpr int DW = D < DW_MAX ? D : DW_MAX;  // a warp's out columns
  static constexpr int SPLIT = D / DW;                // warps on 16 rows
  static constexpr int RW = 4 / SPLIT;                // 16-row groups a block
  static constexpr int THREADS = 32 * RW * SPLIT;     // 128
  // the SPLIT warps of a group share S's and dP's contraction (float32) or
  // each compute it whole (16-bit); (a) runs one warp a group in the latter
  static constexpr bool SHARE = F32 && SPLIT > 1;
  static constexpr int KW = SHARE ? DW : D;           // S / dP columns a warp
  static constexpr int D_THREADS = SHARE ? THREADS : 32 * RW;
  static constexpr int LD = D + 16 / (int)sizeof(T);  // 16 bytes of pad
  // keys a tile walked by (a) / (c), queries a tile walked by (b)
  static constexpr int BK = F32 ? (D == 256 ? 16 : 32) : (D == 256 ? 32 : 64);
  static constexpr int BQ = F32 ? (D == 256 ? 16 : 32) : (D <= 64 ? 64 : 32);
  // split_sum's partials: 2 x (n-tiles) x 4 x 32 floats a warp
  static constexpr int RED_ROWS = SHARE ? THREADS * BK : 0;
  static constexpr int RED_KV = SHARE ? THREADS * BQ : 0;
  static constexpr int ROWS_BYTES =
      (2 * 16 * RW + 4 * BK) * LD * (int)sizeof(T) + 4 * RED_ROWS;
  static constexpr int KV_BYTES =
      (2 * 16 * RW + 4 * BQ) * LD * (int)sizeof(T) + 4 * BQ * 4 +
      4 * RED_KV;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The SP warps of a 16-row group hold partial s and dp over their own
// columns of the contraction: sum them through shared memory (red: the
// group's SP x 2 x NT x 4 x 32 floats) in the order of the parts, so every
// warp of the group ends with the same whole S and dP.  The group meets at
// named barrier 1 + rg; the caller's __syncthreads orders red's reuse.
template <int SP, int NT>
__device__ __forceinline__ void split_sum(float (&s)[NT][4],
                                          float (&dp)[NT][4], float* red,
                                          int part, int rg, int lane) {
  if constexpr (SP > 1) {
    constexpr int W = 2 * NT * 4 * 32;  // floats a warp
    float* mine = red + part * W;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32 + lane] = s[n][e];
        mine[((NT + n) * 4 + e) * 32 + lane] = dp[n][e];
      }
    bar_sync(1 + rg, 32 * SP);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int p = 0; p < SP; ++p) {
          a += red[p * W + (n * 4 + e) * 32 + lane];
          b += red[p * W + ((NT + n) * 4 + e) * 32 + lane];
        }
        s[n][e] = a;
        dp[n][e] = b;
      }
  }
}

// s[n] = A . B^T over KW columns: 16 rows of A (row-major, row stride LD
// of a D-wide tile, from Aw) against the 8 NT rows of B from Bt, as the
// forward's q.k^T (16-bit: one mma.sync m16n8k16 a step of 16; float32:
// 3xTF32 m16n8k8 a step of 8)
template <typename T, int D, int NT, int KW>
__device__ __forceinline__ void rows_dot(float (&s)[NT][4], const T* Aw,
                                         const T* Bt, int gq, int tq) {
  constexpr int LD = D + 16 / (int)sizeof(T);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (sizeof(T) == 4) {
#pragma unroll 2
    for (int kk = 0; kk < KW; kk += 8) {
      const float* ar = Aw + gq * LD + kk + tq;
      const FragA a = frag_a(ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]);
      FragB b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* br = Bt + (n * 8 + gq) * LD + kk + tq;
        b[n] = frag_b(br[0], br[4]);
      }
      mma3_row(s, a, b);
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < KW; kk += 16) {
      const T* ar = Aw + gq * LD + kk + 2 * tq;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LD), ld32(ar + 8),
                             ld32(ar + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* br = Bt + (n * 8 + gq) * LD + kk + 2 * tq;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
        mma_16<T>(s[n], a, b);
      }
    }
  }
}

// acc[t] += P . B[:, 8t .. 8t + 7] for t < DT, P (16 x 8 NT) the score
// accumulators as they lie, B (8 NT rows) row-major at Bt (row stride LD),
// as the forward's p.v.  16-bit: P split into hi / lo, lo.B then hi.B, B's
// fragments transposed by ldmatrix; float32: 3xTF32, P's columns in the
// permuted order (k = tq <-> column 2tq, k = tq + 4 <-> 2tq + 1) and B's
// rows read in the same order
template <typename T, int D, int NT, int DT>
__device__ __forceinline__ void acc_pb(float (&acc)[DT][4],
                                       const float (&p)[NT][4], const T* Bt,
                                       int lane) {
  constexpr int LD = D + 16 / (int)sizeof(T);
  const int gq = lane >> 2, tq = lane & 3;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const FragA pa = frag_a(p[n][0], p[n][2], p[n][1], p[n][3]);
      const float* br = Bt + (n * 8 + 2 * tq) * LD + gq;
      FragB b[DT];
#pragma unroll
      for (int t = 0; t < DT; ++t) b[t] = frag_b(br[t * 8], br[LD + t * 8]);
      mma3_row(acc, pa, b);
    }
  } else {
    static_assert(NT % 2 == 0 && DT % 2 == 0, "16-row steps");
    const T* brow = Bt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                    (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t ph[4], pl[4];
      split_pair<T>(p[2 * j][0], p[2 * j][1], ph[0], pl[0]);
      split_pair<T>(p[2 * j][2], p[2 * j][3], ph[1], pl[1]);
      split_pair<T>(p[2 * j + 1][0], p[2 * j + 1][1], ph[2], pl[2]);
      split_pair<T>(p[2 * j + 1][2], p[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, brow + 16 * j * LD + t * 8);
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
        mma_16<T>(acc[t], pl, b0);
        mma_16<T>(acc[t + 1], pl, b1);
        mma_16<T>(acc[t], ph, b0);
        mma_16<T>(acc[t + 1], ph, b1);
      }
    }
  }
}

// a pair of output values (columns c, c + 1 of a contiguous row), rounded
// once to T
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = bits16<T>(a) | (bits16<T>(b) << 16);
}

// (a) with DQ false: delta = D per query row; (c) with DQ true: dq.  A
// block owns 16 RW query rows of one (batch, head), Q and dO staged once,
// K and V tiles of BK keys double-buffered; rows longest causal first
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(DQ ? FbCfg<T, D>::THREADS
                                     : FbCfg<T, D>::D_THREADS)
flash_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, T* __restrict__ dq, int sq,
                      int sk, int h, int group, long long q_sb,
                      long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, long long o_sb,
                      long long o_ss, long long o_sh, int causal,
                      int window, float scale, int vec) {
  using Cfg = FbCfg<T, D>;
  // (a) without SHARE: one warp a group (no output columns to split)
  constexpr int SP = DQ || Cfg::SHARE ? Cfg::SPLIT : 1;
  constexpr int RW = Cfg::RW, BK = Cfg::BK, DW = Cfg::DW, KW = Cfg::KW;
  constexpr int LD = Cfg::LD, THREADS = 32 * RW * SP, BQ = 16 * RW;
  constexpr int NT = BK / 8, DT = DW / 8, K0 = Cfg::SHARE ? DW : 0;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  T* Qs = reinterpret_cast<T*>(fb_smem);  // [BQ][LD]
  T* Os = Qs + BQ * LD;                   // dO [BQ][LD]
  T* Ks = Os + BQ * LD;                   // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;               // [2][BK][LD]
  float* red = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // split_sum's

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp / SP, part = warp - rg * SP;
  const int hi = blockIdx.x % h, bi = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // long rows first
  const int kvh = hi / group;
  const T* kb = k + bi * k_sb + kvh * k_sh;
  const T* vb = v + bi * v_sb + kvh * v_sh;

  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + BQ);            // keys <= the last row
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);  // keys > row 0 - window
  k_lo = (k_lo / BK) * BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  stage_tile<THREADS>(Qs, LD, q + bi * q_sb + hi * q_sh + (long long)q0 * q_ss,
                      q_ss, BQ, D, sq - q0, D, vec);
  stage_tile<THREADS>(Os, LD,
                      dout + bi * o_sb + hi * o_sh + (long long)q0 * o_ss,
                      o_ss, BQ, D, sq - q0, D, vec);
  if (ntiles > 0) {
    stage_tile<THREADS>(Ks, LD, kb + (long long)k_lo * k_ss, k_ss, BK, D,
                        sk - k_lo, D, vec);
    stage_tile<THREADS>(Vs, LD, vb + (long long)k_lo * v_ss, v_ss, BK, D,
                        sk - k_lo, D, vec);
  }
  cp_async_commit();

  const int w0 = q0 + 16 * rg;  // the warp's first query row
  const T* Qw = Qs + 16 * rg * LD;
  const T* Ow = Os + 16 * rg * LD;
  const long long rb = ((long long)bi * h + hi) * sq;
  // this lane's rows w0 + gq (c0 / c1) and + 8 (c2 / c3)
  float lse_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gq + 8 * r;
    lse_r[r] = row < sq ? lse[rb + row] : INFINITY;
    if constexpr (DQ) d_r[r] = row < sq ? delta[rb + row] : 0.f;
  }
  float acc[DQ ? DT : 2][4];
#pragma unroll
  for (int t = 0; t < (DQ ? DT : 2); ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int kt = k_lo + t * BK;
    if (t + 1 < ntiles) {           // prefetch the next tile
      const int st = (t + 1) & 1, kn = kt + BK;
      stage_tile<THREADS>(Ks + st * BK * LD, LD, kb + (long long)kn * k_ss,
                          k_ss, BK, D, sk - kn, D, vec);
      stage_tile<THREADS>(Vs + st * BK * LD, LD, vb + (long long)kn * v_ss,
                          v_ss, BK, D, sk - kn, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();             // this tile (and Q, dO) has landed
    __syncthreads();
    const T* Kt = Ks + (t & 1) * BK * LD;
    const T* Vt = Vs + (t & 1) * BK * LD;
    const bool live = w0 < sq && (!causal || kt <= w0 + 15) &&
                      (window <= 0 || kt + BK - 1 > w0 - window);
    if (live) {
      float s[NT][4], dp[NT][4];
      rows_dot<T, D, NT, KW>(s, Qw + part * K0, Kt + part * K0, gq, tq);
      rows_dot<T, D, NT, KW>(dp, Ow + part * K0, Vt + part * K0, gq, tq);
      if constexpr (Cfg::SHARE)
        split_sum<SP, NT>(s, dp, red + rg * SP * 2 * NT * 128, part, rg,
                          lane);
      // every key of the tile visible to every row of the warp: no mask
      const bool full = kt + BK <= sk && (!causal || kt + BK - 1 <= w0) &&
                        (window <= 0 || kt > w0 + 15 - window);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w0 + gq + 8 * (e >> 1);
          const int key = kt + n * 8 + 2 * tq + (e & 1);
          const bool ok = full || (key < sk && (!causal || key <= row) &&
                                   (window <= 0 || key > row - window));
          const float p =
              ok ? expf(fmaf(s[n][e], scale, -lse_r[e >> 1])) : 0.f;
          if constexpr (DQ)
            s[n][e] = p * (dp[n][e] - d_r[e >> 1]);  // dS
          else
            acc[0][e >> 1] += p * dp[n][e];          // this lane's D
        }
      if constexpr (DQ) acc_pb<T, D, NT, DT>(acc, s, Kt + part * DW, lane);
    }
    __syncthreads();                // the stage is refilled next iteration
  }
  cp_async_wait<0>();               // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gq + 8 * r;
    if constexpr (DQ) {
      if (row >= sq) continue;
      // dq is contiguous (b, sq, h, D)
      T* drow = dq + (((long long)bi * sq + row) * h + hi) * D + part * DW +
                2 * tq;
#pragma unroll
      for (int t = 0; t < DT; ++t)
        store_pair<T>(drow + t * 8, acc[t][2 * r] * scale,
                      acc[t][2 * r + 1] * scale);
    } else {
      const float dsum = quad_sum(acc[0][r]);  // the group's warps agree
      if (part == 0 && tq == 0 && row < sq) delta[rb + row] = dsum;
    }
  }
}

// (b): dk and dv.  A block owns 16 RW keys of one (batch, kv head), K and
// V staged once, and walks the group's heads and, for each, the query
// tiles that see its keys: Q, dO, lse and D tiles of BQ rows
// double-buffered.  Key tile 0 first (the most query tiles under causal)
template <typename T, int D>
__global__ void __launch_bounds__(FbCfg<T, D>::THREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int sq, int sk, int h, int group,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh,
                    int causal, int window, float scale, int vec) {
  using Cfg = FbCfg<T, D>;
  constexpr int SP = Cfg::SPLIT, RW = Cfg::RW, BQ = Cfg::BQ, LD = Cfg::LD;
  constexpr int THREADS = Cfg::THREADS, BKV = 16 * RW, NT = BQ / 8;
  constexpr int DW = Cfg::DW, DT = DW / 8, KW = Cfg::KW;
  constexpr int K0 = Cfg::SHARE ? DW : 0;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  T* Ks = reinterpret_cast<T*>(fb_smem);  // [BKV][LD]
  T* Vs = Ks + BKV * LD;                  // [BKV][LD]
  T* Qs = Vs + BKV * LD;                  // [2][BQ][LD]
  T* Os = Qs + 2 * BQ * LD;               // dO [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // lse [2][BQ]
  float* Ds = Ls + 2 * BQ;                                 // D [2][BQ]
  float* red = Ds + 2 * BQ;                                // split_sum's

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp / SP, part = warp - rg * SP;
  const int kv = h / group;
  const int kvh = blockIdx.x % kv, bi = blockIdx.x / kv;
  const int k0 = blockIdx.y * BKV;

  // the query tiles that see a key of [k0, k0 + BKV)
  int q_lo = causal ? k0 : 0;                     // queries >= the key
  int q_hi = sq;
  if (window > 0) q_hi = min(sq, k0 + BKV - 1 + window);  // < key + window
  q_lo = (q_lo / BQ) * BQ;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int total = group * nqt;  // (head, query tile) steps

  auto stage_q = [&](int it, int st) {
    const int j = it / nqt, qt = q_lo + (it - j * nqt) * BQ;
    const int hq = kvh * group + j;
    stage_tile<THREADS>(Qs + st * BQ * LD, LD,
                        q + bi * q_sb + hq * q_sh + (long long)qt * q_ss,
                        q_ss, BQ, D, sq - qt, D, vec);
    stage_tile<THREADS>(Os + st * BQ * LD, LD,
                        dout + bi * o_sb + hq * o_sh + (long long)qt * o_ss,
                        o_ss, BQ, D, sq - qt, D, vec);
    const long long rb = ((long long)bi * h + hq) * sq + qt;
    stage_tile<THREADS>(Ls + st * BQ, BQ, lse + rb, 0, 1, BQ, 1, sq - qt,
                        false);
    stage_tile<THREADS>(Ds + st * BQ, BQ, delta + rb, 0, 1, BQ, 1, sq - qt,
                        false);
  };
  stage_tile<THREADS>(Ks, LD, k + bi * k_sb + kvh * k_sh + (long long)k0 * k_ss,
                      k_ss, BKV, D, sk - k0, D, vec);
  stage_tile<THREADS>(Vs, LD, v + bi * v_sb + kvh * v_sh + (long long)k0 * v_ss,
                      v_ss, BKV, D, sk - k0, D, vec);
  if (total > 0) stage_q(0, 0);
  cp_async_commit();

  const int w0 = k0 + 16 * rg;  // the warp's first key
  const T* Kw = Ks + 16 * rg * LD;
  const T* Vw = Vs + 16 * rg * LD;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) stage_q(it + 1, (it + 1) & 1);  // prefetch
    cp_async_commit();
    cp_async_wait<1>();             // this step's tiles (and K, V) landed
    __syncthreads();
    const int j = it / nqt, qt = q_lo + (it - j * nqt) * BQ;
    const T* Qt = Qs + (it & 1) * BQ * LD;
    const T* Ot = Os + (it & 1) * BQ * LD;
    const float* Lt = Ls + (it & 1) * BQ;
    const float* Dt = Ds + (it & 1) * BQ;
    const bool live = w0 < sk && (!causal || qt + BQ - 1 >= w0) &&
                      (window <= 0 || qt < w0 + 15 + window);
    if (live) {
      float s[NT][4], dp[NT][4];    // S^T and dP^T: (key, query)
      rows_dot<T, D, NT, KW>(s, Kw + part * K0, Qt + part * K0, gq, tq);
      rows_dot<T, D, NT, KW>(dp, Vw + part * K0, Ot + part * K0, gq, tq);
      if constexpr (Cfg::SHARE)
        split_sum<SP, NT>(s, dp, red + rg * SP * 2 * NT * 128, part, rg,
                          lane);
      // every query of the tile sees every key of the warp: no mask
      const bool full = w0 + 16 <= sk && qt + BQ <= sq &&
                        (!causal || qt >= w0 + 15) &&
                        (window <= 0 || qt + BQ - 1 - w0 < window);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = w0 + gq + 8 * (e >> 1);
          const int c = n * 8 + 2 * tq + (e & 1), query = qt + c;
          const bool ok =
              full || (key < sk && query < sq && (!causal || key <= query) &&
                       (window <= 0 || key > query - window));
          const float p = ok ? expf(fmaf(s[n][e], scale, -Lt[c])) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Dt[c]);  // dS^T
        }
      acc_pb<T, D, NT, DT>(dva, s, Ot + part * DW, lane);
      acc_pb<T, D, NT, DT>(dka, dp, Qt + part * DW, lane);
    }
    __syncthreads();                // the stage is refilled next iteration
  }
  cp_async_wait<0>();               // nothing in flight at exit

  // dk and dv are contiguous (b, sk, kv, D), rounded once to T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = w0 + gq + 8 * r;
    if (key >= sk) continue;
    const long long off = (((long long)bi * sk + key) * kv + kvh) * D +
                          part * DW + 2 * tq;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      store_pair<T>(dk + off + t * 8, dka[t][2 * r] * scale,
                    dka[t][2 * r + 1] * scale);
      store_pair<T>(dv + off + t * 8, dva[t][2 * r], dva[t][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t fb_smem_attr(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
int launch_flash_bwd(const T* q, const T* k, const T* v, const T* dout,
                     const float* lse, float* delta, T* dq, T* dk, T* dv,
                     int b, int sq, int sk, int h, int kv, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, long long o_sb,
                     long long o_ss, long long o_sh, int causal, int window,
                     float scale, cudaStream_t st) {
  using Cfg = FbCfg<T, D>;
  auto pass_d = flash_bwd_rows_kernel<T, D, false>;
  auto pass_q = flash_bwd_rows_kernel<T, D, true>;
  auto pass_kv = flash_bwd_kv_kernel<T, D>;
  cudaError_t err = fb_smem_attr(pass_d, Cfg::ROWS_BYTES);
  if (err == cudaSuccess) err = fb_smem_attr(pass_q, Cfg::ROWS_BYTES);
  if (err == cudaSuccess) err = fb_smem_attr(pass_kv, Cfg::KV_BYTES);
  if (err != cudaSuccess) return (int)err;
  constexpr long long E = 16 / sizeof(T);     // values a 16-byte copy
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) &&
                   (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss |
                    v_sh | o_sb | o_ss | o_sh) % E == 0;
  const int group = h / kv, rows = 16 * Cfg::RW;
  const dim3 rows_grid(b * h, (sq + rows - 1) / rows);
  const dim3 kv_grid(b * kv, (sk + rows - 1) / rows);
#define REPRO_FB_ARGS                                                        \
  sq, sk, h, group, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,    \
      o_sb, o_ss, o_sh, causal, window, scale, (int)vec
  if (sq > 0) {
    pass_d<<<rows_grid, Cfg::D_THREADS, Cfg::ROWS_BYTES, st>>>(
        q, k, v, dout, lse, delta, dq, REPRO_FB_ARGS);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (sk > 0) {
    pass_kv<<<kv_grid, Cfg::THREADS, Cfg::KV_BYTES, st>>>(
        q, k, v, dout, lse, delta, dk, dv, REPRO_FB_ARGS);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (sq > 0)
    pass_q<<<rows_grid, Cfg::THREADS, Cfg::ROWS_BYTES, st>>>(
        q, k, v, dout, lse, delta, dq, REPRO_FB_ARGS);
#undef REPRO_FB_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flash_bwd_d(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, float* delta,
                       void* dq, void* dk, void* dv, int b, int sq, int sk,
                       int h, int kv, int d, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long o_sb, long long o_ss,
                       long long o_sh, int causal, int window, float scale,
                       cudaStream_t st) {
#define REPRO_FB(D)                                                          \
  launch_flash_bwd<T, D>(                                                    \
      static_cast<const T*>(q), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,     \
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), b, sq,  \
      sk, h, kv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, \
      o_ss, o_sh, causal, window, scale, st)
  switch (d) {
    case 32: return REPRO_FB(32);
    case 64: return REPRO_FB(64);
    case 128: return REPRO_FB(128);
    case 256: return REPRO_FB(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FB
}

// Stage a tile of T as float32 in shared memory (dst float, row stride
// sld, a multiple of 4), rows >= nrows and columns >= ncols zero: float32
// by stage_tile (asynchronously); a 16-bit T widened on the way, exactly,
// by plain loads and stores (cp.async cannot convert), which the
// __syncthreads after the cp.async wait orders as well.  vec: 16-byte
// loads of 8 values (cols, ncols, ld and src multiples of 16 bytes), each
// stored as two float4.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_tile_f32(float* dst, int sld,
                                               const T* src, long long ld,
                                               int rows, int cols, int nrows,
                                               int ncols, bool vec) {
  if constexpr (sizeof(T) == 4) {
    stage_tile<THREADS, float>(dst, sld, src, ld, rows, cols, nrows, ncols,
                               vec);
  } else if (vec) {
    const int ce = cols / 8;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * ce; e += THREADS) {
      const int r = e / ce, c = (e - r * ce) * 8;
      float f[8];
      if (r < nrows && c < ncols)
        unpack<T>(*reinterpret_cast<const uint4*>(src + r * ld + c), f);
      else
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] = 0.f;
      float4* d4 = reinterpret_cast<float4*>(dst + r * sld + c);
      d4[0] = make_float4(f[0], f[1], f[2], f[3]);
      d4[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e - r * cols;
      dst[r * sld + c] =
          r < nrows && c < ncols ? to_f32<T>(src[r * ld + c]) : 0.f;
    }
  }
}

// ===================================================== SSD chunk scan
// Replaces _ssd_kernel (Mamba2 SSD).  Per chunk of positions, with
// cum = inclusive prefix sum of dt*A:
//   y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i.H
//   H  <- exp(total) H + sum_j exp(total - cum_j) dt_j B_j x_j^T
// and returns the final H (the TPU kernel dropped it; the prefill cache
// needs it).
// Bound: operations.  At mamba2-780m's prefill (b 8, s 1024, 48 heads in
// one B/C group, p 64, n 128, chunk 256) the work is ~1.96e10 flops (C.B^T
// once per group, the other three products per head) against ~0.2 GB of
// x/dt/B/C/y.  Design: Mamba2's own chunked decomposition (arXiv:2405.21060
// section 6) as four kernels behind one call, every product in 3xTF32 on
// mma.sync, one warp per 16 rows of a tile:
//   cumsum  per (batch, head, chunk): cum and dt, contiguous, in scratch;
//   cb      per (batch, group, chunk, 64 x 64 tile of the lower triangle):
//           C.B^T, once for all the group's heads, into scratch (8.4 MB at
//           the path's shape, so it stays in L2);
//   state   per (32 columns of p, head, batch): walks the chunks in order,
//           each chunk's own state S_c = sum_j exp(total - cum_j) dt_j
//           B_j x_j^T on the tensor cores (j tiles double-buffered with
//           cp.async), then the inter-chunk pass H_{c+1} = exp(total_c)
//           H_c + S_c in registers; H_c goes to scratch, the last H to the
//           final state;
//   scan    per (128-row i tile, head, batch x chunk), 8 warps:
//           exp(cum_i) C_i.H_c, then the (CB o exp(cum_i - cum_j) o dt_j)
//           x_j tiles j <= i (64 wide) with CB and x double-buffered.  The
//           i tiles of one (batch, head, chunk) sit side by side in the
//           grid, so H_c and x are read from L2, and the heads of a group
//           share CB and C there.
// Inputs: x, B and C in float32, bfloat16 or float16 (one type), dt and A
// each in float32 or that type.  A 16-bit tile is widened exactly to
// float32 as it is staged in shared memory (stage_tile_f32), so every
// product and every intermediate (cum, C.B^T, the chunk states, the final
// state) is the float32 one; y is written in x's type, rounded once from
// the float32 accumulator (the reference's astype(x.dtype)).
// The scratch is the wrapper's (repro_ssd_workspace_floats says how many
// floats).  Positions past s (a ragged last chunk) read as dt = 0 and
// x = B = C = 0, so they leave the state unchanged, and are not stored.
constexpr int SSD_T = 64;          // position tile
constexpr int SSD_NMAX = 128;      // d_state
constexpr int SSD_PMAX = 64;       // head_dim
constexpr int SSD_CMAX = 256;      // chunk
// shared row strides: + 4 where a fragment walks along a row (banks
// 4 gq + tq), + 8 where it walks down a column (banks 8 tq + gq)
constexpr int SSD_LDC = SSD_NMAX + 4;  // C or B tile [pos][n], along n
constexpr int SSD_LDB = SSD_NMAX + 8;  // B tile [pos][n], down pos
constexpr int SSD_LDX = SSD_PMAX + 8;  // x tile [pos][p], H [n][p]: down
constexpr int SSD_LDS = SSD_T + 4;     // CB tile [i][j], along j
// cb: 64 x 64 tiles, 4 warps x 16 rows
constexpr int SSD_CB_THREADS = 128;
constexpr int SSD_CB_FLOATS = 2 * SSD_T * SSD_LDC;
// state: 32 columns of p, 8 warps x 16 rows of n, 64-row j tiles in two
// stages (deeper pipelines of smaller tiles ran slower)
constexpr int SSD_PB = 32;
constexpr int SSD_STATE_THREADS = 256;
constexpr int SSD_LDXB = SSD_PB + 8;   // its x tile: down
constexpr int SSD_TJ = 64, SSD_ST = 2;
constexpr int SSD_STATE_FLOATS =
    SSD_ST * SSD_TJ * (1 + SSD_LDB + SSD_LDXB);
// scan: 128-row i tiles, 8 warps x 16 rows; shared memory for cum and dt,
// then phase 1 (the C tile and H) and phase 2 (two stages of the CB and x
// tiles) in one region
constexpr int SSD_TI = 128;
constexpr int SSD_SCAN_THREADS = 2 * SSD_TI;
constexpr int SSD_P1_FLOATS = SSD_TI * SSD_LDC + SSD_NMAX * SSD_LDX;
constexpr int SSD_P2_FLOATS = 2 * SSD_TI * SSD_LDS + 2 * SSD_T * SSD_LDX;
constexpr int SSD_SCAN_FLOATS =
    2 * SSD_CMAX +
    (SSD_P1_FLOATS > SSD_P2_FLOATS ? SSD_P1_FLOATS : SSD_P2_FLOATS);

struct SsdWork {      // float offsets into the wrapper's scratch
  long long cum, dts, cb, hs, total;
  int nc, ldcb, ldh;  // chunks; row strides of CB (chunk) and H (p)
};

SsdWork ssd_work(int b, int s, int h, int p, int g, int n, int chunk) {
  SsdWork w;
  w.nc = (s + chunk - 1) / chunk;
  w.ldcb = (int)round_up(chunk, 4);
  w.ldh = (int)round_up(p, 4);
  const long long bhc = (long long)b * h * w.nc;
  // cum, dt: (b, h, nc, chunk); C.B^T: (b, g, nc, chunk, ldcb); H: (b, h,
  // nc, n, ldh), slot c holding H_c (slot 0 unused: H_0 = 0)
  w.cum = 0;
  w.dts = round_up(bhc * chunk, 64);
  w.cb = w.dts + round_up(bhc * chunk, 64);
  w.hs = w.cb + round_up((long long)b * g * w.nc * chunk * w.ldcb, 64);
  w.total = w.hs + bhc * n * w.ldh;
  return w;
}

template <typename TD, typename TA>
__global__ void __launch_bounds__(SSD_CMAX)
ssd_cumsum_kernel(const TD* __restrict__ dt, const TA* __restrict__ A,
                  float* __restrict__ cum, float* __restrict__ dts, int s,
                  int h, int chunk, int nc, long long dt_sb, long long dt_ss,
                  long long dt_sh) {
  __shared__ float wsum[SSD_CMAX / 32];
  const int bh = blockIdx.x, c = blockIdx.y, bi = bh / h, hi = bh % h;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int pos = c * chunk + t;
  const float d =
      t < chunk && pos < s
          ? to_f32<TD>(dt[bi * dt_sb + (long long)pos * dt_ss + hi * dt_sh])
          : 0.f;
  float la = d * to_f32<TA>(A[hi]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(FULL, la, off);
    if (lane >= off) la += u;
  }
  if (lane == 31) wsum[warp] = la;
  __syncthreads();
  if (warp == 0) {
    float w = lane < SSD_CMAX / 32 ? wsum[lane] : 0.f;
    const float own = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += u;
    }
    if (lane < SSD_CMAX / 32) wsum[lane] = w - own;     // exclusive
  }
  __syncthreads();
  if (t < chunk) {
    const long long at = ((long long)bh * nc + c) * chunk + t;
    cum[at] = la + wsum[warp];
    dts[at] = d;
  }
}

template <typename T>
__global__ void __launch_bounds__(SSD_CB_THREADS)
ssd_cb_kernel(const T* __restrict__ B, const T* __restrict__ C,
              float* __restrict__ cb, int s, int g, int n, int chunk, int nc,
              int ldcb, long long B_sb, long long B_ss, long long B_sg,
              long long C_sb, long long C_ss, long long C_sg, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                       // [T][LDC]: rows i
  float* Bs = Cs + SSD_T * SSD_LDC;       // [T][LDC]: rows j
  int tj = blockIdx.x, ti = 0;            // tile pair of the lower triangle
  while (tj > ti) tj -= ++ti;
  const int c = blockIdx.y, bi = blockIdx.z / g, gi = blockIdx.z % g;
  const int c0 = c * chunk, L = min(chunk, s - c0);
  const int i0 = ti * SSD_T, j0 = tj * SSD_T, np = (n + 7) & ~7;
  stage_tile_f32<SSD_CB_THREADS>(
      Cs, SSD_LDC, C + bi * C_sb + gi * C_sg + (long long)(c0 + i0) * C_ss,
      C_ss, SSD_T, np, L - i0, n, vec);
  stage_tile_f32<SSD_CB_THREADS>(
      Bs, SSD_LDC, B + bi * B_sb + gi * B_sg + (long long)(c0 + j0) * B_ss,
      B_ss, SSD_T, np, L - j0, n, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  const float* Cw = Cs + 16 * warp * SSD_LDC;
#pragma unroll 2
  for (int kk = 0; kk < np; kk += 8) {
    const float* cr = Cw + gq * SSD_LDC + kk + tq;
    const FragA a = frag_a(cr[0], cr[8 * SSD_LDC], cr[4], cr[8 * SSD_LDC + 4]);
    FragB bf[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float* br = Bs + (t * 8 + gq) * SSD_LDC + kk + tq;
      bf[t] = frag_b(br[0], br[4]);
    }
    mma3_row(acc, a, bf);
  }
  // rows past L are zero; the padding columns up to ldcb are written too
  float* out = cb + ((long long)blockIdx.z * nc + c) * chunk * ldcb +
               (long long)i0 * ldcb + j0;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gq + 8 * (e >> 1);
      const int col = t * 8 + 2 * tq + (e & 1);
      if (r < chunk - i0 && col < ldcb - j0) out[r * ldcb + col] = acc[t][e];
    }
}

// One block per (32 columns of p, head, batch) walks the chunks in order:
// S_c = sum_j exp(total_c - cum_j) dt_j B_j x_j^T on the tensor cores, then
// H_{c+1} = exp(total_c) H_c + S_c in registers; H_c (c >= 1) goes to
// scratch for the scan, the last H to the final state.  8 warps, one per
// 16 rows of n.
template <typename T>
__global__ void __launch_bounds__(SSD_STATE_THREADS)
ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ B,
                 const float* __restrict__ cum,
                 const float* __restrict__ dts, float* __restrict__ hs,
                 float* __restrict__ state, int s, int h, int p, int g,
                 int n, int chunk, int nc, int ldh, long long x_sb,
                 long long x_ss, long long x_sh, long long B_sb,
                 long long B_ss, long long B_sg, int vec_x, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  float* wj = smem;                           // [ST][TJ]
  float* Bs = wj + SSD_ST * SSD_TJ;           // [ST][TJ][LDB]
  float* Xs = Bs + SSD_ST * SSD_TJ * SSD_LDB; // [ST][TJ][LDXB]
  const int p0 = blockIdx.x * SSD_PB, hi = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (h / g), pw = min(SSD_PB, p - p0);
  const int np = (n + 7) & ~7, pwp = (pw + 7) & ~7, nt_p = pwp / 8;
  const long long bh = (long long)bi * h + hi;
  const T* xb = x + bi * x_sb + hi * x_sh + p0;
  const T* Bb = B + bi * B_sb + gi * B_sg;
  const int ntc = (chunk + SSD_TJ - 1) / SSD_TJ, ntiles = nc * ntc;

  // tile k: j tile k % ntc of chunk k / ntc, with its weights
  auto stage = [&](int k) {
    const int sg = k % SSD_ST, c = k / ntc, j0 = (k - c * ntc) * SSD_TJ;
    const int L = min(chunk, s - c * chunk);
    const long long pos0 = (long long)c * chunk + j0;
    stage_tile_f32<SSD_STATE_THREADS>(Bs + sg * SSD_TJ * SSD_LDB, SSD_LDB,
                                      Bb + pos0 * B_ss, B_ss, SSD_TJ, np,
                                      L - j0, n, vec_b);
    stage_tile_f32<SSD_STATE_THREADS>(Xs + sg * SSD_TJ * SSD_LDXB, SSD_LDXB,
                                      xb + pos0 * x_ss, x_ss, SSD_TJ, pwp,
                                      L - j0, pw, vec_x);
    const float* cumc = cum + (bh * nc + c) * chunk;
    const float* dtc = dts + (bh * nc + c) * chunk;
    const float total = cumc[chunk - 1];
    for (int j = threadIdx.x; j < SSD_TJ; j += SSD_STATE_THREADS)
      wj[sg * SSD_TJ + j] =
          j0 + j < L ? expf(total - cumc[j0 + j]) * dtc[j0 + j] : 0.f;
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // the warp's rows of S and H (n): 16 warp .. 16 warp + 15
  const int m0 = 16 * warp;
  float acc[SSD_PB / 8][4], hreg[SSD_PB / 8][4];
#pragma unroll
  for (int t = 0; t < SSD_PB / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = hreg[t][e] = 0.f;

  for (int k = 0; k < SSD_ST - 1; ++k) {      // fill the pipeline
    if (k < ntiles) stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    if (k + SSD_ST - 1 < ntiles) stage(k + SSD_ST - 1);
    cp_async_commit();
    cp_async_wait<SSD_ST - 1>();              // tile k has landed
    __syncthreads();
    const int sg = k % SSD_ST;
    const float* Bt = Bs + sg * SSD_TJ * SSD_LDB;
    const float* Xt = Xs + sg * SSD_TJ * SSD_LDXB;
    const float* w = wj + sg * SSD_TJ;
    const int c = k / ntc, j0 = (k - c * ntc) * SSD_TJ;
    const int kmax = min(SSD_TJ, min(chunk, s - c * chunk) - j0);
#pragma unroll 2
    for (int kk = 0; kk < (m0 < n ? kmax : 0); kk += 8) {
      const float w0 = w[kk + tq], w1 = w[kk + tq + 4];
      FragB bf[SSD_PB / 8];
#pragma unroll
      for (int t = 0; t < SSD_PB / 8; ++t) {
        const float* xr = Xt + (kk + tq) * SSD_LDXB + t * 8 + gq;
        bf[t] = frag_b(xr[0], xr[4 * SSD_LDXB]);
      }
      const float* br = Bt + (kk + tq) * SSD_LDB + m0 + gq;
      const FragA a = frag_a(br[0] * w0, br[8] * w0, br[4 * SSD_LDB] * w1,
                             br[4 * SSD_LDB + 8] * w1);
      mma3_row(acc, a, bf, nt_p);
    }
    if (k - c * ntc == ntc - 1) {             // the chunk's last tile
      const float et = expf(cum[(bh * nc + c) * chunk + chunk - 1]);
      const bool fin = c + 1 == nc;
      float* out = fin ? state + bh * n * p + p0
                       : hs + (bh * nc + c + 1) * n * ldh + p0;
      const int ld = fin ? p : ldh;
#pragma unroll
      for (int t = 0; t < SSD_PB / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hreg[t][e] = et * hreg[t][e] + acc[t][e];
          acc[t][e] = 0.f;
          const int r = m0 + gq + 8 * (e >> 1);
          const int col = t * 8 + 2 * tq + (e & 1);
          if (r < n && col < pw) out[r * ld + col] = hreg[t][e];
        }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(SSD_SCAN_THREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ C,
                const float* __restrict__ cum, const float* __restrict__ dts,
                const float* __restrict__ cb, const float* __restrict__ hs,
                T* __restrict__ y, int s, int h, int p, int g, int n,
                int chunk, int nc, int ldcb, int ldh, long long x_sb,
                long long x_ss, long long x_sh, long long C_sb,
                long long C_ss, long long C_sg, int vec_x, int vec_c) {
  extern __shared__ __align__(16) float smem[];
  float* cumc = smem;                         // [CMAX]
  float* dtc = cumc + SSD_CMAX;               // [CMAX]
  float* region = dtc + SSD_CMAX;
  float* Cs = region;                         // phase 1: [TI][LDC]
  float* Hs = Cs + SSD_TI * SSD_LDC;          //          [NMAX][LDX]
  float* CBs = region;                        // phase 2: [2][TI][LDS]
  float* Xs = CBs + 2 * SSD_TI * SSD_LDS;     //          [2][T][LDX]

  const int it = gridDim.x - 1 - blockIdx.x, hi = blockIdx.y;
  const int bi = blockIdx.z / nc, c = blockIdx.z % nc, gi = hi / (h / g);
  const int c0 = c * chunk, L = min(chunk, s - c0), i0 = it * SSD_TI;
  if (i0 >= L) return;
  const long long bhc = ((long long)bi * h + hi) * nc + c;
  for (int j = threadIdx.x; j < SSD_CMAX; j += SSD_SCAN_THREADS) {
    cumc[j] = j < chunk ? cum[bhc * chunk + j] : 0.f;
    dtc[j] = j < chunk ? dts[bhc * chunk + j] : 0.f;
  }
  const T* xb = x + bi * x_sb + hi * x_sh + (long long)c0 * x_ss;
  const float* cbb = cb + ((long long)(bi * g + gi) * nc + c) * chunk * ldcb +
                     (long long)i0 * ldcb;
  const int np = (n + 7) & ~7, pp = (p + 7) & ~7, nt_p = pp / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3, wr = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // ---- incoming state: exp(cum_i) C_i.H_c (H_0 = 0)
  if (c > 0) {
    stage_tile_f32<SSD_SCAN_THREADS>(
        Cs, SSD_LDC, C + bi * C_sb + gi * C_sg + (long long)(c0 + i0) * C_ss,
        C_ss, SSD_TI, np, L - i0, n, vec_c);
    stage_tile<SSD_SCAN_THREADS>(Hs, SSD_LDX, hs + bhc * n * ldh, ldh, np,
                                 pp, n, p, (p & 3) == 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < np; kk += 8) {
      const float* cr = Cs + (wr + gq) * SSD_LDC + kk + tq;
      const FragA a =
          frag_a(cr[0], cr[8 * SSD_LDC], cr[4], cr[8 * SSD_LDC + 4]);
      FragB bf[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float* hr = Hs + (kk + tq) * SSD_LDX + t * 8 + gq;
        bf[t] = frag_b(hr[0], hr[4 * SSD_LDX]);
      }
      mma3_row(acc, a, bf, nt_p);
    }
    const float e0 = expf(cumc[i0 + wr + gq]);
    const float e1 = expf(cumc[i0 + wr + gq + 8]);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      acc[t][0] *= e0;
      acc[t][1] *= e0;
      acc[t][2] *= e1;
      acc[t][3] *= e1;
    }
  }
  __syncthreads();                            // phase 2 reuses the region

  // ---- intra-chunk: tiles j <= i of (CB o exp(cum_i - cum_j) o dt_j) x_j.
  // A 64-wide j tile right of a row's diagonal block holds CB's upper
  // triangle, which the cb kernel leaves unwritten: the j <= i select (and
  // kmax) never reads it.
  auto stage = [&](int jt, int sg) {
    const int j0 = jt * SSD_T;
    stage_tile<SSD_SCAN_THREADS>(CBs + sg * SSD_TI * SSD_LDS, SSD_LDS,
                                 cbb + j0, ldcb, SSD_TI, SSD_T, chunk - i0,
                                 ldcb - j0, true);
    stage_tile_f32<SSD_SCAN_THREADS>(Xs + sg * SSD_T * SSD_LDX, SSD_LDX,
                                     xb + (long long)j0 * x_ss, x_ss, SSD_T,
                                     pp, L - j0, p, vec_x);
  };
  stage(0, 0);
  cp_async_commit();
  const float cum_r0 = cumc[i0 + wr + gq], cum_r1 = cumc[i0 + wr + gq + 8];
  const int nj = (min(L, i0 + SSD_TI) + SSD_T - 1) / SSD_T;  // j tiles to i
  for (int jt = 0; jt < nj; ++jt) {
    if (jt + 1 < nj) stage(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* CBt = CBs + (jt & 1) * SSD_TI * SSD_LDS;
    const float* Xt = Xs + (jt & 1) * SSD_T * SSD_LDX;
    const int j0 = jt * SSD_T;
    // later rows of x are zero; keys past the warp's last row are masked
    const int kmax = min(min(SSD_T, L - j0), i0 + wr + 16 - j0);
#pragma unroll 2
    for (int kk = 0; kk < kmax; kk += 8) {
      float av[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int rr = wr + gq + 8 * (q4 & 1), cc = kk + tq + 4 * (q4 >> 1);
        const int j = j0 + cc;
        av[q4] = j <= i0 + rr ? CBt[rr * SSD_LDS + cc] *
                                    expf((q4 & 1 ? cum_r1 : cum_r0) -
                                         cumc[j]) *
                                    dtc[j]
                              : 0.f;
      }
      const FragA a = frag_a(av[0], av[1], av[2], av[3]);
      FragB bf[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float* xr = Xt + (kk + tq) * SSD_LDX + t * 8 + gq;
        bf[t] = frag_b(xr[0], xr[4 * SSD_LDX]);
      }
      mma3_row(acc, a, bf, nt_p);
    }
    __syncthreads();
  }

  const long long y_ss = (long long)h * p;
  T* yb = y + ((long long)bi * s + c0) * y_ss + (long long)hi * p;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wr + gq + 8 * (e >> 1);
      const int col = t * 8 + 2 * tq + (e & 1);
      if (i < L && col < p) yb[i * y_ss + col] = from_f32<T>(acc[t][e]);
    }
}

// Calls f with null (T*, TD*, TA*) for x's dtype code (0 float32, 1
// bfloat16, 2 float16) and dt's and A's (each float32 or x's type); false
// otherwise.
template <typename F>
bool with_ssd_types(int xcode, int dtcode, int acode, F f) {
  if ((dtcode != 0 && dtcode != xcode) || (acode != 0 && acode != xcode))
    return false;
  auto go = [&](auto* xt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    if (dtcode == 0 && acode == 0) f(xt, (float*)nullptr, (float*)nullptr);
    else if (dtcode == 0) f(xt, (float*)nullptr, (T*)nullptr);
    else if (acode == 0) f(xt, (T*)nullptr, (float*)nullptr);
    else f(xt, (T*)nullptr, (T*)nullptr);
  };
  switch (xcode) {
    case 0: f((float*)nullptr, (float*)nullptr, (float*)nullptr); return true;
    case 1: go((__nv_bfloat16*)nullptr); return true;
    case 2: go((__half*)nullptr); return true;
    default: return false;
  }
}

// The four kernels of one call on x / B / C of type T (y written in T),
// dt of TD and A of TA; every intermediate and the state float32.
template <typename T, typename TD, typename TA>
cudaError_t launch_ssd(const T* x, const TD* dt, const TA* A, const T* B,
                       const T* C, T* y, float* state, float* work, int b,
                       int s, int h, int p, int g, int n, int chunk,
                       long long x_sb, long long x_ss, long long x_sh,
                       long long dt_sb, long long dt_ss, long long dt_sh,
                       long long B_sb, long long B_ss, long long B_sg,
                       long long C_sb, long long C_ss, long long C_sg,
                       cudaStream_t st) {
  const SsdWork w = ssd_work(b, s, h, p, g, n, chunk);
  float* cum = work + w.cum;
  float* dts = work + w.dts;
  float* cbs = work + w.cb;
  float* hs = work + w.hs;
  // 16-byte loads: 16 / sizeof(T) values, so every stride and width a
  // multiple of that
  constexpr int E = 16 / sizeof(T);
  const bool vec_x = aligned16(x) && (x_sb | x_ss | x_sh | p) % E == 0;
  const bool vec_b = aligned16(B) && (B_sb | B_ss | B_sg | n) % E == 0;
  const bool vec_c = aligned16(C) && (C_sb | C_ss | C_sg | n) % E == 0;
  const int nt = (chunk + SSD_T - 1) / SSD_T;
  cudaError_t err;
  const struct {
    const void* fn;
    int bytes;
  } big[] = {{(const void*)ssd_cb_kernel<T>, SSD_CB_FLOATS * 4},
             {(const void*)ssd_state_kernel<T>, SSD_STATE_FLOATS * 4},
             {(const void*)ssd_scan_kernel<T>, SSD_SCAN_FLOATS * 4}};
  for (const auto& k : big) {
    err = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.bytes);
    if (err != cudaSuccess) return err;
  }
  ssd_cumsum_kernel<TD, TA><<<dim3(b * h, w.nc), SSD_CMAX, 0, st>>>(
      dt, A, cum, dts, s, h, chunk, w.nc, dt_sb, dt_ss, dt_sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_cb_kernel<T><<<dim3(nt * (nt + 1) / 2, w.nc, b * g), SSD_CB_THREADS,
                     SSD_CB_FLOATS * 4, st>>>(
      B, C, cbs, s, g, n, chunk, w.nc, w.ldcb, B_sb, B_ss, B_sg, C_sb, C_ss,
      C_sg, (int)(vec_b && vec_c));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_kernel<T><<<dim3((p + SSD_PB - 1) / SSD_PB, h, b),
                        SSD_STATE_THREADS, SSD_STATE_FLOATS * 4, st>>>(
      x, B, cum, dts, hs, state, s, h, p, g, n, chunk, w.nc, w.ldh, x_sb,
      x_ss, x_sh, B_sb, B_ss, B_sg, (int)vec_x, (int)vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_kernel<T><<<dim3((chunk + SSD_TI - 1) / SSD_TI, h, b * w.nc),
                       SSD_SCAN_THREADS, SSD_SCAN_FLOATS * 4, st>>>(
      x, C, cum, dts, cbs, hs, y, s, h, p, g, n, chunk, w.nc, w.ldcb, w.ldh,
      x_sb, x_ss, x_sh, C_sb, C_ss, C_sg, (int)vec_x, (int)vec_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y (rows, d) of x's dtype code, scale (d,) of its own (see rmsnorm
// above: 0 float32, 1 bfloat16, 2 float16; scale float32 or x's type)
int repro_rmsnorm(const void* x, const void* scale, void* y, long long rows,
                  int d, float eps, int xcode, int scode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = aligned16(x) && aligned16(y);
  const bool known = with_rms_types(xcode, scode, [&](auto* xt, auto* stt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using S = std::remove_pointer_t<decltype(stt)>;
    if (rows > 0 && d > 0)
      launch_rmsnorm<T, S>(static_cast<const T*>(x),
                           static_cast<const S*>(scale), static_cast<T*>(y),
                           rows, d, eps, vec, st);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// blocks a group of repro_rmsnorm_backward takes for these sizes (its
// workspace holds groups x blocks x d floats); -1 for unknown dtype codes
int repro_rmsnorm_backward_blocks(long long rows, int d, int groups,
                                  int xcode, int scode) {
  int blocks = -1;
  with_rms_types(xcode, scode, [&](auto* xt, auto* stt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using S = std::remove_pointer_t<decltype(stt)>;
    blocks = rms_bwd_blocks<T, S>(rows, d, groups, true);
  });
  return blocks;
}

// groups of `rows` rows each: x, dy, dx (groups * rows, d), scale (d,) or,
// with scale_grouped, (groups, d); dscale (groups, d) in scale's type; work
// groups * blocks * d floats (blocks from repro_rmsnorm_backward_blocks).
// Two kernels: the rows, then dscale's sum over the blocks.
int repro_rmsnorm_backward(const void* x, const void* scale, const void* dy,
                           void* dx, void* dscale, float* work,
                           long long rows, int d, int groups, int blocks,
                           int scale_grouped, float eps, int xcode,
                           int scode, void* stream) {
  if (d <= 0 || groups <= 0) return 0;
  if (rows < 0 || blocks < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = aligned16(x) && aligned16(dy) && aligned16(dx);
  cudaError_t err = cudaSuccess;
  const bool known = with_rms_types(xcode, scode, [&](auto* xt, auto* stt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using S = std::remove_pointer_t<decltype(stt)>;
    err = launch_rmsnorm_bwd<T, S>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<S*>(dscale),
        work, rows, d, groups, blocks, scale_grouped ? d : 0, eps, vec, st);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)err;
}

int repro_flash_attention_hopper(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int b, int sq, int sk,
                                 int h, int kv, int d, long long q_sb,
                                 long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss,
                                 long long k_sh, long long v_sb,
                                 long long v_ss, long long v_sh, int causal,
                                 int window, float scale, int code,
                                 void* stream);

// q (b, sq, h, d), k / v (b, sk, kv, d) read through their strides, o a
// contiguous (b, sq, h, d), all of one dtype code (0 float32, 1 bfloat16,
// 2 float16); lse a contiguous float32 (b, h, sq), each row's log-sum-exp
// of its scaled scores (+inf for a row with no visible key), written on
// every call.  route 1 is the Hopper kernel (flash_hopper.cu), which
// refuses what it does not take; route 0 the mma.sync kernel here
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, float* lse, int b, int sq, int sk, int h,
                          int kv, int d, long long q_sb, long long q_ss,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, int causal, int window, float scale,
                          int code, int route, void* stream) {
  if (route == 1)
    return repro_flash_attention_hopper(q, k, v, o, lse, b, sq, sk, h, kv, d,
                                        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                        v_sb, v_ss, v_sh, causal, window,
                                        scale, code, stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case 0:
      return launch_flash_d<float>(q, k, v, o, lse, b, sq, sk, h, kv, d, q_sb,
                                   q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                   v_sh, causal, window, scale, st);
    case 1:
      return launch_flash_d<__nv_bfloat16>(q, k, v, o, lse, b, sq, sk, h, kv,
                                           d, q_sb, q_ss, q_sh, k_sb, k_ss,
                                           k_sh, v_sb, v_ss, v_sh, causal,
                                           window, scale, st);
    case 2:
      return launch_flash_d<__half>(q, k, v, o, lse, b, sq, sk, h, kv, d,
                                    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                    v_ss, v_sh, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int repro_flash_attention_backward_hopper(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int b,
    int sq, int sk, int h, int kv, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    int code, void* stream);

// The gradient of repro_flash_attention: q and dout (b, sq, h, d), k and v
// (b, sk, kv, d) read through their strides (the trailing dim contiguous),
// lse the forward's (b, h, sq) float32, delta a (b, h, sq) float32 scratch
// (D); dq (b, sq, h, d) and dk / dv (b, sk, kv, d) contiguous, all of one
// dtype code (0 float32, 1 bfloat16, 2 float16).  route 1 is the Hopper
// kernels (flash_hopper_bwd.cu: dq and D, then dk / dv), which refuse what
// they do not take; route 0 the mma.sync kernels here, three launches: D,
// then dk / dv, then dq.
int repro_flash_attention_backward(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int b, int sq, int sk,
                                   int h, int kv, int d, long long q_sb,
                                   long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss,
                                   long long o_sh, int causal, int window,
                                   float scale, int code, int route,
                                   void* stream) {
  if (route == 1)
    return repro_flash_attention_backward_hopper(
        q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kv, d, q_sb,
        q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
        causal, window, scale, code, stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || (sq <= 0 && sk <= 0)) return 0;
  if (kv <= 0 || h % kv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FB_D(T)                                                        \
  launch_flash_bwd_d<T>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h, \
                        kv, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,     \
                        v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, scale, \
                        st)
  switch (code) {
    case 0: return REPRO_FB_D(float);
    case 1: return REPRO_FB_D(__nv_bfloat16);
    case 2: return REPRO_FB_D(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FB_D
}

// floats of scratch that repro_ssd_chunk_scan needs for these sizes
long long repro_ssd_workspace_floats(int b, int s, int h, int p, int g,
                                     int n, int chunk) {
  if (b <= 0 || s <= 0 || h <= 0 || chunk < 1) return 0;
  return ssd_work(b, s, h, p, g, n, chunk).total;
}

// x, B, C (and y) of one dtype code (0 float32, 1 bfloat16, 2 float16),
// dt and A each float32 or x's type; state and work float32
int repro_ssd_chunk_scan(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, float* state,
                         float* work, int b, int s, int h, int p, int g,
                         int n, int chunk, long long x_sb, long long x_ss,
                         long long x_sh, long long dt_sb, long long dt_ss,
                         long long dt_sh, long long B_sb, long long B_ss,
                         long long B_sg, long long C_sb, long long C_ss,
                         long long C_sg, int xcode, int dtcode, int acode,
                         void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (p > SSD_PMAX || n > SSD_NMAX || chunk > SSD_CMAX || chunk < 1 ||
      g < 1 || h % g)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (s <= 0)
    return (int)cudaMemsetAsync(state, 0, sizeof(float) * b * h * n * p, st);
  cudaError_t err = cudaErrorInvalidValue;
  with_ssd_types(xcode, dtcode, acode, [&](auto* xt, auto* dtt, auto* at) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TD = std::remove_pointer_t<decltype(dtt)>;
    using TA = std::remove_pointer_t<decltype(at)>;
    err = launch_ssd<T, TD, TA>(
        static_cast<const T*>(x), static_cast<const TD*>(dt),
        static_cast<const TA*>(A), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<T*>(y), state, work, b, s, h, p,
        g, n, chunk, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sg,
        C_sb, C_ss, C_sg, st);
  });
  return (int)err;
}

}  // extern "C"
