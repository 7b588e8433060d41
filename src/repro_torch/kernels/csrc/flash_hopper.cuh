// Pieces shared by flash attention's Hopper kernels (sm_90a): the forward
// (flash_hopper.cu) and the backward (flash_hopper_bwd.cu).  On the device:
// 16-bit packing and the hi / lo split of float32 values, mbarriers, TMA
// loads of 4-D tensor maps, 128-byte-swizzle shared-memory descriptors and
// the wgmma instructions (m64n128k16 and m64n64k16, with both operands in
// shared memory or A in registers), the operand descriptors of a tile laid
// out as TMA boxes of 64 columns, p by ex2.approx.ftz and the masks by
// per-row limits.  On the host: cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, and the 4-D tensor map over a (b, s, heads, d)
// tensor read through its strides (d 64, 128 or 256: one, two or four
// boxes a row).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // reached through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int FH_BOX = 64;            // columns a TMA box: 128 bytes
constexpr int FH_ROW = FH_BOX * 2;    // bytes a swizzled row of a box
constexpr float FH_LOG2E = 1.4426950408889634f;
constexpr float FH_LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a and b rounded to T (to nearest even) in one register, a in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __half2 r = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

// the two T values of a register, as float32 (exact)
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return make_float2(__uint_as_float(r << 16),
                       __uint_as_float(r & 0xffff0000u));
  else
    return __half22float2(*reinterpret_cast<const __half2*>(&r));
}

// p0, p1 -> (hi, lo) registers of two T values each, p ~ hi + lo: hi =
// T(p), lo = T(p - hi) (p - hi is exact), lm.cu's split_pair with each pair
// converted by one packed instruction
template <typename T>
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack2<T>(p0, p1);
  const float2 h = unpack2<T>(hi);
  lo = pack2<T>(p0 - h.x, p1 - h.y);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects ``bytes`` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// a shared-memory matrix descriptor for the 128-byte swizzle: the start
// address, LBO and SBO in 16-byte units, layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins registers at this point of the program, so the compiler moves no
// read or write of an asynchronous wgmma's operands across a fence / wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define FH_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define FH_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define FH_ACC8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FH_ACC32(d)                                                        \
  FH_ACC8(d, 0), FH_ACC8(d, 8), FH_ACC8(d, 16), FH_ACC8(d, 24)
#define FH_ACC64(d)                                                        \
  FH_ACC8(d, 0), FH_ACC8(d, 8), FH_ACC8(d, 16), FH_ACC8(d, 24),            \
      FH_ACC8(d, 32), FH_ACC8(d, 40), FH_ACC8(d, 48), FH_ACC8(d, 56)
// both operands in shared memory, K-major; scale-d 0 overwrites d
#define FH_WGMMA_SS(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY    \
               " " FH_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                \
               : FH_ACC64(d)                                               \
               : "l"(da), "l"(db), "r"(accumulate))
#define FH_WGMMA_SS64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " " FH_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                \
               : FH_ACC32(d)                                               \
               : "l"(da), "l"(db), "r"(accumulate))
// A from registers, B MN-major in shared memory (transpose bit 1)
#define FH_WGMMA_RS(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY    \
               " " FH_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
               : FH_ACC64(d)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1))
#define FH_WGMMA_RS64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " " FH_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
               : FH_ACC32(d)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1))

// d (64 x 128) (+)= A (64 x 16, shared) . B (16 x 128, shared)
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    FH_WGMMA_SS("bf16");
  else
    FH_WGMMA_SS("f16");
}

// d (64 x 64) (+)= A (64 x 16, shared) . B (16 x 64, shared)
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    FH_WGMMA_SS64("bf16");
  else
    FH_WGMMA_SS64("f16");
}

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    FH_WGMMA_RS("bf16");
  else
    FH_WGMMA_RS("f16");
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    FH_WGMMA_RS64("bf16");
  else
    FH_WGMMA_RS64("f16");
}

// A tile of ``rows`` rows by d columns lies as d / 64 TMA boxes of 64
// columns, each rows * 128 bytes after the one before.  As a K-major
// operand (the contraction over d), step kk of 16 columns starts 32 bytes
// further inside the swizzle's 128-byte rows, or in the next box; SBO: 8
// rows of 128 bytes
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + (kk >> 2) * (rows * FH_ROW) + (kk & 3) * 32, 16,
                    8 * FH_ROW);
}

// the same tile as the MN-major B operand of a contraction over its rows
// (n = d, the transpose bit of 16-bit B): step kk of 16 rows; LBO: the
// next box (64 columns on), SBO: 8 rows.  ``base`` may start at any box
// (an N of 128 from box 2: columns 128-255)
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + kk * 16 * FH_ROW, rows * FH_ROW, 8 * FH_ROW);
}

// 2^x on the multi-function unit (ex2.approx: 2 ulp), a result below
// 2^-126 flushed to 0, 2^-inf = 0: exp2f's handling of subnormal results
// cost a fifth of the backward's dQ kernel time, and a flushed p moves no
// output or gradient by more than 2^-126 of a term
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// column offsets past every tile: a row with no visible column
constexpr int FH_NONE = 1 << 30;

// -inf (p = 0) into the accumulator x (64 x N per warpgroup) where the
// column offset 8j + (e & 1) of value 4j + e lies outside [lo, hi] of its
// row (e >> 1): two compares with a constant a value
template <int N>
__device__ __forceinline__ void mask_acc(float (&x)[N], const int (&lo)[2],
                                         const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + (e & 1), r = e >> 1;
      if (col < lo[r] || col > hi[r]) x[4 * j + e] = -INFINITY;
    }
}

// a tile of ``rows`` rows by BOXES x 64 columns into shared memory, one
// TMA box of 64 columns after another, completing on ``bar``
template <int BOXES>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int row,
                                         int head, int batch) {
#pragma unroll
  for (int x = 0; x < BOXES; ++x)
    tma_load(dst + x * rows * FH_ROW, map, bar, x * FH_BOX, row, head, batch);
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over (d, s, heads, b) of a 16-bit tensor read through its
// element strides, boxes of 64 columns by ``rows``, 128-byte swizzle, rows
// out of bounds zero-filled: a row of d columns is d / 64 boxes.  A
// dimension of extent 1 is never stepped, so its stride is given as 16
// bytes (TMA wants multiples of 16).
bool make_map(CUtensorMap* map, EncodeTiled enc, CUtensorMapDataType type,
              const void* ptr, int d, int s, int heads, int b, long long ss,
              long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)b};
  const long long el[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)(2 * el[i]);
  const cuuint32_t box[4] = {(cuuint32_t)FH_BOX, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace
