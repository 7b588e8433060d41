// Cut-boundary codec for Hopper (sm_90a): five kernels with a plain C
// interface, loaded with ctypes by repro_torch/kernels/_build.py.
//
// They replace the Pallas TPU kernels of the JAX package:
//   repro_quantize_int8      <- repro/kernels/quant.py  _quant_kernel
//   repro_dequantize_int8    <- repro/kernels/quant.py  _dequant_kernel
//   repro_sparsify_quant_pack<- repro/kernels/wire.py   _pack_kernel/_pack_tile
//   repro_unpack_dequant     <- repro/kernels/wire.py   _unpack_dequant_kernel
//   repro_unpack_dequant_matmul <- repro/kernels/wire.py _unpack_matmul_kernel
//
// C interface.  One entry point per function; each takes, before the
// stream, a dtype code for its floating-point tensor: 0 float32, 1
// bfloat16, 2 float16 (any other code returns cudaErrorInvalidValue and
// launches nothing).  The code names x's type for quantize_int8 and
// sparsify_quant_pack, the output's for dequantize_int8 and
// unpack_dequant, and w's for unpack_dequant_matmul; int8 values, scales,
// wire words and kernel 5's output are always int8 / float32 / int32 /
// float32.  As the reference's kernels do, every kernel widens a 2-byte
// input to f32 exactly when it reads it (a bf16 or f16 NaN is an f32 NaN),
// so q, scales and words are those of x.float(), and computes every
// product in f32; a decoder rounds its f32 product once to its output type,
// to nearest even (__float2bfloat16_rn / __float2half_rn), as XLA's astype
// does.  Kernel 5 copies w's raw bytes to shared memory and widens them
// there: its accumulation, and so its f32 output for a given f32 w, is
// that of the f32 kernel.
//
// The first four are memory-bound: a few integer/float operations per byte moved.
// On the TPU a tile of (block_rows, g) lived in VMEM; here a group (g <=
// 128) never leaves registers / a small per-warp shared-memory row.
// Quantize gives a group W lanes, 4 consecutive values a lane (W = 32 at
// g = 128, 16 at g = 64), so a warp holds 32/W groups, on a 2-D (lanes,
// rows) grid; the pack kernel one warp per group.  Reductions (amax,
// bitmap, survivor slot) are warp shuffles, ballots and popcounts, so no
// block-level synchronisation is needed.  The pack kernel's exactly-k top-k
// is a radix select over the bits of |x| by warp ballots (~31 ballot steps
// per slot at most, not a comparison against every value of the group).
// Dequantize gives a thread 4 consecutive int8 of one group (one 4-byte
// load beside its scale's, one 16- or 8-byte store).  Unpack
// and the fused matmul (kernel 5) share one decode: a warp reads its group's
// words with one coalesced load and decodes them by shuffles and popcounts.
// Kernel 5 copies its w slab with cp.async while its warps decode, then
// sums slab @ w-slab on CUDA cores in register patches.
//
// Bit-exactness with the JAX reference: the scale is max(amax, 1e-8f)
// times f32(1/127) (a multiply), q = rintf(x / scale) with IEEE division and
// round-half-to-even.  Build WITHOUT --use_fast_math: fast math turns the
// division into an approximate reciprocal and the words stop matching.
//
// Non-finite input follows the reference too: the amax and the max with
// 1e-8 keep a NaN (max.NaN, where fmaxf would drop it), so a group holding a
// NaN has a NaN scale and one holding +-inf an inf scale; a NaN quotient
// (NaN scale, inf / inf) quantises to 0, as XLA casts it; in the top-k a NaN
// is beaten by nothing and beats nothing, so it takes no part in the select
// and survives beside the k winners, its value slot >= k dropped; and
// unpack writes q x scale everywhere, q = 0 off the mask, so such a group
// decodes to NaN (in kernel 5 its survivors make the output row NaN).  NaN
// payloads are not kept.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = 32 * WARPS_PER_BLOCK;
constexpr int MAX_G = 128;               // GROUP: at most 4 values per lane
constexpr int DQ_THREADS = 256;          // dequantize: threads per block
constexpr int Q_THREADS = 256;           // quantize: threads per block
constexpr int MAX_T = MAX_G / 32;

// ---------------------------------------------- element types (see header)
// f32 <-> the 2-byte types' bits: widening is exact, narrowing rounds to
// nearest even.
template <typename T>
__device__ __forceinline__ float bits_to_f32(unsigned b);
template <>
__device__ __forceinline__ float bits_to_f32<__nv_bfloat16>(unsigned b) {
  return __uint_as_float(b << 16);
}
template <>
__device__ __forceinline__ float bits_to_f32<__half>(unsigned b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}
template <typename T>
__device__ __forceinline__ unsigned f32_to_bits(float v);
template <>
__device__ __forceinline__ unsigned f32_to_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ unsigned f32_to_bits<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *p;
  } else {
    return bits_to_f32<T>(*reinterpret_cast<const unsigned short*>(p));
  }
}

template <typename T>
__device__ __forceinline__ void store1(T* p, float v) {
  if constexpr (sizeof(T) == 4) {
    *p = v;
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)f32_to_bits<T>(v);
  }
}

// 4 consecutive values, one load (16 bytes f32, 8 bytes bf16 / f16; p
// aligned to that)
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = bits_to_f32<T>(u.x & 0xffffu);
    v[1] = bits_to_f32<T>(u.x >> 16);
    v[2] = bits_to_f32<T>(u.y & 0xffffu);
    v[3] = bits_to_f32<T>(u.y >> 16);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(f32_to_bits<T>(a) | f32_to_bits<T>(b) << 16,
                   f32_to_bits<T>(c) | f32_to_bits<T>(d) << 16);
  }
}

__device__ __forceinline__ float inv127() {
  return (float)(1.0 / 127.0);
}

// max that keeps a NaN (PTX max.NaN, sm_80+), as jnp.max / jnp.maximum do
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float group_scale(float amax) {
  return max_nan(amax, 1e-8f) * inv127();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max_nan(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int quant_value(float x, float scale) {
  const float r = rintf(x / scale);
  if (r != r) return 0;                   // NaN quotient: 0, as XLA casts it
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// ---------------------------------------------------------------- quantize
// A group takes W lanes, W = the next power of two of ceil(g/4) (32 at
// g = 128, 16 at 64 or 48, 8 at 32), and segment lane s holds the group's
// values 4s .. 4s+3, so a warp holds 32/W groups.  The grid is 2-D: x over
// a row's ng*W lanes (group j = lane / W, a shift), y over rows,
// grid-striding past 65,535; the row loop's trip count is the block's, so
// every warp reaches the shuffles whole.  The host makes the block a
// multiple of W lanes wide (no segment straddles two rows) and of 32
// threads (whole warps).  VEC (d and g multiples of 4, x aligned to 4
// values, q to 4 bytes): one 16-byte (f32) or 8-byte (bf16 / f16) load a
// lane and one 32-bit store of its 4 int8, so a warp's load covers 512 or
// 256 contiguous bytes and its store 128; else 4 one-value loads and byte
// stores.  The amax is a max.NaN shuffle reduction over the segment, or at
// W = 32 one redux.sync (measured 4 % faster at the g = 128 cut shapes;
// redux per segment, 32/W of them, gained 1-2 % at W = 16: not taken).
// Values past g, past d (a padded tail group), lanes past ng (a padded
// block) and rows past `rows` read 0 and store nothing; the segment's
// first lane stores the scale.
template <typename T, int W, bool VEC>
__global__ void quantize_int8_kernel(const T* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales,
                                     long long rows, int d, int g, int ng) {
  const unsigned lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = (int)(lane / W);
  const int i = 4 * (int)(lane % W);      // first value in the group
  const int col = j * g + i;
  const bool in_group = j < ng && i < g && col < d;
  for (long long r0 = (long long)blockIdx.y * blockDim.y; r0 < rows;
       r0 += (long long)gridDim.y * blockDim.y) {
    const long long r = r0 + threadIdx.y;
    const bool live = r < rows && in_group;
    const long long e = r * d + col;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (VEC) {
      if (live) load4(x + e, v);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (live && i + t < g && col + t < d) v[t] = load1(x + e + t);
    }
    float amax = max_nan(max_nan(fabsf(v[0]), fabsf(v[1])),
                         max_nan(fabsf(v[2]), fabsf(v[3])));
    if constexpr (W == 32) {
      // one group a warp: one redux.sync.max over the bits of |x|, which
      // order as the values do, a NaN's above +inf's (so it is max.NaN)
      amax = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(amax)));
    } else {
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        amax = max_nan(amax, __shfl_xor_sync(FULL, amax, off));
    }
    const float scale = group_scale(amax);
    if (live) {
      if constexpr (VEC) {
        const unsigned word = (unsigned)(quant_value(v[0], scale) & 0xff) |
                              (unsigned)(quant_value(v[1], scale) & 0xff)
                                  << 8 |
                              (unsigned)(quant_value(v[2], scale) & 0xff)
                                  << 16 |
                              (unsigned)(quant_value(v[3], scale) & 0xff)
                                  << 24;
        *reinterpret_cast<unsigned*>(q + e) = word;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (i + t < g && col + t < d)
            q[e + t] = (int8_t)quant_value(v[t], scale);
      }
      if (i == 0) scales[r * ng + j] = scale;
    }
  }
}

// -------------------------------------------------------------- dequantize
// A thread owns a run of V consecutive int8 of one group in one row.  The
// grid is 2-D, x over a row's runs and y over rows, so the row, the run and
// its group (one 32-bit divide) come from the thread index, and the scale's
// load is in flight beside the run's.  V = 4 when d and g are multiples of
// 4, q is 4-byte and x aligned to 4 values: one 4-byte load and one
// 16-byte (f32) or 8-byte (bf16 / f16) store, so each of a warp's load and
// store instructions covers 128 and 512 (256) contiguous bytes; else V = 1.
// (Sixteen int8 a thread, one 16-byte load and four float4 stores at a
// 64-byte lane stride, measured slower at every cut shape.)  The product
// is f32, rounded once to T.  Zero bytes are multiplied too: 0 x NaN is
// NaN.
template <typename T, int V>
__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       T* __restrict__ x, long long rows,
                                       int d, int g, int ng) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= d) return;
  const int j = col / g;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < rows; r += (long long)gridDim.y * blockDim.y) {
    const long long e = r * d + col;
    const float s = __ldg(scales + r * ng + j);
    if constexpr (V == 4) {
      const int u = __ldg(reinterpret_cast<const int*>(q + e));
      store4(x + e, (float)(int8_t)u * s, (float)(int8_t)(u >> 8) * s,
             (float)(int8_t)(u >> 16) * s, (float)(int8_t)(u >> 24) * s);
    } else {
      store1(x + e, (float)q[e] * s);
    }
  }
}

// -------------------------------------------------- sparsify + quant + pack
// One warp per group; lane l holds values i = l + 32 t, t < NT = ceil(g/32)
// (NT is a template parameter, so a g = 64 group loops over two slots).
// Survivors: element i survives when fewer than k elements beat it (|x_j| >
// |x_i|, or equal with j < i).  Found by an exact radix select with warp
// ballots, not by ranking each value against the whole group:
//  1. key = bits of |x| as uint32 (the sign bit cleared), which order as
//     the values do for every non-negative float, +0 and subnormals
//     included; lanes with i >= g hold no key and ballot 0.  A NaN lane
//     (bits above +inf's) holds key 0, which no candidate below reaches,
//     takes no part in the ties at T, and sets its bit unconditionally:
//     the reference's NaN is beaten by nothing and beats nothing;
//  2. T = the largest t with #(key >= t) >= k, i.e. the k-th largest key,
//     set bit by bit from bit 30 down (one compare per held value, one
//     ballot per slot and popcounts a bit); once #(key >= candidate) == k
//     those k keys are the survivors and the descent stops; with fewer
//     than k keys T stays 0 and every key survives;
//  3. keys > T survive; a key == T survives iff #(key > T) plus its rank
//     among the equal keys in index order (popcounts of the earlier slots'
//     `eq` ballots and of its own ballot below its lane) is < k.
// Padded tail columns (col >= d, i < g) are zeros ranked at their own
// indices, as the plain version pads them.  Bitmap word t is the ballot of
// the survivors of slot t; a survivor's value slot is the popcount of
// earlier ballots plus popc(ballot & lanemask_lt).  Survivors at slots < k
// drop their int8 into a per-warp shared byte row (a NaN beside the k
// winners has a slot >= k and writes nothing), and the first ceil(k/4)
// lanes assemble one little-endian value word each.
template <typename T, int NT>
__global__ void sparsify_quant_pack_kernel(const T* __restrict__ x,
                                           int32_t* __restrict__ buf,
                                           long long n_groups, int d, int g,
                                           int ng, int k, int wpg) {
  __shared__ int8_t s_val[WARPS_PER_BLOCK][32 * NT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long grp = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (grp >= n_groups) return;            // whole warp exits together
  const long long row = grp / ng;
  const int j = (int)(grp % ng);
  const T* xr = x + row * d;
  const int vw = (k + 3) / 4;

  float v[NT];
  unsigned key[NT];
  bool live[NT];
  bool nan[NT];
  float amax = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int i = lane + 32 * t;
    const int col = j * g + i;
    live[t] = i < g;
    v[t] = (live[t] && col < d) ? load1(xr + col) : 0.0f;   // tail pad: 0
    const unsigned bits = __float_as_uint(v[t]) & 0x7fffffffu;
    nan[t] = bits > 0x7f800000u;
    key[t] = nan[t] ? 0u : bits;          // below every candidate (>= 1)
    amax = max_nan(amax, fabsf(v[t]));
    s_val[warp][i] = 0;
  }
  amax = warp_max(amax);
  const float scale = group_scale(amax);

  unsigned thr = 0;                       // every key >= 0
  for (int b = 30; b >= 0; --b) {
    const unsigned cand = thr | (1u << b);
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      cnt += __popc(__ballot_sync(FULL, live[t] && key[t] >= cand));
    if (cnt >= k) {                       // warp-uniform
      thr = cand;
      if (cnt == k) break;
    }
  }
  unsigned eq[NT];
  int ahead = 0;                          // #(key > T), then ties before
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    ahead += __popc(__ballot_sync(FULL, live[t] && key[t] > thr));
    eq[t] = __ballot_sync(FULL, live[t] && !nan[t] && key[t] == thr);
  }
  const unsigned lt = (1u << lane) - 1u;
  unsigned ballots[NT];
  bool keep[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    // bitwise, not short-circuit: no branch around the ties' rank
    const bool first_k = ahead + __popc(eq[t] & lt) < k;
    keep[t] = nan[t] | (live[t] & ((key[t] > thr) | ((key[t] == thr) &
                                                     first_k)));
    ahead += __popc(eq[t]);
    ballots[t] = __ballot_sync(FULL, keep[t]);
  }
  __syncwarp();                           // s_val zeroed before the drops
  int before = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int slot = before + __popc(ballots[t] & lt);
    if (keep[t] && slot < k)
      s_val[warp][slot] = (int8_t)quant_value(v[t], scale);
    before += __popc(ballots[t]);
  }
  __syncwarp();

  int32_t* out = buf + grp * wpg;
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (lane == t) out[t] = (int32_t)ballots[t];
  if (lane == 0) out[NT] = __float_as_int(scale);
  if (lane < vw) {
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int slot = 4 * lane + b;
      const unsigned byte =
          slot < k ? (unsigned)(uint8_t)s_val[warp][slot] : 0u;
      word |= byte << (8 * b);
    }
    out[NT + 1 + lane] = (int32_t)word;
  }
}

// --------------------------------------------------------- unpack + dequant
// Decode of one packed group, shared by unpack_dequant and kernel 5.  Lane
// l holds the group's words l (lo) and l + 32 (hi; wpg <= 37), read with
// one coalesced load, so nothing below waits on another global load: the
// scale and bitmap word t come by __shfl_sync, value i = lane + 32 t gets
// its slot from popcounts of the bitmap words, and its value word by
// __shfl_sync.  store(t, q x scale) for t < bw, with q the sign-extended
// byte on the mask at slots < k and 0 elsewhere: the reference's product
// (a group with a NaN or inf scale decodes to NaN).  Kernel 5 passes
// ZERO_X_SCALE false and takes 0 for q = 0: a NaN or inf scale makes its
// survivors, and so its output row, NaN all the same, and the product
// measured 2-12 % slower in its wide tiles.  The store is a callable, so
// the values stay in registers.
template <bool ZERO_X_SCALE, typename Store>
__device__ __forceinline__ void decode_group(int lo, int hi, int bw, int k,
                                             int lane, Store store) {
  const float scale = __int_as_float(__shfl_sync(FULL, lo, bw));
  const float zero = ZERO_X_SCALE ? 0.0f * scale : 0.0f;   // q = 0
  const unsigned lt = (1u << lane) - 1u;
  int before = 0;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= bw) break;                   // warp-uniform
    const unsigned bits = (unsigned)__shfl_sync(FULL, lo, t);
    const int slot = before + __popc(bits & lt);
    const int widx = bw + 1 + (slot >> 2);
    const int wlo = __shfl_sync(FULL, lo, widx & 31);
    const int whi = __shfl_sync(FULL, hi, widx & 31);
    const unsigned word = (unsigned)(widx < 32 ? wlo : whi);
    float v = zero;
    if (((bits >> lane) & 1u) && slot < k)
      v = (float)(int8_t)((word >> (8 * (slot & 3))) & 0xFFu) * scale;
    store(t, v);
    before += __popc(bits);
  }
}

// The group's words lane and lane + 32 (0 past wpg, and when !ok).
__device__ __forceinline__ void load_group(const int32_t* in, int wpg,
                                           int lane, bool ok, int& lo,
                                           int& hi) {
  lo = ok && lane < wpg ? __ldg(in + lane) : 0;
  hi = ok && lane + 32 < wpg ? __ldg(in + lane + 32) : 0;
}

// One warp per group; lane l stores columns j*g + l + 32 t (coalesced), only
// those < d.  With no padded group (d == ng*g) the group starts at grp * g
// and no division is needed.
template <typename T>
__global__ void unpack_dequant_kernel(const int32_t* __restrict__ buf,
                                      T* __restrict__ x,
                                      long long n_groups, int d, int g,
                                      int ng, int k, int wpg) {
  const int lane = threadIdx.x & 31;
  const long long grp =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (grp >= n_groups) return;            // whole warp exits together
  int lo, hi;
  load_group(buf + grp * wpg, wpg, lane, true, lo, hi);
  long long first = grp * g;              // the group's first element
  int cols = g;                           // its columns < d
  if (d != ng * g) {
    const long long row = grp / ng;
    const int j = (int)(grp - row * ng);
    first = row * d + (long long)j * g;
    cols = min(g, d - j * g);
  }
  decode_group<true>(lo, hi, (g + 31) / 32, k, lane, [&](int t, float v) {
    const int i = lane + 32 * t;
    if (i < cols) store1(x + first + i, v);
  });
}

// ------------------------------------ unpack + dequant fused into a matmul
// out (rows, n) = dense(buf) (rows, d) @ w (d, n), where dense(buf) is the
// received topk_int8 wire (rows, ng*wpg) and never exists in device memory.
// A block of 128 threads owns an R x MM_COLS output tile, R = 8 * RT rows;
// each thread an RT-row x 4-column register patch.  The host picks 16 rows
// (RT = 2) when that still gives every SM a block, else 8 rows: the
// scenario path's 8 or 16 rows leave no tile row idle, and many rows get
// 2 x 4 patches.
//
// Per group j, in order, nothing waits on a chain of dependent loads:
//  - w rows j*g .. j*g+g-1 of the tile's columns go to shared memory as
//    they are (T: f32, bf16 or f16) by cp.async (16-byte copies when n and
//    w allow, else 4-byte ones for f32 and plain 2-byte copies; zero past
//    d, as the reference pads w, and past n), issued before anything else
//    and, for the next group, while this group computes (two buffers when
//    ng > 1);
//  - each warp reads its rows' group words with one coalesced load per row
//    (lane l holds word l and word l + 32; wpg <= 37), issued with the
//    copy, and decode them as unpack_dequant does (decode_group) into a
//    g x R f32 slab in shared memory (rows past `rows` are not decoded;
//    their outputs are not written);
//  - after one barrier every thread sums slab @ w-slab over the g positions
//    in order with fmaf, w widened to f32 as it is read, and adds the
//    partial to its accumulator, the reference's group-by-group order.
//
// Bound on H100: bytes at the main path's shapes (rows 8-16, d = n = 64:
// ~20 KB moved against 0.13 Mflop), operations for wide rows; at the
// path's shapes one block, so its time is the latency of one word load,
// one shuffle decode, one barrier and g fmaf steps.  No tensor cores: the
// path's product is 65 kflop.
constexpr int MM_COLS = 64;
constexpr int MM_THREADS = 128;          // 8 row groups x 16 column quads
constexpr int MM_WARPS = MM_THREADS / 32;

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// RT consecutive floats of shared memory (8 / 4-byte aligned)
template <int RT>
__device__ __forceinline__ void load_rt(float (&a)[RT], const float* p) {
  if constexpr (RT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  } else {
    a[0] = *p;
  }
}

// slab row stride: 16-byte rows, and a warp's decode stores spread over
// 8 banks
__host__ __device__ constexpr int mm_slab_stride(int rt) {
  return 8 * rt + 4;
}

// shared bytes: nbuf w slabs of T, then the f32 decode slab
__host__ __device__ constexpr int mm_smem_bytes(int rt, int g, int nbuf,
                                                int wbytes) {
  return nbuf * g * MM_COLS * wbytes + 4 * g * mm_slab_stride(rt);
}

template <typename T, int RT>
__global__ void __launch_bounds__(MM_THREADS)
unpack_dequant_matmul_kernel(const int32_t* __restrict__ buf,
                             const T* __restrict__ w,
                             float* __restrict__ out, long long rows, int d,
                             int n, int g, int ng, int k, int wpg, int vec) {
  constexpr int R = 8 * RT;              // tile rows
  constexpr int RPW = R / MM_WARPS;      // rows each warp decodes
  constexpr int SL = mm_slab_stride(RT);
  constexpr int CP = 16 / sizeof(T);     // values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);   // [nbuf][g][MM_COLS]
  float* s_slab = reinterpret_cast<float*>(
      smem + (ng > 1 ? 2 : 1) * g * MM_COLS * sizeof(T));   // [g][SL]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * R;
  const int col0 = blockIdx.y * MM_COLS;
  const int ncols = min(MM_COLS, n - col0);
  const int tr = (tid >> 4) * RT;        // first tile row of this thread
  const int tc = 4 * (tid & 15);         // first tile column of this thread
  const int bw = (g + 31) / 32;

  auto stage_w = [&](int j) {            // w rows of group j -> buffer j & 1
    T* dst = s_w + (j & 1) * g * MM_COLS;
    const int nrows = min(g, d - j * g);
    const T* src = w + (long long)j * g * n + col0;
    if (vec) {
      for (int e = tid; e < g * (MM_COLS / CP); e += MM_THREADS) {
        const int r = e / (MM_COLS / CP), c = CP * (e % (MM_COLS / CP));
        const bool ok = r < nrows && c < ncols;
        cp_async16(dst + r * MM_COLS + c, ok ? src + (long long)r * n + c
                                             : w, ok);
      }
    } else {
      for (int e = tid; e < g * MM_COLS; e += MM_THREADS) {
        const int r = e / MM_COLS, c = e % MM_COLS;
        const bool ok = r < nrows && c < ncols;
        if constexpr (sizeof(T) == 4) {
          cp_async4(dst + r * MM_COLS + c, ok ? src + (long long)r * n + c
                                              : w, ok);
        } else {                         // no 2-byte cp.async
          dst[r * MM_COLS + c] = ok ? src[(long long)r * n + c] : T();
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int32_t lo[RPW], hi[RPW];              // words lane and lane + 32 per row
  auto load_words = [&](int j) {
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const long long row = row0 + warp + MM_WARPS * q;
      load_group(buf + (row * ng + j) * wpg, wpg, lane, row < rows, lo[q],
                 hi[q]);
    }
  };

  stage_w(0);
  load_words(0);
  float acc[RT][4] = {};
  for (int j = 0; j < ng; ++j) {
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int r = warp + MM_WARPS * q;
      if (row0 + r >= rows) continue;    // warp-uniform
      decode_group<false>(lo[q], hi[q], bw, k, lane, [&](int t, float v) {
        const int i = lane + 32 * t;
        if (i < g) s_slab[i * SL + r] = v;
      });
    }
    if (j + 1 < ng) {                    // next group's copies and words
      stage_w(j + 1);
      load_words(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // running pointers: with the templated w type, indexing by i measured
    // 7-8 % slower at rows 4096 (its address math rematerialised per step)
    const T* sw = s_w + (j & 1) * g * MM_COLS + tc;
    const float* sa = s_slab + tr;
    float part[RT][4] = {};
    for (int i = 0; i < g; ++i, sw += MM_COLS, sa += SL) {
      float a[RT];
      load_rt<RT>(a, sa);
      float b[4];
      load4(sw, b);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = fmaf(a[r], b[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
    __syncthreads();                     // the slab and this buffer are reused
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const long long row = row0 + tr + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tc + c < ncols) out[row * n + col0 + tc + c] = acc[r][c];
  }
}

template <typename T, int RT>
int launch_unpack_dequant_matmul(const int32_t* buf, const T* w, float* out,
                                 long long rows, int d, int n, int g, int ng,
                                 int k, int wpg, cudaStream_t stream) {
  constexpr int R = 8 * RT;
  const int bytes = mm_smem_bytes(RT, g, ng > 1 ? 2 : 1, sizeof(T));
  auto kern = unpack_dequant_matmul_kernel<T, RT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = n % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((unsigned)((rows + R - 1) / R),
                  (unsigned)((n + MM_COLS - 1) / MM_COLS));
  kern<<<grid, MM_THREADS, bytes, stream>>>(buf, w, out, rows, d, n, g, ng,
                                            k, wpg, vec);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int count = 0;                  // one card model per process
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

unsigned group_blocks(long long n_groups) {
  return (unsigned)((n_groups + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

// Calls f with a null T* for the dtype code (see the header); false for an
// unknown code.
template <typename F>
bool with_dtype(int dtype, F f) {
  switch (dtype) {
    case 0: f(static_cast<float*>(nullptr)); return true;
    case 1: f(static_cast<__nv_bfloat16*>(nullptr)); return true;
    case 2: f(static_cast<__half*>(nullptr)); return true;
    default: return false;
  }
}

template <typename T, int W>
void launch_quantize(const T* x, int8_t* q, float* scales, long long rows,
                     int d, int g, int ng, bool vec, cudaStream_t stream) {
  const int lanes = ng * W;              // per row
  int bx = lanes < Q_THREADS ? lanes : Q_THREADS;   // a multiple of W
  int by = Q_THREADS / bx;
  while (by > 1 && bx * by % 32) --by;   // whole warps
  if (bx * by % 32) bx = (bx + 31) / 32 * 32;       // by = 1: pad the row
  const long long row_blocks = (rows + by - 1) / by;
  const dim3 grid((unsigned)((lanes + bx - 1) / bx),
                  (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
  if (vec)
    quantize_int8_kernel<T, W, true><<<grid, dim3(bx, by), 0, stream>>>(
        x, q, scales, rows, d, g, ng);
  else
    quantize_int8_kernel<T, W, false><<<grid, dim3(bx, by), 0, stream>>>(
        x, q, scales, rows, d, g, ng);
}

}  // namespace

extern "C" {

int repro_quantize_int8(const void* x, int8_t* q, float* scales,
                        long long rows, int d, int g, int ng, int dtype,
                        cudaStream_t stream) {
  const bool known = with_dtype(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    if (rows <= 0 || d <= 0) return;
    const T* xt = static_cast<const T*>(x);
    const bool vec = d % 4 == 0 && g % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 4 == 0;
    int w = 1;                           // lanes a group: pow2 >= ceil(g/4)
    while (4 * w < g) w <<= 1;
    switch (w) {
      case 1: launch_quantize<T, 1>(xt, q, scales, rows, d, g, ng, vec,
                                    stream); break;
      case 2: launch_quantize<T, 2>(xt, q, scales, rows, d, g, ng, vec,
                                    stream); break;
      case 4: launch_quantize<T, 4>(xt, q, scales, rows, d, g, ng, vec,
                                    stream); break;
      case 8: launch_quantize<T, 8>(xt, q, scales, rows, d, g, ng, vec,
                                    stream); break;
      case 16: launch_quantize<T, 16>(xt, q, scales, rows, d, g, ng, vec,
                                      stream); break;
      default: launch_quantize<T, 32>(xt, q, scales, rows, d, g, ng, vec,
                                      stream);
    }
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int repro_dequantize_int8(const int8_t* q, const float* scales, void* x,
                          long long rows, int d, int g, int ng, int dtype,
                          cudaStream_t stream) {
  const bool known = with_dtype(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    if (rows <= 0 || d <= 0) return;
    T* xt = static_cast<T*>(x);
    const bool vec = d % 4 == 0 && g % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
    const int runs = vec ? d / 4 : d;    // threads per row
    const int bx = runs < DQ_THREADS ? runs : DQ_THREADS;
    const int by = DQ_THREADS / bx;
    const long long row_blocks = (rows + by - 1) / by;
    const dim3 block(bx, by);
    const dim3 grid((unsigned)((runs + bx - 1) / bx),
                    (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
    if (vec)
      dequantize_int8_kernel<T, 4><<<grid, block, 0, stream>>>(
          q, scales, xt, rows, d, g, ng);
    else
      dequantize_int8_kernel<T, 1><<<grid, block, 0, stream>>>(
          q, scales, xt, rows, d, g, ng);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int repro_sparsify_quant_pack(const void* x, int32_t* buf, long long rows,
                              int d, int g, int ng, int k, int wpg,
                              int dtype, cudaStream_t stream) {
  const bool known = with_dtype(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const long long n_groups = rows * ng;
    if (n_groups <= 0) return;
    const T* xt = static_cast<const T*>(x);
    const unsigned blocks = group_blocks(n_groups);
    switch ((g + 31) / 32) {            // NT: value slots per lane
      case 1:
        sparsify_quant_pack_kernel<T, 1><<<blocks, THREADS, 0, stream>>>(
            xt, buf, n_groups, d, g, ng, k, wpg);
        break;
      case 2:
        sparsify_quant_pack_kernel<T, 2><<<blocks, THREADS, 0, stream>>>(
            xt, buf, n_groups, d, g, ng, k, wpg);
        break;
      case 3:
        sparsify_quant_pack_kernel<T, 3><<<blocks, THREADS, 0, stream>>>(
            xt, buf, n_groups, d, g, ng, k, wpg);
        break;
      default:
        sparsify_quant_pack_kernel<T, 4><<<blocks, THREADS, 0, stream>>>(
            xt, buf, n_groups, d, g, ng, k, wpg);
    }
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int repro_unpack_dequant(const int32_t* buf, void* x, long long rows, int d,
                         int g, int ng, int k, int wpg, int dtype,
                         cudaStream_t stream) {
  const bool known = with_dtype(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const long long n_groups = rows * ng;
    if (n_groups > 0)
      unpack_dequant_kernel<T><<<group_blocks(n_groups), THREADS, 0,
                                 stream>>>(buf, static_cast<T*>(x), n_groups,
                                           d, g, ng, k, wpg);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int repro_unpack_dequant_matmul(const int32_t* buf, const void* w,
                                float* out, long long rows, int d, int n,
                                int g, int ng, int k, int wpg, int dtype,
                                cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  with_dtype(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    if (rows <= 0 || n <= 0) {
      err = (int)cudaGetLastError();
      return;
    }
    const T* wt = static_cast<const T*>(w);
    // 16-row tiles when they still give every SM a block, else 8-row tiles
    const long long col_blocks = (n + MM_COLS - 1) / MM_COLS;
    err = (rows + 15) / 16 * col_blocks >= sm_count()
              ? launch_unpack_dequant_matmul<T, 2>(buf, wt, out, rows, d, n,
                                                   g, ng, k, wpg, stream)
              : launch_unpack_dequant_matmul<T, 1>(buf, wt, out, rows, d, n,
                                                   g, ng, k, wpg, stream);
  });
  return err;
}

}  // extern "C"
