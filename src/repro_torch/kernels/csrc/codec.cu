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
// The first four are memory-bound: a few integer/float operations per byte moved.
// On the TPU a tile of (block_rows, g) lived in VMEM; here one warp owns one
// quantisation group (g <= 128, so <= 4 values per lane) and the group never
// leaves registers / a small per-warp shared-memory row.  Reductions (amax,
// bitmap, survivor slot) are warp shuffles, ballots and popcounts, so no
// block-level synchronisation is needed.  The pack kernel's exactly-k top-k
// is a radix select over the bits of |x| by warp ballots (~31 ballot steps
// per slot at most, not a comparison against every value of the group).
// Dequantize is the exception: a thread owns 4 consecutive int8 of one
// group (one 4-byte load beside its scale's, one float4 store).  Unpack
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = 32 * WARPS_PER_BLOCK;
constexpr int MAX_G = 128;               // GROUP: at most 4 values per lane
constexpr int DQ_THREADS = 256;          // dequantize: threads per block
constexpr int MAX_T = MAX_G / 32;

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
// one warp per (row, group); lanes past d in the tail group read 0
__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales,
                                     long long n_groups, int d, int g,
                                     int ng) {
  const int lane = threadIdx.x & 31;
  const long long grp =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (grp >= n_groups) return;            // whole warp exits together
  const long long row = grp / ng;
  const int j = (int)(grp % ng);
  const float* xr = x + row * d;
  float v[MAX_T];
  float amax = 0.0f;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    const int i = lane + 32 * t;
    const int col = j * g + i;
    v[t] = (i < g && col < d) ? xr[col] : 0.0f;
    amax = max_nan(amax, fabsf(v[t]));
  }
  amax = warp_max(amax);
  const float scale = group_scale(amax);
  int8_t* qr = q + row * d;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    const int i = lane + 32 * t;
    const int col = j * g + i;
    if (i < g && col < d) qr[col] = (int8_t)quant_value(v[t], scale);
  }
  if (lane == 0) scales[grp] = scale;
}

// -------------------------------------------------------------- dequantize
// A thread owns a run of V consecutive int8 of one group in one row.  The
// grid is 2-D, x over a row's runs and y over rows, so the row, the run and
// its group (one 32-bit divide) come from the thread index, and the scale's
// load is in flight beside the run's.  V = 4 when d and g are multiples of
// 4, q is 4-byte and x 16-byte aligned: one 4-byte load and one float4
// store, so each of a warp's load and store instructions covers 128 and 512
// contiguous bytes; else V = 1.  (Sixteen int8 a thread, one 16-byte load
// and four float4 stores at a 64-byte lane stride, measured slower at every
// cut shape.)  Zero bytes are multiplied too: 0 x NaN is NaN.
template <int V>
__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ x, long long rows,
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
      *reinterpret_cast<float4*>(x + e) =
          make_float4((float)(int8_t)u * s, (float)(int8_t)(u >> 8) * s,
                      (float)(int8_t)(u >> 16) * s,
                      (float)(int8_t)(u >> 24) * s);
    } else {
      x[e] = (float)q[e] * s;
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
template <int NT>
__global__ void sparsify_quant_pack_kernel(const float* __restrict__ x,
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
  const float* xr = x + row * d;
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
    v[t] = (live[t] && col < d) ? xr[col] : 0.0f;   // tail pad reads 0
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
__global__ void unpack_dequant_kernel(const int32_t* __restrict__ buf,
                                      float* __restrict__ x,
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
    if (i < cols) x[first + i] = v;
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
//  - w rows j*g .. j*g+g-1 of the tile's columns go to shared memory by
//    cp.async (16-byte copies when n and w allow; zero past d, as the
//    reference pads w, and past n), issued before anything else and, for
//    the next group, while this group computes (two buffers when ng > 1);
//  - each warp reads its rows' group words with one coalesced load per row
//    (lane l holds word l and word l + 32; wpg <= 37), issued with the
//    copy, and decode them as unpack_dequant does (decode_group) into a
//    g x R slab in shared memory (rows past `rows` are not decoded; their
//    outputs are not written);
//  - after one barrier every thread sums slab @ w-slab over the g positions
//    in order with fmaf and adds the partial to its accumulator, the
//    reference's group-by-group order.
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
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

__host__ __device__ constexpr int mm_smem_floats(int rt, int g, int nbuf) {
  return nbuf * g * MM_COLS + g * mm_slab_stride(rt);
}

template <int RT>
__global__ void __launch_bounds__(MM_THREADS)
unpack_dequant_matmul_kernel(const int32_t* __restrict__ buf,
                             const float* __restrict__ w,
                             float* __restrict__ out, long long rows, int d,
                             int n, int g, int ng, int k, int wpg, int vec) {
  constexpr int R = 8 * RT;              // tile rows
  constexpr int RPW = R / MM_WARPS;      // rows each warp decodes
  constexpr int SL = mm_slab_stride(RT);
  extern __shared__ __align__(16) float smem[];
  float* s_slab = smem + (ng > 1 ? 2 : 1) * g * MM_COLS;   // [g][SL]
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
    float* dst = smem + (j & 1) * g * MM_COLS;
    const int nrows = min(g, d - j * g);
    const float* src = w + (long long)j * g * n + col0;
    if (vec) {
      for (int e = tid; e < g * (MM_COLS / 4); e += MM_THREADS) {
        const int r = e / (MM_COLS / 4), c = 4 * (e % (MM_COLS / 4));
        const bool ok = r < nrows && c < ncols;
        cp_async16(dst + r * MM_COLS + c, ok ? src + (long long)r * n + c
                                             : w, ok);
      }
    } else {
      for (int e = tid; e < g * MM_COLS; e += MM_THREADS) {
        const int r = e / MM_COLS, c = e % MM_COLS;
        const bool ok = r < nrows && c < ncols;
        cp_async4(dst + r * MM_COLS + c, ok ? src + (long long)r * n + c
                                            : w, ok);
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
    const float* sw = smem + (j & 1) * g * MM_COLS;
    float part[RT][4] = {};
    for (int i = 0; i < g; ++i) {
      float a[RT];
      load_rt<RT>(a, s_slab + i * SL + tr);
      const float4 b = *reinterpret_cast<const float4*>(sw + i * MM_COLS + tc);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        part[r][0] = fmaf(a[r], b.x, part[r][0]);
        part[r][1] = fmaf(a[r], b.y, part[r][1]);
        part[r][2] = fmaf(a[r], b.z, part[r][2]);
        part[r][3] = fmaf(a[r], b.w, part[r][3]);
      }
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

template <int RT>
int launch_unpack_dequant_matmul(const int32_t* buf, const float* w,
                                 float* out, long long rows, int d, int n,
                                 int g, int ng, int k, int wpg,
                                 cudaStream_t stream) {
  constexpr int R = 8 * RT;
  const int bytes = 4 * mm_smem_floats(RT, g, ng > 1 ? 2 : 1);
  auto kern = unpack_dequant_matmul_kernel<RT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
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

}  // namespace

extern "C" {

int repro_quantize_int8(const float* x, int8_t* q, float* scales,
                        long long rows, int d, int g, int ng,
                        cudaStream_t stream) {
  const long long n_groups = rows * ng;
  if (n_groups > 0)
    quantize_int8_kernel<<<group_blocks(n_groups), THREADS, 0, stream>>>(
        x, q, scales, n_groups, d, g, ng);
  return (int)cudaGetLastError();
}

int repro_dequantize_int8(const int8_t* q, const float* scales, float* x,
                          long long rows, int d, int g, int ng,
                          cudaStream_t stream) {
  if (rows > 0 && d > 0) {
    const bool vec = d % 4 == 0 && g % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int runs = vec ? d / 4 : d;    // threads per row
    const int bx = runs < DQ_THREADS ? runs : DQ_THREADS;
    const int by = DQ_THREADS / bx;
    const long long row_blocks = (rows + by - 1) / by;
    const dim3 block(bx, by);
    const dim3 grid((unsigned)((runs + bx - 1) / bx),
                    (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
    if (vec)
      dequantize_int8_kernel<4><<<grid, block, 0, stream>>>(q, scales, x,
                                                             rows, d, g, ng);
    else
      dequantize_int8_kernel<1><<<grid, block, 0, stream>>>(q, scales, x,
                                                             rows, d, g, ng);
  }
  return (int)cudaGetLastError();
}

int repro_sparsify_quant_pack(const float* x, int32_t* buf, long long rows,
                              int d, int g, int ng, int k, int wpg,
                              cudaStream_t stream) {
  const long long n_groups = rows * ng;
  if (n_groups > 0) {
    const unsigned blocks = group_blocks(n_groups);
    switch ((g + 31) / 32) {            // NT: value slots per lane
      case 1:
        sparsify_quant_pack_kernel<1><<<blocks, THREADS, 0, stream>>>(
            x, buf, n_groups, d, g, ng, k, wpg);
        break;
      case 2:
        sparsify_quant_pack_kernel<2><<<blocks, THREADS, 0, stream>>>(
            x, buf, n_groups, d, g, ng, k, wpg);
        break;
      case 3:
        sparsify_quant_pack_kernel<3><<<blocks, THREADS, 0, stream>>>(
            x, buf, n_groups, d, g, ng, k, wpg);
        break;
      default:
        sparsify_quant_pack_kernel<4><<<blocks, THREADS, 0, stream>>>(
            x, buf, n_groups, d, g, ng, k, wpg);
    }
  }
  return (int)cudaGetLastError();
}

int repro_unpack_dequant(const int32_t* buf, float* x, long long rows, int d,
                         int g, int ng, int k, int wpg, cudaStream_t stream) {
  const long long n_groups = rows * ng;
  if (n_groups > 0)
    unpack_dequant_kernel<<<group_blocks(n_groups), THREADS, 0, stream>>>(
        buf, x, n_groups, d, g, ng, k, wpg);
  return (int)cudaGetLastError();
}

int repro_unpack_dequant_matmul(const int32_t* buf, const float* w,
                                float* out, long long rows, int d, int n,
                                int g, int ng, int k, int wpg,
                                cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  // 16-row tiles when they still give every SM a block, else 8-row tiles
  const long long col_blocks = (n + MM_COLS - 1) / MM_COLS;
  if ((rows + 15) / 16 * col_blocks >= sm_count())
    return launch_unpack_dequant_matmul<2>(buf, w, out, rows, d, n, g, ng, k,
                                           wpg, stream);
  return launch_unpack_dequant_matmul<1>(buf, w, out, rows, d, n, g, ng, k,
                                         wpg, stream);
}

}  // extern "C"
