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
// The fused matmul (kernel 5) copies its w slab with cp.async while each
// warp decodes its rows from one coalesced load of the group's words by
// shuffles, then sums slab @ w-slab on CUDA cores in register patches.
//
// Bit-exactness with the JAX reference: the scale is fmaxf(amax, 1e-8f)
// times f32(1/127) (a multiply), q = rintf(x / scale) with IEEE division and
// round-half-to-even.  Build WITHOUT --use_fast_math: fast math turns the
// division into an approximate reciprocal and the words stop matching.
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
constexpr int MAX_T = MAX_G / 32;

__device__ __forceinline__ float inv127() {
  return (float)(1.0 / 127.0);
}

__device__ __forceinline__ float group_scale(float amax) {
  return fmaxf(amax, 1e-8f) * inv127();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int quant_value(float x, float scale) {
  float r = rintf(x / scale);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int)r;
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
    amax = fmaxf(amax, fabsf(v[t]));
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
// one thread per element; the group index is column / g
__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ x, long long n,
                                       int d, int g, int ng) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / d;
    const int col = (int)(e % d);
    x[e] = (float)q[e] * scales[row * ng + col / g];
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
//     included; lanes with i >= g hold no key and ballot 0;
//  2. T = the largest t with #(key >= t) >= k, i.e. the k-th largest key,
//     set bit by bit from bit 30 down (one compare per held value, one
//     ballot per slot and popcounts a bit); once #(key >= candidate) == k
//     those k keys are the survivors and the descent stops;
//  3. keys > T survive; a key == T survives iff #(key > T) plus its rank
//     among the equal keys in index order (popcounts of the earlier slots'
//     `eq` ballots and of its own ballot below its lane) is < k.
// Padded tail columns (col >= d, i < g) are zeros ranked at their own
// indices, as the plain version pads them.  Bitmap word t is the ballot of
// the survivors of slot t; a survivor's value slot is the popcount of
// earlier ballots plus popc(ballot & lanemask_lt).  Survivors drop their
// int8 into a per-warp shared byte row, and the first ceil(k/4) lanes
// assemble one little-endian value word each.
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
  float amax = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int i = lane + 32 * t;
    const int col = j * g + i;
    live[t] = i < g;
    v[t] = (live[t] && col < d) ? xr[col] : 0.0f;   // tail pad reads 0
    key[t] = __float_as_uint(v[t]) & 0x7fffffffu;
    amax = fmaxf(amax, fabsf(v[t]));
    s_val[warp][i] = 0;
  }
  amax = warp_max(amax);
  const float scale = group_scale(amax);

  unsigned thr = 0;                       // #(key >= 0) = g >= k
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
    eq[t] = __ballot_sync(FULL, live[t] && key[t] == thr);
  }
  const unsigned lt = (1u << lane) - 1u;
  unsigned ballots[NT];
  bool keep[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    keep[t] = live[t] && (key[t] > thr ||
                          (key[t] == thr && ahead + __popc(eq[t] & lt) < k));
    ahead += __popc(eq[t]);
    ballots[t] = __ballot_sync(FULL, keep[t]);
  }
  __syncwarp();                           // s_val zeroed before the drops
  int before = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (keep[t]) {
      const int slot = before + __popc(ballots[t] & lt);
      s_val[warp][slot] = (int8_t)quant_value(v[t], scale);
    }
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
// one warp per group: bitmap bit -> slot by popcount -> sign-extended byte
// times the scale; off-mask positions write 0; only columns < d are written
__global__ void unpack_dequant_kernel(const int32_t* __restrict__ buf,
                                      float* __restrict__ x,
                                      long long n_groups, int d, int g,
                                      int ng, int k, int wpg) {
  const int lane = threadIdx.x & 31;
  const long long grp =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (grp >= n_groups) return;
  const long long row = grp / ng;
  const int j = (int)(grp % ng);
  const int32_t* in = buf + grp * wpg;
  const int bw = (g + 31) / 32;
  const float scale = __int_as_float(in[bw]);
  const int32_t* words = in + bw + 1;
  const unsigned lt = (1u << lane) - 1u;
  float* xr = x + row * d;
  int before = 0;
  for (int t = 0; t < bw; ++t) {
    const unsigned bits = (unsigned)in[t];
    const int i = lane + 32 * t;
    const int col = j * g + i;
    float val = 0.0f;
    if ((bits >> lane) & 1u) {
      const int slot = before + __popc(bits & lt);
      if (slot < k) {
        const unsigned word = (unsigned)words[slot >> 2];
        const int8_t b = (int8_t)((word >> (8 * (slot & 3))) & 0xFFu);
        val = (float)b * scale;
      }
    }
    if (i < g && col < d) xr[col] = val;
    before += __popc(bits);
  }
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
//    copy; bitmap, scale and value words then come from __shfl_sync:
//    bitmap bit -> slot by popcount -> value word -> sign-extended byte
//    times the scale, into a g x R slab in shared memory (rows past `rows`
//    are not decoded; their outputs are not written);
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
  const unsigned lt = (1u << lane) - 1u;

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
      const int32_t* in = buf + (row * ng + j) * wpg;
      lo[q] = (row < rows && lane < wpg) ? __ldg(in + lane) : 0;
      hi[q] = (row < rows && lane + 32 < wpg) ? __ldg(in + lane + 32) : 0;
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
      const float scale = __int_as_float(__shfl_sync(FULL, lo[q], bw));
      int before = 0;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t >= bw) break;
        const unsigned bits = (unsigned)__shfl_sync(FULL, lo[q], t);
        const int slot = before + __popc(bits & lt);
        const int widx = bw + 1 + (slot >> 2);
        const int wlo = __shfl_sync(FULL, lo[q], widx & 31);
        const int whi = __shfl_sync(FULL, hi[q], widx & 31);
        const unsigned word = (unsigned)(widx < 32 ? wlo : whi);
        float val = 0.0f;
        if (((bits >> lane) & 1u) && slot < k)
          val = (float)(int8_t)((word >> (8 * (slot & 3))) & 0xFFu) * scale;
        const int i = lane + 32 * t;
        if (i < g) s_slab[i * SL + r] = val;
        before += __popc(bits);
      }
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
  const long long n = rows * d;
  if (n > 0) {
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 8) blocks = 65535LL * 8;
    dequantize_int8_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        q, scales, x, n, d, g, ng);
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
