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
// block-level synchronisation is needed.
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
// one warp per group.  Rank: element i survives when fewer than k elements
// beat it (|x_j| > |x_i|, or equal with j < i).  Bitmap word w is the warp
// ballot of mask[w*32 + lane]; a survivor's slot is the popcount of earlier
// ballots plus popc(ballot & lanemask_lt).  Survivors drop their int8 into a
// per-warp shared byte row, and the first ceil(k/4) lanes assemble one
// little-endian value word each.
__global__ void sparsify_quant_pack_kernel(const float* __restrict__ x,
                                           int32_t* __restrict__ buf,
                                           long long n_groups, int d, int g,
                                           int ng, int k, int wpg) {
  __shared__ float s_abs[WARPS_PER_BLOCK][MAX_G];
  __shared__ int8_t s_val[WARPS_PER_BLOCK][MAX_G];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long grp = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (grp >= n_groups) return;            // whole warp exits together
  const long long row = grp / ng;
  const int j = (int)(grp % ng);
  const float* xr = x + row * d;
  const int bw = (g + 31) / 32;
  const int vw = (k + 3) / 4;

  float v[MAX_T];
  float amax = 0.0f;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    const int i = lane + 32 * t;
    const int col = j * g + i;
    v[t] = (i < g && col < d) ? xr[col] : 0.0f;   // tail pad reads 0
    if (i < g) s_abs[warp][i] = fabsf(v[t]);
    amax = fmaxf(amax, fabsf(v[t]));
  }
  for (int i = lane; i < MAX_G; i += 32) s_val[warp][i] = 0;
  __syncwarp();
  amax = warp_max(amax);
  const float scale = group_scale(amax);

  unsigned ballots[MAX_T];
  bool keep[MAX_T];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    const int i = lane + 32 * t;
    keep[t] = false;
    if (i < g) {
      const float ai = s_abs[warp][i];
      int beaten = 0;
      for (int jj = 0; jj < g; ++jj) {
        const float aj = s_abs[warp][jj];
        beaten += (aj > ai) || (aj == ai && jj < i);
      }
      keep[t] = beaten < k;
    }
    ballots[t] = __ballot_sync(FULL, keep[t]);
  }
  const unsigned lt = (1u << lane) - 1u;
  int before = 0;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (keep[t]) {
      const int slot = before + __popc(ballots[t] & lt);
      s_val[warp][slot] = (int8_t)quant_value(v[t], scale);
    }
    before += __popc(ballots[t]);
  }
  __syncwarp();

  int32_t* out = buf + grp * wpg;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t)
    if (t < bw && lane == t) out[t] = (int32_t)ballots[t];
  if (lane == 0) out[bw] = __float_as_int(scale);
  if (lane < vw) {
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int slot = 4 * lane + b;
      const unsigned byte =
          slot < k ? (unsigned)(uint8_t)s_val[warp][slot] : 0u;
      word |= byte << (8 * b);
    }
    out[bw + 1 + lane] = (int32_t)word;
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
// A block owns an MM_ROWS x MM_COLS output tile.  For each group j in order
// it decodes the g-wide slab of its rows into shared memory (one warp per
// row, as unpack_dequant_kernel: bitmap bit -> slot by popcount ->
// sign-extended byte times the scale; rows past `rows` decode to 0), loads
// rows j*g .. j*g+g-1 of w for its columns (zero past d: the ragged last
// group meets zero rows, as the reference pads w; zero past n), and adds
// slab @ w-slab to the tile in f32 registers on CUDA cores.  Each thread owns
// one row x 4 columns; a slab's partial product is summed over its g
// positions in order and then added to the accumulator, the reference's
// group-by-group order.
//
// Bound on H100: bytes at the main path's shapes (rows 8-16, d = n = 64:
// ~20 KB moved against 0.13 Mflop); operations for wide rows.  This first
// version is simple: no tensor cores, no cp.async, a 40 KB tile per block.
constexpr int MM_ROWS = 16;
constexpr int MM_COLS = 64;
constexpr int MM_THREADS = 256;          // 16 rows x 16 column quads

__global__ void unpack_dequant_matmul_kernel(const int32_t* __restrict__ buf,
                                             const float* __restrict__ w,
                                             float* __restrict__ out,
                                             long long rows, int d, int n,
                                             int g, int ng, int k, int wpg) {
  __shared__ float s_slab[MM_ROWS][MAX_G];
  __shared__ __align__(16) float s_w[MAX_G][MM_COLS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * MM_ROWS;
  const int col0 = blockIdx.y * MM_COLS;
  const int tr = tid >> 4;               // tile row of this thread
  const int tc = 4 * (tid & 15);         // first tile column of this thread
  const int bw = (g + 31) / 32;
  const unsigned lt = (1u << lane) - 1u;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < ng; ++j) {
    for (int r = warp; r < MM_ROWS; r += MM_THREADS / 32) {
      const long long row = row0 + r;
      if (row >= rows) {
        for (int i = lane; i < g; i += 32) s_slab[r][i] = 0.0f;
        continue;
      }
      const int32_t* in = buf + (row * ng + j) * wpg;
      const float scale = __int_as_float(in[bw]);
      const int32_t* words = in + bw + 1;
      int before = 0;
      for (int t = 0; t < bw; ++t) {
        const unsigned bits = (unsigned)in[t];
        const int i = lane + 32 * t;
        float val = 0.0f;
        if ((bits >> lane) & 1u) {
          const int slot = before + __popc(bits & lt);
          if (slot < k) {
            const unsigned word = (unsigned)words[slot >> 2];
            const int8_t b = (int8_t)((word >> (8 * (slot & 3))) & 0xFFu);
            val = (float)b * scale;
          }
        }
        if (i < g) s_slab[r][i] = val;
        before += __popc(bits);
      }
    }
    for (int e = tid; e < g * MM_COLS; e += MM_THREADS) {
      const int i = e / MM_COLS;
      const int c = e - i * MM_COLS;
      const int wr = j * g + i;
      const int wc = col0 + c;
      s_w[i][c] = (wr < d && wc < n) ? w[(long long)wr * n + wc] : 0.0f;
    }
    __syncthreads();
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < g; ++i) {
      const float a = s_slab[tr][i];
      const float4 b = *reinterpret_cast<const float4*>(&s_w[i][tc]);
      part[0] = fmaf(a, b.x, part[0]);
      part[1] = fmaf(a, b.y, part[1]);
      part[2] = fmaf(a, b.z, part[2]);
      part[3] = fmaf(a, b.w, part[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
    __syncthreads();                     // the next group reuses the tiles
  }
  const long long row = row0 + tr;
  if (row < rows) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col0 + tc + c < n) out[row * n + col0 + tc + c] = acc[c];
  }
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
  if (n_groups > 0)
    sparsify_quant_pack_kernel<<<group_blocks(n_groups), THREADS, 0,
                                 stream>>>(x, buf, n_groups, d, g, ng, k,
                                           wpg);
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
  if (rows > 0 && n > 0) {
    const dim3 grid((unsigned)((rows + MM_ROWS - 1) / MM_ROWS),
                    (unsigned)((n + MM_COLS - 1) / MM_COLS));
    unpack_dequant_matmul_kernel<<<grid, MM_THREADS, 0, stream>>>(
        buf, w, out, rows, d, n, g, ng, k, wpg);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
