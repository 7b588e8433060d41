// LM-lane kernels for Hopper (sm_90a): rmsnorm, flash attention and the
// Mamba2 SSD chunk scan, each with a plain C interface loaded with ctypes by
// repro_torch/kernels/_build.py.  All three work in float32 on CUDA cores
// (no tensor cores, so no TF32 rounding: the port holds the card to the
// CPU's float32 results).
//
// They replace the Pallas TPU kernels of the JAX package:
//   repro_rmsnorm          <- repro/kernels/rmsnorm.py          _rmsnorm_kernel
//   repro_flash_attention  <- repro/kernels/flash_attention.py  _fa_kernel
//   repro_ssd_chunk_scan   <- repro/kernels/ssd.py              _ssd_kernel
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  Built without --use_fast_math: expf / rsqrtf keep their IEEE-ish
// accuracy, which the tolerances against the plain versions rely on.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// reductions across the 16 lanes of a half-warp (lanes differ in bits 0-3)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ================================================================= rmsnorm
// Replaces _rmsnorm_kernel: y = x * rsqrt(mean(x^2) + eps) * scale per row.
// Bound: bytes (each value read once and written once, ~3 flops per value,
// far below the card's f32 ridge of ~20 flops/byte).  One block per row: the
// row is read once into registers-by-stride (float4 loads when d % 4 == 0
// and the pointers are 16-byte aligned, scalar loads otherwise), the sum of
// squares is a warp-shuffle reduction plus one shared-memory step, and the
// second pass re-reads the row from L1/L2, not from device memory.
constexpr int RMS_THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ y, int d, float eps) {
  __shared__ float partial[RMS_THREADS / 32];
  __shared__ float total;
  const long long row = blockIdx.x;
  const float* xr = x + row * d;
  float* yr = y + row * d;
  float ss = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < d / 4; i += RMS_THREADS) {
      const float4 v = x4[i];
      ss += v.x * v.x;
      ss += v.y * v.y;
      ss += v.z * v.z;
      ss += v.w * v.w;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += RMS_THREADS) {
      const float v = xr[i];
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < RMS_THREADS / 32 ? partial[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) total = v;
  }
  __syncthreads();
  const float r = rsqrtf(total / (float)d + eps);
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(scale);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int i = threadIdx.x; i < d / 4; i += RMS_THREADS) {
      const float4 v = x4[i];
      const float4 g = g4[i];
      y4[i] = make_float4(v.x * r * g.x, v.y * r * g.y, v.z * r * g.z,
                          v.w * r * g.w);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += RMS_THREADS)
      yr[i] = xr[i] * r * scale[i];
  }
}

// ========================================================= flash attention
// Replaces _fa_kernel: softmax(q k^T * scale + mask) v with causal and
// sliding-window masks and GQA (kv head = head / group).
// Bound: operations.  At the serving path's prefill (b 8, s 1024, 15 heads,
// d 64) the causal triangle needs ~1.6e10 flops against ~84 MB of q/k/v/o,
// so f32 FMA issue, not bandwidth, sets the floor.  Design: one block per
// (q tile of BQ rows, head, batch) with the k loop inside the block (the
// TPU's sequential k grid axis); the online-softmax m / l and the BQ x D
// accumulator stay in registers, 16 x 16 threads each own a (BQ/16) x
// (BK/16) patch of the score tile and a (BQ/16) x (D/16) patch of the
// output, and q / k / v / p tiles sit in shared memory (rows padded by one
// float so column walks do not hit one bank).  k tiles wholly above the
// diagonal, or wholly left of the window, are never loaded.  q / k / v are
// read in their (b, s, heads, d) layout through strides; the ragged edge
// (kpos >= sk) is masked in place of a host-side pad.  A row with no
// visible key outputs 0.
constexpr int FA_THREADS = 256;

template <int D, int BQ, int BK>
struct FaSmem {
  static constexpr int QS = D + 1, KS = D + 1, VS = D, PS = BK + 1;
  static constexpr int FLOATS = BQ * QS + BK * KS + BK * VS + BQ * PS;
  static constexpr int BYTES = FLOATS * 4;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int sq, int sk, int h, int group, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, int causal,
                       int window, float scale) {
  using S = FaSmem<D, BQ, BK>;
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * S::QS;
  float* Vs = Ks + BK * S::KS;
  float* Ps = Vs + BK * S::VS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, hi = blockIdx.y, bi = blockIdx.z;
  const int kvh = hi / group;
  const float* qb = q + bi * q_sb + hi * q_sh;
  const float* kb = k + bi * k_sb + kvh * k_sh;
  const float* vb = v + bi * v_sb + kvh * v_sh;

  for (int e = tid; e < BQ * D; e += FA_THREADS) {
    const int r = e / D, c = e % D, qpos = q0 + r;
    Qs[r * S::QS + c] = qpos < sq ? qb[qpos * q_ss + c] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[a][c] = 0.f;
  }

  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + BQ);          // keys <= the last row
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1); // keys > row 0 - window
  k_lo = (k_lo / BK) * BK;

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();                             // previous tile consumed
    for (int e = tid; e < BK * D; e += FA_THREADS) {
      const int r = e / D, c = e % D, kpos = kt + r;
      const bool ok = kpos < sk;
      Ks[r * S::KS + c] = ok ? kb[kpos * k_ss + c] : 0.f;
      Vs[r * S::VS + c] = ok ? vb[kpos * v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qa[RQ], kj[RK];
#pragma unroll
      for (int a = 0; a < RQ; ++a) qa[a] = Qs[(ty + 16 * a) * S::QS + kk];
#pragma unroll
      for (int j = 0; j < RK; ++j) kj[j] = Ks[(tx + 16 * j) * S::KS + kk];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[a][j] = fmaf(qa[a], kj[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int qpos = q0 + ty + 16 * a;
      float mx = -INFINITY;
      bool ok[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = kt + tx + 16 * j;
        ok[j] = kpos < sk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[a][j] = ok[j] ? s[a][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[a], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = ok[j] ? expf(s[a][j] - m_use) : 0.f;
        rs += p;
        Ps[(ty + 16 * a) * S::PS + tx + 16 * j] = p;
      }
      rs = half_warp_sum(rs);
      const float alpha = expf(m[a] - m_use);    // 0 while nothing was seen
      l[a] = alpha * l[a] + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[RQ], vc[RD];
#pragma unroll
      for (int a = 0; a < RQ; ++a) pa[a] = Ps[(ty + 16 * a) * S::PS + j];
#pragma unroll
      for (int c = 0; c < RD; ++c) vc[c] = Vs[j * S::VS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }

  // output is contiguous (b, sq, h, D)
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int qpos = q0 + ty + 16 * a;
    if (qpos >= sq) continue;
    float* orow = o + (((long long)bi * sq + qpos) * h + hi) * D;
#pragma unroll
    for (int c = 0; c < RD; ++c)
      orow[tx + 16 * c] = l[a] > 0.f ? acc[a][c] / l[a] : 0.f;
  }
}

template <int D, int BQ, int BK>
int launch_flash(const float* q, const float* k, const float* v, float* o,
                 int b, int sq, int sk, int h, int kv, long long q_sb,
                 long long q_ss, long long q_sh, long long k_sb,
                 long long k_ss, long long k_sh, long long v_sb,
                 long long v_ss, long long v_sh, int causal, int window,
                 float scale, cudaStream_t stream) {
  using S = FaSmem<D, BQ, BK>;
  auto kern = flash_attention_kernel<D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, FA_THREADS, S::BYTES, stream>>>(
      q, k, v, o, sq, sk, h, h / kv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, causal, window, scale);
  return (int)cudaGetLastError();
}

// ===================================================== SSD chunk scan
// Replaces _ssd_kernel (Mamba2 SSD).  Per chunk of positions, with
// cum = inclusive prefix sum of dt*A:
//   y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i.H
//   H  <- exp(total) H + sum_j exp(total - cum_j) dt_j B_j x_j^T
// and returns the final H (the TPU kernel dropped it; the prefill cache
// needs it).
// Bound: operations.  At mamba2-780m's prefill (b 8, s 1024, 48 heads,
// p 64, n 128, chunk 256) the chunked form needs ~3.2e10 flops against
// ~0.2 GB of x/dt/B/C/y, so f32 FMA issue sets the floor.  Design: one block
// per (batch, head) loops over the chunks in order (the TPU's sequential
// chunk axis); the f32 state H (n x p, 32 KB) lives in shared memory for the
// whole sequence.  A chunk's q x q score block does not fit (256 KB at
// q 256), so the chunk is tiled into 64 x 64 (i, j) tiles, lower triangle
// only: C_i and B_j tiles (64 x n), x_j (64 x p) and the score tile sit in
// shared memory, each of 16 x 16 threads owns a 4 x 4 patch.  Every y of the
// chunk reads the old H before the block synchronises and updates H.
// Positions past s (a ragged last chunk) load as dt = 0, x = B = C = 0, so
// they leave H unchanged, and are not stored.
constexpr int SSD_THREADS = 256;
constexpr int SSD_T = 64;          // position tile (i and j)
constexpr int SSD_NMAX = 128;      // d_state
constexpr int SSD_PMAX = 64;       // head_dim
constexpr int SSD_CMAX = 256;      // chunk
constexpr int SSD_CS = SSD_NMAX + 1;
constexpr int SSD_SS = SSD_T + 1;
constexpr int SSD_SMEM_FLOATS = SSD_NMAX * SSD_PMAX   // H
                                + SSD_T * SSD_CS      // C_i tile
                                + SSD_T * SSD_CS      // B_j tile
                                + SSD_T * SSD_PMAX    // x_j tile
                                + SSD_T * SSD_SS      // score tile
                                + 2 * SSD_CMAX        // dt, cum
                                + SSD_T + 32;         // w_j, warp sums
constexpr int SSD_SMEM_BYTES = SSD_SMEM_FLOATS * 4;

__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ B,
                      const float* __restrict__ C, float* __restrict__ y,
                      float* __restrict__ state, int s, int h, int P, int g,
                      int N, int chunk, long long x_sb, long long x_ss,
                      long long x_sh, long long dt_sb, long long dt_ss,
                      long long dt_sh, long long B_sb, long long B_ss,
                      long long B_sg, long long C_sb, long long C_ss,
                      long long C_sg) {
  extern __shared__ float smem[];
  float* Hs = smem;                              // [NMAX][PMAX]
  float* Cs = Hs + SSD_NMAX * SSD_PMAX;          // [T][CS]
  float* Bs = Cs + SSD_T * SSD_CS;               // [T][CS]
  float* Xs = Bs + SSD_T * SSD_CS;               // [T][PMAX]
  float* Ss = Xs + SSD_T * SSD_PMAX;             // [T][SS]
  float* dts = Ss + SSD_T * SSD_SS;              // [CMAX]
  float* cum = dts + SSD_CMAX;                   // [CMAX]
  float* wj = cum + SSD_CMAX;                    // [T]
  float* wsum = wj + SSD_T;                      // [32]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int gi = hi / (h / g);
  const float a_h = A[hi];
  const float* xb = x + bi * x_sb + hi * x_sh;
  const float* dtb = dt + bi * dt_sb + hi * dt_sh;
  const float* Bb = B + bi * B_sb + gi * B_sg;
  const float* Cb = C + bi * C_sb + gi * C_sg;
  float* yb = y + ((long long)bi * s * h + hi) * P;   // y (b, s, h, P)
  const long long y_ss = (long long)h * P;

  for (int e = tid; e < SSD_NMAX * SSD_PMAX; e += SSD_THREADS) Hs[e] = 0.f;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    const int L = min(chunk, s - c0);
    __syncthreads();                             // H update of last chunk
    // ---- dt and the inclusive prefix sum of dt*A (chunk <= 256 threads)
    float la = 0.f;
    if (tid < chunk) {
      const float d = tid < L ? dtb[(c0 + tid) * dt_ss] : 0.f;
      dts[tid] = d;
      la = d * a_h;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(FULL, la, off);
      if (lane >= off) la += t;
    }
    if (lane == 31) wsum[warp] = la;
    __syncthreads();
    if (warp == 0) {
      float w = lane < SSD_THREADS / 32 ? wsum[lane] : 0.f;
      const float own = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w += t;
      }
      if (lane < SSD_THREADS / 32) wsum[lane] = w - own;   // exclusive
    }
    __syncthreads();
    if (tid < chunk) cum[tid] = la + wsum[warp];
    __syncthreads();
    const float total = cum[chunk - 1];

    // ---- y for every i tile of the chunk (reads the old H)
    for (int i0 = 0; i0 < L; i0 += SSD_T) {
      __syncthreads();                           // Cs free
      for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
        const int r = e / N, c = e % N;
        Cs[r * SSD_CS + c] =
            i0 + r < L ? Cb[(long long)(c0 + i0 + r) * C_ss + c] : 0.f;
      }
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) acc[a][b2] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += SSD_T) {
        __syncthreads();                         // Bs / Xs / Ss free
        for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
          const int r = e / N, c = e % N;
          Bs[r * SSD_CS + c] =
              j0 + r < L ? Bb[(long long)(c0 + j0 + r) * B_ss + c] : 0.f;
        }
        for (int e = tid; e < SSD_T * P; e += SSD_THREADS) {
          const int r = e / P, c = e % P;
          Xs[r * SSD_PMAX + c] =
              j0 + r < L ? xb[(long long)(c0 + j0 + r) * x_ss + c] : 0.f;
        }
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b2 = 0; b2 < 4; ++b2) sc[a][b2] = 0.f;
        for (int nn = 0; nn < N; ++nn) {
          float ca[4], bj[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) ca[a] = Cs[(ty + 16 * a) * SSD_CS + nn];
#pragma unroll
          for (int b2 = 0; b2 < 4; ++b2)
            bj[b2] = Bs[(tx + 16 * b2) * SSD_CS + nn];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b2 = 0; b2 < 4; ++b2)
              sc[a][b2] = fmaf(ca[a], bj[b2], sc[a][b2]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b2 = 0; b2 < 4; ++b2) {
            const int j = j0 + tx + 16 * b2;
            float val = 0.f;
            if (j <= i && i < L)
              val = sc[a][b2] * expf(cum[i] - cum[j]) * dts[j];
            Ss[(ty + 16 * a) * SSD_SS + tx + 16 * b2] = val;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < SSD_T; ++jj) {
          float sa[4], xp[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sa[a] = Ss[(ty + 16 * a) * SSD_SS + jj];
#pragma unroll
          for (int b2 = 0; b2 < 4; ++b2)
            xp[b2] = Xs[jj * SSD_PMAX + tx + 16 * b2];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b2 = 0; b2 < 4; ++b2)
              acc[a][b2] = fmaf(sa[a], xp[b2], acc[a][b2]);
        }
      }
      // incoming-state term: exp(cum_i) * (C_i . H), H from before the chunk
      float inter[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) inter[a][b2] = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        float ca[4], hp[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ca[a] = Cs[(ty + 16 * a) * SSD_CS + nn];
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2)
          hp[b2] = Hs[nn * SSD_PMAX + tx + 16 * b2];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b2 = 0; b2 < 4; ++b2)
            inter[a][b2] = fmaf(ca[a], hp[b2], inter[a][b2]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= L) continue;
        const float ec = expf(cum[i]);
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) {
          const int p = tx + 16 * b2;
          if (p < P)
            yb[(long long)(c0 + i) * y_ss + p] = acc[a][b2] + ec * inter[a][b2];
        }
      }
    }

    // ---- state update, after every y of the chunk has read the old H
    float hacc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) hacc[a][b2] = 0.f;
    for (int j0 = 0; j0 < L; j0 += SSD_T) {
      __syncthreads();                           // Bs / Xs / wj free
      for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
        const int r = e / N, c = e % N;
        Bs[r * SSD_CS + c] =
            j0 + r < L ? Bb[(long long)(c0 + j0 + r) * B_ss + c] : 0.f;
      }
      for (int e = tid; e < SSD_T * P; e += SSD_THREADS) {
        const int r = e / P, c = e % P;
        Xs[r * SSD_PMAX + c] =
            j0 + r < L ? xb[(long long)(c0 + j0 + r) * x_ss + c] : 0.f;
      }
      if (tid < SSD_T) {
        const int j = j0 + tid;
        wj[tid] = j < L ? expf(total - cum[j]) * dts[j] : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < SSD_T; ++jj) {
        const float w = wj[jj];
        float bn[8], xp[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) bn[a] = Bs[jj * SSD_CS + ty + 16 * a] * w;
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2)
          xp[b2] = Xs[jj * SSD_PMAX + tx + 16 * b2];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b2 = 0; b2 < 4; ++b2)
            hacc[a][b2] = fmaf(bn[a], xp[b2], hacc[a][b2]);
      }
    }
    __syncthreads();                             // every y read the old H
    const float et = expf(total);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int nn = ty + 16 * a;
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) {
        const int p = tx + 16 * b2;
        if (nn < N && p < P)
          Hs[nn * SSD_PMAX + p] = et * Hs[nn * SSD_PMAX + p] + hacc[a][b2];
      }
    }
  }
  __syncthreads();
  float* st = state + ((long long)bi * h + hi) * N * P;   // (b, h, N, P)
  for (int e = tid; e < N * P; e += SSD_THREADS)
    st[e] = Hs[(e / P) * SSD_PMAX + e % P];
}

}  // namespace

extern "C" {

int repro_rmsnorm(const float* x, const float* scale, float* y,
                  long long rows, int d, float eps, void* stream) {
  if (rows <= 0) return 0;
  const bool vec = d % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)y % 16) == 0 && ((uintptr_t)scale % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    rmsnorm_kernel<true><<<(unsigned)rows, RMS_THREADS, 0, st>>>(x, scale, y,
                                                                 d, eps);
  else
    rmsnorm_kernel<false><<<(unsigned)rows, RMS_THREADS, 0, st>>>(x, scale,
                                                                  y, d, eps);
  return (int)cudaGetLastError();
}

int repro_flash_attention(const float* q, const float* k, const float* v,
                          float* o, int b, int sq, int sk, int h, int kv,
                          int d, long long q_sb, long long q_ss,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, int causal, int window, float scale,
                          void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_flash<32, 64, 64>(q, k, v, o, b, sq, sk, h, kv, q_sb,
                                      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                      v_ss, v_sh, causal, window, scale, st);
    case 64:
      return launch_flash<64, 64, 64>(q, k, v, o, b, sq, sk, h, kv, q_sb,
                                      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                      v_ss, v_sh, causal, window, scale, st);
    case 128:
      return launch_flash<128, 64, 32>(q, k, v, o, b, sq, sk, h, kv, q_sb,
                                       q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                       v_ss, v_sh, causal, window, scale, st);
    case 256:
      return launch_flash<256, 32, 32>(q, k, v, o, b, sq, sk, h, kv, q_sb,
                                       q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                       v_ss, v_sh, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int repro_ssd_chunk_scan(const float* x, const float* dt, const float* A,
                         const float* B, const float* C, float* y,
                         float* state, int b, int s, int h, int p, int g,
                         int n, int chunk, long long x_sb, long long x_ss,
                         long long x_sh, long long dt_sb, long long dt_ss,
                         long long dt_sh, long long B_sb, long long B_ss,
                         long long B_sg, long long C_sb, long long C_ss,
                         long long C_sg, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (p > SSD_PMAX || n > SSD_NMAX || chunk > SSD_CMAX || chunk < 1 ||
      g < 1 || h % g)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SSD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<b * h, SSD_THREADS, SSD_SMEM_BYTES,
                          (cudaStream_t)stream>>>(
      x, dt, A, B, C, y, state, s, h, p, g, n, chunk, x_sb, x_ss, x_sh,
      dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sg, C_sb, C_ss, C_sg);
  return (int)cudaGetLastError();
}

}  // extern "C"
