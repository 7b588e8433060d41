// Flash attention's backward on Hopper (sm_90a): bfloat16 / float16 q, k, v
// and the cotangent dO at head dim 128, with a plain C interface loaded with
// ctypes by repro_torch/kernels/_build.py.  repro_flash_attention_backward
// (lm.cu) calls it when the Python wrapper's flash_backward_route picked
// "hopper"; every other input takes lm.cu's mma.sync backward.
//
// Replaces no TPU kernel: the JAX package's flash_attention has no
// custom_vjp (JAX differentiates attention_ref).  It computes what lm.cu's
// backward computes: from q, k, v, dO and the forward's lse (each row's
// log-sum-exp of its scaled scores, +inf for a row with no visible key),
//   P = exp(S scale - lse) (0 on masked pairs),  dV = P^T dO,  dP = dO V^T,
//   D = rowsum(P o dP),  dS = P o (dP - D),  dK = scale dS^T Q,
//   dQ = scale dS K,
// the scores of the 16-bit values as they are (exact products, float32
// sums), P, dP, D and dS in float32, the three products with a float32 left
// operand (P^T dO, dS^T Q, dS K) run twice on its hi = T(x) and lo =
// T(x - hi) halves (as the forward's p.v), each gradient rounded once to T.
// D is the softmax backward's sum over the visible keys (lm.cu says why not
// rowsum(dO o O) of a 16-bit O).  No atomics: the same inputs give the same
// bits on every run.
//
// Bound: operations.  The five products take 10 d flops a visible pair and
// head; the kernels run 24 d of 16-bit products (S and dP twice in the dQ
// kernel, once in the dK / dV kernel, and the three split products twice),
// at 989 TFLOP/s (dense bf16 / f16, NVIDIA's H100 SXM data sheet).
//
// Design: FlashAttention-3's backward (Shah et al., arXiv:2407.08608) with
// the forward's pieces (flash_hopper.cuh): TMA loads from tensor maps with a
// 128-byte swizzle, a ring of stages with full / empty mbarriers, a
// producer warpgroup lowered to 24 registers and two consumer warpgroups
// raised to 240, wgmma with both operands in shared memory for S and dP and
// with A from registers for the split products, whose A is the float32
// accumulator of S or dP as it lies.  Where FA-3 sums dQ across the key
// blocks with atomics, this runs two launches:
//   (1) flash_bwd_hopper_dq_kernel: a block per (batch, head, 128-row query
//       tile), Q and dO loaded once, 128-key K / V tiles through a ring of
//       two stages.  Each consumer owns 64 rows and walks its key tiles
//       twice: first S = Q K^T and dP = dO V^T (wgmma m64n128k16, both
//       K-major) for D, kept in registers and written for (2); then S and
//       dP again, dS, and dQ += dS K (K as the MN-major B operand, as V is
//       in the forward's p.v), in two halves of 64 keys;
//   (2) flash_bwd_hopper_dkdv_kernel: a block per (batch, kv head, 128-key
//       tile), K and V loaded once.  The producer streams 64-row Q / dO
//       tiles (TMA) and their rows' lse and D (one warp's loads and stores)
//       through a ring of three stages for the GQA group's heads, over the
//       query tiles that see the keys (causal: from the diagonal down;
//       under a window: to the last key + window - 1), so the group's sum
//       stays in the block in a fixed order.  Each consumer owns 64 keys:
//       S^T = K Q^T and dP^T = V dO^T (m64n64k16: 64 + 64 accumulators
//       beside dK's and dV's 128 fit the 240 registers), P^T and dS^T in
//       registers, then dV += P^T dO and dK += dS^T Q (m64n128k16, dO and
//       Q MN-major), dV's products in flight while dS^T is split.
// What bounded a first version on the card was the consumers' elementwise
// work, not the tensor cores: a mask evaluated on every pair and exp2f's
// handling of subnormal results took over half the dQ kernel's time.  So
// a tile is masked only where it holds a masked pair, with two per-row
// limits compared to constant column offsets (masked scores -inf), and p
// is one ex2.approx.ftz (a p below 2^-126 flushed to 0).  Key / query
// tiles that see no visible pair are skipped.
//
// Left for later: D from the forward (the first walk costs S and dP once
// more: a sixth of the products), ping-pong scheduling of the consumers,
// overlap of one tile's elementwise work with the next tile's products
// inside a consumer, a persistent grid, d 64 and d 256.

#include "flash_hopper.cuh"

namespace {

constexpr int FB_BM = 128;      // query rows a dQ block and keys a dQ
                                // tile, keys a dK / dV block
constexpr int FB_BN = 64;       // queries a dK / dV tile
constexpr int FB_THREADS = 384; // producer + two consumer warpgroups
constexpr int FB_BIG = FB_BM * FH_D * 2;    // a 128-row tile's bytes
constexpr int FB_SMALL = FB_BN * FH_D * 2;  // a 64-row tile's bytes
// each tile 1024-aligned (the swizzle's span): the block's own two tiles,
// then the ring's two tiles a stage (dQ: 128 keys of K and V, dK / dV: 64
// queries of Q and dO, their lse and D); the barriers (the block's own
// tiles, full and empty a stage); slack to align the dynamic shared
// memory's base
constexpr int FQ_STAGES = 2, FK_STAGES = 3;
constexpr int FQ_BAR = 2 * FB_BIG + 2 * FQ_STAGES * FB_BIG;
constexpr int FK_TILES = 2 * FB_BIG + 2 * FK_STAGES * FB_SMALL;
constexpr int FK_BAR = FK_TILES + 2 * FK_STAGES * FB_BN * 4;
constexpr int FQ_SMEM = FQ_BAR + 8 * (1 + 2 * FQ_STAGES) + 1024;
constexpr int FK_SMEM = FK_BAR + 8 * (1 + 2 * FK_STAGES) + 1024;

#define FB_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
// both operands in shared memory, K-major, N = 64; scale-d 0 overwrites d
#define FB_WGMMA_SS64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " " FB_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                \
               : FH_ACC8(d, 0), FH_ACC8(d, 8), FH_ACC8(d, 16),             \
                 FH_ACC8(d, 24)                                            \
               : "l"(da), "l"(db), "r"(accumulate))

// d (64 x 64) (+)= A (64 x 16, shared) . B (16 x 64, shared)
template <typename T>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    FB_WGMMA_SS64("bf16");
  else
    FB_WGMMA_SS64("f16");
}

// A tile of ``rows`` rows by 128 columns lies as two TMA boxes of 64
// columns, the second rows * 128 bytes after the first.  As a K-major
// operand (the contraction over d), step kk of 16 columns starts 32 bytes
// further inside the swizzle's 128-byte rows, or in the second box; SBO: 8
// rows of 128 bytes
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + (kk >> 2) * (rows * FH_ROW) + (kk & 3) * 32, 16,
                    8 * FH_ROW);
}

// the same tile as the MN-major B operand of a contraction over its rows
// (n = d, the transpose bit of 16-bit B): step kk of 16 rows; LBO: the
// second box (d 64-127), SBO: 8 rows
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + kk * 16 * FH_ROW, rows * FH_ROW, 8 * FH_ROW);
}

// 64 columns of the accumulator x (64 x N per warpgroup), from its value
// i0, split into the hi / lo register A operands of their four 16-column
// steps
template <typename T, int N>
__device__ __forceinline__ void split_acc(const float (&x)[N], int i0,
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = i0 + 8 * kk + 2 * f;
      split_pair<T>(x[i], x[i + 1], hi[kk][f], lo[kk][f]);
    }
}

// 2^x on the multi-function unit (ex2.approx: 2 ulp), a result below
// 2^-126 flushed to 0, 2^-inf = 0: exp2f's handling of subnormal results
// cost a fifth of the dQ kernel's time, and a flushed p moves no gradient
// by more than 2^-126 of a term
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// column offsets past every tile: a row with no visible column
constexpr int FB_NONE = 1 << 30;

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

// one 128 x 128 tile (two boxes) or one 64 x 128 tile into shared memory
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int row,
                                         int head, int batch) {
  tma_load(dst, map, bar, 0, row, head, batch);
  tma_load(dst + rows * FH_ROW, map, bar, FH_BOX, row, head, batch);
}

// ------------------------------------------------------------- (1) dQ, D
// Accumulators as in flash_hopper.cu: d[4j + e] is row 16w + gq + 8 (e >>
// 1), column 8j + 2tq + (e & 1) of the warpgroup's tile.
template <typename T>
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_bwd_hopper_dq_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mo,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const float* __restrict__ lse,
                               float* __restrict__ delta, T* __restrict__ dq,
                               int sq, int sk, int h, int group, int causal,
                               int window, float scale) {
  extern __shared__ __align__(1024) unsigned char fb_smem[];
  const uint32_t sQ =
      ((uint32_t)__cvta_generic_to_shared(fb_smem) + 1023u) & ~1023u;
  const uint32_t sO = sQ + FB_BIG;
  const uint32_t sK = sO + FB_BIG;
  const uint32_t sV = sK + FQ_STAGES * FB_BIG;
  const uint32_t bar_q = sQ + FQ_BAR;
  auto bar_f = [=](int s) { return bar_q + 8u * (1 + s); };
  auto bar_e = [=](int s) { return bar_q + 8u * (1 + FQ_STAGES + s); };

  const int hi = blockIdx.x % h, bi = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FB_BM;  // long rows first
  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + FB_BM);              // keys <= last row
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);      // keys > row 0 - window
  k_lo = (k_lo / FB_BM) * FB_BM;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + FB_BM - 1) / FB_BM : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FQ_STAGES; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && ntiles > 0) {
      const int kvh = hi / group;
      mbar_expect_tx(bar_q, 2 * FB_BIG);
      tma_tile(sQ, &mq, bar_q, FB_BM, q0, hi, bi);
      tma_tile(sO, &mo, bar_q, FB_BM, q0, hi, bi);
      // the key tiles twice: for D, then for dQ
      for (int t = 0; t < 2 * ntiles; ++t) {
        const int st = t % FQ_STAGES;
        const uint32_t parity = ((t / FQ_STAGES) & 1) ^ 1;  // round 0 free
        const int kt = k_lo + (t < ntiles ? t : t - ntiles) * FB_BM;
        mbar_wait(bar_e(st), parity);
        mbar_expect_tx(bar_f(st), 2 * FB_BIG);
        tma_tile(sK + st * FB_BIG, &mk, bar_f(st), FB_BM, kt, kvh, bi);
        tma_tile(sV + st * FB_BIG, &mv, bar_f(st), FB_BM, kt, kvh, bi);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int g0 = q0 + 64 * c;     // the warpgroup's first row
    const int w0 = g0 + 16 * warp;  // the warp's first row
    const int r0 = w0 + gq;         // this thread's rows: r0, r0 + 8
    const uint32_t qa = sQ + 64 * c * FH_ROW, oa = sO + 64 * c * FH_ROW;
    const float sl2 = scale * FH_LOG2E;
    const long long rb = ((long long)bi * h + hi) * sq;
    // lse in the exp2 domain; rows past sq see nothing (p = 0)
    float lse_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lse_r[r] = row < sq ? lse[rb + row] * FH_LOG2E : INFINITY;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (ntiles > 0) mbar_wait(bar_q, 0);

    for (int t = 0; t < 2 * ntiles; ++t) {
      const bool dq_walk = t >= ntiles;
      const int st = t % FQ_STAGES;
      const uint32_t parity = (t / FQ_STAGES) & 1;
      const int kt = k_lo + (dq_walk ? t - ntiles : t) * FB_BM;
      const uint32_t kb = sK + st * FB_BIG, vb = sV + st * FB_BIG;
      // one decision for the warpgroup: its 64 rows see a key of the tile
      const bool live = g0 < sq && (!causal || kt <= g0 + 63) &&
                        (window <= 0 || kt + FB_BM - 1 > g0 - window);
      mbar_wait(bar_f(st), parity);
      if (live) {
        float s[64], dp[64];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FH_D / 16; ++kk)
          wgmma_ss<T>(s, kmajor(qa, FB_BM, kk), kmajor(kb, FB_BM, kk),
                      kk > 0);
#pragma unroll
        for (int kk = 0; kk < FH_D / 16; ++kk)
          wgmma_ss<T>(dp, kmajor(oa, FB_BM, kk), kmajor(vb, FB_BM, kk),
                      kk > 0);
        wg_commit();
        wg_wait_all();
        pin(s);
        pin(dp);
        // every key of the tile visible to every row of the warp: no mask
        const bool full = kt + FB_BM <= sk &&
                          (!causal || kt + FB_BM - 1 <= w0) &&
                          (window <= 0 || kt > w0 + 15 - window);
        if (!full) {
          // a row's visible keys, as offsets from the thread's first
          // column kt + 2 tq: key < sk, key <= row (causal), key > row -
          // window; column 8j + (e & 1) outside them gets p = 0
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r, at = kt + 2 * tq;
            hi[r] = (causal ? min(row, sk - 1) : sk - 1) - at;
            lo[r] = (window > 0 ? row - window + 1 : 0) - at;
          }
          mask_acc(s, lo, hi);
        }
        // p = exp(S scale - lse), scale.log2(e) and lse.log2(e) folded
        if (dq_walk) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int r = (i >> 1) & 1;
            const float p = ex2(fmaf(s[i], sl2, -lse_r[r]));
            s[i] = p * (dp[i] - d_r[r]);  // dS
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int r = (i >> 1) & 1;
            d_r[r] += ex2(fmaf(s[i], sl2, -lse_r[r])) * dp[i];  // D's part
          }
        }
        if (dq_walk) {
          // dQ += dS K in two halves of 64 keys, a commit group each: the
          // second half's split runs while the first half's products do
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t dh[4][4], dl[4][4];
            split_acc<T>(s, 32 * half, dh, dl);
            pin(dh);
            pin(dl);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t db = mnmajor(kb, FB_BM, 4 * half + kk);
              wgmma_rs<T>(acc, dl[kk], db);
              wgmma_rs<T>(acc, dh[kk], db);
            }
            wg_commit();
          }
          wg_wait_all();
          pin(acc);
        }
      }
      mbar_arrive(bar_e(st));
      if (t == ntiles - 1) {
        // D of the rows, summed over the quad in a fixed order, written
        // for the dK / dV kernel
#pragma unroll
        for (int r = 0; r < 2; ++r) d_r[r] = quad_sum(d_r[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sq) continue;
      if (tq == 0) delta[rb + row] = d_r[r];
      // dq is contiguous (b, sq, h, D), rounded once to T
      T* drow = dq + (((long long)bi * sq + row) * h + hi) * FH_D + 2 * tq;
#pragma unroll
      for (int j = 0; j < FH_D / 8; ++j)
        *reinterpret_cast<uint32_t*>(drow + 8 * j) = pack2<T>(
            acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------- (2) dK, dV
template <typename T>
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_bwd_hopper_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mo,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 int sq, int sk, int h, int group, int causal,
                                 int window, float scale) {
  extern __shared__ __align__(1024) unsigned char fb_smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(fb_smem);
  const uint32_t sK = (s0 + 1023u) & ~1023u;
  const uint32_t sV = sK + FB_BIG;
  const uint32_t sQ = sV + FB_BIG;
  const uint32_t sO = sQ + FK_STAGES * FB_SMALL;
  // each stage's rows' lse (exp2 domain) and D, FB_BN floats each
  float* Ls = reinterpret_cast<float*>(fb_smem + (sK - s0) + FK_TILES);
  float* Ds = Ls + FK_STAGES * FB_BN;
  const uint32_t bar_kv = sK + FK_BAR;
  auto bar_f = [=](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_e = [=](int s) { return bar_kv + 8u * (1 + FK_STAGES + s); };

  const int kv = h / group;
  const int kvh = blockIdx.x % kv, bi = blockIdx.x / kv;
  const int k0 = blockIdx.y * FB_BM;  // key tile 0 first (the most work)
  // the query tiles that see a key of [k0, k0 + FB_BM)
  int q_lo = causal ? k0 : 0;                       // queries >= the key
  int q_hi = sq;
  if (window > 0) q_hi = min(sq, k0 + FB_BM - 1 + window);  // < key + window
  q_lo = (q_lo / FB_BN) * FB_BN;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + FB_BN - 1) / FB_BN : 0;
  const int total = group * nqt;  // (head, query tile) steps

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < FK_STAGES; ++s) {
      mbar_init(bar_f(s), 1 + 32);   // the TMA thread and the lse / D warp
      mbar_init(bar_e(s), 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(bar_kv, 2 * FB_BIG);
      tma_tile(sK, &mk, bar_kv, FB_BM, k0, kvh, bi);
      tma_tile(sV, &mv, bar_kv, FB_BM, k0, kvh, bi);
      for (int it = 0; it < total; ++it) {
        const int st = it % FK_STAGES;
        const uint32_t parity = ((it / FK_STAGES) & 1) ^ 1;
        const int j = it / nqt, qt = q_lo + (it - j * nqt) * FB_BN;
        const int hq = kvh * group + j;
        mbar_wait(bar_e(st), parity);
        mbar_expect_tx(bar_f(st), 2 * FB_SMALL);
        tma_tile(sQ + st * FB_SMALL, &mq, bar_f(st), FB_BN, qt, hq, bi);
        tma_tile(sO + st * FB_SMALL, &mo, bar_f(st), FB_BN, qt, hq, bi);
      }
    } else if ((threadIdx.x >> 5) == 1) {
      // warp 1: the rows' lse (exp2 domain; +inf past sq, so p = 0) and D
      const int lane = threadIdx.x & 31;
      for (int it = 0; it < total; ++it) {
        const int st = it % FK_STAGES;
        const int j = it / nqt, qt = q_lo + (it - j * nqt) * FB_BN;
        const long long rb = ((long long)bi * h + kvh * group + j) * sq;
        mbar_wait(bar_e(st), ((it / FK_STAGES) & 1) ^ 1);
#pragma unroll
        for (int x = 0; x < FB_BN; x += 32) {
          const int qi = qt + x + lane;
          Ls[st * FB_BN + x + lane] =
              qi < sq ? lse[rb + qi] * FH_LOG2E : INFINITY;
          Ds[st * FB_BN + x + lane] = qi < sq ? delta[rb + qi] : 0.f;
        }
        mbar_arrive(bar_f(st));
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int kw = k0 + 64 * c;     // the warpgroup's first key
    const int w0 = kw + 16 * warp;  // the warp's first key
    const int r0 = w0 + gq;         // this thread's keys: r0, r0 + 8
    const uint32_t ka = sK + 64 * c * FH_ROW, va = sV + 64 * c * FH_ROW;
    const float sl2 = scale * FH_LOG2E;
    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    if (total > 0) mbar_wait(bar_kv, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % FK_STAGES;
      const uint32_t parity = (it / FK_STAGES) & 1;
      const int qt = q_lo + (it % nqt) * FB_BN;
      const uint32_t qs = sQ + st * FB_SMALL, os = sO + st * FB_SMALL;
      const float* Lt = Ls + st * FB_BN;
      const float* Dt = Ds + st * FB_BN;
      // one decision for the warpgroup: a query of the tile sees one of
      // its 64 keys
      const bool live = kw < sk && (!causal || qt + FB_BN - 1 >= kw) &&
                        (window <= 0 || qt < kw + 63 + window);
      mbar_wait(bar_f(st), parity);
      if (live) {
        float s[32], dp[32];  // S^T and dP^T: (key, query)
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FH_D / 16; ++kk)
          wgmma_ss64<T>(s, kmajor(ka, FB_BM, kk), kmajor(qs, FB_BN, kk),
                        kk > 0);
#pragma unroll
        for (int kk = 0; kk < FH_D / 16; ++kk)
          wgmma_ss64<T>(dp, kmajor(va, FB_BM, kk), kmajor(os, FB_BN, kk),
                        kk > 0);
        wg_commit();
        wg_wait_all();
        pin(s);
        pin(dp);
        // every query of the tile sees every key of the warp: no mask
        // (queries past sq have lse +inf: p = 0)
        const bool full = w0 + 16 <= sk && (!causal || qt >= w0 + 15) &&
                          (window <= 0 || qt + FB_BN - 1 - w0 < window);
        if (!full) {
          // a key's visible queries, as offsets from the thread's first
          // column qt + 2 tq: query >= key (causal), query < key + window,
          // none for a key past sk
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = r0 + 8 * r, at = qt + 2 * tq;
            lo[r] = key >= sk ? FB_NONE : (causal ? key : 0) - at;
            hi[r] = (window > 0 ? key + window - 1 : sq) - at;
          }
          mask_acc(s, lo, hi);
        }
#pragma unroll
        for (int j = 0; j < FB_BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, col = 8 * j + 2 * tq + (e & 1);
            const float p = ex2(fmaf(s[i], sl2, -Lt[col]));
            s[i] = p;
            dp[i] = p * (dp[i] - Dt[col]);  // dS^T
          }
        // dV += P^T dO, in flight while dS^T is split; then dK += dS^T Q
        uint32_t ph[4][4], pl[4][4];
        split_acc<T>(s, 0, ph, pl);
        pin(ph);
        pin(pl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FB_BN / 16; ++kk) {
          const uint64_t db = mnmajor(os, FB_BN, kk);
          wgmma_rs<T>(dva, pl[kk], db);
          wgmma_rs<T>(dva, ph[kk], db);
        }
        wg_commit();
        uint32_t dh[4][4], dl[4][4];
        split_acc<T>(dp, 0, dh, dl);
        pin(dh);
        pin(dl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FB_BN / 16; ++kk) {
          const uint64_t db = mnmajor(qs, FB_BN, kk);
          wgmma_rs<T>(dka, dl[kk], db);
          wgmma_rs<T>(dka, dh[kk], db);
        }
        wg_commit();
        wg_wait_all();
        pin(dka);
        pin(dva);
      }
      mbar_arrive(bar_e(st));
    }

    // dk and dv are contiguous (b, sk, kv, D), rounded once to T
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + 8 * r;
      if (key >= sk) continue;
      const long long off =
          (((long long)bi * sk + key) * kv + kvh) * FH_D + 2 * tq;
#pragma unroll
      for (int j = 0; j < FH_D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack2<T>(
            dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack2<T>(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ host
template <typename T>
int launch_bwd_hopper(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, float* delta,
                      void* dq, void* dk, void* dv, int b, int sq, int sk,
                      int h, int kv, long long q_sb, long long q_ss,
                      long long q_sh, long long k_sb, long long k_ss,
                      long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh, long long o_sb, long long o_ss,
                      long long o_sh, int causal, int window, float scale,
                      cudaStream_t st) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // [0]: the dQ kernel's boxes (128 rows), [1]: the dK / dV kernel's (K /
  // V of 128 rows, Q / dO of 64)
  CUtensorMap mq[2], mo[2], mk[2], mv[2];
  for (int i = 0; i < 2; ++i) {
    const int rows_q = i == 0 ? FB_BM : FB_BN, rows_k = FB_BM;
    if (!make_map(&mq[i], enc, type, q, sq, h, b, q_ss, q_sh, q_sb, rows_q) ||
        !make_map(&mo[i], enc, type, dout, sq, h, b, o_ss, o_sh, o_sb,
                  rows_q) ||
        !make_map(&mk[i], enc, type, k, sk, kv, b, k_ss, k_sh, k_sb, rows_k) ||
        !make_map(&mv[i], enc, type, v, sk, kv, b, v_ss, v_sh, v_sb, rows_k))
      return (int)cudaErrorInvalidValue;
  }
  auto kern_q = flash_bwd_hopper_dq_kernel<T>;
  auto kern_kv = flash_bwd_hopper_dkdv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern_q, cudaFuncAttributeMaxDynamicSharedMemorySize, FQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern_kv, cudaFuncAttributeMaxDynamicSharedMemorySize, FK_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int group = h / kv;
  kern_q<<<dim3(b * h, (sq + FB_BM - 1) / FB_BM), FB_THREADS, FQ_SMEM,
           st>>>(mq[0], mo[0], mk[0], mv[0], lse, delta, static_cast<T*>(dq),
                 sq, sk, h, group, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kern_kv<<<dim3(b * kv, (sk + FB_BM - 1) / FB_BM), FB_THREADS, FK_SMEM,
            st>>>(mq[1], mo[1], mk[1], mv[1], lse, delta,
                  static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, group,
                  causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// As repro_flash_attention_backward (lm.cu), for the inputs this route
// takes: dtype code 1 (bfloat16) or 2 (float16), d 128, sq >= 1, sk >= 1,
// scale > 0, q / k / v / dO and the outputs 16-byte aligned with batch,
// sequence and head strides multiples of 8 elements (the trailing one 1,
// which the wrapper checks).  Anything else returns cudaErrorInvalidValue
// before a launch.  Two launches: dQ and D, then dK and dV.
int repro_flash_attention_backward_hopper(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int b,
    int sq, int sk, int h, int kv, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    int code, void* stream) {
  if (b <= 0) return 0;
  if ((code != 1 && code != 2) || d != FH_D || sq <= 0 || sk <= 0 ||
      kv <= 0 || h % kv != 0 || !(scale > 0.f) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) ||
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh | o_sb |
       o_ss | o_sh) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FBH(T)                                                         \
  launch_bwd_hopper<T>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h,  \
                       kv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,   \
                       v_sh, o_sb, o_ss, o_sh, causal, window, scale, st)
  return code == 1 ? REPRO_FBH(__nv_bfloat16) : REPRO_FBH(__half);
#undef REPRO_FBH
}

// the dynamic shared memory a block of each backward kernel asks for: dQ
// (which = 0) or dK / dV (1)
int repro_flash_hopper_bwd_smem_bytes(int which) {
  return which == 0 ? FQ_SMEM : FK_SMEM;
}

}  // extern "C"
