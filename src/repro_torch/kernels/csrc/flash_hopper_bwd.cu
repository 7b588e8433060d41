// Flash attention's backward on Hopper (sm_90a): bfloat16 / float16 q, k, v
// and the cotangent dO at head dim 128 or 256, with a plain C interface
// loaded with ctypes by repro_torch/kernels/_build.py.
// repro_flash_attention_backward (lm.cu) calls it when the Python
// wrapper's flash_backward_route picked "hopper"; every other input takes
// lm.cu's mma.sync backward.
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
//       tile), Q and dO loaded once, K / V tiles of 128 keys (d 128) or 64
//       (d 256) through rings of their own: K two stages, V two (d 128) or
//       one (d 256), a V stage freed as soon as dP has read it.  Each
//       consumer owns 64 rows and walks its key tiles twice: first S = Q
//       K^T and dP = dO V^T (wgmma m64n{keys}k16, both K-major) for D,
//       kept in registers and written for (2); then S and dP again, dS, and
//       dQ += dS K (K as the MN-major B operand, as V is in the forward's
//       p.v, m64n128k16 a 128 of dQ's columns), in halves of 64 keys;
//   (2) flash_bwd_hopper_dkdv_kernel: a block per (batch, kv head, key
//       block of 128 (d 128) or 64 (d 256)), K and V loaded once.  The
//       producer streams 64-row Q / dO tiles (TMA) and their rows' lse and
//       D (one warp's loads and stores) through a ring of three stages (d
//       128) or two (d 256) for the GQA group's heads, over the query tiles
//       that see the keys (causal: from the diagonal down; under a window:
//       to the last key + window - 1), so the group's sum stays in the
//       block in a fixed order.  Each consumer computes S^T = K Q^T and
//       dP^T = V dO^T for 64 keys (m64n64k16: 32 + 32 accumulators), P^T
//       and dS^T in registers, then dV += P^T dO and dK += dS^T Q
//       (m64n128k16, dO and Q MN-major) into 128 columns of each (64 + 64
//       accumulators, all fitting 240 registers), dV's products in flight
//       while dS^T is split.  d 128: each consumer owns 64 keys and every
//       column.  d 256: dK's and dV's 256 columns for 64 keys would be 256
//       accumulators a thread, so the two consumers share the block's 64
//       keys, each owning 128 of the columns, and each computes S^T and
//       dP^T whole (as lm.cu's 16-bit d 256 does): halves of the
//       contraction summed through shared memory took longer on the card
//       (PERF.md, PR 35).
// Shared memory at d 256 (227 KB a block): the dQ kernel's Q and dO of 128
// rows are 128 KB, so its K / V tiles are 64 keys (32 KB each): two K
// stages and one V stage, 224 KB; the dK / dV kernel's K and V are 64 KB
// and a Q / dO stage 64 KB, so its ring is two stages, 192 KB.
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
// inside a consumer, a persistent grid, d 64.

#include "flash_hopper.cuh"

namespace {

constexpr int FB_THREADS = 384;  // producer + two consumer warpgroups
constexpr int FB_QM = 128;       // query rows a dQ block
constexpr int FB_BN = 64;        // queries a dK / dV tile

// the tiling at head dim D.  dQ: a 128-row block, each consumer 64 rows
// and every one of dQ's D columns (D / 2 accumulators a thread); key tiles
// of QBK keys, K through a ring of two stages and V through QVST: at D 128
// the two share the ring's barriers, at D 256 V has one stage of its own,
// freed once dP has read it, while dS and dQ's products run.  dK / dV: a
// block of KB keys over 64-row query tiles, a ring of KST stages; at D 128
// each consumer owns 64 of the keys and all 128 columns, at D 256 both own
// the block's 64 keys, each 128 of the columns.
// Each tile 1024-aligned (the swizzle's span), then (dK / dV) each
// stage's rows' lse and D, the barriers, and slack to align the dynamic
// shared memory's base.
template <int D>
struct BwdCfg {
  static constexpr int BOXES = D / FH_BOX;
  static constexpr int QBK = D == 256 ? 64 : 128;
  static constexpr int QKST = 2, QVST = D == 256 ? 1 : 2;
  static constexpr int Q_ROWS = FB_QM * D * 2;  // the block's Q or dO
  static constexpr int Q_KV = QBK * D * 2;      // a K or V tile
  static constexpr int Q_BAR = 2 * Q_ROWS + (QKST + QVST) * Q_KV;
  static constexpr int Q_SMEM =
      Q_BAR + 8 * (1 + 2 * QKST + (QKST == QVST ? 0 : 2 * QVST)) + 1024;
  static constexpr int KB = D == 256 ? 64 : 128;
  static constexpr int KST = D == 256 ? 2 : 3;
  static constexpr int K_KV = KB * D * 2;       // the block's K or V
  static constexpr int K_Q = FB_BN * D * 2;     // a Q or dO tile
  static constexpr int K_TILES = 2 * K_KV + 2 * KST * K_Q;
  static constexpr int K_BAR = K_TILES + 2 * KST * FB_BN * 4;
  static constexpr int K_SMEM = K_BAR + 8 * (1 + 2 * KST) + 1024;
};

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

// ------------------------------------------------------------- (1) dQ, D
// Accumulators as in flash_hopper.cu: d[4j + e] is row 16w + gq + 8 (e >>
// 1), column 8j + 2tq + (e & 1) of the warpgroup's tile.
template <typename T, int D>
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_bwd_hopper_dq_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mo,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const float* __restrict__ lse,
                               float* __restrict__ delta, T* __restrict__ dq,
                               int sq, int sk, int h, int group, int causal,
                               int window, float scale) {
  using C = BwdCfg<D>;
  constexpr int BK = C::QBK, KST = C::QKST, VST = C::QVST;
  // K and V share a ring (one full and one empty barrier a stage, as both
  // are loaded and done with together) when their stages match (d 128);
  // else (d 256) each has its own, V's stage freed once dP has read it
  constexpr bool SHARED = KST == VST;
  extern __shared__ __align__(1024) unsigned char fb_smem[];
  const uint32_t sQ =
      ((uint32_t)__cvta_generic_to_shared(fb_smem) + 1023u) & ~1023u;
  const uint32_t sO = sQ + C::Q_ROWS;
  const uint32_t sK = sO + C::Q_ROWS;
  const uint32_t sV = sK + KST * C::Q_KV;
  // barriers: Q and dO full; K full, K empty a K stage; V full, V empty
  // a V stage (the K ones where shared)
  const uint32_t bar_q = sQ + C::Q_BAR;
  auto bar_kf = [=](int s) { return bar_q + 8u * (1 + s); };
  auto bar_ke = [=](int s) { return bar_q + 8u * (1 + KST + s); };
  auto bar_vf = [=](int s) {
    return SHARED ? bar_kf(s) : bar_q + 8u * (1 + 2 * KST + s);
  };
  auto bar_ve = [=](int s) {
    return SHARED ? bar_ke(s) : bar_q + 8u * (1 + 2 * KST + VST + s);
  };

  const int hi = blockIdx.x % h, bi = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FB_QM;  // long rows first
  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + FB_QM);              // keys <= last row
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);      // keys > row 0 - window
  k_lo = (k_lo / BK) * BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(bar_kf(s), 1);
      mbar_init(bar_ke(s), 2 * 128);  // every consumer thread
    }
    if (!SHARED)
      for (int s = 0; s < VST; ++s) {
        mbar_init(bar_vf(s), 1);
        mbar_init(bar_ve(s), 2 * 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    // thread 0: Q, dO and the K ring (and V, where it shares the ring);
    // thread 32: V's own ring.  The key tiles twice each: for D, then for
    // dQ (round 0 of a ring free)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int kvh = hi / group;
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_expect_tx(bar_q, 2 * C::Q_ROWS);
      tma_tile<C::BOXES>(sQ, &mq, bar_q, FB_QM, q0, hi, bi);
      tma_tile<C::BOXES>(sO, &mo, bar_q, FB_QM, q0, hi, bi);
      for (int t = 0; t < 2 * ntiles; ++t) {
        const int ks = t % KST;
        const int kt = k_lo + (t < ntiles ? t : t - ntiles) * BK;
        mbar_wait(bar_ke(ks), ((t / KST) & 1) ^ 1);
        mbar_expect_tx(bar_kf(ks), (SHARED ? 2 : 1) * C::Q_KV);
        tma_tile<C::BOXES>(sK + ks * C::Q_KV, &mk, bar_kf(ks), BK, kt, kvh,
                           bi);
        if (SHARED)
          tma_tile<C::BOXES>(sV + ks * C::Q_KV, &mv, bar_kf(ks), BK, kt,
                             kvh, bi);
      }
    } else if (!SHARED && threadIdx.x == 32 && ntiles > 0) {
      for (int t = 0; t < 2 * ntiles; ++t) {
        const int vs = t % VST;
        mbar_wait(bar_ve(vs), ((t / VST) & 1) ^ 1);
        mbar_expect_tx(bar_vf(vs), C::Q_KV);
        tma_tile<C::BOXES>(sV + vs * C::Q_KV, &mv, bar_vf(vs), BK,
                           k_lo + (t < ntiles ? t : t - ntiles) * BK, kvh,
                           bi);
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
    const float sl2 = scale * FH_LOG2E;
    const long long rb = ((long long)bi * h + hi) * sq;
    // lse in the exp2 domain; rows past sq see nothing (p = 0)
    float lse_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lse_r[r] = row < sq ? lse[rb + row] * FH_LOG2E : INFINITY;
    }
    // dQ's D columns, 128 (64 values a thread) a chunk
    float acc[D / 128][64];
#pragma unroll
    for (int c2 = 0; c2 < D / 128; ++c2)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[c2][i] = 0.f;
    if (ntiles > 0) mbar_wait(bar_q, 0);

    for (int t = 0; t < 2 * ntiles; ++t) {
      const bool dq_walk = t >= ntiles;
      const int ks = t % KST, vs = t % VST;
      const int kt = k_lo + (dq_walk ? t - ntiles : t) * BK;
      // one decision for the warpgroup: its 64 rows see a key of the tile
      const bool live = g0 < sq && (!causal || kt <= g0 + 63) &&
                        (window <= 0 || kt + BK - 1 > g0 - window);
      mbar_wait(bar_kf(ks), (t / KST) & 1);
      if (!SHARED) mbar_wait(bar_vf(vs), (t / VST) & 1);
      if (live) {
        const uint32_t kb = sK + ks * C::Q_KV, vb = sV + vs * C::Q_KV;
        // Q's and dO's addresses made opaque a tile, so that their
        // operand descriptors (16 a tile at d 256) are formed as they are
        // issued rather than held in registers across the walk
        uint32_t qa = sQ + 64 * c * FH_ROW, oa = sO + 64 * c * FH_ROW;
        asm volatile("" : "+r"(qa), "+r"(oa));
        float s[BK / 2], dp[BK / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(s, kmajor(qa, FB_QM, kk), kmajor(kb, BK, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(dp, kmajor(oa, FB_QM, kk), kmajor(vb, BK, kk), kk > 0);
        wg_commit();
        wg_wait_all();
        pin(s);
        pin(dp);
        if (!SHARED) mbar_arrive(bar_ve(vs));  // V's stage free once dP is
        // every key of the tile visible to every row of the warp: no mask
        const bool full = kt + BK <= sk &&
                          (!causal || kt + BK - 1 <= w0) &&
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
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            const float p = ex2(fmaf(s[i], sl2, -lse_r[r]));
            s[i] = p * (dp[i] - d_r[r]);  // dS
          }
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            d_r[r] += ex2(fmaf(s[i], sl2, -lse_r[r])) * dp[i];  // D's part
          }
        }
        if (dq_walk) {
          // dQ += dS K in halves of 64 keys, a commit group each: the
          // second half's split runs while the first half's products do;
          // K as the MN-major B operand, 128 of dQ's columns a product
#pragma unroll
          for (int half = 0; half < BK / 64; ++half) {
            uint32_t dh[4][4], dl[4][4];
            split_acc<T>(s, 32 * half, dh, dl);
            pin(dh);
            pin(dl);
            wg_fence();
#pragma unroll
            for (int c2 = 0; c2 < D / 128; ++c2)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const uint64_t db =
                    mnmajor(kb + 2 * c2 * BK * FH_ROW, BK, 4 * half + kk);
                wgmma_rs<T>(acc[c2], dl[kk], db);
                wgmma_rs<T>(acc[c2], dh[kk], db);
              }
            wg_commit();
          }
          wg_wait_all();
#pragma unroll
          for (int c2 = 0; c2 < D / 128; ++c2) pin(acc[c2]);
        }
      } else if (!SHARED) {
        mbar_arrive(bar_ve(vs));
      }
      mbar_arrive(bar_ke(ks));
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
      T* drow = dq + (((long long)bi * sq + row) * h + hi) * D + 2 * tq;
#pragma unroll
      for (int c2 = 0; c2 < D / 128; ++c2)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(drow + 128 * c2 + 8 * j) =
              pack2<T>(acc[c2][4 * j + 2 * r] * scale,
                       acc[c2][4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------- (2) dK, dV
template <typename T, int D>
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
  using C = BwdCfg<D>;
  constexpr int KB = C::KB, KST = C::KST;
  extern __shared__ __align__(1024) unsigned char fb_smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(fb_smem);
  const uint32_t sK = (s0 + 1023u) & ~1023u;
  const uint32_t sV = sK + C::K_KV;
  const uint32_t sQ = sV + C::K_KV;
  const uint32_t sO = sQ + KST * C::K_Q;
  // each stage's rows' lse (exp2 domain) and D, FB_BN floats each
  float* Ls = reinterpret_cast<float*>(fb_smem + (sK - s0) + C::K_TILES);
  float* Ds = Ls + KST * FB_BN;
  const uint32_t bar_kv = sK + C::K_BAR;
  auto bar_f = [=](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_e = [=](int s) { return bar_kv + 8u * (1 + KST + s); };

  const int kv = h / group;
  const int kvh = blockIdx.x % kv, bi = blockIdx.x / kv;
  const int k0 = blockIdx.y * KB;  // key tile 0 first (the most work)
  // the query tiles that see a key of [k0, k0 + KB)
  int q_lo = causal ? k0 : 0;                       // queries >= the key
  int q_hi = sq;
  if (window > 0) q_hi = min(sq, k0 + KB - 1 + window);  // < key + window
  q_lo = (q_lo / FB_BN) * FB_BN;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + FB_BN - 1) / FB_BN : 0;
  const int total = group * nqt;  // (head, query tile) steps

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < KST; ++s) {
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
      mbar_expect_tx(bar_kv, 2 * C::K_KV);
      tma_tile<C::BOXES>(sK, &mk, bar_kv, KB, k0, kvh, bi);
      tma_tile<C::BOXES>(sV, &mv, bar_kv, KB, k0, kvh, bi);
      for (int it = 0; it < total; ++it) {
        const int st = it % KST;
        const uint32_t parity = ((it / KST) & 1) ^ 1;
        const int j = it / nqt, qt = q_lo + (it - j * nqt) * FB_BN;
        const int hq = kvh * group + j;
        mbar_wait(bar_e(st), parity);
        mbar_expect_tx(bar_f(st), 2 * C::K_Q);
        tma_tile<C::BOXES>(sQ + st * C::K_Q, &mq, bar_f(st), FB_BN, qt, hq,
                           bi);
        tma_tile<C::BOXES>(sO + st * C::K_Q, &mo, bar_f(st), FB_BN, qt, hq,
                           bi);
      }
    } else if ((threadIdx.x >> 5) == 1) {
      // warp 1: the rows' lse (exp2 domain; +inf past sq, so p = 0) and D
      const int lane = threadIdx.x & 31;
      for (int it = 0; it < total; ++it) {
        const int st = it % KST;
        const int j = it / nqt, qt = q_lo + (it - j * nqt) * FB_BN;
        const long long rb = ((long long)bi * h + kvh * group + j) * sq;
        mbar_wait(bar_e(st), ((it / KST) & 1) ^ 1);
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
    // the warpgroup's 64 keys, and the first of its 128 columns of dK /
    // dV: at D 128 its own keys and every column, at D 256 the block's
    // keys and its half of the columns (S^T and dP^T then computed whole
    // by each consumer)
    const int kw = k0 + (D == 256 ? 0 : 64 * c);
    const int col0 = D == 256 ? 128 * c : 0;
    const int w0 = kw + 16 * warp;  // the warp's first key
    const int r0 = w0 + gq;         // this thread's keys: r0, r0 + 8
    const uint32_t ka = sK + (kw - k0) * FH_ROW, va = sV + (kw - k0) * FH_ROW;
    const uint32_t box0 = (col0 / FH_BOX) * FB_BN * FH_ROW;
    const float sl2 = scale * FH_LOG2E;
    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    if (total > 0) mbar_wait(bar_kv, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % KST;
      const uint32_t parity = (it / KST) & 1;
      const int qt = q_lo + (it % nqt) * FB_BN;
      const uint32_t qs = sQ + st * C::K_Q, os = sO + st * C::K_Q;
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
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(s, kmajor(ka, KB, kk), kmajor(qs, FB_BN, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(dp, kmajor(va, KB, kk), kmajor(os, FB_BN, kk), kk > 0);
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
            lo[r] = key >= sk ? FH_NONE : (causal ? key : 0) - at;
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
        // (dO and Q MN-major, the consumer's 128 columns)
        uint32_t ph[4][4], pl[4][4];
        split_acc<T>(s, 0, ph, pl);
        pin(ph);
        pin(pl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FB_BN / 16; ++kk) {
          const uint64_t db = mnmajor(os + box0, FB_BN, kk);
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
          const uint64_t db = mnmajor(qs + box0, FB_BN, kk);
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
          (((long long)bi * sk + key) * kv + kvh) * D + col0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack2<T>(
            dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack2<T>(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ host
template <typename T, int D>
int launch_bwd_hopper(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, float* delta,
                      void* dq, void* dk, void* dv, int b, int sq, int sk,
                      int h, int kv, long long q_sb, long long q_ss,
                      long long q_sh, long long k_sb, long long k_ss,
                      long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh, long long o_sb, long long o_ss,
                      long long o_sh, int causal, int window, float scale,
                      cudaStream_t st) {
  using C = BwdCfg<D>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // [0]: the dQ kernel's boxes (Q / dO 128 rows, K / V a key tile), [1]:
  // the dK / dV kernel's (K / V its key block, Q / dO 64 rows)
  CUtensorMap mq[2], mo[2], mk[2], mv[2];
  for (int i = 0; i < 2; ++i) {
    const int rows_q = i == 0 ? FB_QM : FB_BN;
    const int rows_k = i == 0 ? C::QBK : C::KB;
    if (!make_map(&mq[i], enc, type, q, D, sq, h, b, q_ss, q_sh, q_sb,
                  rows_q) ||
        !make_map(&mo[i], enc, type, dout, D, sq, h, b, o_ss, o_sh, o_sb,
                  rows_q) ||
        !make_map(&mk[i], enc, type, k, D, sk, kv, b, k_ss, k_sh, k_sb,
                  rows_k) ||
        !make_map(&mv[i], enc, type, v, D, sk, kv, b, v_ss, v_sh, v_sb,
                  rows_k))
      return (int)cudaErrorInvalidValue;
  }
  auto kern_q = flash_bwd_hopper_dq_kernel<T, D>;
  auto kern_kv = flash_bwd_hopper_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern_q, cudaFuncAttributeMaxDynamicSharedMemorySize, C::Q_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern_kv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::K_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int group = h / kv;
  kern_q<<<dim3(b * h, (sq + FB_QM - 1) / FB_QM), FB_THREADS, C::Q_SMEM,
           st>>>(mq[0], mo[0], mk[0], mv[0], lse, delta, static_cast<T*>(dq),
                 sq, sk, h, group, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kern_kv<<<dim3(b * kv, (sk + C::KB - 1) / C::KB), FB_THREADS, C::K_SMEM,
            st>>>(mq[1], mo[1], mk[1], mv[1], lse, delta,
                  static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, group,
                  causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// As repro_flash_attention_backward (lm.cu), for the inputs this route
// takes: dtype code 1 (bfloat16) or 2 (float16), d 128 or 256, sq >= 1,
// sk >= 1, scale > 0, q / k / v / dO and the outputs 16-byte aligned with
// batch, sequence and head strides multiples of 8 elements (the trailing
// one 1, which the wrapper checks).  Anything else returns
// cudaErrorInvalidValue before a launch.  Two launches: dQ and D, then dK
// and dV.
int repro_flash_attention_backward_hopper(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int b,
    int sq, int sk, int h, int kv, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    int code, void* stream) {
  if (b <= 0) return 0;
  if ((code != 1 && code != 2) || (d != 128 && d != 256) || sq <= 0 ||
      sk <= 0 || kv <= 0 || h % kv != 0 || !(scale > 0.f) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) ||
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh | o_sb |
       o_ss | o_sh) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FBH(T, D)                                                      \
  launch_bwd_hopper<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk,  \
                          h, kv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   \
                          v_ss, v_sh, o_sb, o_ss, o_sh, causal, window,      \
                          scale, st)
  if (code == 1)
    return d == 128 ? REPRO_FBH(__nv_bfloat16, 128)
                    : REPRO_FBH(__nv_bfloat16, 256);
  return d == 128 ? REPRO_FBH(__half, 128) : REPRO_FBH(__half, 256);
#undef REPRO_FBH
}

// the dynamic shared memory a block of each backward kernel asks for at
// head dim d (128 or 256; 0 for any other): dQ (which = 0) or dK / dV (1)
int repro_flash_hopper_bwd_smem_bytes(int which, int d) {
  if (d == 128) return which == 0 ? BwdCfg<128>::Q_SMEM : BwdCfg<128>::K_SMEM;
  if (d == 256) return which == 0 ? BwdCfg<256>::Q_SMEM : BwdCfg<256>::K_SMEM;
  return 0;
}

}  // extern "C"
