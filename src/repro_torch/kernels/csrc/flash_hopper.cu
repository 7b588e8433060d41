// Flash attention's Hopper route (sm_90a): bfloat16 / float16 q, k and v at
// head dim 64 or 128, with a plain C interface loaded with ctypes by
// repro_torch/kernels/_build.py.  repro_flash_attention (lm.cu) calls it when
// the Python wrapper's flash_route picked "hopper"; every other input takes
// lm.cu's mma.sync kernel.
//
// Replaces _fa_kernel (repro/kernels/flash_attention.py), as lm.cu's route
// does, and computes what lm.cu's 16-bit route computes: softmax(q k^T *
// scale + mask) v with causal and sliding-window masks and GQA (kv head =
// head / group), the scores of the 16-bit values as they are (a product of
// two 16-bit values is exact in float32, the sums float32), the online
// softmax in float32, p kept in float32 for p.v by splitting it into
// hi = T(p) and lo = T(p - hi) and summing lo.v, then hi.v, into float32
// accumulators, and one rounding of the output to T.  A row with no visible
// key outputs 0.
//
// Bound: operations.  The function needs 4 d flops a visible (query, key)
// pair and head; the kernel does 6 d (q.k^T once, p.v twice), so its floor
// is 6 d flops a visible pair at 989 TFLOP/s (dense bf16 / f16, NVIDIA's H100
// SXM data sheet); the bytes (q, k, v and o read or written once) take
// ~1/10 of that at the bf16 archs' prefills.  At d 64 each pair carries
// half the products but the same softmax work (an exp, a scale, a max, a
// sum and a split a score): there the elementwise work is the likelier
// bound.
//
// Design: FlashAttention-3's shape, the usual shape of a fast Hopper kernel.
// A block owns one (batch, head, 128-row query tile), query tiles ordered
// longest causal row first, and runs three warpgroups:
//   - a producer (registers lowered to 24 by setmaxnreg): one thread issues
//     every copy with TMA (cp.async.bulk.tensor) from tensor maps the host
//     builds for each call.  Q (4-D map over (d, s, h, b)) is loaded once;
//     K and V (over (d, s, kv, b)) run through a ring of FH_STAGES stages
//     with full / empty mbarriers.  A box is 64 columns (128 bytes, the
//     128-byte swizzle's span) by the tile's rows, so a row is d / 64
//     boxes; rows past sq or sk arrive zero-filled;
//   - two consumers of 64 query rows each (registers raised to 240): S =
//     Q.K^T is wgmma m64n128k16 with both operands in shared memory (both
//     K-major), into float32 registers; the masks only on tiles that need
//     them (the diagonal, the window's edge, a ragged sk), by two per-row
//     limits compared to constant column offsets; the online softmax in
//     registers, p by one ex2.approx.ftz of an FFMA that folds
//     scale.log2(e) (a p below 2^-126 flushed to 0); then p.v is wgmma
//     m64n{d}k16 with p's hi / lo halves as register A operands (the S
//     accumulators' layout is the A register layout of 16-bit operands) and
//     V as the shared-memory B operand, MN-major (row-major [key][d] tiles,
//     the transpose bit of 16-bit B), in two commit groups of 64 keys so
//     that the second half's split overlaps the first half's products.
//     Each pair of p is converted with one packed instruction.
// d 64 keeps d 128's tiles: the output is 32 accumulators a thread, not
// 64, and a 128-key K / V tile 16 KB.  Two variants measured slower there
// on the card (PERF.md, PR 35): a third consumer (FA-3's hdim-64 tile, 192
// rows at 160 registers) and FA-3's intra-warpgroup overlap (S of the next
// tile and p.v of this one in flight while the next softmax runs, a
// three-stage ring).
// Key tiles wholly above the diagonal or left of the window are skipped.
// The wgmma descriptors use the 128-byte swizzle TMA writes: K-major
// operands step 32 bytes along K inside the swizzle atom (SBO: 8 rows of
// 128 bytes); V steps 16 keys (2048 bytes) and its 64-column boxes are LBO
// apart.
//
// Left for later: ping-pong scheduling of the consumers, a persistent grid,
// cluster multicast of K / V across a GQA group's heads, d 256.

#include "flash_hopper.cuh"


namespace {

constexpr int FH_BQ = 128;            // query rows a block (two consumers)
constexpr int FH_BK = 128;            // keys a tile
constexpr int FH_STAGES = 2;          // K / V ring
constexpr int FH_THREADS = 384;       // producer + two consumer warpgroups

// the tiling at head dim D: Q's tile, a K or V tile, and the dynamic
// shared memory: Q, K[stages], V[stages] (each 1024-aligned, as the
// swizzle needs), the barriers, and slack to align the dynamic shared
// memory's base
template <int D>
struct FwdCfg {
  static constexpr int BOXES = D / FH_BOX;
  static constexpr int Q_BYTES = FH_BQ * D * 2;
  static constexpr int KV_BYTES = FH_BK * D * 2;
  static constexpr int BAR = Q_BYTES + 2 * FH_STAGES * KV_BYTES;
  static constexpr int SMEM = BAR + 64 + 1024;
};

// ---------------------------------------------------------------- kernel
// Accumulator layout of wgmma m64nN (f32), per warp w of the warpgroup and
// lane = 4 gq + tq: d[4j + e] is row 16w + gq + 8 (e >> 1), column
// 8j + 2tq + (e & 1); the A register fragment of a 16-column step kk is
// {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
// {d[8kk+6], d[8kk+7]} packed as pairs of T.
template <typename T, int D>
__global__ void __launch_bounds__(FH_THREADS, 1)
    flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap mq,
                                  const __grid_constant__ CUtensorMap mk,
                                  const __grid_constant__ CUtensorMap mv,
                                  T* __restrict__ o, float* __restrict__ lse,
                                  int sq, int sk, int h, int group,
                                  int causal, int window, float scale_log2) {
  using C = FwdCfg<D>;
  extern __shared__ __align__(1024) unsigned char fh_smem[];
  const uint32_t sQ =
      ((uint32_t)__cvta_generic_to_shared(fh_smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + FH_STAGES * C::KV_BYTES;
  // barriers: Q full, then per stage K full, V full, stage empty
  const uint32_t bar_q = sQ + C::BAR;
  auto bar_k = [=](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [=](int s) { return bar_q + 8u * (1 + FH_STAGES + s); };
  auto bar_e = [=](int s) { return bar_q + 8u * (1 + 2 * FH_STAGES + s); };

  const int hi = blockIdx.x % h, bi = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FH_BQ;  // long rows first
  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + FH_BQ);              // keys <= last row
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);      // keys > row 0 - window
  k_lo = (k_lo / FH_BK) * FH_BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + FH_BK - 1) / FH_BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FH_STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = hi / group;
      mbar_expect_tx(bar_q, C::Q_BYTES);
      tma_tile<C::BOXES>(sQ, &mq, bar_q, FH_BQ, q0, hi, bi);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % FH_STAGES;
        const uint32_t parity = ((t / FH_STAGES) & 1) ^ 1;  // round 0 free
        const int kt = k_lo + t * FH_BK;
        mbar_wait(bar_e(st), parity);
        mbar_expect_tx(bar_k(st), C::KV_BYTES);
        tma_tile<C::BOXES>(sK + st * C::KV_BYTES, &mk, bar_k(st), FH_BK, kt,
                           kvh, bi);
        mbar_expect_tx(bar_v(st), C::KV_BYTES);
        tma_tile<C::BOXES>(sV + st * C::KV_BYTES, &mv, bar_v(st), FH_BK, kt,
                           kvh, bi);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int g0 = q0 + 64 * c;   // the warpgroup's first row
    const int w0 = g0 + 16 * warp;  // the warp's first row
    const int r0 = w0 + gq;       // this thread's rows: r0, r0 + 8
    const uint32_t qa = sQ + 64 * c * FH_ROW;
    float acc[D / 2], m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(bar_q, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % FH_STAGES;
      const uint32_t parity = (t / FH_STAGES) & 1;
      const int kt = k_lo + t * FH_BK;
      const uint32_t kb = sK + st * C::KV_BYTES, vb = sV + st * C::KV_BYTES;
      // one decision for the warpgroup: its 64 rows see a key of the tile
      const bool live = g0 < sq && (!causal || kt <= g0 + 63) &&
                        (window <= 0 || kt + FH_BK - 1 > g0 - window);
      mbar_wait(bar_k(st), parity);
      if (live) {
        float s[64];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(s, kmajor(qa, FH_BQ, kk), kmajor(kb, FH_BK, kk),
                      kk > 0);
        wg_commit();
        wg_wait_all();
        pin(s);
        // every key of the tile visible to every row of the warp: no mask
        const bool full = kt + FH_BK <= sk &&
                          (!causal || kt + FH_BK - 1 <= w0) &&
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
        // the running max of the raw scores (scale > 0), alpha, l
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float ms[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = ex2((m_r[r] - m_use) * scale_log2);  // 0 while unseen
          m_r[r] = m_new;
          l_r[r] *= alpha[r];
          ms[r] = m_use * scale_log2;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = ex2(fmaf(s[i], scale_log2, -ms[r]));  // masked: 0
          l_r[r] += s[i];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        mbar_wait(bar_v(st), parity);
        pin(acc);
        // p.v in two halves of 64 keys, a commit group each: the second
        // half's split runs while the first half's products do
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t ph[4][4], pl[4][4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int i = 8 * (4 * half + k4) + 2 * f;
              split_pair<T>(s[i], s[i + 1], ph[k4][f], pl[k4][f]);
            }
          pin(ph);
          pin(pl);
          wg_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const uint64_t db = mnmajor(vb, FH_BK, 4 * half + k4);
            wgmma_rs<T>(acc, pl[k4], db);
            wgmma_rs<T>(acc, ph[k4], db);
          }
          wg_commit();
        }
        wg_wait_all();
        pin(acc);
      } else {
        mbar_wait(bar_v(st), parity);  // the stage's copies have landed
      }
      mbar_arrive(bar_e(st));
    }

    // output is contiguous (b, sq, h, D), rounded once to T; lse (b, h,
    // sq) the row's log-sum-exp in natural-log units of the scaled scores:
    // m and l are kept in the exp2 domain (m raw, scale.log2(e) folded into
    // the exponent), so lse = (m scale log2(e) + log2(l)) ln 2; +inf where
    // the row sees no key (the backward's p = exp(s - lse) is then 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const float l = quad_sum(l_r[r]);
      if (row >= sq) continue;
      if (tq == 0)
        lse[((long long)bi * h + hi) * sq + row] =
            l > 0.f ? (m_r[r] * scale_log2 + log2f(l)) * FH_LN2 : INFINITY;
      T* orow = o + (((long long)bi * sq + row) * h + hi) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float o0 = l > 0.f ? acc[4 * j + 2 * r] / l : 0.f;
        const float o1 = l > 0.f ? acc[4 * j + 2 * r + 1] / l : 0.f;
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack2<T>(o0, o1);
      }
    }
  }
}

template <typename T, int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int sq, int sk, int h, int kv, long long q_sb,
                  long long q_ss, long long q_sh, long long k_sb,
                  long long k_ss, long long k_sh, long long v_sb,
                  long long v_ss, long long v_sh, int causal, int window,
                  float scale, cudaStream_t st) {
  using C = FwdCfg<D>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, enc, type, q, D, sq, h, b, q_ss, q_sh, q_sb, FH_BQ) ||
      !make_map(&mk, enc, type, k, D, sk, kv, b, k_ss, k_sh, k_sb, FH_BK) ||
      !make_map(&mv, enc, type, v, D, sk, kv, b, v_ss, v_sh, v_sb, FH_BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_hopper_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (sq + FH_BQ - 1) / FH_BQ);
  kern<<<grid, FH_THREADS, C::SMEM, st>>>(mq, mk, mv, static_cast<T*>(o),
                                          lse, sq, sk, h, h / kv, causal,
                                          window, scale * FH_LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// As repro_flash_attention (lm.cu), lse included, for the inputs this
// route takes: dtype code 1 (bfloat16) or 2 (float16), d 64 or 128, sk >=
// 1, scale > 0, q / k / v 16-byte aligned with batch, sequence and head
// strides multiples of 8 elements (the trailing one 1, which the wrapper
// checks).  Anything else returns cudaErrorInvalidValue before a launch.
int repro_flash_attention_hopper(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int b, int sq, int sk,
                                 int h, int kv, int d, long long q_sb,
                                 long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss,
                                 long long k_sh, long long v_sb,
                                 long long v_ss, long long v_sh, int causal,
                                 int window, float scale, int code,
                                 void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if ((code != 1 && code != 2) || (d != 64 && d != 128) || sk <= 0 ||
      kv <= 0 || h % kv != 0 || !(scale > 0.f) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FH(T, D)                                                       \
  launch_hopper<T, D>(q, k, v, o, lse, b, sq, sk, h, kv, q_sb, q_ss, q_sh,   \
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window,    \
                      scale, st)
  if (code == 1)
    return d == 64 ? REPRO_FH(__nv_bfloat16, 64)
                   : REPRO_FH(__nv_bfloat16, 128);
  return d == 64 ? REPRO_FH(__half, 64) : REPRO_FH(__half, 128);
#undef REPRO_FH
}

// the dynamic shared memory a block of the kernel asks for at head dim d
// (64 or 128; 0 for any other)
int repro_flash_hopper_smem_bytes(int d) {
  return d == 64 ? FwdCfg<64>::SMEM : d == 128 ? FwdCfg<128>::SMEM : 0;
}

}  // extern "C"
