// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_fwd_core through pl.pallas_call). Computes, for q [B,Sq,H,D] and
// k/v [B,Skv,Hkv,D] (contiguous, the layout of the public flash_attention),
//   O   = softmax(scale * Q K^T [+ causal mask]) V   in the input dtype,
//   LSE = row logsumexp of the scaled, masked scores  [B,H,Sq] in f32
// (LSE is the residual the backward kernels K2/K3 rebuild P from). Causal
// masks key j > query i, both counted from 0. P is rounded to bf16 before
// P V, as the Pallas kernel casts p to v's dtype; sums are f32, the
// denominator is clamped at 1e-30.
//
// Translation from the TPU kernel: the Pallas grid (B, H, q-blocks,
// k-blocks) ran its last axis in order on one core, carrying the running
// max, sum and accumulator in VMEM scratch. Here a thread block takes a
// tile of 128 query rows of one kv group and batch row at a time and loops
// over its kv tiles itself; the running max, sum and accumulator stay in
// f32 registers. The kv head is h / (H/Hkv), so the GQA repeat is never
// materialized. Any Sq and Skv work (the TPU kernel needed blocks that
// divide S).
//
// What bounds it on the H100: at the training shape (B=2, S=2048, H=32,
// Hkv=8, D=128, causal) it does 4 D flops a (q, k) pair, 68.7 GFLOP, 0.0695
// ms at 989 TFLOP/s, against ~42 MB (0.013 ms at 3.35 TB/s): it is bound
// by tensor-core operations, which only wgmma reaches at full rate, and
// next by the exponentials (one MUFU ex2 an element, 16 a clock an SM,
// half the time of the two products). So the bf16 path is a warp-
// specialized, persistent wgmma pipeline:
// - A tile is 128 query rows: G query heads of one kv group (G the largest
//   power of two that divides the group, 4 for Llama-3-8B) at 128 / G
//   consecutive positions, position-major. One K/V tile serves all of
//   them, and a short sequence still fills whole tiles (the GQA repeat is
//   read from the kv head, never materialized).
// - One block an SM (132 on the H100) walks the tiles in a fixed order:
//   the last position tiles, which see the most keys under the causal
//   mask, first, dealt out in a snake (round r gives block j tile r * grid
//   + j, or r * grid + grid - 1 - j when r is odd) so heavy and light tiles
//   even out across blocks. The next tile's Q and K/V loads run under this
//   tile's last products and its epilogue.
// - 384 threads a block: warpgroup 0 is the producer, warpgroups 1 and 2
//   are consumers of 64 query rows each. setmaxnreg moves registers from
//   the producer (24 a thread) to the consumers (240): 128 x 24 + 256 x
//   240 = 64,512 of the SM's 65,536.
// - The producer is one thread of warp 0 (the rest of its warpgroup exits):
//   it copies each tile's Q and then the K and V tiles of 128 keys with
//   TMA, K and V into a ring of 2 stages, each buffer with a "full"
//   mbarrier (TMA completes its bytes on it) and an "empty" one (the
//   consumers arrive when done). The consumers take Q into registers at the
//   start of a tile and release its buffer at once; K of a stage is
//   released as soon as S is computed from it, V after P V. TMA writes the
//   128-byte swizzle that wgmma reads and zero-fills rows past Sq/Skv and
//   columns past D (D = 32 is padded to the 64-column swizzle atom), so
//   ragged tails need no masking of the loads. The tensor maps are 4-d (D,
//   heads, S, B), built on the host through the driver entry point (no
//   -lcuda).
// - Both products are wgmma.mma_async m64nNk16, bf16 in, f32 accumulate,
//   with A from registers: S = Q K^T (m64n128; Q's fragments, K K-major
//   from shared memory) and O += P V (m64nD; P is the f32 accumulator of S
//   rounded to bf16, already in the A-register layout, V an MN-major B
//   through the transpose bit). Q in registers instead of shared memory
//   cuts the operand bytes S reads from shared memory by a third, and was
//   faster at both main-path shapes on the card.
// - Softmax overlaps the products: a consumer issues S_{i+1} = Q K_{i+1}^T
//   and O += P_i V_i back to back, computes the softmax of S_{i+1} while
//   P_i V_i runs, and only then rescales O; the two consumer warpgroups
//   interleave on the tensor cores. (Ping-pong between them with named
//   barriers made ptxas spill and serialize the products: much slower.)
// - Elementwise work as K2 does it: P = 2^(S sl2 - m2) with sl2 = scale
//   log2(e) folded into one FFMA an element (m2 is the running max in that
//   base; LSE goes back to natural log at the end); the row sum is kept
//   per thread and summed over the row's four threads only at the end; the
//   mask only on tiles that cross the diagonal or Skv's end, which are
//   processed first (a tile's kv tiles run from the last to the first);
//   causal kv tiles wholly above the diagonal are never loaded. A negative
//   scale negates Q inside the product (imm-scale-a), so sl2 stays
//   positive.
// - Shared memory at D = 128: Q 2 x 16 KB + 2 stages x (K + V) 2 x 64 KB =
//   160 KB, + 1 KB to align the tiles to 1,024 bytes + the barriers; at D =
//   64 and 32, 80 KB. One block an SM (registers and shared memory).
// - Grids: at the training shape, 1,024 tiles (64 position tiles x 8 head
//   groups x 2) over 132 blocks, 7.8 a block; at the serving shape (B=8,
//   S=176), 384 tiles (6 x 8 x 8), 2.9 a block. The last position tile
//   there has 16 positions (64 rows), so its second consumer warpgroup
//   computes on zeros and stores nothing.
//
// The f32 path (used at small shapes, with TF32 off for parity) is plain
// FMA on shared-memory tiles: f32 inputs take no tensor-core shortcut.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// 10000 + the CUresult when a tensor map cannot be built.

#include <cuda.h>  // CUtensorMap and its enums; no driver library is linked

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;  // ray_tpu's NEG_INF (not -inf)
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16 path: warp-specialized wgmma with a TMA ring
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;       // query rows of a consumer warpgroup
constexpr int kBQ = 2 * kWgRows;  // query rows a block
constexpr int kBK = 128;          // keys a kv tile
constexpr int kStages = 2;        // depth of the K and V rings
constexpr int kWsThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of a block (DP columns): 1,024 bytes of slack to align the
// tiles, the Q buffer (two 64-row tiles, one a consumer warpgroup), kStages
// K tiles, kStages V tiles, then the mbarriers: Q full/empty, and K
// full/empty and V full/empty for each stage.
template <int DP>
struct Smem {
  static constexpr uint32_t kQ = kWgRows * DP * 2;    // one warpgroup's Q
  static constexpr uint32_t kKV = kBK * DP * 2;       // one K or V tile
  static constexpr uint32_t kK = 2 * kQ;              // K stage 0
  static constexpr uint32_t kV = kK + kStages * kKV;  // V stage 0
  static constexpr uint32_t kBars = kV + kStages * kKV;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (2 + 4 * kStages);
};

// S = +-Q K^T for the warpgroup's 64 rows and the tile's 128 keys: Q as
// bf16 A fragments in registers (qf[kk]: columns 16kk..16kk+15), K K-major
// from shared memory.
template <int DP, bool kNeg>
__device__ __forceinline__ void issue_scores_signed(
    float (&s)[64], const uint32_t (&qf)[DP / 16][4], uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs_n128_k<kNeg>(s, qf[kk], desc_k<kBK>(k, kk), kk > 0);
}

template <int DP>
__device__ __forceinline__ void issue_scores(float (&s)[64],
                                             const uint32_t (&qf)[DP / 16][4],
                                             uint32_t k, bool neg) {
  if (neg)
    issue_scores_signed<DP, true>(s, qf, k);
  else
    issue_scores_signed<DP, false>(s, qf, k);
}

// The warpgroup's Q tile (64 rows, swizzled) as wgmma A fragments: this
// thread's rows g and g + 8 of its warp's 16, columns 16kk + c2, +1 and
// 16kk + 8 + c2, +1.
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DP / 16][4],
                                             const unsigned char* tile,
                                             int warp, int lane) {
  const int r = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qf[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + tile_off<kWgRows>(r + 8 * (i & 1), 2 * kk + (i >> 1)) +
          2 * c2);
}

// O += P V: P (64 x 128 keys) as bf16 A fragments, V a 128-row tile read
// MN-major (128 keys x DP).
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&p)[8][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<DP>(o, p[kk], desc_mn<kBK>(v, kk));
}

// The online-softmax step for one tile of scores s (in place: P), with the
// running max m2 (base 2: max of S sl2) and this thread's share of the row
// sums l. Element e of column block j is this thread's row e >> 1 (query
// position pos[e >> 1]), key k0 + 8j + c2 + (e & 1). alpha = 2^(m2_old -
// m2_new) rescales O afterwards. kMask drops keys past Skv and above the
// diagonal: only tiles that reach either need it.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sl2, int k0, int c2,
                                             const int (&pos)[2], int SKV,
                                             int causal) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask) {
        const int col = k0 + 8 * j + c2 + (e & 1);
        if (col >= SKV || (causal && col > pos[e >> 1]))
          s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r] * sl2);
    alpha[r] = ex2(m2[r] - m_new);
    m2[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(fmaf(s[4 * j + e], sl2, -m2[r]));
      if (kMask && s[4 * j + e] == -INFINITY) p = 0.f;  // also at scale 0
      s[4 * j + e] = p;
      rs[r] += p;
    }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// The work of one block-sized tile: query positions p0.. of heads h0..h0+G-1
// (of one kv group) of batch row b, and the kv tiles it needs.
struct Tile {
  int p0, h0, b, n_kv;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    bf16* __restrict__ o, float* __restrict__ lse, int B,
                    int H, int HKV, int SQ, int SKV, int lg, float sl2,
                    int neg, int causal) {
  constexpr int DP = D < 64 ? 64 : D;
  using L = Smem<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  // A tile's rows are the query heads h0..h0+G-1 (G = 2^lg, all of one kv
  // group) at kBQ / G consecutive positions from p0, position-major: local
  // row R is position p0 + (R >> lg) of head h0 + (R & (G - 1)). Tiles are
  // numbered position-tile-major, the last position tiles (which see the
  // most keys under the causal mask) first, and dealt to the persistent
  // blocks in a snake: round r gives block j tile r * grid + j when r is
  // even and r * grid + grid - 1 - j when r is odd, so the heavy and the
  // light tiles even out across blocks.
  const int G = 1 << lg, n_groups = H >> lg;
  const int pos_tile = kBQ >> lg, pos_wg = kWgRows >> lg;
  const int n_t = (SQ + pos_tile - 1) / pos_tile;
  const int n_tiles = n_t * n_groups * B;
  auto tile_of = [&](int round) {
    const int idx = round * gridDim.x +
                    ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    Tile T;
    T.n_kv = 0;  // past the last tile
    if (idx < n_tiles) {
      const int t = idx / (n_groups * B), hb = idx % (n_groups * B);
      T.p0 = (causal ? n_t - 1 - t : t) * pos_tile;
      T.h0 = (hb % n_groups) * G;
      T.b = hb / n_groups;
      // Causal: keys past the tile's last position are masked everywhere.
      const int kv_end = causal ? min(SKV, T.p0 + pos_tile) : SKV;
      T.n_kv = (kv_end + kBK - 1) / kBK;
    }
    return T;
  };
  const int rounds = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 256);
      mbar_init(v_empty + 8 * s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer. Tile n's Q goes in once the consumers have taken tile n -
    // 1's into registers; the ring's it-th K (and V) tile, counted across
    // the block's tiles, goes to stage it % kStages once use it / kStages
    // - 1 of that stage is released. A tile's kv tiles run from the last
    // to the first.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int n = 0; n < rounds; ++n) {
        const Tile T = tile_of(n);
        if (T.n_kv == 0) break;
        const int hk = T.h0 / (H / HKV);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int cb = 0; cb < DP / 64; ++cb)
            tma_load_4d(base + w * L::kQ + cb * kWgRows * kRowBytes, &tm_q,
                        q_full, cb * 64, T.h0, T.p0 + w * pos_wg, T.b);
        for (int i = 0; i < T.n_kv; ++i, ++it) {
          const int st = it % kStages, u = it / kStages;
          const int k0 = (T.n_kv - 1 - i) * kBK;
          if (u > 0) mbar_wait(k_empty + 8 * st, (u - 1) & 1);
          mbar_expect_tx(k_full + 8 * st, L::kKV);
#pragma unroll
          for (int cb = 0; cb < DP / 64; ++cb)
            tma_load_4d(base + L::kK + st * L::kKV + cb * kBK * kRowBytes,
                        &tm_k, k_full + 8 * st, cb * 64, hk, k0, T.b);
          if (u > 0) mbar_wait(v_empty + 8 * st, (u - 1) & 1);
          mbar_expect_tx(v_full + 8 * st, L::kKV);
#pragma unroll
          for (int cb = 0; cb < DP / 64; ++cb)
            tma_load_4d(base + L::kV + st * L::kKV + cb * kBK * kRowBytes,
                        &tm_v, v_full + 8 * st, cb * 64, hk, k0, T.b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // Both consumer warpgroups work on every tile (a warpgroup whose rows
    // all lie past Sq computes on TMA's zeros and stores nothing), so the
    // barrier counts stay fixed.
    const int w = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int c2 = (lane & 3) * 2;
    const int row_a = w * kWgRows + warp * 16 + (lane >> 2);  // +8: 2nd row
    const bool neg_scale = neg != 0;
    const unsigned char* q_tile =
        smem_raw + (base - smem_addr(smem_raw)) + w * L::kQ;

    float acc[DP / 2], s[64];
    uint32_t p[8][4];
    int it = 0;
    for (int n = 0; n < rounds; ++n) {
      const Tile T = tile_of(n);
      if (T.n_kv == 0) break;
      const int r0 = T.p0 + w * pos_wg;  // the warpgroup's first position
      // This thread's two rows: positions and heads.
      const int pos[2] = {T.p0 + (row_a >> lg), T.p0 + ((row_a + 8) >> lg)};
      const int head[2] = {T.h0 + (row_a & (G - 1)),
                           T.h0 + ((row_a + 8) & (G - 1))};
      // A kv tile needs the mask if it reaches past Skv or above the
      // diagonal of the warpgroup's first position.
      auto needs_mask = [&](int k0) {
        return k0 + kBK > SKV || (causal && k0 + kBK - 1 > r0);
      };
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
      float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

      // Q into registers, and its buffer back to the producer (the reads
      // are ordered before TMA's next write by the proxy fence).
      mbar_wait(q_full, n & 1);
      uint32_t qf[DP / 16][4];
      load_q_frags<DP>(qf, q_tile, warp, lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(q_empty);

      // kv tile 0: S_0 alone (nothing to overlap it with yet).
      int st = it % kStages;
      mbar_wait(k_full + 8 * st, (it / kStages) & 1);
      wgmma_fence();
      issue_scores<DP>(s, qf, base + L::kK + st * L::kKV, neg_scale);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      mbar_arrive(k_empty + 8 * st);
      int k0 = (T.n_kv - 1) * kBK;
      if (needs_mask(k0))
        softmax_tile<true>(s, m2, l, alpha, sl2, k0, c2, pos, SKV, causal);
      else
        softmax_tile<false>(s, m2, l, alpha, sl2, k0, c2, pos, SKV, causal);
      to_frags(p, s);

      for (int i = 1; i < T.n_kv; ++i) {
        const int prev = st;
        st = (it + i) % kStages;
        k0 -= kBK;
        mbar_wait(k_full + 8 * st, ((it + i) / kStages) & 1);
        pin(acc);
        pin(p);
        wgmma_fence();
        issue_scores<DP>(s, qf, base + L::kK + st * L::kKV, neg_scale);
        wgmma_commit();  // S_i = Q K_i^T
        mbar_wait(v_full + 8 * prev, ((it + i - 1) / kStages) & 1);
        issue_pv<DP>(acc, p, base + L::kV + prev * L::kKV);
        wgmma_commit();  // O += P_{i-1} V_{i-1}
        wgmma_wait<1>();  // S_i is in; its softmax runs under P V
        pin(s);
        mbar_arrive(k_empty + 8 * st);
        if (needs_mask(k0))
          softmax_tile<true>(s, m2, l, alpha, sl2, k0, c2, pos, SKV,
                             causal);
        else
          softmax_tile<false>(s, m2, l, alpha, sl2, k0, c2, pos, SKV,
                              causal);
        wgmma_wait<0>();
        pin(acc);
        pin(p);
        mbar_arrive(v_empty + 8 * prev);
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
        to_frags(p, s);
      }
      mbar_wait(v_full + 8 * st, ((it + T.n_kv - 1) / kStages) & 1);
      pin(acc);
      pin(p);
      wgmma_fence();
      issue_pv<DP>(acc, p, base + L::kV + st * L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(p);
      mbar_arrive(v_empty + 8 * st);
      it += T.n_kv;

      // The row sums over the row's four threads, then O / l and LSE.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        if (pos[r] >= SQ) continue;
        const float den = fmaxf(l[r], 1e-30f), inv = 1.f / den;
        bf16* orow = o + (((long)T.b * SQ + pos[r]) * H + head[r]) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + j * 8 + c2) =
              pack_bf16(acc[4 * j + 2 * r] * inv,
                        acc[4 * j + 2 * r + 1] * inv);
        if ((lane & 3) == 0)
          lse[((long)T.b * H + head[r]) * SQ + pos[r]] =
              m2[r] * kLn2 + logf(den);
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map (D, heads, S, B) of a contiguous [B, S, heads, D] bf16 tensor,
// box 64 columns x box_heads heads x box_rows positions x 1, 128-byte
// swizzle, zero fill past every bound (the columns past D = 32 too).
int tensor_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
               int B, int box_heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 10000 + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int H, int HKV, int SQ, int SKV,
                 float scale, int causal, cudaStream_t stream) {
  // Pack G = 2^lg query heads of a kv group into a block's rows: the
  // largest power of two that divides the group, at most 64.
  int lg = 0;
  while (lg < 6 && (H / HKV) % (2 << lg) == 0) ++lg;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = tensor_map(&tm_q, q, D, H, SQ, B, 1 << lg, kWgRows >> lg);
  if (err == 0) err = tensor_map(&tm_k, k, D, HKV, SKV, B, 1, kBK);
  if (err == 0) err = tensor_map(&tm_v, v, D, HKV, SKV, B, 1, kBK);
  if (err != 0) return err;
  const size_t smem = Smem<(D < 64 ? 64 : D)>::kBytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  int device = 0, sms = 0;
  cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (cerr != cudaSuccess) return (int)cerr;
  const int tiles = (SQ + (kBQ >> lg) - 1) / (kBQ >> lg) * (H >> lg) * B;
  const int blocks = tiles < sms ? tiles : sms;  // persistent
  flash_fwd_wgmma<D><<<blocks, kWsThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), B,
      H, HKV, SQ, SKV, lg, fabsf(scale) * kLog2e, scale < 0.f, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 path: FMA on shared-memory tiles
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;  // 4 warps
constexpr int kSQ = 16;     // query rows per block
constexpr int kSK = 32;     // keys per tile
constexpr int kMaxD = 128;  // largest head dim
constexpr int kAccPerThread = kSQ * kMaxD / kThreads;

__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int HKV, int SQ,
                         int SKV, int D, float scale, int causal) {
  __shared__ float Qs[kSQ][kMaxD];
  __shared__ float Ks[kSK][kMaxD + 1];  // +1: conflict-free column reads
  __shared__ float Vs[kSK][kMaxD];
  __shared__ float Ss[kSQ][kSK];
  __shared__ float m_s[kSQ], l_s[kSQ], a_s[kSQ];

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int hk = h / (H / HKV);
  const int q0 = blockIdx.x * kSQ;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const float* qb = q + (long)b * SQ * q_stride + (long)h * D;
  const float* kb = k + (long)b * SKV * kv_stride + (long)hk * D;
  const float* vb = v + (long)b * SKV * kv_stride + (long)hk * D;

  for (int i = tid; i < kSQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r][d] = (q0 + r < SQ) ? qb[(long)(q0 + r) * q_stride + d] : 0.f;
  }
  if (tid < kSQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(SKV, q0 + kSQ) : SKV;
  for (int k0 = 0; k0 < kv_end; k0 += kSK) {
    __syncthreads();
    for (int i = tid; i < kSK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < SKV;
      Ks[r][d] = in ? kb[(long)(k0 + r) * kv_stride + d] : 0.f;
      Vs[r][d] = in ? vb[(long)(k0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kSQ * kSK; i += kThreads) {
      const int r = i / kSK, j = i % kSK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += Qs[r][d] * Ks[j][d];
      float x = dot * scale;
      if (k0 + j >= SKV || (causal && k0 + j > q0 + r)) x = kNegInf;
      Ss[r][j] = x;
    }
    __syncthreads();
    if (tid < kSQ) {
      const int r = tid;
      float mx = m_s[r];
      for (int j = 0; j < kSK; ++j) mx = fmaxf(mx, Ss[r][j]);
      float sum = 0.f;
      for (int j = 0; j < kSK; ++j) {
        const float p = expf(Ss[r][j] - mx);
        Ss[r][j] = p;
        sum += p;
      }
      const float alpha = expf(m_s[r] - mx);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = mx;
      a_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + kThreads * i;
      if (e < kSQ * D) {
        const int r = e / D, d = e % D;
        float a = acc[i] * a_s[r];
        for (int j = 0; j < kSK; ++j) a += Ss[r][j] * Vs[j][d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  float* ob = o + (long)b * SQ * q_stride + (long)h * D;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + kThreads * i;
    if (e < kSQ * D) {
      const int r = e / D, d = e % D;
      if (q0 + r < SQ)
        ob[(long)(q0 + r) * q_stride + d] = acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
  if (tid < kSQ && q0 + tid < SQ)
    lse[((long)b * H + h) * SQ + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int HKV,
                              int SQ, int SKV, int D, float scale, int causal,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_wgmma<32>(q, k, v, o, lse, B, H, HKV, SQ, SKV, scale,
                              causal, s);
    case 64:
      return launch_wgmma<64>(q, k, v, o, lse, B, H, HKV, SQ, SKV, scale,
                              causal, s);
    case 128:
      return launch_wgmma<128>(q, k, v, o, lse, B, H, HKV, SQ, SKV, scale,
                               causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int HKV, int SQ,
                             int SKV, int D, float scale, int causal,
                             void* stream) {
  if (D % 8 != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 grid((SQ + kSQ - 1) / kSQ, H, B);
  flash_fwd_f32_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, HKV, SQ, SKV, D, scale, causal);
  return (int)cudaGetLastError();
}
