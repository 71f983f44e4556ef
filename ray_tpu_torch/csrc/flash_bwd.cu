// K2 and K3: flash-attention backward for Hopper (sm_90a).
//
// K2 (flash_bwd_dq_*) replaces ray_tpu/ops/attention.py::_flash_dq_kernel
// and K3 (flash_bwd_dkv_*) replaces ::_flash_dkv_kernel, both launched by
// _flash_bwd_core through pl.pallas_call. For q/dO [B,Sq,H,D], k/v
// [B,Skv,Hkv,D] (contiguous, the layout of the public flash_attention), K1's
// row logsumexp LSE [B,H,Sq] and Delta = rowsum(dO * O) [B,H,Sq] (both f32,
// Delta computed outside the kernels as the Pallas code does):
//   P  = exp(scale * Q K^T [causal mask] - LSE)
//   dS = P * (dO V^T - Delta) * scale
//   K2: dQ = dS K                         in q's dtype
//   K3: dV = P^T dO, dK = dS^T Q          in k's dtype, per kv head
// In the bf16 path P is rounded to bf16 before P^T dO and dS before dS K and
// dS^T Q, as the Pallas kernels cast p to dO's dtype and ds to q's/k's.
//
// Translation from the TPU kernels: the Pallas grids ran the reduction axis
// (k-blocks for dQ, q-blocks for dK/dV) in order on one core and carried the
// sum in VMEM scratch. Here one thread block owns one output tile and loops
// over the reduction itself, the sum held in f32 registers:
// - K2: one block per (64-row q tile, head h, batch b), looping over kv tiles
//   up to the diagonal. The kv head is h / (H/Hkv): no GQA repeat.
// - K3: one block per (64-key kv tile, kv head hk, batch b), looping over the
//   H/Hkv query heads of its group and, for each, the q tiles from the
//   diagonal on. The Pallas kernel wrote dK/dV per expanded head and XLA
//   summed each group through the VJP of jnp.repeat; here the group sum
//   happens inside the block, with no atomics and in a fixed order, so the
//   gradients are bitwise the same from run to run.
// Keys past Skv and queries past Sq are masked, so any length works (the
// Pallas kernels needed blocks that divide S).
//
// What bounds them on the H100: at the training shape (B=2, S=2048, H=32,
// Hkv=8, D=128, causal; 2,098,176 (q, k) pairs a batch row and head) K2 does
// 6*D flops a pair (S = Q K^T, dP = dO V^T, dQ = dS K): 103.1 GFLOP, 0.104 ms
// at 989 TFLOP/s; K3 8*D (S^T, dP^T, dV, dK): 137.5 GFLOP, 0.139 ms. Their
// bytes (~119 and ~102 MB, each input read once) take ~0.035 ms at 3.35
// TB/s: both are bound by tensor-core operations, and on Hopper only wgmma
// reaches the tensor cores' full rate. So the bf16 path is built around it:
// - One warpgroup (4 warps, 128 threads) a block. Every product is
//   wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) over 64-row tiles.
//   K2: S = Q K^T and dP = dO V^T read both operands K-major from shared
//   memory; dQ += dS K takes dS from registers (the f32 accumulator of S,
//   rounded to bf16, is already in wgmma's A-register layout) and K as an
//   MN-major B through the transpose bit. K3 computes the transposed scores
//   S^T = K Q^T and dP^T = V dO^T the same way, so P^T and dS^T are A
//   registers for dV += P^T dO and dK += dS^T Q, with dO and Q MN-major:
//   no transpose is ever written out.
// - Tiles in shared memory are 64 rows of DP = max(D, 64) bf16, stored as
//   64-column blocks of 128-byte rows in the 128-byte swizzle wgmma reads
//   (16-byte chunk c of row r at chunk c ^ (r % 8)), so one tile serves as a
//   K-major operand (S, dP) and as an MN-major one (dQ, dV, dK). D = 32 is
//   zero-padded to 64 columns.
// - Loads are cp.async into a ring of 2 stages (K2: the K/V tiles; K3: the
//   Q/dO tiles and their LSE/Delta rows), with zero fill for rows past S and
//   columns past D. The copy of step i+1 starts right after the barrier
//   that opens step i, so it runs under step i's products; the stage it
//   overwrites was read by step i-1, whose wgmma groups every thread waited
//   for before that barrier. Each thread waits for its own copies
//   (cp.async.wait_group), makes them visible to wgmma's async proxy
//   (fence.proxy.async), then the barrier.
// - Inside a step the elementwise work runs under the products: S and dP
//   are committed as two wgmma groups, and P = 2^(S scale log2(e) - LSE
//   log2(e)) (one FFMA and one ex2 an element; the mask only on tiles that
//   cross the diagonal or an end) is computed while dP's product runs. K3
//   then starts dV += P^T dO before it computes dS^T.
// - Blocks an SM: K3 holds dK and dV (64 keys x 128, f32) in 128 registers
//   a thread, plus 32 each for S^T and dP^T (255 registers at D=128, with a
//   few bytes spilled); K2 holds dQ in 64 plus S and dP (196). Both are
//   held to 255 registers, so 2 blocks (8 warps) fit an SM's
//   65,536 registers, and the shared memory is sized for 2 as well: at
//   D=128, K2 Q + dO + 2 x (K + V) = 96 KB and K3 K + V + 2 x (Q + dO) +
//   rows = 97 KB (+1 KB to align the tiles to 1,024 bytes), 2 x ~99 KB of
//   the SM's 228 KB. The main path's grids (2,048 K2 blocks, 512 K3 blocks)
//   fill 264 slots on 132 SMs; one block's elementwise work and waits run
//   under the other's products.
// - Causal balance: a block's work grows with the keys (K2) or queries (K3)
//   it sees. Blocks are numbered tile-major over (head, batch), so every
//   heaviest tile starts before any lighter one: K2's last q tiles first,
//   K3's first kv tiles first (block k0 does work in proportion to
//   group * (S - k0)).
//
// The f32 path (small shapes, parity with TF32 off) is plain FMA on
// shared-memory tiles.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;  // 4 warps: one warpgroup

// ---------------------------------------------------------------------------
// bf16 tensor-core path: wgmma over cp.async-fed swizzled tiles
// (helpers in hopper.cuh)
// ---------------------------------------------------------------------------
constexpr int kTile = 64;   // rows of every tile: q rows (K2), keys (K3)
constexpr int kStages = 2;  // depth of the load ring

// 16- and 4-byte asynchronous copies to shared memory; src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies, then make them visible to wgmma, which
// reads shared memory through the async proxy. A barrier follows.
__device__ __forceinline__ void cp_async_land() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start copying rows [r0, r0 + kTile) of a [S, row_stride] bf16 matrix with
// D columns into the tile at dst (DP columns); rows at or past S and
// columns at or past D are zero-filled.
template <int D, int DP>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                long row_stride, int r0,
                                                int S) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, cc = c % kChunks;
    const bool in = r0 + r < S && cc * 8 < D;
    cp_async16(dst + tile_off<kTile>(r, cc),
               in ? src + (long)(r0 + r) * row_stride + cc * 8 : src,
               in ? 16 : 0);
  }
}

// s = A B^T over DP columns: A and B are 64-row tiles, both K-major.
template <int DP>
__device__ __forceinline__ void wgmma_scores(float (&s)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(s, desc_k<kTile>(a, kk), desc_k<kTile>(b, kk), kk > 0);
}

// acc += P B: P (64 x 64) as bf16 A fragments p[kk] for the k steps
// kk = 0..3, B a 64-row tile read MN-major (64 x DP).
template <int DP>
__device__ __forceinline__ void wgmma_accumulate(float (&acc)[DP / 2],
                                                 const uint32_t (&p)[4][4],
                                                 uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP>(acc, p[kk], desc_mn<kTile>(b, kk));
}

// P = 2^(S sl2 - lse2) in place, with sl2 = scale log2(e) and lse2 = LSE
// log2(e): one FFMA and one ex2 an element. K2's tile: element e of column
// block j is row row_a + 8 (e >> 1), key col0 + 8j + (e & 1). kMask zeroes
// P past the keys and above the diagonal: only tiles that reach either
// need it.
template <bool kMask>
__device__ __forceinline__ void dq_p(float (&s)[32], const float (&lse2)[2],
                                     float sl2, int col0, int row_a, int SKV,
                                     int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(fmaf(s[4 * j + e], sl2, -lse2[r]));
      if (kMask) {
        const int col = col0 + j * 8 + (e & 1);
        if (col >= SKV || (causal && col > row_a + 8 * r)) p = 0.f;
      }
      s[4 * j + e] = p;
    }
}

// The same for K3's transposed tile: element e of column block j is key
// key_a + 8 (e >> 1), query q0 + qc, qc = 8j + c2 + (e & 1), its LSE in
// shared memory (lse_s[qc]). kMask also zeroes P past the queries.
template <bool kMask>
__device__ __forceinline__ void dkv_p(float (&st)[32], const float* lse_s,
                                      float sl2, int q0, int c2, int key_a,
                                      int SQ, int SKV, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = j * 8 + c2;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      float p = ex2(fmaf(st[4 * j + e], sl2, -(c ? l2.y : l2.x) * kLog2e));
      if (kMask) {
        const int qi = q0 + qc + c;
        const int key = key_a + 8 * (e >> 1);
        if (qi >= SQ || key >= SKV || (causal && key > qi)) p = 0.f;
      }
      st[4 * j + e] = p;
    }
  }
}

// Write a 64 x DP f32 accumulator as bf16: this thread's rows row_a (d[4j],
// d[4j+1]) and row_a + 8 (d[4j+2], d[4j+3]), columns 8j + c2, +1, of a
// [S, row_stride] matrix; rows at or past S and columns at or past D are
// dropped.
template <int D, int DP>
__device__ __forceinline__ void store_acc(bf16* dst, long row_stride,
                                          const float (&acc)[DP / 2],
                                          int row_a, int S, int c2) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + c2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(dst + (long)row_a * row_stride + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row_a + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (long)(row_a + 8) * row_stride +
                                   col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int DP>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kTile * DP * 2;
}

// Shared memory of a block: 1,024 bytes of slack to align the tiles, then
// the two resident tiles, kStages stages of two tiles each, and (K3) the
// stages' LSE/Delta rows.
template <int DP>
constexpr size_t smem_bytes(bool rows) {
  return 1024 + (2 + 2 * kStages) * tile_bytes<DP>() +
         (rows ? kStages * 2 * kTile * sizeof(float) : 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int B, int H, int HKV, int SQ, int SKV, float scale,
                       int causal) {
  constexpr int DP = D < 64 ? 64 : D;
  constexpr uint32_t kBytes = tile_bytes<DP>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base, dOs = base + kBytes;  // then the K/V stages

  // Tile-major numbering: the last q tiles see the most keys under the
  // causal mask, so every (head, batch)'s last tile starts first.
  const int n_q = (SQ + kTile - 1) / kTile;
  const int t = blockIdx.x / (H * B), hb = blockIdx.x % (H * B);
  const int q0 = (causal ? n_q - 1 - t : t) * kTile;
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / HKV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // +8: the second row
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const long q_off = (long)b * SQ * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * SKV * kv_stride + (long)hk * D;
  const bf16* vb = v + (long)b * SKV * kv_stride + (long)hk * D;

  // Causal: keys past the tile's last query row are masked for every row.
  const int kv_end = causal ? min(SKV, q0 + kTile) : SKV;
  const int steps = (kv_end + kTile - 1) / kTile;
  auto prefetch = [&](int i) {  // step i's K and V tiles into a stage
    if (i < steps) {
      const uint32_t st = base + (2 + 2 * (i % kStages)) * kBytes;
      load_tile_async<D, DP>(st, kb, kv_stride, i * kTile,
                                              SKV);
      load_tile_async<D, DP>(st + kBytes, vb, kv_stride,
                                              i * kTile, SKV);
    }
    cp_async_commit();
  };
  load_tile_async<D, DP>(Qs, q + q_off, q_stride, q0, SQ);
  load_tile_async<D, DP>(dOs, dout + q_off, q_stride, q0,
                                          SQ);
  prefetch(0);

  const float* lrow = lse + ((long)b * H + h) * SQ;
  const float* drow = delta + ((long)b * H + h) * SQ;
  const float sl2 = scale * kLog2e;
  float lse_r[2], dl_r[2];  // LSE log2(e) and Delta scale of the two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    lse_r[i] = row < SQ ? lrow[row] * kLog2e : 0.f;
    dl_r[i] = row < SQ ? drow[row] * scale : 0.f;
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    cp_async_land();
    __syncthreads();  // step i is in; every thread is done with step i-1
    prefetch(i + 1);  // into step i-1's stage, under step i's products
    const uint32_t Ks = base + (2 + 2 * (i % kStages)) * kBytes;
    const uint32_t Vs = Ks + kBytes;

    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
    wgmma_scores<DP>(s, Qs, Ks);  // S = Q K^T
    wgmma_commit();
    wgmma_scores<DP>(dp, dOs, Vs);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();  // S is in; P is computed under dP's product
    pin(s);
    const int k0 = i * kTile;
    if (k0 + kTile <= SKV && !(causal && k0 + kTile - 1 > q0))
      dq_p<false>(s, lse_r, sl2, k0 + c2, row_a, SKV, causal);
    else
      dq_p<true>(s, lse_r, sl2, k0 + c2, row_a, SKV, causal);
    wgmma_wait<0>();
    pin(dp);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      s[j] *= fmaf(dp[j], scale, -dl_r[(j >> 1) & 1]);  // dS
    uint32_t f[4][4];
    to_frags(f, s);
    pin(acc);
    pin(f);
    wgmma_fence();
    wgmma_accumulate<DP>(acc, f, Ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(f);
  }
  cp_async_land();  // no copy outlives the block
  store_acc<D, DP>(dq + q_off, q_stride, acc, row_a, SQ, c2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_wgmma(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                        int H, int HKV, int SQ, int SKV, float scale,
                        int causal) {
  constexpr int DP = D < 64 ? 64 : D;
  constexpr uint32_t kBytes = tile_bytes<DP>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = ((smem_addr(smem_raw) + 1023) & ~1023u) -
                       smem_addr(smem_raw);
  const uint32_t base = smem_addr(smem_raw) + pad;
  const uint32_t Ks = base, Vs = base + kBytes;  // then the Q/dO stages
  const uint32_t rows_off = pad + (2 + 2 * kStages) * kBytes;
  const uint32_t rows_addr = smem_addr(smem_raw) + rows_off;
  float* rows = reinterpret_cast<float*>(smem_raw + rows_off);

  // Tile-major numbering: under the causal mask kv tile 0 sees every query,
  // so every (kv head, batch)'s first tile starts first.
  const int t = blockIdx.x / (HKV * B), hb = blockIdx.x % (HKV * B);
  const int k0 = t * kTile;
  const int hk = hb % HKV, b = hb / HKV;
  const int group = H / HKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // +8: the second key
  const float sl2 = scale * kLog2e;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const long kv_off = (long)b * SKV * kv_stride + (long)hk * D;

  // Causal: q tiles wholly before the block's first key see none of it.
  const int n_q = (SQ + kTile - 1) / kTile;
  const int qt0 = causal ? min(t, n_q) : 0;
  const int per_head = n_q - qt0;
  const int steps = group * per_head;  // head-major, q tiles in order
  auto prefetch = [&](int i) {  // step i's Q, dO, LSE and Delta into a stage
    if (i < steps) {
      const int h = hk * group + i / per_head;
      const int r0 = (qt0 + i % per_head) * kTile;
      const long q_off = (long)b * SQ * q_stride + (long)h * D;
      const uint32_t st = base + (2 + 2 * (i % kStages)) * kBytes;
      load_tile_async<D, DP>(st, q + q_off, q_stride, r0,
                                              SQ);
      load_tile_async<D, DP>(st + kBytes, dout + q_off,
                                              q_stride, r0, SQ);
      // Threads 0..63 copy the LSE row, 64..127 the Delta row.
      const int r = threadIdx.x & (kTile - 1);
      const float* src = (threadIdx.x < kTile ? lse : delta) +
                         ((long)b * H + h) * SQ + r0 + r;
      const bool in = r0 + r < SQ;
      cp_async4(rows_addr + ((i % kStages) * 2 * kTile + threadIdx.x) * 4,
                in ? src : lse, in ? 4 : 0);
    }
    cp_async_commit();
  };
  load_tile_async<D, DP>(Ks, k + kv_off, kv_stride, k0,
                                          SKV);
  load_tile_async<D, DP>(Vs, v + kv_off, kv_stride, k0,
                                          SKV);
  prefetch(0);

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    cp_async_land();
    __syncthreads();  // step i is in; every thread is done with step i-1
    prefetch(i + 1);  // into step i-1's stage, under step i's products
    const uint32_t Qs = base + (2 + 2 * (i % kStages)) * kBytes;
    const uint32_t dOs = Qs + kBytes;
    const float* lse_s = rows + (i % kStages) * 2 * kTile;
    const float* dl_s = lse_s + kTile;
    const int q0 = (qt0 + i % per_head) * kTile;

    // Transposed scores: rows are the block's 64 keys, columns the tile's
    // 64 queries.
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    pin(st);
    pin(dpt);
    wgmma_fence();
    wgmma_scores<DP>(st, Ks, Qs);  // S^T = K Q^T
    wgmma_commit();
    wgmma_scores<DP>(dpt, Vs, dOs);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; P^T is computed under dP^T's product
    pin(st);
    if (q0 + kTile <= SQ && k0 + kTile <= SKV &&
        !(causal && k0 + kTile - 1 > q0))
      dkv_p<false>(st, lse_s, sl2, q0, c2, key_a, SQ, SKV, causal);
    else
      dkv_p<true>(st, lse_s, sl2, q0, c2, key_a, SQ, SKV, causal);
    uint32_t pf[4][4], df[4][4];
    to_frags(pf, st);
    pin(dv_acc);
    pin(pf);
    wgmma_fence();
    wgmma_accumulate<DP>(dv_acc, pf, dOs);  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dS^T is computed under dV's product
    pin(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dl_s + j * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] *
                         fmaf(dpt[4 * j + e], scale,
                              -((e & 1) ? d2.y : d2.x) * scale);  // dS^T
    }
    to_frags(df, dpt);
    pin(dk_acc);
    pin(df);
    wgmma_fence();
    wgmma_accumulate<DP>(dk_acc, df, Qs);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
    pin(pf);
    pin(df);
  }
  cp_async_land();  // no copy outlives the block
  store_acc<D, DP>(dk + kv_off, kv_stride, dk_acc, key_a, SKV, c2);
  store_acc<D, DP>(dv + kv_off, kv_stride, dv_acc, key_a, SKV, c2);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int H, int HKV, int SQ, int SKV,
                    float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<(D < 64 ? 64 : D)>(false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (SQ + kTile - 1) / kTile * H * B;
  flash_bwd_dq_wgmma<D><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), B, H, HKV, SQ, SKV, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int HKV, int SQ,
                     int SKV, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<(D < 64 ? 64 : D)>(true);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (SKV + kTile - 1) / kTile * HKV * B;
  flash_bwd_dkv_wgmma<D><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, HKV, SQ, SKV,
      scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 path: FMA on shared-memory tiles
// ---------------------------------------------------------------------------
constexpr int kFQ = 16;     // query rows per tile
constexpr int kFK = 16;     // keys per tile
constexpr int kMaxD = 128;  // largest head dim
constexpr int kAccPerThread = 16 * kMaxD / kThreads;

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int H, int HKV, int SQ,
                            int SKV, int D, float scale, int causal) {
  __shared__ float Qs[kFQ][kMaxD];
  __shared__ float dOs[kFQ][kMaxD];
  __shared__ float Ks[kFK][kMaxD + 1];  // +1: conflict-free column reads
  __shared__ float Vs[kFK][kMaxD + 1];
  __shared__ float dSs[kFQ][kFK];
  __shared__ float lse_s[kFQ], dl_s[kFQ];

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int hk = h / (H / HKV);
  const int q0 = blockIdx.x * kFQ;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const long q_off = (long)b * SQ * q_stride + (long)h * D;
  const float* kb = k + (long)b * SKV * kv_stride + (long)hk * D;
  const float* vb = v + (long)b * SKV * kv_stride + (long)hk * D;

  for (int i = tid; i < kFQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < SQ;
    Qs[r][d] = in ? q[q_off + (long)(q0 + r) * q_stride + d] : 0.f;
    dOs[r][d] = in ? dout[q_off + (long)(q0 + r) * q_stride + d] : 0.f;
  }
  if (tid < kFQ) {
    const int r = q0 + tid;
    lse_s[tid] = r < SQ ? lse[((long)b * H + h) * SQ + r] : 0.f;
    dl_s[tid] = r < SQ ? delta[((long)b * H + h) * SQ + r] : 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(SKV, q0 + kFQ) : SKV;
  for (int k0 = 0; k0 < kv_end; k0 += kFK) {
    __syncthreads();
    for (int i = tid; i < kFK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < SKV;
      Ks[r][d] = in ? kb[(long)(k0 + r) * kv_stride + d] : 0.f;
      Vs[r][d] = in ? vb[(long)(k0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kFQ * kFK; i += kThreads) {
      const int r = i / kFK, j = i % kFK;
      float ds = 0.f;
      if (k0 + j < SKV && !(causal && k0 + j > q0 + r)) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s += Qs[r][d] * Ks[j][d];
          dp += dOs[r][d] * Vs[j][d];
        }
        const float p = expf(s * scale - lse_s[r]);
        ds = p * (dp - dl_s[r]) * scale;
      }
      dSs[r][j] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + kThreads * i;
      if (e < kFQ * D) {
        const int r = e / D, d = e % D;
        float a = acc[i];
        for (int j = 0; j < kFK; ++j) a += dSs[r][j] * Ks[j][d];
        acc[i] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + kThreads * i;
    if (e < kFQ * D) {
      const int r = e / D, d = e % D;
      if (q0 + r < SQ) dq[q_off + (long)(q0 + r) * q_stride + d] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int HKV, int SQ, int SKV, int D,
                             float scale, int causal) {
  __shared__ float Ks[kFK][kMaxD + 1];
  __shared__ float Vs[kFK][kMaxD + 1];
  __shared__ float Qs[kFQ][kMaxD + 1];
  __shared__ float dOs[kFQ][kMaxD + 1];
  __shared__ float Ps[kFK][kFQ];
  __shared__ float dSs[kFK][kFQ];
  __shared__ float lse_s[kFQ], dl_s[kFQ];

  const int hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int group = H / HKV;
  const int k0 = blockIdx.x * kFK;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const long kv_off = (long)b * SKV * kv_stride + (long)hk * D;

  for (int i = tid; i < kFK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = k0 + r < SKV;
    Ks[r][d] = in ? k[kv_off + (long)(k0 + r) * kv_stride + d] : 0.f;
    Vs[r][d] = in ? v[kv_off + (long)(k0 + r) * kv_stride + d] : 0.f;
  }
  float dk_acc[kAccPerThread], dv_acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int q_begin = causal ? (k0 / kFQ) * kFQ : 0;
  for (int hi = 0; hi < group; ++hi) {
    const int h = hk * group + hi;
    const long q_off = (long)b * SQ * q_stride + (long)h * D;
    const long row_off = ((long)b * H + h) * SQ;
    for (int q0 = q_begin; q0 < SQ; q0 += kFQ) {
      __syncthreads();
      for (int i = tid; i < kFQ * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const bool in = q0 + r < SQ;
        Qs[r][d] = in ? q[q_off + (long)(q0 + r) * q_stride + d] : 0.f;
        dOs[r][d] = in ? dout[q_off + (long)(q0 + r) * q_stride + d] : 0.f;
      }
      if (tid < kFQ) {
        const int r = q0 + tid;
        lse_s[tid] = r < SQ ? lse[row_off + r] : 0.f;
        dl_s[tid] = r < SQ ? delta[row_off + r] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < kFK * kFQ; i += kThreads) {
        const int jj = i / kFQ, r = i % kFQ;
        float p = 0.f, ds = 0.f;
        if (k0 + jj < SKV && q0 + r < SQ && !(causal && k0 + jj > q0 + r)) {
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s += Qs[r][d] * Ks[jj][d];
            dp += dOs[r][d] * Vs[jj][d];
          }
          p = expf(s * scale - lse_s[r]);
          ds = p * (dp - dl_s[r]) * scale;
        }
        Ps[jj][r] = p;
        dSs[jj][r] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kAccPerThread; ++i) {
        const int e = tid + kThreads * i;
        if (e < kFK * D) {
          const int jj = e / D, d = e % D;
          float a = dv_acc[i], c = dk_acc[i];
          for (int r = 0; r < kFQ; ++r) {
            a += Ps[jj][r] * dOs[r][d];
            c += dSs[jj][r] * Qs[r][d];
          }
          dv_acc[i] = a;
          dk_acc[i] = c;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + kThreads * i;
    if (e < kFK * D) {
      const int jj = e / D, d = e % D;
      if (k0 + jj < SKV) {
        const long at = kv_off + (long)(k0 + jj) * kv_stride + d;
        dk[at] = dk_acc[i];
        dv[at] = dv_acc[i];
      }
    }
  }
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int HKV, int SQ, int SKV, int D, float scale,
                                 int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq_wgmma<32>(q, k, v, dout, lse, delta, dq, B, H, HKV,
                                 SQ, SKV, scale, causal, s);
    case 64:
      return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, B, H, HKV,
                                 SQ, SKV, scale, causal, s);
    case 128:
      return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, B, H, HKV,
                                  SQ, SKV, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int H, int HKV, int SQ, int SKV,
                                  int D, float scale, int causal,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkv_wgmma<32>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  HKV, SQ, SKV, scale, causal, s);
    case 64:
      return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  HKV, SQ, SKV, scale, causal, s);
    case 128:
      return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   HKV, SQ, SKV, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int HKV, int SQ, int SKV, int D, float scale,
                                int causal, void* stream) {
  if (D % 8 != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 grid((SQ + kFQ - 1) / kFQ, H, B);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, HKV, SQ, SKV, D, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int HKV, int SQ, int SKV, int D,
                                 float scale, int causal, void* stream) {
  if (D % 8 != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 grid((SKV + kFK - 1) / kFK, HKV, B);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, HKV, SQ, SKV, D,
      scale, causal);
  return (int)cudaGetLastError();
}
