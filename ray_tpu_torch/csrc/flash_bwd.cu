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
//   happens inside the block, with no atomics and in a fixed order.
// Keys past Skv and queries past Sq are masked, so any length works (the
// Pallas kernels needed blocks that divide S).
//
// What bounds them on the H100: at the 8B training shape (B=2, S=2048,
// H=32, D=128, causal) K2 does 6*D flops per (q, k) pair (103 GFLOP) and K3
// 8*D (137 GFLOP) on ~120 MB, far above the card's ~295 flop/byte ridge:
// both are bound by tensor-core operations. So every product runs on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). It is the
// simple form: tiles are loaded synchronously into padded shared memory and
// each warp owns 16 rows of the output tile. Registers are the scarce part:
// K3 keeps dK and dV (16 keys x D each, f32) per warp, so its inner q tile
// is 32 rows and Q, dO, K and V fragments are read from shared memory at
// each product instead of being held. wgmma, TMA and pipelining are later
// work.
//
// The f32 path (small shapes, parity with TF32 off) is plain FMA on
// shared-memory tiles.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------
constexpr int kDqBQ = 64;   // K2: query rows per block, 16 per warp
constexpr int kDqBK = 64;   // K2: keys per kv tile
constexpr int kDkvBK = 64;  // K3: keys per block, 16 per warp
constexpr int kDkvBQ = 32;  // K3: query rows per inner tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a(16x16, row) * b(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [r0, r0+rows) of a [S, row_stride] matrix into shared memory
// with a padded row of LD elements; rows at or past S are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long row_stride, int r0, int rows,
                                          int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_stride +
                                            cc * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + cc * 8) = val;
  }
}

// s = A B^T for this warp: A is 16 rows x D at `a`, B is NT*8 rows x D at
// `b` (both in shared memory, row pitch LD). s[j] is the C fragment of
// columns [8j, 8j+8).
template <int D, int LD, int NT>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const bf16* a,
                                        const bf16* b, int g, int c2) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = a + g * LD + kk * 16 + c2;
    const uint32_t af[4] = {ld32(p0), ld32(p0 + 8 * LD), ld32(p0 + 8),
                            ld32(p0 + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* br = b + (j * 8 + g) * LD + kk * 16 + c2;
      mma_bf16(s[j], af, ld32(br), ld32(br + 8));
    }
  }
}

// acc += P B for this warp: P is 16 x 16*NC given as C fragments p[2*NC]
// (rounded to bf16 here and reused as A fragments, no shared-memory round
// trip), B is 16*NC rows x D at `b` (shared memory, row pitch LD).
template <int D, int LD, int NC>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&p)[2 * NC][4],
                                       const bf16* b, int g, int c2) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint32_t a[4] = {pack_bf16(p[2 * c][0], p[2 * c][1]),
                           pack_bf16(p[2 * c][2], p[2 * c][3]),
                           pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]),
                           pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3])};
    const bf16* br = b + (c * 16 + c2) * LD + g;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const bf16* vp = br + t * 8;
      mma_bf16(acc[t], a, pack_raw(vp[0], vp[LD]),
               pack_raw(vp[8 * LD], vp[9 * LD]));
    }
  }
}

// Write this warp's 16 x D f32 accumulator as bf16 rows row_a (c0, c1) and
// row_a + 8 (c2, c3) of a [S, row_stride] matrix; rows at or past S are
// dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long row_stride,
                                           const float (&acc)[D / 8][4],
                                           int row_a, int S, int c2) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + c2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(dst + (long)row_a * row_stride + col) =
          pack_bf16(acc[t][0], acc[t][1]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(dst + (long)row_b * row_stride + col) =
          pack_bf16(acc[t][2], acc[t][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int H, int HKV, int SQ, int SKV, float scale,
                     int causal) {
  constexpr int LD = D + 8;  // pad 16 bytes: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kDqBQ * LD;
  bf16* Ks = dOs + kDqBQ * LD;
  bf16* Vs = Ks + kDqBK * LD;

  // Causal: the last q tiles see the most keys, so they start first.
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kDqBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const long q_off = (long)b * SQ * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * SKV * kv_stride + (long)hk * D;
  const bf16* vb = v + (long)b * SKV * kv_stride + (long)hk * D;

  load_tile<D, LD>(Qs, q + q_off, q_stride, q0, kDqBQ, SQ);
  load_tile<D, LD>(dOs, dout + q_off, q_stride, q0, kDqBQ, SQ);

  const int row_a = q0 + warp * 16 + g;  // query index of c0/c1; +8: c2/c3
  const float* lrow = lse + ((long)b * H + h) * SQ;
  const float* drow = delta + ((long)b * H + h) * SQ;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    lse_r[i] = row < SQ ? lrow[row] : 0.f;
    dl_r[i] = row < SQ ? drow[row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;
  // Causal: keys past the tile's last query row are masked for every row.
  const int kv_end = causal ? min(SKV, q0 + kDqBQ) : SKV;
  for (int k0 = 0; k0 < kv_end; k0 += kDqBK) {
    __syncthreads();  // Q/dO are in; the previous K/V tile is consumed
    load_tile<D, LD>(Ks, kb, kv_stride, k0, kDqBK, SKV);
    load_tile<D, LD>(Vs, vb, kv_stride, k0, kDqBK, SKV);
    __syncthreads();

    float s[kDqBK / 8][4], dp[kDqBK / 8][4];
    mma_abt<D, LD, kDqBK / 8>(s, Qw, Ks, g, c2);    // S = Q K^T
    mma_abt<D, LD, kDqBK / 8>(dp, dOw, Vs, g, c2);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kDqBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + c2 + (e & 1);
        const int i = e >> 1;
        const bool masked = col >= SKV || (causal && col > row_a + 8 * i);
        const float p = masked ? 0.f : expf(s[j][e] * scale - lse_r[i]);
        s[j][e] = p * (dp[j][e] - dl_r[i]) * scale;  // dS
      }
    mma_pb<D, LD, kDqBK / 16>(acc, s, Ks, g, c2);  // dQ += dS K
  }
  store_rows<D>(dq + q_off, q_stride, acc, row_a, SQ, c2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int HKV, int SQ, int SKV,
                      float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kDkvBK * LD;
  bf16* Qs = Vs + kDkvBK * LD;
  bf16* dOs = Qs + kDkvBQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kDkvBQ * LD);
  float* dl_s = lse_s + kDkvBQ;

  const int k0 = blockIdx.x * kDkvBK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / HKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const long kv_off = (long)b * SKV * kv_stride + (long)hk * D;

  load_tile<D, LD>(Ks, k + kv_off, kv_stride, k0, kDkvBK, SKV);
  load_tile<D, LD>(Vs, v + kv_off, kv_stride, k0, kDkvBK, SKV);

  const int key_a = k0 + warp * 16 + g;  // key index of c0/c1; +8: c2/c3
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  // Causal: q tiles wholly before the block's first key see none of it.
  const int q_begin = causal ? (k0 / kDkvBQ) * kDkvBQ : 0;
  for (int hi = 0; hi < group; ++hi) {
    const int h = hk * group + hi;
    const long q_off = (long)b * SQ * q_stride + (long)h * D;
    const float* lrow = lse + ((long)b * H + h) * SQ;
    const float* drow = delta + ((long)b * H + h) * SQ;
    for (int q0 = q_begin; q0 < SQ; q0 += kDkvBQ) {
      __syncthreads();  // K/V are in; the previous Q/dO tile is consumed
      load_tile<D, LD>(Qs, q + q_off, q_stride, q0, kDkvBQ, SQ);
      load_tile<D, LD>(dOs, dout + q_off, q_stride, q0, kDkvBQ, SQ);
      if (threadIdx.x < kDkvBQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < SQ ? lrow[r] : 0.f;
        dl_s[threadIdx.x] = r < SQ ? drow[r] : 0.f;
      }
      __syncthreads();

      // Transposed scores: rows are this warp's 16 keys, columns the tile's
      // 32 queries.
      float pt[kDkvBQ / 8][4], dst[kDkvBQ / 8][4];
      mma_abt<D, LD, kDkvBQ / 8>(pt, Kw, Qs, g, c2);    // S^T = K Q^T
      mma_abt<D, LD, kDkvBQ / 8>(dst, Vw, dOs, g, c2);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < kDkvBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + c2 + (e & 1);
          const int key = key_a + 8 * (e >> 1);
          const bool valid = q0 + qc < SQ && key < SKV &&
                             !(causal && key > q0 + qc);
          const float p =
              valid ? expf(pt[j][e] * scale - lse_s[qc]) : 0.f;
          pt[j][e] = p;
          dst[j][e] = p * (dst[j][e] - dl_s[qc]) * scale;  // dS^T
        }
      mma_pb<D, LD, kDkvBQ / 16>(dv_acc, pt, dOs, g, c2);  // dV += P^T dO
      mma_pb<D, LD, kDkvBQ / 16>(dk_acc, dst, Qs, g, c2);  // dK += dS^T Q
    }
  }
  store_rows<D>(dk + kv_off, kv_stride, dk_acc, key_a, SKV, c2);
  store_rows<D>(dv + kv_off, kv_stride, dv_acc, key_a, SKV, c2);
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int H, int HKV, int SQ, int SKV,
                  float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kDqBQ + 2 * kDqBK) * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((SQ + kDqBQ - 1) / kDqBQ, H, B);
  flash_bwd_dq_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, HKV, SQ, SKV, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int HKV, int SQ, int SKV,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kDkvBK + 2 * kDkvBQ) * (D + 8) * sizeof(bf16) +
      2 * kDkvBQ * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((SKV + kDkvBK - 1) / kDkvBK, HKV, B);
  flash_bwd_dkv_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, HKV, SQ, SKV, scale,
      causal);
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
      return launch_dq_mma<32>(q, k, v, dout, lse, delta, dq, B, H, HKV, SQ,
                               SKV, scale, causal, s);
    case 64:
      return launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, B, H, HKV, SQ,
                               SKV, scale, causal, s);
    case 128:
      return launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, B, H, HKV, SQ,
                                SKV, scale, causal, s);
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
      return launch_dkv_mma<32>(q, k, v, dout, lse, delta, dk, dv, B, H, HKV,
                                SQ, SKV, scale, causal, s);
    case 64:
      return launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, B, H, HKV,
                                SQ, SKV, scale, causal, s);
    case 128:
      return launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
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
