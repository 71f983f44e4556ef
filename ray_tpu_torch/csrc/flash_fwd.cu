// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_fwd_core through pl.pallas_call). Computes, for q [B,Sq,H,D] and
// k/v [B,Skv,Hkv,D] (contiguous, the layout of the public flash_attention),
//   O   = softmax(scale * Q K^T [+ causal mask]) V   in the input dtype,
//   LSE = row logsumexp of the scaled, masked scores  [B,H,Sq] in f32
// (LSE is the residual the backward kernels K2/K3 will rebuild P from).
//
// Translation from the TPU kernel: the Pallas grid (B, H, q-blocks,
// k-blocks) ran its last axis in order on one core, carrying the running
// max, sum and accumulator in VMEM scratch. Here one thread block owns one
// (q-tile, head, batch) and loops over the kv tiles itself; the running
// m, l and acc stay in f32 registers. The kv head is h / (H/Hkv), so the
// GQA repeat is never materialized. With causal masking, kv tiles wholly
// above the diagonal are skipped (the kernel's :143-147), and positions past
// Skv are masked, so any length works (the TPU kernel needed blocks that
// divide S).
//
// What bounds it on the H100: at the 8B shape (S=2048, H=32, D=128, causal)
// it does ~34 GFLOP on ~42 MB, far above the card's ~295 flop/byte ridge,
// so it is bound by tensor-core operations. The bf16 path therefore runs
// its two products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate; P is rounded to bf16 before P·V, as the Pallas kernel casts p
// to v's dtype). It is the simple form: K and V tiles are loaded
// synchronously into padded shared memory and each warp owns 16 query rows.
// wgmma, TMA and a producer/consumer pipeline are later work.
//
// The f32 path (used at small shapes, with TF32 off for parity) is plain
// FMA on shared-memory tiles: f32 inputs take no tensor-core shortcut.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // ray_tpu's NEG_INF (not -inf)

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;        // query rows per block: 16 per warp
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// Copy rows [r0, r0+rows) of a [S, stride] matrix into shared memory with a
// padded row of LD elements; rows at or past S are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int H, int HKV, int SQ, int SKV, float scale, int causal) {
  constexpr int LD = D + 8;  // pad 16 bytes: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;        // fragment row within 8
  const int c2 = (lane & 3) * 2;  // fragment column pair
  const int q0 = blockIdx.x * kBQ;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)HKV * D;
  const __nv_bfloat16* qb = q + (long)b * SQ * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * SKV * kv_stride + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * SKV * kv_stride + (long)hk * D;

  load_tile<D, LD>(Qs, qb, q_stride, q0, kBQ, SQ);
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept in registers.
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = Qs + r0 * LD + kk * 16 + c2;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const int row_a = q0 + r0, row_b = row_a + 8;  // query index of c0/c1, c2/c3
  // Causal: keys past the block's last query row are masked for every row.
  const int kv_end = causal ? min(SKV, q0 + kBQ) : SKV;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D, LD>(Ks, kb, kv_stride, k0, kBK, SKV);
    load_tile<D, LD>(Vs, vb, kv_stride, k0, kBK, SKV);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + c2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // Scale, mask, and the online-softmax update of (m, l, acc).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + c2 + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        float x = s[j][e] * scale;
        if (col >= SKV || (causal && col > row)) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      const float alpha = expf(m_run[i] - mx[i]);
      l_run[i] = l_run[i] * alpha + rs[i];
      m_run[i] = mx[i];
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][2 * i] *= alpha;
        acc[t][2 * i + 1] *= alpha;
      }
    }

    // acc += P V: P's accumulator fragments are reused as A fragments.
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
      const __nv_bfloat16* vr = Vs + (c * 16 + c2) * LD + g;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const __nv_bfloat16* vp = vr + t * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(acc[t], a, b0, b1);
      }
    }
  }

  const float den_a = fmaxf(l_run[0], 1e-30f);
  const float den_b = fmaxf(l_run[1], 1e-30f);
  __nv_bfloat16* ob = o + (long)b * SQ * q_stride + (long)h * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + c2;
    if (row_a < SQ)
      *reinterpret_cast<uint32_t*>(ob + (long)row_a * q_stride + col) =
          pack_bf16(acc[t][0] / den_a, acc[t][1] / den_a);
    if (row_b < SQ)
      *reinterpret_cast<uint32_t*>(ob + (long)row_b * q_stride + col) =
          pack_bf16(acc[t][2] / den_b, acc[t][3] / den_b);
  }
  if ((lane & 3) == 0) {
    float* lb = lse + ((long)b * H + h) * SQ;
    if (row_a < SQ) lb[row_a] = m_run[0] + logf(den_a);
    if (row_b < SQ) lb[row_b] = m_run[1] + logf(den_b);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int H, int HKV, int SQ, int SKV, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((SQ + kBQ - 1) / kBQ, H, B);
  flash_fwd_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, HKV, SQ, SKV, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 path: FMA on shared-memory tiles
// ---------------------------------------------------------------------------
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
      return launch_mma<32>(q, k, v, o, lse, B, H, HKV, SQ, SKV, scale,
                            causal, s);
    case 64:
      return launch_mma<64>(q, k, v, o, lse, B, H, HKV, SQ, SKV, scale,
                            causal, s);
    case 128:
      return launch_mma<128>(q, k, v, o, lse, B, H, HKV, SQ, SKV, scale,
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
