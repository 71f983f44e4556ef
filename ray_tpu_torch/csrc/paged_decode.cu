// K4: paged-attention decode for Hopper (sm_90a).
//
// Replaces ray_tpu/llm/_internal/paged.py::_paged_decode_kernel (launched by
// paged_attention_decode_kernel through pl.pallas_call). One query token per
// sequence attends over that sequence's pages of the paged KV cache:
//   q [B,1,H,D], k/v pages [HK,P,ps,D], page_table [B,MP] int32,
//   seq_lens [B] int32  ->  out [B,1,H,D] in q's dtype.
// Keys at positions >= seq_len are masked; seq_len is clamped to MP*ps, the
// most a page-table row can address.
//
// Translation from the TPU kernel: there a grid step (b, kv head) got its
// page ids and length as prefetched scalars and double-buffered page DMAs
// into VMEM, zero-filling slots it did not fetch so that 0*NaN could not
// poison the sum. Here one thread block per (b, kv head) reads its own
// seq_len and page ids, and streams only the ceil(seq_len/ps) real pages,
// 32 keys at a time, through shared memory: a slot past seq_len is never
// read, it is written as zeros in shared memory. The block holds all
// Hg = H/HK query heads of its group, so each K/V row it loads serves Hg
// heads. The softmax is online, in f32.
//
// What bounds it on the H100: at 8B decode it reads each sequence's K and V
// once (2*HK*D*2 bytes per token in bf16) and does 4*H*D flops per token,
// 4 flops per byte in bf16: far below the ridge, so it is bound by bytes.
// This simple form loads each tile synchronously (no cp.async double
// buffering yet) and runs B*HK blocks: at 8B decode (B=8, HK=8) that is only
// 64 blocks against 132 SMs, so half the card's memory paths sit idle. A
// split-context variant (partial m, l, acc merged by a second pass) is the
// later fix for occupancy.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // keys per shared-memory tile
constexpr int kMaxHg = 8;      // query heads per kv head
constexpr int kMaxD = 128;     // head dim (one output column per thread)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ page_table,
                 const int* __restrict__ seq_lens, T* __restrict__ out,
                 int HK, int HG, int P, int PS, int MP, int D, float scale) {
  __shared__ float qs[kMaxHg * kMaxD];
  __shared__ __align__(16) T Kt[kTile * kMaxD];
  __shared__ __align__(16) T Vt[kTile * kMaxD];
  __shared__ float Ss[kMaxHg * kTile];
  __shared__ float m_s[kMaxHg], l_s[kMaxHg], a_s[kMaxHg];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = HK * HG;
  int len = seq_lens[b];
  len = max(0, min(len, MP * PS));
  const int* pt = page_table + (long)b * MP;
  const T* qb = q + ((long)b * H + (long)hk * HG) * D;

  for (int i = tid; i < HG * D; i += kThreads) qs[i] = to_f(qb[i]);
  if (tid < HG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxHg];
#pragma unroll
  for (int h = 0; h < kMaxHg; ++h) acc[h] = 0.f;

  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte chunk
  const int chunks = D / kElems;
  for (int k0 = 0; k0 < len; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < kTile * chunks; c += kThreads) {
      const int r = c / chunks, cc = c % chunks;
      const int pos = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (pos < len) {
        const int page = pt[pos / PS];
        if (page >= 0 && page < P) {
          const long off =
              (((long)hk * P + page) * PS + pos % PS) * D + cc * kElems;
          kv = *reinterpret_cast<const uint4*>(k_pages + off);
          vv = *reinterpret_cast<const uint4*>(v_pages + off);
        }
      }
      *reinterpret_cast<uint4*>(Kt + r * D + cc * kElems) = kv;
      *reinterpret_cast<uint4*>(Vt + r * D + cc * kElems) = vv;
    }
    __syncthreads();

    // Scores: warp w takes keys w, w+4, ...; lanes split the head dim.
    for (int j = warp; j < kTile; j += kWarps) {
      float part[kMaxHg];
#pragma unroll
      for (int h = 0; h < kMaxHg; ++h) part[h] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kd = to_f(Kt[j * D + d]);
#pragma unroll
        for (int h = 0; h < kMaxHg; ++h)
          if (h < HG) part[h] += qs[h * D + d] * kd;
      }
#pragma unroll
      for (int h = 0; h < kMaxHg; ++h) {
        if (h < HG) {
          const float s = warp_sum(part[h]);
          if (lane == 0) Ss[h * kTile + j] = (k0 + j < len) ? s * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp w updates heads w, w+4; lanes span the 32 keys.
    for (int h = warp; h < HG; h += kWarps) {
      const float x = Ss[h * kTile + lane];
      const float m_new = fmaxf(m_s[h], warp_max(x));
      const float p = expf(x - m_new);
      const float sum = warp_sum(p);
      Ss[h * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_s[h] - m_new);
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        a_s[h] = alpha;
      }
    }
    __syncthreads();

    // acc[h] (column d = tid) = acc[h] * alpha[h] + sum_j p[h][j] * V[j][d].
    if (tid < D) {
#pragma unroll
      for (int h = 0; h < kMaxHg; ++h) {
        if (h < HG) {
          float a = acc[h] * a_s[h];
          for (int j = 0; j < kTile; ++j)
            a += Ss[h * kTile + j] * to_f(Vt[j * D + tid]);
          acc[h] = a;
        }
      }
    }
  }
  __syncthreads();
  if (tid < D) {
    T* ob = out + ((long)b * H + (long)hk * HG) * D;
#pragma unroll
    for (int h = 0; h < kMaxHg; ++h)
      if (h < HG) ob[h * D + tid] = from_f<T>(acc[h] / fmaxf(l_s[h], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* seq_lens, void* out, int B,
           int HK, int HG, int P, int PS, int MP, int D, float scale,
           void* stream) {
  if (HG < 1 || HG > kMaxHg || D > kMaxD || D % (16 / (int)sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, HK);
  paged_decode<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), HK, HG, P, PS,
      MP, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_bf16(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* seq_lens, void* out, int B,
                                 int HK, int HG, int P, int PS, int MP, int D,
                                 float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, seq_lens, out,
                               B, HK, HG, P, PS, MP, D, scale, stream);
}

extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const void* page_table,
                                const void* seq_lens, void* out, int B, int HK,
                                int HG, int P, int PS, int MP, int D,
                                float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, page_table, seq_lens, out, B, HK,
                       HG, P, PS, MP, D, scale, stream);
}
