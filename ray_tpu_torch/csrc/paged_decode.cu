// K4: paged-attention decode for Hopper (sm_90a), split across the context.
//
// Replaces ray_tpu/llm/_internal/paged.py::_paged_decode_kernel (launched by
// paged_attention_decode_kernel through pl.pallas_call). One query token per
// sequence attends over that sequence's pages of the paged KV cache:
//   q [B,1,H,D], k/v pages [HK,P,ps,D], page_table [B,MP] int32,
//   seq_lens [B] int32  ->  out [B,1,H,D] in q's dtype.
// As there: keys at positions >= seq_len are masked (seq_len clamped to
// MP*ps, the most a page-table row can address); the softmax is online, in
// f32; P is rounded to v's dtype before P.V while the denominator sums the
// unrounded P; the denominator is clamped at 1e-30, so seq_len 0 gives zeros.
//
// What bounds it on the H100: each sequence's K and V rows are read once,
// 2*HK*D*2 bytes a token in bf16, for 4*H*D flops a token: 4 flops a byte at
// Hg = H/HK = 4, far below the card's ~295. So it is bound by bytes, and the
// design keeps enough blocks reading and enough copies in flight:
//
// - Split. The Pallas grid ran (sequence, kv head) steps in order on one
//   core, each walking its whole page list. Here the grid is (split, kv head
//   x m tile, sequence): a split is `pps` consecutive pages of a page-table
//   row, and the host picks pps from the shapes and the SM count alone (never
//   from seq_lens' values, which would need a device sync): about 2 blocks an
//   SM, one wave, with at least 256 keys a split. A block reads its
//   sequence's seq_len; a split that starts past it returns at once, so only
//   live pages cost a block. A block takes the query heads of one kv group as
//   the 16 rows of one m16 tile (Hg > 16 takes more tiles, one block each),
//   so every K/V row it loads serves the whole group.
// - Warps. Each of the block's 4 warps walks its own 16-key tiles of the
//   split (tiles w, w+4, ...), with its own online softmax (m, l, acc) and its
//   own copy ring, so the main loop needs no block barrier.
// - Copy ring. A page is a contiguous [ps, D] slab, so a key's K or V row is
//   one contiguous copy. A warp streams its tiles through kStages stages of
//   shared memory: each lane starts one bulk copy (cp.async.bulk, on the TMA
//   engine) of one K or V row, completing on the stage's mbarrier, and tile
//   i+1 is in flight while tile i's scores and P.V run. A key past seq_len
//   (or on a page id outside the pool) is never read: its lane zeroes the
//   row, because 0 * NaN would poison P.V, as the Pallas kernel zeroed its
//   unfetched slots. Rows are padded by 16 bytes, so ldmatrix is free of bank
//   conflicts. (f32 at D > 128 has one stage: two would pass 227 KB.)
// - Products. bf16: mma.sync m16n8k16 on the tensor cores, the group's heads
//   as the M rows (padded to 16; wgmma's 64-row minimum would waste 60 of 64
//   rows at Hg 4). S = Q K^T takes Q and K through ldmatrix; the f32
//   accumulator of S, rounded to bf16, is already mma's A layout for P.V,
//   and V comes through ldmatrix.trans. f32: FMA on the CUDA cores (TF32
//   would not keep the f32 result).
// - Merge, in a fixed order, so two launches give the same bits. The 4
//   warps' partials merge in warp order in shared memory. A sequence whose
//   keys fit one split writes its output there, with no second round trip
//   (serving's 176-token rows). Otherwise each block writes its partial
//   (m, l, acc) to a workspace, fences, and counts itself on a
//   per-(sequence, kv head, m tile) counter with one atomicAdd; the last
//   block of the row merges the live splits in split order, writes the
//   output and resets the counter to 0 for the next launch. No atomics
//   touch a sum. The wrapper allocates the workspace and keeps the
//   counters, zeroed once, per device; launches that share the counters
//   run in one stream.
//
// Head dims: D up to 256 in whole 16-byte rows (bf16 D % 8 == 0, f32
// D % 4 == 0), compiled for D <= 64, 128 and 256; bf16 pads the reduction to
// a multiple of 16 with zero columns.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include "hopper.cuh"

namespace {

using hopper::bf16;
using hopper::ex2;
using hopper::smem_addr;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;  // query heads of a block: one m16 tile
constexpr int kKeys = 16;  // keys of a warp's tile
// Masked scores and empty rows, as the reference's NEG_INF: finite, so an
// empty warp or split weighs ex2(-1e30 - m) = 0 and one with no keys at all
// gives 0 / max(0, 1e-30) = 0, with no special case.
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* seq_lens;
  void* out;
  float* acc_ws;  // [B, HK, splits, HG, D] partial sums
  float* ml_ws;   // [B, HK, splits, HG, 2] partial (max, denominator)
  int* counters;  // [B, HK, MT] blocks of a row that have written
  int HK, HG, P, PS, MP, D, pps, splits;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

// Shared memory of one block: each warp's ring of (K, V) tiles, the Q tile,
// and the per-warp row statistics; f32 also keeps each warp's P and rescale
// factors. A warp's partial sums reuse its own ring once its loop is done.
template <typename T, int DMAX>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);          // one 16-byte chunk
  static constexpr int kRowBytes = (DMAX + kPad) * sizeof(T);
  static constexpr int kStages = (sizeof(T) == 4 && DMAX > 128) ? 1 : 2;
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kWarpRing = kStages * 2 * kTileBytes;
  static constexpr int kRing = kWarps * kWarpRing;
  static constexpr int kQ = kRing;
  static constexpr int kStats = kQ + kRows * kRowBytes;  // m, l: [4][16] each
  static constexpr int kP = kStats + 2 * kWarps * kRows * 4;
  // f32: each warp's P [16 rows][17] and rescale factors [16].
  static constexpr int kPWarp = kRows * (kKeys + 1) + kRows;
  static constexpr int kPBytes = sizeof(T) == 4 ? kWarps * kPWarp * 4 : 0;
  static constexpr int kFlag = kP + kPBytes;
  static constexpr int kBars = kFlag + 16;  // [4 warps][kStages] mbarriers
  static constexpr int kBytes = kBars + kWarps * kStages * 8;
  static_assert(kRows * DMAX * 4 <= kWarpRing, "a warp's partial fits its ring");
};

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory on the TMA engine; the copy completes its bytes
// on the mbarrier at bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for one m16n8k16 tile: bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
// Over the 16 lanes of a half warp.
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Start copying the K and V rows of keys [key0, key0 + 16) of a sequence
// into one stage of a warp's ring, each row by one lane with one bulk copy
// (the TMA engine; lanes 0-15 K, 16-31 V) that completes its bytes on the
// stage's mbarrier. A key at or past kend, or on a page id outside [0, P),
// is not read: its lane writes zeros over its row.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(uint32_t kdst, uint32_t vdst,
                                          uint32_t bar, const T* kbase,
                                          const T* vbase, const int* pt_row,
                                          const Args& a, int key0, int kend,
                                          int lane) {
  using S = Smem<T, DMAX>;
  const int r = lane & (kKeys - 1), pos = key0 + r;
  const int page = pos < kend ? __ldg(pt_row + pos / a.PS) : -1;
  const bool copy = page >= 0 && page < a.P;
  const uint32_t row_bytes = a.D * sizeof(T);
  const uint32_t dst = (lane < kKeys ? kdst : vdst) + r * S::kRowBytes;
  // This stage's rows were last read by ldmatrix or loads (generic proxy);
  // order those reads before the bulk copies' writes (async proxy).
  fence_proxy_async();
  const int copied = __popc(__ballot_sync(~0u, copy));
  if (lane == 0) hopper::mbar_expect_tx(bar, copied * row_bytes);
  __syncwarp();
  if (copy) {
    const T* src = (lane < kKeys ? kbase : vbase) +
                   ((long)page * a.PS + pos % a.PS) * a.D;
    bulk_copy(dst, src, row_bytes, bar);
  } else {
    for (uint32_t o = 0; o < row_bytes; o += 16)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst + o),
                   "r"(0u)
                   : "memory");
  }
}

// One warp's running softmax state over its tiles.
//   bf16: mma's accumulator layout. Lane (g = lane/4, t = lane%4) holds rows
//   g and g + 8: m[0..1], l[0..1]; acc[n][0..1] at row g, columns 8n + 2t,
//   +1, and acc[n][2..3] at row g + 8.
//   f32: lane (j = lane%16, h = lane/16) holds rows 8h..8h+7: m[i], l[i];
//   acc[r][c] is row r, column lane + 32c.
template <typename T, int DMAX>
struct WarpState;

template <int DMAX>
struct WarpState<bf16, DMAX> {
  float m[2], l[2];
  float acc[DMAX / 8][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
};

template <int DMAX>
struct WarpState<float, DMAX> {
  float m[8], l[8];
  float acc[kRows][DMAX / 32];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < DMAX / 32; ++c) acc[r][c] = 0.f;
  }
};

// The scores, online softmax and P.V of one 16-key tile (bf16).
template <int DMAX>
__device__ __forceinline__ void tile_bf16(WarpState<bf16, DMAX>& st,
                                          uint32_t qs, uint32_t ks,
                                          uint32_t vs, const Args& a,
                                          int key0, int kend, int lane) {
  using S = Smem<bf16, DMAX>;
  const int ksteps = (a.D + 15) / 16;
  float sc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < ksteps) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, qs + (lane & 15) * S::kRowBytes +
                          (kk * 16 + (lane >> 4) * 8) * 2);
      ldmatrix_x4(kb, ks + ((lane & 7) + ((lane >> 4) << 3)) * S::kRowBytes +
                          (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma_bf16(sc[1], qa, kb[2], kb[3]);
    }
  }
  const int t = lane & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = key0 + 8 * n + 2 * t + (e & 1) < kend;
      sc[n][e] = live ? sc[n][e] * a.scale_log2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(st.m[h], quad_max(mx[h]));
    alpha[h] = ex2(st.m[h] - m_new);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = ex2(sc[n][e] - st.m[e >> 1]);
      sum[e >> 1] += sc[n][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + quad_sum(sum[h]);
  // P rounded to bf16, in mma's A layout (keys 2t.. of n tile 0, then 1).
  const uint32_t pa[4] = {hopper::pack_bf16(sc[0][0], sc[0][1]),
                          hopper::pack_bf16(sc[0][2], sc[0][3]),
                          hopper::pack_bf16(sc[1][0], sc[1][1]),
                          hopper::pack_bf16(sc[1][2], sc[1][3])};
  const int npairs = (a.D + 15) / 16;
#pragma unroll
  for (int np = 0; np < DMAX / 16; ++np) {
    if (np < npairs) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (lane & 15) * S::kRowBytes +
                                (np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float(&c)[4] = st.acc[2 * np + x];
        c[0] *= alpha[0];
        c[1] *= alpha[0];
        c[2] *= alpha[1];
        c[3] *= alpha[1];
        mma_bf16(c, pa, vb[2 * x], vb[2 * x + 1]);
      }
    }
  }
}

// The same for f32, on FMA. ps/as: this warp's P [16 rows][17] and rescale
// factors [16] in shared memory.
template <int DMAX>
__device__ __forceinline__ void tile_f32(WarpState<float, DMAX>& st,
                                         const float* qs, const float* ks,
                                         const float* vs, float* ps,
                                         float* as, const Args& a, int key0,
                                         int kend, int lane) {
  using S = Smem<float, DMAX>;
  constexpr int RS = S::kRowBytes / 4;
  const int j = lane & 15, h = lane >> 4;
  float s[8] = {};
  for (int d = 0; d < a.D; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(ks + j * RS + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(qs + (8 * h + i) * RS + d);
      s[i] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
    }
  }
  const bool live = key0 + j < kend;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = live ? s[i] * a.scale_log2 : kNegInf;
    const float m_new = fmaxf(st.m[i], half_max(x));
    const float alpha = ex2(st.m[i] - m_new);
    const float p = ex2(x - m_new);
    st.l[i] = st.l[i] * alpha + half_sum(p);
    st.m[i] = m_new;
    ps[(8 * h + i) * (kKeys + 1) + j] = p;
    if (j == 0) as[8 * h + i] = alpha;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float al = as[r];
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) st.acc[r][c] *= al;
  }
  for (int jj = 0; jj < kKeys; ++jj) {
    float v[DMAX / 32];
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) v[c] = vs[jj * RS + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = ps[r * (kKeys + 1) + jj];
#pragma unroll
      for (int c = 0; c < DMAX / 32; ++c) st.acc[r][c] += p * v[c];
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const Args a) {
  using S = Smem<T, DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, b = blockIdx.z;
  const int MT = (a.HG + kRows - 1) / kRows;
  const int hk = blockIdx.y / MT, mt = blockIdx.y - hk * MT;
  const int len = max(0, min(a.seq_lens[b], a.MP * a.PS));
  const int split_keys = a.pps * a.PS;
  const int live = max(1, (len + split_keys - 1) / split_keys);
  if (s >= live) return;  // every page of this split lies past seq_len
  const int k0 = s * split_keys, kend = min(len, k0 + split_keys);
  const int rows = min(kRows, a.HG - mt * kRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.HK * a.HG;
  const int row0 = hk * a.HG + mt * kRows;  // first query head of the tile

  // This warp's tiles: w, w + 4, ... of the split's 16-key tiles.
  const int n_tiles = kend > k0 ? (kend - k0 + kKeys - 1) / kKeys : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const uint32_t sbase = smem_addr(smem);
  const long page_elems = (long)a.PS * a.D;
  const T* kbase = static_cast<const T*>(a.k_pages) + (long)hk * a.P * page_elems;
  const T* vbase = static_cast<const T*>(a.v_pages) + (long)hk * a.P * page_elems;
  const int* pt_row = a.page_table + (long)b * a.MP;
  // Byte offset of the K tile of this warp's i-th tile's stage; V follows.
  auto stage = [&](int i) {
    return warp * S::kWarpRing + (i % S::kStages) * 2 * S::kTileBytes;
  };
  const uint32_t bars = sbase + S::kBars + warp * S::kStages * 8;
  auto issue = [&](int i) {
    const int key0 = k0 + (warp + kWarps * i) * kKeys;
    load_tile<T, DMAX>(sbase + stage(i), sbase + stage(i) + S::kTileBytes,
                       bars + (i % S::kStages) * 8, kbase, vbase, pt_row, a,
                       key0, kend, lane);
  };
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < S::kStages; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_fence_init();
  }
  __syncwarp();
  if constexpr (sizeof(T) == 2) {
    // bf16 with D % 16 == 8: the reduction's last 8 columns are zeros.
    if (a.D % 16) {
      for (int r = lane; r < S::kStages * 2 * kKeys; r += 32)
        *reinterpret_cast<uint4*>(smem + warp * S::kWarpRing +
                                  r * S::kRowBytes + a.D * 2) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i)
    if (i < mine) issue(i);

  // Q tile: the group's heads of this m tile, rows past HG and (bf16)
  // columns up to the next multiple of 16 zero.
  {
    constexpr int E = 16 / sizeof(T);
    const int cpr = sizeof(T) == 2 ? (a.D + 15) / 16 * 2 : a.D / E;
    const T* qb = static_cast<const T*>(a.q) + ((long)b * H + row0) * a.D;
    for (int c = tid; c < kRows * cpr; c += kThreads) {
      const int r = c / cpr, cc = c - r * cpr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && cc * E < a.D)
        v = *reinterpret_cast<const uint4*>(qb + (long)r * a.D + cc * E);
      *reinterpret_cast<uint4*>(smem + S::kQ + r * S::kRowBytes + cc * 16) = v;
    }
  }
  __syncthreads();

  WarpState<T, DMAX> st;
  st.init();

  for (int i = 0; i < mine; ++i) {
    if (i + S::kStages - 1 < mine) issue(i + S::kStages - 1);
    hopper::mbar_wait(bars + (i % S::kStages) * 8, (i / S::kStages) & 1);
    __syncwarp();  // and the zero rows other lanes wrote
    const int key0 = k0 + (warp + kWarps * i) * kKeys;
    if constexpr (sizeof(T) == 2) {
      tile_bf16<DMAX>(st, sbase + S::kQ, sbase + stage(i),
                      sbase + stage(i) + S::kTileBytes, a, key0, kend, lane);
    } else {
      float* ps = reinterpret_cast<float*>(smem + S::kP) + warp * S::kPWarp;
      tile_f32<DMAX>(st, reinterpret_cast<const float*>(smem + S::kQ),
                     reinterpret_cast<const float*>(smem + stage(i)),
                     reinterpret_cast<const float*>(smem + stage(i) +
                                                    S::kTileBytes),
                     ps, ps + kRows * (kKeys + 1), a, key0, kend, lane);
    }
    __syncwarp();
  }
  // This warp's partial into its own ring: acc [16][DMAX], m and l [16].
  float* wacc = reinterpret_cast<float*>(smem + warp * S::kWarpRing);
  float* wm = reinterpret_cast<float*>(smem + S::kStats) + warp * kRows;
  float* wl = wm + kWarps * kRows;
  if constexpr (sizeof(T) == 2) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      *reinterpret_cast<float2*>(wacc + g * DMAX + 8 * n + 2 * t) =
          make_float2(st.acc[n][0], st.acc[n][1]);
      *reinterpret_cast<float2*>(wacc + (g + 8) * DMAX + 8 * n + 2 * t) =
          make_float2(st.acc[n][2], st.acc[n][3]);
    }
    if (t == 0) {
      wm[g] = st.m[0];
      wl[g] = st.l[0];
      wm[g + 8] = st.m[1];
      wl[g + 8] = st.l[1];
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < DMAX / 32; ++c)
        wacc[r * DMAX + lane + 32 * c] = st.acc[r][c];
    if ((lane & 15) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        wm[8 * (lane >> 4) + i] = st.m[i];
        wl[8 * (lane >> 4) + i] = st.l[i];
      }
    }
  }
  __syncthreads();

  // The block's partial: the warps merged in warp order. A warp that had no
  // tile holds m = -1e30, l = 0 and weighs 0.
  const float* wm0 = reinterpret_cast<const float*>(smem + S::kStats);
  const float* wl0 = wm0 + kWarps * kRows;
  const int D4 = a.D / 4;
  const bool direct = live == 1;
  T* out = static_cast<T*>(a.out) + ((long)b * H + row0) * a.D;
  const long part = ((long)b * a.HK + hk) * a.splits;
  float* acc_ws = a.acc_ws + ((part + s) * a.HG + mt * kRows) * a.D;
  float* ml_ws = a.ml_ws + ((part + s) * a.HG + mt * kRows) * 2;
  for (int e = tid; e < rows * D4; e += kThreads) {
    const int r = e / D4, c = (e - r * D4) * 4;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm0[w * kRows + r]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm0[w * kRows + r];
      const float f = ex2(mw - m);
      const float4 x = *reinterpret_cast<const float4*>(
          smem + w * S::kWarpRing + (r * DMAX + c) * 4);
      l += f * wl0[w * kRows + r];
      acc.x += f * x.x;
      acc.y += f * x.y;
      acc.z += f * x.z;
      acc.w += f * x.w;
    }
    if (direct) {
      const float den = fmaxf(l, 1e-30f);
      T* o = out + (long)r * a.D + c;
      o[0] = from_f<T>(acc.x / den);
      o[1] = from_f<T>(acc.y / den);
      o[2] = from_f<T>(acc.z / den);
      o[3] = from_f<T>(acc.w / den);
    } else {
      *reinterpret_cast<float4*>(acc_ws + (long)r * a.D + c) = acc;
      if (c == 0) *reinterpret_cast<float2*>(ml_ws + 2 * r) = make_float2(m, l);
    }
  }
  if (direct) return;

  // Count this block; the last of the row's live splits merges them.
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + S::kFlag);
  if (tid == 0) {
    int* counter = a.counters + (long)b * a.HK * MT + blockIdx.y;
    const int done = atomicAdd(counter, 1);
    *flag = done == live - 1;
    if (done == live - 1) atomicExch(counter, 0);
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* acc_row = a.acc_ws + (part * a.HG + mt * kRows) * a.D;
  const float* ml_row = a.ml_ws + (part * a.HG + mt * kRows) * 2;
  const long split_acc = (long)a.HG * a.D, split_ml = (long)a.HG * 2;
  for (int e = tid; e < rows * D4; e += kThreads) {
    const int r = e / D4, c = (e - r * D4) * 4;
    float m = kNegInf;
    for (int x = 0; x < live; ++x)
      m = fmaxf(m, __ldcg(ml_row + x * split_ml + 2 * r));
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x = 0; x < live; ++x) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          ml_row + x * split_ml + 2 * r));
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          acc_row + x * split_acc + (long)r * a.D + c));
      const float f = ex2(ml.x - m);
      l += f * ml.y;
      acc.x += f * v.x;
      acc.y += f * v.y;
      acc.z += f * v.z;
      acc.w += f * v.w;
    }
    const float den = fmaxf(l, 1e-30f);
    T* o = out + (long)r * a.D + c;
    o[0] = from_f<T>(acc.x / den);
    o[1] = from_f<T>(acc.y / den);
    o[2] = from_f<T>(acc.z / den);
    o[3] = from_f<T>(acc.w / den);
  }
}

template <typename T, int DMAX>
int launch_dmax(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Smem<T, DMAX>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int MT = (a.HG + kRows - 1) / kRows;
  dim3 grid(a.splits, a.HK * MT, B);
  paged_decode_split<T, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* seq_lens, void* out,
           void* acc_ws, void* ml_ws, void* counters, int B, int HK, int HG,
           int P, int PS, int MP, int D, int pps, int splits, float scale,
           void* stream) {
  if (HG < 1 || D < 1 || D > 256 || D % (16 / (int)sizeof(T)) != 0 ||
      pps < 1 || splits < 1 || (long)pps * splits < MP)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(seq_lens), out,
               static_cast<float*>(acc_ws), static_cast<float*>(ml_ws),
               static_cast<int*>(counters), HK, HG, P, PS, MP, D, pps,
               splits, scale * hopper::kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_dmax<T, 64>(a, B, st);
  if (D <= 128) return launch_dmax<T, 128>(a, B, st);
  return launch_dmax<T, 256>(a, B, st);
}

}  // namespace

#define PAGED_DECODE_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* q, const void* k_pages,                    \
                      const void* v_pages, const void* page_table,           \
                      const void* seq_lens, void* out, void* acc_ws,         \
                      void* ml_ws, void* counters, int B, int HK, int HG,    \
                      int P, int PS, int MP, int D, int pps, int splits,     \
                      float scale, void* stream) {                           \
    return launch<T>(q, k_pages, v_pages, page_table, seq_lens, out, acc_ws, \
                     ml_ws, counters, B, HK, HG, P, PS, MP, D, pps, splits,  \
                     scale, stream);                                         \
  }

PAGED_DECODE_ENTRY(paged_decode_bf16, bf16)
PAGED_DECODE_ENTRY(paged_decode_f32, float)
