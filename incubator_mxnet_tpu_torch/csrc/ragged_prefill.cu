// Ragged paged-attention CHUNKED-PREFILL kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel incubator_mxnet_tpu/ops/ragged_attention.py
// `_ragged_prefill_kernel`, launched by `_ragged_prefill_pallas` (raw
// pools) and by `_ragged_prefill_pallas_q` (int8 / fp8 code pools with
// per-page scales: the int8_t / __nv_fp8_e4m3 instantiations below): a
// chunk of C queries of ONE slot, at absolute positions start + i,
// attends the slot's paged prefix plus the causal part of the chunk (the
// chunk's own K/V is already written into the pages), through one
// predicate pos_k <= start + i. Only keys below start + n_real are ever
// read (key_end below): no live row sees past it, and a partial chunk's
// unwritten tail may hold a recycled page's NaN.
//
// What bounds it on an H100: the bytes of the live K/V. A chunk of C = 64
// queries over 1024 live keys does 4 * C * keys * D flops on 2 * keys * D
// elements, ~64 flops per bf16 byte (~128 per code byte): below the
// ~295 flop/byte balance point of the bf16 tensor cores, so the floor is
// the live K/V bytes over 3.35 TB/s (1.0 us for bf16 at that depth, 0.53
// us for codes). At such sizes launch and load latency dominate.
//
// Design. The TPU grid walks the pages in order with (H, C) m/l/acc
// scratch; blocks on the GPU run in no order, so the keys are split and
// the splits merged. The split plan is computed by the wrapper
// (ops/ragged_attention.prefill_plan) from the LIVE keys, start + n_real:
// keys per split and number of splits (about one block per SM at depth,
// one split of 64 keys at start 0: no block that only exits), query
// tiles per block, and the CUDA-core body's exact scratch; this file
// checks the plan and launches it. Two bodies, chosen from the dtype
// and D before the launch:
//
// 1. bf16 queries with D = 64 (GPT-2, gpt_small: the serving path), on
//    the tensor cores, prefill_mma_kernel, grid (split, head, query
//    group), 4 warps:
//    - one read of each live K/V byte: a block owns one (head, key split)
//      and every query row of its group, a group being 1 or 2 tiles of 64
//      rows (a warp owns 16 rows of each; the second tile's state is held
//      in registers beside the first). The plan takes one group for C <=
//      128, so each live K/V element is loaded from device memory once
//      per launch; a block no live row of its group can see walks
//      nothing;
//    - staging: the split's page ids (and page scales) go to shared
//      memory first; then each 64-key tile of K and V is copied with
//      16-byte cp.async per thread (a page's head slice is contiguous),
//      double-buffered: tile kt + 1 is in flight while tile kt is used.
//      Keys past the block's bound (>= key_end) are zero-filled by the
//      copy itself (src-size 0): V is SELECTED out, never 0 * NaN;
//    - products: S = Q K^T and P V on mma.sync.m16n8k16 (bf16 operands,
//      f32 accumulation; flash_common.cuh), Q's fragments held in
//      registers for the whole walk, V read as the B operand through
//      ldmatrix.trans, p passed from S's C fragments to P V's A fragments
//      in registers. Rounding points of the Pallas kernel for a raw pool:
//      bf16 q . k with f32 accumulation, the scale on the f32 score,
//      p.astype(bf16) before P V;
//    - code pools on the same body: every int8 code (|c| <= 127) and
//      every e4m3 value is exact in bf16, so codes are converted to bf16
//      in shared memory after they land and the scales stay out of the
//      products. K: each key's f32 score is multiplied by its page's k
//      scale, q . (k sk) up to summation order. V: the Pallas kernel
//      forms P V in f32 on dequantized values (p is not rounded there),
//      so each key's weight is multiplied by its page's v scale in f32,
//      p' = p sv, and split into bf16 hi + lo = p' (two mmas on the same
//      codes): ~16 bits of p' survive, against 8 for one bf16 product.
//      A key past the bound gets scale 0 by a select, never a multiply,
//      so a NaN scale on a masked page cannot leak; one on a live page
//      propagates (0 * NaN = NaN in the product, as in the Pallas kernel);
//    - a row that sees no key of the split gets zero weights (its max
//      still -1e30); every max keeps NaN (nan_max);
//    - the merge: a head's splits (at most 16) are one thread-block
//      cluster. Each block leaves its rows' (o, m, l) in its shared
//      memory; after the cluster barrier block j merges rows j, j +
//      nsplit, ... reading the partials of the splits each row sees, in
//      split order, through distributed shared memory. No scratch in
//      device memory and no second launch; one split finalizes alone.
// 2. every other case (f32 queries, head dims other than 64): the CUDA-
//    core body, prefill_split_kernel, grid (16-row query tile, head,
//    64-key split), scores and P V in f32 out of shared memory (K/V
//    staged as f32 through stage_kv, once per 16-row tile). It writes
//    each split's (m, l, acc[D]) of the live rows (rows < n_real) to the
//    wrapper's scratch, and a second launch, prefill_merge_kernel, gives
//    one warp to each (row, head): it reads the row's splits in order
//    (acc as float2 when D is even) and writes acc / l.
//
// Rows >= n_real (garbage by contract) are written as zeros. No atomics:
// the output is bitwise the same from run to run. No TMA or wgmma (the
// tiles are 64 x 64: mma.sync suffices here).

#include <cooperative_groups.h>

#include <algorithm>

#include "flash_common.cuh"   // mma.sync, cp.async and ldmatrix helpers;
                              // includes ragged_common

namespace mxt {

// keys [0, end) cover every live row of rows [i0, i0 + n); 0 = no live
// row. key_end = min(start + n_real, the page row's capacity).
__device__ __forceinline__ int rows_key_end(int i0, int n, int start,
                                            int n_real, int key_end) {
  const int live = min(i0 + n, n_real) - i0;
  return live > 0 ? min(start + i0 + live, key_end) : 0;
}

// ---------------------------------------------------------------------
// body 2: CUDA cores (f32 queries, any head dim up to 256)
// ---------------------------------------------------------------------

// Scratch layout, for the n_real live rows only, with
// idx = (row * H + h) * nsplit + j: m at part[idx], l at
// part[nparts + idx], acc at part[2 * nparts + idx * D .. + D).
__device__ __forceinline__ int64_t prefill_nparts(int n_real, int H,
                                                  int nsplit) {
  return (int64_t)n_real * H * nsplit;
}

// One warp merges a row's n splits into D output columns, V columns a
// lane per load (V = 2: float2 reads of acc).
template <typename T, int V>
__device__ __forceinline__ void merge_cols(const float* __restrict__ pm,
                                           const float* __restrict__ pl,
                                           const float* __restrict__ pa,
                                           int n, float M, int D,
                                           T* __restrict__ orow) {
  constexpr int kIt = kMaxHeadDim / (32 * V);
  const int lane = threadIdx.x & 31;
  float acc[kIt][V];
#pragma unroll
  for (int it = 0; it < kIt; ++it)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[it][v] = 0.f;
  float l = 0.f;
  for (int j0 = 0; j0 < n; j0 += 32) {
    float w = 0.f, lw = 0.f;
    if (j0 + lane < n) {
      w = expf(pm[j0 + lane] - M);
      lw = pl[j0 + lane] * w;
    }
    l += warp_sum(lw);
    for (int u = 0; u < min(32, n - j0); ++u) {
      const float wu = __shfl_sync(0xffffffffu, w, u);
      const float* src = pa + (int64_t)(j0 + u) * D;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int c = (lane + 32 * it) * V;
        if (c < D) {
          if constexpr (V == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src + c);
            acc[it][0] += wu * x.x;
            acc[it][1] += wu * x.y;
          } else {
            acc[it][0] += wu * src[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int c = (lane + 32 * it) * V;
    if (c < D) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        orow[c + v] = from_float<T>(finalize(acc[it][v], M, l));
    }
  }
}

// Merge launch: one warp per (row, head). Row i < n_real sees keys
// [0, min(start + i + 1, key_end)), so it reads the first
// ceil(that / split_keys) splits (each was written by its first pass);
// rows >= n_real get zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int start, int n_real, int key_end, int C, int H, int D,
                     int split_keys, int nsplit) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= C * H) return;
  const int row = w / H;
  int n = 0;
  if (row < n_real) {
    const int vis = min(start + row + 1, key_end);
    n = vis > 0 ? min(nsplit, (vis + split_keys - 1) / split_keys) : 0;
  }
  const int64_t nparts = prefill_nparts(n_real, H, nsplit);
  const int64_t base = (int64_t)w * nsplit;          // w = row * H + h
  const float* pm = part + base;
  const float* pl = part + nparts + base;
  const float* pa = part + 2 * nparts + base * D;
  float M = kNegInf;
  for (int j = (threadIdx.x & 31); j < n; j += 32) M = nan_max(M, pm[j]);
  M = warp_max(M);
  T* orow = out + (int64_t)w * D;
  if ((D & 1) == 0)
    merge_cols<T, 2>(pm, pl, pa, n, M, D, orow);
  else
    merge_cols<T, 1>(pm, pl, pa, n, M, D, orow);
}

template <typename T>
cudaError_t launch_merge(const float* part, void* out, int start,
                         int n_real, int key_end, int C, int H, int D,
                         int split_keys, int nsplit, cudaStream_t stream) {
  const int blocks = (int)(((int64_t)C * H + kWarps - 1) / kWarps);
  prefill_merge_kernel<T><<<blocks, kThreads, 0, stream>>>(
      part, static_cast<T*>(out), start, n_real, key_end, C, H, D,
      split_keys, nsplit);
  return cudaGetLastError();
}

constexpr int kRows = 16;                    // query rows per block
constexpr int kPreAcc = kRows * kMaxHeadDim / kThreads;

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
prefill_split_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                     const P* __restrict__ v_pool,
                     const int* __restrict__ page_row,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     float* __restrict__ part, int start, int n_real,
                     int key_end, int C, int H, int D, int ps, int nsplit,
                     float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, j = blockIdx.z;
  const int i0 = tile * kRows;
  const int rows = min(kRows, C - i0);
  const int end = rows_key_end(i0, rows, start, n_real, key_end);
  const int k0 = j * kSplitKeys;
  if (k0 >= end) return;                     // no live row sees the split
  const int nk = min(kSplitKeys, end - k0);
  const int live_rows = min(rows, n_real - i0);

  extern __shared__ float smem[];
  const int kstride = D + 1;                 // pad: conflict-free dots
  float* q_s = smem;                         // (kRows, D)
  float* k_s = q_s + kRows * D;              // (kSplitKeys, D + 1)
  float* v_s = k_s + kSplitKeys * kstride;   // (kSplitKeys, D)
  float* s_s = v_s + kSplitKeys * D;         // (kRows, kSplitKeys)
  __shared__ float row_m[kRows], row_l[kRows];
  __shared__ int pages_s[kSplitKeys];
  __shared__ float ks_s[kSplitKeys], vs_s[kSplitKeys];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    q_s[e] = i < rows ? to_float(q[((int64_t)(i0 + i) * H + h) * D + d])
                      : 0.f;
  }
  stage_pages<P>(page_row, k0, nk, ps, k_scale, v_scale, pages_s, ks_s,
                 vs_s);
  __syncthreads();
  stage_kv(k_pool, v_pool, pages_s, ks_s, vs_s, k0, nk, key_end, H, h, D,
           ps, k_s, kstride, v_s);
  __syncthreads();

  for (int e = tid; e < kRows * kSplitKeys; e += kThreads) {
    const int i = e / kSplitKeys, t = e % kSplitKeys;
    const float* qr = q_s + i * D;
    const float* kr = k_s + t * kstride;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
    const bool seen = t < nk && k0 + t <= start + i0 + i;
    s_s[e] = seen ? dot * scale : kNegInf;
  }
  __syncthreads();

  for (int i = warp; i < kRows; i += kWarps) {
    float m, l;
    warp_softmax(s_s + i * kSplitKeys, kSplitKeys, m, l);
    if (lane == 0) {
      row_m[i] = m;
      row_l[i] = l;
    }
  }
  __syncthreads();

  const int64_t nparts = prefill_nparts(n_real, H, nsplit);
  for (int i = tid; i < live_rows; i += kThreads) {
    const int64_t idx = ((int64_t)(i0 + i) * H + h) * nsplit + j;
    part[idx] = row_m[i];
    part[nparts + idx] = row_l[i];
  }
#pragma unroll
  for (int c = 0; c < kPreAcc; ++c) {
    const int e = tid + c * kThreads;
    if (e < live_rows * D) {
      const int i = e / D, d = e % D;
      const float* pr = s_s + i * kSplitKeys;
      float a = 0.f;
      for (int t = 0; t < nk; ++t) a += pr[t] * v_s[t * D + d];
      const int64_t idx = ((int64_t)(i0 + i) * H + h) * nsplit + j;
      part[2 * nparts + idx * D + d] = a;
    }
  }
}

template <typename T, typename P>
cudaError_t launch_prefill_cores(const void* q, const void* k,
                                 const void* v, const int* page_row,
                                 const float* ks, const float* vs,
                                 void* out, float* part, int start,
                                 int n_real, int key_end, int C, int H,
                                 int D, int ps, int nsplit, float scale,
                                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRows * D + (size_t)kSplitKeys * (D + 1) +
                       (size_t)kSplitKeys * D + (size_t)kRows * kSplitKeys);
  cudaError_t e = allow_smem(prefill_split_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (C + kRows - 1) / kRows;
  prefill_split_kernel<T, P><<<dim3(tiles, H, nsplit), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), page_row, ks, vs, part, start, n_real,
      key_end, C, H, D, ps, nsplit, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_merge<T>(part, out, start, n_real, key_end, C, H, D,
                         kSplitKeys, nsplit, stream);
}

// ---------------------------------------------------------------------
// body 1: tensor cores (bf16 queries, D = kMmaD = 64)
// ---------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kKeyTile = kMmaTile;           // keys per staged tile
constexpr int kMaxClusterSplits = 16;        // largest (non-portable) cluster
constexpr int kTileElems = kMmaTile * kMmaLd;   // one padded bf16 tile

template <typename P>
__device__ __forceinline__ float code_value(uint8_t b);
template <>
__device__ __forceinline__ float code_value<int8_t>(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}
template <>
__device__ __forceinline__ float code_value<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 x;
  x.__x = b;
  return static_cast<float>(x);
}

// Shared-memory layout of the tensor-core body, in bytes: Q tiles, the
// K/V ring (raw: two stages of bf16 tiles; codes: two stages of code
// tiles plus one bf16 tile each for K and V, and the current tile's
// per-key scales), then the split's page ids (and page scales). After
// the walk the ring holds the block's per-row (o, m, l) for the merge
// across its cluster.
template <typename P, int QT>
struct MmaSmem {
  static constexpr bool kQuant = kQuantized<P>;
  static constexpr size_t kQ = sizeof(bf16) * QT * kTileElems;
  static constexpr size_t kBf = sizeof(bf16) * kTileElems;     // one tile
  static constexpr size_t kCode = (size_t)kKeyTile * kMmaD;    // one tile
  static constexpr size_t kRing = kQuant ? 2 * 2 * kCode + 2 * kBf
                                         : 2 * 2 * kBf;
  static constexpr size_t kKeyScales = kQuant ? 2 * kKeyTile * 4 : 0;
  static constexpr size_t kFixed = kQ + kRing + kKeyScales;
  static constexpr int kXLd = kMmaD + 2;        // a partial's o row (floats)
  static_assert(sizeof(float) * QT * kMmaTile * (kXLd + 2) <= kRing,
                "the partials must fit in the ring");
  static size_t bytes(int npg) {
    return kFixed + (size_t)npg * 4 * (kQuant ? 3 : 1);
  }
};

// Grid (split, head, query group); the splits of one (head, group) form
// one thread-block cluster. Warp w owns rows 16 w of each 64-row query
// tile of the group.
template <typename P, int QT>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(const bf16* __restrict__ q, const P* __restrict__ k_pool,
                   const P* __restrict__ v_pool,
                   const int* __restrict__ page_row,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, bf16* __restrict__ out,
                   int start, int n_real, int key_end, int C, int H, int ps,
                   int split_keys, int nsplit, float scale) {
  using L = MmaSmem<P, QT>;
  constexpr bool kQuant = L::kQuant;
  constexpr int NT = kKeyTile / 8, ND = kMmaD / 8;
  constexpr int kChunks = kMmaD * (int)sizeof(P) / 16;  // 16 B per row
  const int j = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = j * split_keys;
  const int q0 = grp * QT * kMmaTile;        // first query row of the group

  // the keys each query tile of the group can see; the block's bound. A
  // block that no live row of the group sees walks nothing (it still
  // joins its cluster's barriers).
  int tile_end[QT];
  int kend = 0;
#pragma unroll
  for (int u = 0; u < QT; ++u) {
    tile_end[u] = rows_key_end(q0 + u * kMmaTile, kMmaTile, start, n_real,
                               key_end);
    kend = max(kend, tile_end[u]);
  }
  kend = min(kend, k0 + split_keys);
  const int nkt = kend > k0 ? (kend - k0 + kKeyTile - 1) / kKeyTile : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ;
  float* key_sc = reinterpret_cast<float*>(ring + L::kRing);  // codes
  int* pages_s = reinterpret_cast<int*>(ring + L::kRing + L::kKeyScales);

  // Q rows of every tile of the group (rows >= C zero-filled)
  if (nkt > 0) {
#pragma unroll
    for (int u = 0; u < QT; ++u)
      for (int e = tid; e < kMmaTile * 8; e += kMmaThreads) {
        const int r = e >> 3, c = (e & 7) * 8;
        const int row = q0 + u * kMmaTile + r;
        const bool ok = row < C;
        cp_async16(q_s + u * kTileElems + r * kMmaLd + c,
                   ok ? q + ((int64_t)row * H + h) * kMmaD + c : q, ok);
      }
  }
  cp_async_commit();

  // the split's page ids (and page scales), first page p0
  const int p0 = k0 / ps;
  const int npg = nkt > 0 ? (kend - 1) / ps - p0 + 1 : 0;
  float* pks_s = reinterpret_cast<float*>(pages_s + npg);
  float* pvs_s = pks_s + npg;
  for (int i = tid; i < npg; i += kMmaThreads) {
    const int pg = page_row[p0 + i];
    pages_s[i] = pg;
    if constexpr (kQuant) {
      pks_s[i] = k_scale[pg];
      pvs_s[i] = v_scale[pg];
    }
  }
  __syncthreads();

  // one 64-key tile of K and V into ring stage `st`; keys >= kend
  // zero-filled
  auto issue_tile = [&](int kt, int st) {
    const int tk0 = k0 + kt * kKeyTile;
    for (int e = tid; e < kKeyTile * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const int pos = tk0 + r;
      const bool ok = pos < kend;
      int64_t off = 0;
      if (ok) {
        const int pg = pages_s[pos / ps - p0];
        off = (((int64_t)pg * H + h) * ps + pos % ps) * kMmaD +
              c * (16 / (int)sizeof(P));
      }
      unsigned char* kd;
      unsigned char* vd;
      if constexpr (kQuant) {
        kd = ring + (size_t)(2 * st) * L::kCode + r * kMmaD + c * 16;
        vd = kd + L::kCode;
      } else {
        kd = ring + (size_t)(2 * st) * L::kBf +
             (r * kMmaLd + c * 8) * sizeof(bf16);
        vd = kd + L::kBf;
      }
      cp_async16(kd, k_pool + off, ok);
      cp_async16(vd, v_pool + off, ok);
    }
  };

  if (nkt > 0) issue_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();                        // Q has landed
  __syncthreads();

  uint32_t qa[QT][kMmaD / 16][4];
  if (nkt > 0) {
#pragma unroll
    for (int u = 0; u < QT; ++u)
      load_a_frags(q_s + u * kTileElems, 16 * warp, qa[u]);
  }
  float m[QT][2], l[QT][2], o[QT][ND][4];
#pragma unroll
  for (int u = 0; u < QT; ++u) {
    m[u][0] = m[u][1] = kNegInf;
    l[u][0] = l[u][1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      o[u][nd][0] = o[u][nd][1] = o[u][nd][2] = o[u][nd][3] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      issue_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tk0 = k0 + kt * kKeyTile;
    const bf16* k_t;
    const bf16* v_t;
    if constexpr (kQuant) {
      // codes -> bf16 (exact), and this tile's per-key scales (0 past
      // the bound: a select, so a NaN scale there is never read)
      const unsigned char* kc = ring + (size_t)(2 * (kt & 1)) * L::kCode;
      bf16* kb = reinterpret_cast<bf16*>(ring + 4 * L::kCode);
      bf16* vb = kb + kTileElems;
      for (int e = tid; e < 2 * kKeyTile * (kMmaD / 16);
           e += kMmaThreads) {
        const int which = e / (kKeyTile * (kMmaD / 16));
        const int e2 = e % (kKeyTile * (kMmaD / 16));
        const int r = e2 / (kMmaD / 16), c = (e2 % (kMmaD / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kc + which * L::kCode + r * kMmaD + c);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = pack_bf16(code_value<P>(b[2 * i]),
                           code_value<P>(b[2 * i + 1]));
        bf16* dst = (which ? vb : kb) + r * kMmaLd + c;
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      if (tid < kKeyTile) {
        const int pos = tk0 + tid;
        const bool ok = pos < kend;
        const int slot = ok ? pos / ps - p0 : 0;
        key_sc[tid] = ok ? pks_s[slot] : 0.f;
        key_sc[kKeyTile + tid] = ok ? pvs_s[slot] : 0.f;
      }
      __syncthreads();
      k_t = kb;
      v_t = vb;
    } else {
      k_t = reinterpret_cast<const bf16*>(ring +
                                          (size_t)(2 * (kt & 1)) * L::kBf);
      v_t = k_t + kTileElems;
    }

#pragma unroll
    for (int u = 0; u < QT; ++u) {
      if (tk0 >= tile_end[u]) continue;      // the tile sees none of it
      float s[NT][4];
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
      mma_rows_t(qa[u], k_t, s);

      const int row0 = q0 + u * kMmaTile + 16 * warp + g;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1), pos = tk0 + col;
          const int row = row0 + 8 * (e >> 1);
          float x = s[jj][e];
          if constexpr (kQuant) x *= key_sc[col];
          x *= scale;
          const bool live = pos < kend && pos <= start + row;
          s[jj][e] = live ? x : kNegInf;
          mx[e >> 1] = nan_max(mx[e >> 1], s[jj][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
      bool dead[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = nan_max(m[u][r], quad_max(mx[r]));
        alpha[r] = __expf(m[u][r] - m_new);
        dead[r] = m_new <= kNegInf / 2;       // NaN is not dead
        m[u][r] = m_new;
      }
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[jj][e] = dead[r] ? 0.f : __expf(s[jj][e] - m[u][r]);
          psum[r] += s[jj][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[u][r] = l[u][r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[u][nd][e] *= alpha[e >> 1];

      // P V: A from the score fragments, B = V (keys, d) by ldmatrix.trans
      const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
      const int lcol = 8 * (lane >> 4);
#pragma unroll
      for (int k2 = 0; k2 < kKeyTile / 16; ++k2) {
        uint32_t a[4], lo[4];
        if constexpr (kQuant) {
          // p' = p * sv in f32, then bf16 hi + lo
          const float* vsc = key_sc + kKeyTile + 16 * k2 + 2 * t;
          const float x[8] = {
              s[2 * k2][0] * vsc[0],     s[2 * k2][1] * vsc[1],
              s[2 * k2][2] * vsc[0],     s[2 * k2][3] * vsc[1],
              s[2 * k2 + 1][0] * vsc[8], s[2 * k2 + 1][1] * vsc[9],
              s[2 * k2 + 1][2] * vsc[8], s[2 * k2 + 1][3] * vsc[9]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 hb =
                __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
            const float2 hf = __bfloat1622float2(hb);
            a[i] = *reinterpret_cast<const uint32_t*>(&hb);
            lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
          }
        } else {
          a[0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
          a[1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
          a[2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
          a[3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_t(b, v_t + (16 * k2 + lrow) * kMmaLd + 16 * n2 + lcol);
          mma_bf16(o[u][2 * n2], a, b[0], b[1]);
          mma_bf16(o[u][2 * n2 + 1], a, b[2], b[3]);
          if constexpr (kQuant) {
            mma_bf16(o[u][2 * n2], lo, b[0], b[1]);
            mma_bf16(o[u][2 * n2 + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                         // this stage may be refilled
  }
  if (nkt == 0) cp_async_wait<0>();

  if (nsplit == 1) {                         // the only split: finalize
#pragma unroll
    for (int u = 0; u < QT; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + u * kMmaTile + 16 * warp + g + 8 * r;
        if (row >= C) continue;
        const float ls = nan_max(l[u][r], 1e-30f);
        const bool row_ok = row < n_real && !(m[u][r] <= kNegInf / 2);
        bf16* orow = out + ((int64_t)row * H + h) * kMmaD;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const float x0 = row_ok ? o[u][nd][2 * r] / ls : 0.f;
          const float x1 = row_ok ? o[u][nd][2 * r + 1] / ls : 0.f;
          *reinterpret_cast<uint32_t*>(orow + 8 * nd + 2 * t) =
              pack_bf16(x0, x1);
        }
      }
    return;
  }

  // The cluster's merge. Each block leaves its rows' (o, m, l) in its
  // own shared memory (the ring: free after the walk's last barrier);
  // after the cluster barrier, block j merges rows j, j + nsplit, ...
  // reading every split's partial of the row in split order through
  // distributed shared memory, as the merge kernel does from the scratch.
  float* xo = reinterpret_cast<float*>(ring);
  float* xm = xo + QT * kMmaTile * L::kXLd;
  float* xl = xm + QT * kMmaTile;
#pragma unroll
  for (int u = 0; u < QT; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = u * kMmaTile + 16 * warp + g + 8 * r;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<float2*>(xo + rr * L::kXLd + 8 * nd + 2 * t) =
            make_float2(o[u][nd][2 * r], o[u][nd][2 * r + 1]);
      if (t == 0) {
        xm[rr] = m[u][r];
        xl[rr] = l[u][r];
      }
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int rr = j + nsplit * warp; rr < QT * kMmaTile;
       rr += nsplit * kWarps) {
    const int row = q0 + rr;
    if (row >= C) break;
    bf16* orow = out + ((int64_t)row * H + h) * kMmaD;
    int n = 0;                               // the splits the row sees
    if (row < n_real) {
      const int vis = min(start + row + 1, key_end);
      n = min(nsplit, (vis + split_keys - 1) / split_keys);
    }
    float mj = kNegInf, lj = 0.f;            // lane s: split s's m, l
    if (lane < n) {
      mj = cluster.map_shared_rank(xm, lane)[rr];
      lj = cluster.map_shared_rank(xl, lane)[rr];
    }
    float2 y[kMaxClusterSplits];             // every load before any use
#pragma unroll
    for (int s2 = 0; s2 < kMaxClusterSplits; ++s2) {
      const float* src = cluster.map_shared_rank(xo, s2 < n ? s2 : 0);
      y[s2] = s2 < n ? *reinterpret_cast<const float2*>(
                           src + rr * L::kXLd + 2 * lane)
                     : make_float2(0.f, 0.f);
    }
    const float M = warp_max(mj);
    const float w = lane < n ? expf(mj - M) : 0.f;
    const float lsum = warp_sum(lj * w);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kMaxClusterSplits; ++s2) {
      const float ws = __shfl_sync(0xffffffffu, w, s2);
      a0 += ws * y[s2].x;
      a1 += ws * y[s2].y;
    }
    *reinterpret_cast<uint32_t*>(orow + 2 * lane) =
        pack_bf16(finalize(a0, M, lsum), finalize(a1, M, lsum));
  }
  cluster.sync();                            // readers done with our smem
}

template <typename P, int QT>
cudaError_t launch_prefill_mma(const void* q, const void* k, const void* v,
                               const int* page_row, const float* ks,
                               const float* vs, void* out, int start,
                               int n_real, int key_end, int C, int H, int ps,
                               int split_keys, int nsplit, float scale,
                               cudaStream_t stream) {
  auto kernel = prefill_mma_kernel<P, QT>;
  const size_t smem = MmaSmem<P, QT>::bytes(split_keys / ps + 2);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (nsplit > 8) {                          // clusters of 9-16 blocks
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  const int tiles = (C + kMmaTile - 1) / kMmaTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, H, (tiles + QT - 1) / QT);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;         // one cluster: a head's splits
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                            static_cast<const P*>(k),
                            static_cast<const P*>(v), page_row, ks, vs,
                            static_cast<bf16*>(out), start, n_real, key_end,
                            C, H, ps, split_keys, nsplit, scale);
}

}  // namespace mxt

// q (C, H, D); k_pool / v_pool (P, H, ps, D); page_row (maxp,) int32;
// out (C, H, D). The chunk's first query sits at position `start`, its
// first `n_real` rows are live. The split plan comes from the wrapper,
// which computes it from the live keys key_end = min(start + n_real,
// maxp * ps): `split_keys` keys per split, `nsplit` splits (at most 16,
// one cluster, on the tensor-core body) and, for that body, `q_tiles`
// 64-row query tiles per block. `part` is the CUDA-core body's f32
// scratch of n_real * H * nsplit * (D + 2) floats (null when n_real = 0;
// the tensor-core body needs none). All contiguous (the tensor-core body
// also needs q and the pools 16-byte aligned); dtypes and scales as for
// mx_ragged_decode. Page-row entries must lie in [0, P). Returns a
// cudaError_t (0 = launched).
extern "C" int mx_ragged_prefill(const void* q, const void* k_pool,
                                 const void* v_pool, const int* page_row,
                                 const float* k_scale, const float* v_scale,
                                 void* out, float* part, int start,
                                 int n_real, int C, int H, int D, int ps,
                                 int maxp, int split_keys, int nsplit,
                                 int q_tiles, float scale, int dtype,
                                 int kv_dtype, void* stream) {
  if (C < 0 || H <= 0 || H > 65535 || D <= 0 || D > mxt::kMaxHeadDim ||
      ps <= 0 || maxp <= 0 || start < 0 || n_real < 0 || n_real > C ||
      (k_scale == nullptr) != (v_scale == nullptr) || split_keys <= 0 ||
      nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int64_t key_end =
      std::min<int64_t>((int64_t)start + n_real, (int64_t)maxp * ps);
  // the plan must cover the live keys with no split wholly past them
  if ((int64_t)nsplit * split_keys < key_end ||
      (int64_t)(nsplit - 1) * split_keys >= std::max<int64_t>(key_end, 1))
    return (int)cudaErrorInvalidValue;
  const bool mma = mxt::use_mma(dtype, D);
  if (mma ? (split_keys % mxt::kKeyTile != 0 ||
             nsplit > mxt::kMaxClusterSplits || q_tiles < 1 ||
             q_tiles > 2 ||
             (C + mxt::kMmaTile * q_tiles - 1) / (mxt::kMmaTile * q_tiles) >
                 65535)
          : (split_keys != mxt::kSplitKeys ||
             (part == nullptr && n_real > 0)))
    return (int)cudaErrorInvalidValue;
  const int kend = (int)key_end;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)mxt::dispatch_types(
      dtype, kv_dtype, k_scale != nullptr, [&](auto tt, auto tp) {
        using T = typename decltype(tt)::type;
        using P = typename decltype(tp)::type;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          if (mma) {
            if (q_tiles == 1)
              return mxt::launch_prefill_mma<P, 1>(
                  q, k_pool, v_pool, page_row, k_scale, v_scale, out, start,
                  n_real, kend, C, H, ps, split_keys, nsplit, scale, st);
            return mxt::launch_prefill_mma<P, 2>(
                q, k_pool, v_pool, page_row, k_scale, v_scale, out, start,
                n_real, kend, C, H, ps, split_keys, nsplit, scale, st);
          }
        }
        return mxt::launch_prefill_cores<T, P>(
            q, k_pool, v_pool, page_row, k_scale, v_scale, out, part, start,
            n_real, kend, C, H, D, ps, nsplit, scale, st);
      });
}
