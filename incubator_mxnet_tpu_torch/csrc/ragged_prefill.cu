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
//    the tensor cores: prefill_mma_kernel, the body of ragged_mma.cuh
//    (shared with the verify kernel), grid (split, head, query group). A block
//    owns one (head, key split) and every query row of its group (1 or 2
//    tiles of 64 rows; the plan takes one group for C <= 128, so each
//    live K/V byte is read once a launch); double-buffered 16-byte
//    cp.async of the split's pages, codes converted to bf16 in shared
//    memory, mma.sync products, and a head's splits (at most 16) merged in
//    one thread-block cluster through distributed shared memory: no
//    scratch, no second launch.
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
// the output is bitwise the same from run to run.

#include <algorithm>

#include "ragged_mma.cuh"     // body 1, shared with the verify kernel

namespace mxt {

// body 1: the tensor-core body of ragged_mma.cuh for one chunk
template <typename P, int QT>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(const bf16* __restrict__ q, const P* __restrict__ k_pool,
                   const P* __restrict__ v_pool,
                   const int* __restrict__ page_row,
                   const int* __restrict__ lengths,
                   const int* __restrict__ draft_len,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, bf16* __restrict__ out,
                   int start, int n_real, int key_end, int C, int H, int ps,
                   int maxp, int split_keys, int nsplit, float scale) {
  ragged_mma_body<P, QT, false, false>(q, k_pool, v_pool, page_row,
                                       lengths, draft_len, k_scale, v_scale,
                                       out, start, n_real, key_end, C, H, ps,
                                       maxp, split_keys, nsplit, scale);
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
            const int tiles = (C + mxt::kMmaTile - 1) / mxt::kMmaTile;
            const int groups = (tiles + q_tiles - 1) / q_tiles;
            if (q_tiles == 1)
              return mxt::launch_ragged_mma<P, 1>(
                  mxt::prefill_mma_kernel<P, 1>, q, k_pool, v_pool, page_row,
                  nullptr, nullptr, k_scale, v_scale, out, start, n_real,
                  kend, C, H, ps, maxp, split_keys, nsplit, groups, scale,
                  st);
            return mxt::launch_ragged_mma<P, 2>(
                mxt::prefill_mma_kernel<P, 2>, q, k_pool, v_pool, page_row,
                nullptr, nullptr, k_scale, v_scale, out, start, n_real, kend,
                C, H, ps, maxp, split_keys, nsplit, groups, scale, st);
          }
        }
        return mxt::launch_prefill_cores<T, P>(
            q, k_pool, v_pool, page_row, k_scale, v_scale, out, part, start,
            n_real, kend, C, H, D, ps, nsplit, scale, st);
      });
}
