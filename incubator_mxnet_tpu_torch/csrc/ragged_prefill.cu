// Ragged paged-attention CHUNKED-PREFILL kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel incubator_mxnet_tpu/ops/ragged_attention.py
// `_ragged_prefill_kernel`, launched by `_ragged_prefill_pallas` (raw
// pools) and by `_ragged_prefill_pallas_q` (int8 / fp8 code pools with
// per-page scales, dequantized where staged: the int8_t / __nv_fp8_e4m3
// instantiations of the templates below): a chunk
// of C queries of ONE slot, at absolute positions start + i, attends the
// slot's paged prefix plus the causal part of the chunk (the chunk's own
// K/V is already written into the pages), through one predicate
// pos_k <= start + i.
//
// What bounds it on an H100: the bytes of the live K/V pages. A chunk of
// C = 64 queries over a prefix of up to 1024 keys does 4 * C * keys * D
// flops on 2 * keys * D elements: ~64 flops per bf16 byte, still below
// the ~295 flop/byte balance point, so the floor is the live K/V bytes
// over 3.35 TB/s.
//
// Design: the TPU grid walks the page axis in order with (H, C) scratch.
// One GPU block walking the pages in order is latency-bound (the first
// version of this file measured 0.35 ms for a chunk at start 960, against
// a 1 us bound), so the keys are split, as in the decode kernel:
//   - pass 1, grid (query tile of kRows rows, head, 64-key split): a
//     block exits at once when no live row of its tile can see its keys
//     (split start >= start + min(tile end, n_real)) — pages past the
//     last live query cost nothing; tiles holding only padded rows
//     (i >= n_real) exit too, and pass 2 writes them zeros (padded rows
//     are garbage by contract);
//   - it stages the tile's queries, the split's page indices and its K
//     and V rows in shared memory (16 K and 16 V loads in flight per
//     thread); V positions >= start + n_real load as 0 — the n_real
//     bound, not start + C: a partial chunk's unwritten tail may hold a
//     recycled page's NaN;
//   - scores kRows x 64 from shared memory with the causal mask, a
//     warp-per-row softmax, P V with threads along D;
//   - it writes each row's (m, l, acc) for the split to the scratch;
//   - pass 2, grid (row, head): merges the row tile's splits.
// K/V rows are read once per query tile (C / kRows = 4 times at C = 64);
// they stay in the 50 MB L2. No tensor cores, no TMA (later work).

#include "ragged_common.cuh"

namespace mxt {

constexpr int kRows = 16;                    // query rows per block
constexpr int kPreAcc = kRows * kMaxHeadDim / kThreads;

__device__ __forceinline__ int tile_key_end(int tile, int start, int n_real,
                                            int C) {
  // keys [0, end) cover every live row of the tile; 0 = no live row
  const int i0 = tile * kRows;
  const int live = min(min(i0 + kRows, C), n_real) - i0;
  return live > 0 ? start + i0 + live : 0;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
prefill_split_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                     const P* __restrict__ v_pool,
                     const int* __restrict__ page_row,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     float* __restrict__ part, int start, int n_real, int C,
                     int H, int D, int ps, int maxp, int nsplit,
                     float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, j = blockIdx.z;
  const int key_end = min(tile_key_end(tile, start, n_real, C), maxp * ps);
  const int k0 = j * kSplitKeys;
  if (k0 >= key_end) return;
  const int nk = min(kSplitKeys, key_end - k0);
  const int i0 = tile * kRows;
  const int rows = min(kRows, C - i0);
  const int v_end = start + n_real;

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
  stage_kv(k_pool, v_pool, pages_s, ks_s, vs_s, k0, nk, v_end, H, h, D, ps,
           k_s, kstride, v_s);
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

  const int64_t nparts = (int64_t)C * H * nsplit;
  for (int i = tid; i < rows; i += kThreads) {
    const int64_t idx = ((int64_t)(i0 + i) * H + h) * nsplit + j;
    part[idx] = row_m[i];
    part[nparts + idx] = row_l[i];
  }
#pragma unroll
  for (int c = 0; c < kPreAcc; ++c) {
    const int e = tid + c * kThreads;
    if (e < rows * D) {
      const int i = e / D, d = e % D;
      const float* pr = s_s + i * kSplitKeys;
      float a = 0.f;
      for (int t = 0; t < nk; ++t) a += pr[t] * v_s[t * D + d];
      const int64_t idx = ((int64_t)(i0 + i) * H + h) * nsplit + j;
      part[2 * nparts + idx * D + d] = a;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                       int start, int n_real, int C, int H, int D, int ps,
                       int maxp, int nsplit) {
  const int row = blockIdx.x, h = blockIdx.y;
  const int key_end = min(tile_key_end(row / kRows, start, n_real, C),
                          maxp * ps);
  combine_row<T>(part, C, H, D, nsplit, row, h,
                 (key_end + kSplitKeys - 1) / kSplitKeys, out);
}

template <typename T, typename P>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const int* page_row, const float* ks,
                           const float* vs, void* out, float* part,
                           int start, int n_real, int C, int H, int D, int ps,
                           int maxp, float scale, cudaStream_t stream) {
  const int nsplit = (maxp * ps + kSplitKeys - 1) / kSplitKeys;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * D + (size_t)kSplitKeys * (D + 1) +
                       (size_t)kSplitKeys * D + (size_t)kRows * kSplitKeys);
  cudaError_t e = allow_smem(prefill_split_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (C + kRows - 1) / kRows;
  prefill_split_kernel<T, P><<<dim3(tiles, H, nsplit), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), page_row, ks, vs, part, start, n_real, C, H,
      D, ps, maxp, nsplit, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefill_combine_kernel<T><<<dim3(C, H), kThreads, 0, stream>>>(
      part, static_cast<T*>(out), start, n_real, C, H, D, ps, maxp, nsplit);
  return cudaGetLastError();
}

}  // namespace mxt

// Floats of scratch the wrapper must pass as `part` for these shapes.
extern "C" long long mx_ragged_prefill_scratch(int C, int H, int D, int ps,
                                               int maxp) {
  const int nsplit = (maxp * ps + mxt::kSplitKeys - 1) / mxt::kSplitKeys;
  return (long long)mxt::split_parts_floats(C, H, D, nsplit);
}

// q (C, H, D); k_pool / v_pool (P, H, ps, D); page_row (maxp,) int32;
// out (C, H, D); part: f32 scratch of mx_ragged_prefill_scratch floats.
// The chunk's first query sits at position `start`, its first `n_real`
// rows are live. All contiguous; dtypes and scales as for
// mx_ragged_decode. Page-row entries must lie in [0, P). Returns a
// cudaError_t (0 = launched).
extern "C" int mx_ragged_prefill(const void* q, const void* k_pool,
                                 const void* v_pool, const int* page_row,
                                 const float* k_scale, const float* v_scale,
                                 void* out, float* part, int start,
                                 int n_real, int C, int H, int D, int ps,
                                 int maxp, float scale, int dtype,
                                 int kv_dtype, void* stream) {
  if (C < 0 || H <= 0 || D <= 0 || D > mxt::kMaxHeadDim || ps <= 0 ||
      maxp <= 0 || start < 0 || n_real < 0 || n_real > C ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)mxt::dispatch_types(
      dtype, kv_dtype, k_scale != nullptr, [&](auto tt, auto tp) {
        using T = typename decltype(tt)::type;
        using P = typename decltype(tp)::type;
        return mxt::launch_prefill<T, P>(q, k_pool, v_pool, page_row, k_scale,
                                         v_scale, out, part, start, n_real, C,
                                         H, D, ps, maxp, scale, st);
      });
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
