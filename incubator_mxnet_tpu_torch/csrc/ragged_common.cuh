// Helpers shared by the ragged paged-attention kernels
// (ragged_decode.cu, ragged_prefill.cu, ragged_verify.cu).
//
// Pools are (P, H, page_size, D), contiguous, page 0 the null page. Each
// kernel is a template on the query/output type T (float or bf16) and the
// pool payload type P: T itself for a raw pool, or int8_t / __nv_fp8_e4m3
// codes for a quantized pool with one f32 scale per page (k_scale,
// v_scale). A block reads a page's scales next to its page-table entry
// (stage_pages) and dequantizes the codes to f32 once, where it stages
// them into shared memory (stage_kv); q is promoted to f32.
// Every kernel keeps the TPU kernels' numerics contract:
//   - a masked score is -1e30 (kNegInf);
//   - masked positions are SELECTED out of V (a reused page may hold
//     NaN past a slot's length, and 0 * NaN = NaN);
//   - the running max keeps a NaN (jnp.maximum semantics; CUDA's fmaxf
//     drops it), so a poisoned page poisons the output;
//   - a row whose max never left -1e30 is dead and emits exactly zero:
//     the test is the negated compare !(m <= -5e29), so a NaN max fails
//     it and propagates;
//   - positions past a bound load as 0 BEFORE any scale multiply, so a
//     NaN scale on a masked page cannot leak; a NaN scale on a live page
//     makes its values NaN and propagates (a code pool's NaN channel).
//
// The CUDA-core bodies of all three kernels (f32 queries, head dims other
// than 64; bf16 at D = 64 runs the tensor-core body of ragged_mma.cuh,
// which merges its splits inside a cluster) split the keys: a block of
// the first pass owns one (query rows, head, kSplitKeys-key split),
// stages that split's K and V tiles in shared memory (stage_kv, many
// loads in flight), and writes the split's partial softmax state per row
// — its max m, its sum l and its unnormalised accumulator acc[D] — to a
// scratch buffer the wrapper allocates. The second pass (combine_row)
// merges a row's splits: M = max_j m_j, l = sum_j l_j e^(m_j - M), acc =
// sum_j acc_j e^(m_j - M), out = acc / l.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// dtype codes of the C entry points (q / out, and the pool payload)
#define MXT_DTYPE_F32 0
#define MXT_DTYPE_BF16 1
#define MXT_KV_INT8 2
#define MXT_KV_FP8 3

namespace mxt {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 64;       // keys per first-pass block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// a payload type holding codes that need a per-page scale
template <typename P>
constexpr bool kQuantized = std::is_same<P, int8_t>::value ||
                            std::is_same<P, __nv_fp8_e4m3>::value;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max(a, b) that returns NaN when either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the finalize select: dead rows give 0, NaN rows propagate
__device__ __forceinline__ float finalize(float acc, float m, float l) {
  const bool row_ok = !(m <= kNegInf / 2);
  return row_ok ? acc / nan_max(l, 1e-30f) : 0.f;
}

// One warp's softmax over a row of n <= kSplitKeys scores held in shared
// memory (lane t covers keys t and t + 32); the scores are replaced by
// their weights e^(s - m). A row that sees no key in this split (max
// still -1e30) gets zero weights, so it contributes nothing to the
// merge. Returns (m, l) in every lane.
__device__ __forceinline__ void warp_softmax(float* s, int n, float& m,
                                             float& l) {
  const int lane = threadIdx.x & 31;
  float mx = kNegInf;
  for (int t = lane; t < n; t += 32) mx = nan_max(mx, s[t]);
  mx = warp_max(mx);
  const bool dead = mx <= kNegInf / 2;
  float sum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float p = dead ? 0.f : expf(s[t] - mx);
    s[t] = p;
    sum += p;
  }
  m = mx;
  l = warp_sum(sum);
}

// Second pass: block (row, head) merges the row's n_split partials at
// part[(row * H + h) * nsplit + j] (m and l planes, then the acc plane of
// D floats per partial) into out[(row * H + h) * D + d]. n_split 0 (a row
// with nothing to attend) writes exact zeros.
template <typename T>
__device__ __forceinline__ void combine_row(const float* __restrict__ part,
                                            int rows_total, int H, int D,
                                            int nsplit, int row, int h,
                                            int n_split, T* __restrict__ out) {
  const int64_t nparts = (int64_t)rows_total * H * nsplit;
  const int64_t base = ((int64_t)row * H + h) * nsplit;
  const float* pm = part + base;
  const float* pl = part + nparts + base;
  const float* pa = part + 2 * nparts + base * D;
  float M = kNegInf;
  for (int j = 0; j < n_split; ++j) M = nan_max(M, pm[j]);
  T* orow = out + ((int64_t)row * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float w = expf(pm[j] - M);
      l += pl[j] * w;
      acc += pa[(int64_t)j * D + d] * w;
    }
    orow[d] = from_float<T>(finalize(acc, M, l));
  }
}

// Stage a split's page indices (and, for a code pool, the pages' K and V
// scales) into shared memory: entry t < nk is key position k0 + t, read
// through the slot's page-table row. Entries t >= nk are never read.
template <typename P>
__device__ __forceinline__ void stage_pages(
    const int* __restrict__ row, int k0, int nk, int ps,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int* pages_s, float* ks_s, float* vs_s) {
  const int t = threadIdx.x;
  if (t < kSplitKeys) {
    const int page = t < nk ? row[(k0 + t) / ps] : 0;
    pages_s[t] = page;
    if constexpr (kQuantized<P>) {
      ks_s[t] = t < nk ? k_scale[page] : 0.f;
      vs_s[t] = t < nk ? v_scale[page] : 0.f;
    }
  }
}

// Stage one split's K and V rows of head h into shared memory as f32:
// row t (t < kSplitKeys) is key position k0 + t, at page pages_s[t]
// (already in shared memory). Rows t >= nk, and V rows at positions
// >= v_end, are 0 (selected out, never multiplied by a scale). A code
// pool's value is code * its page's scale (ks_s / vs_s). Each thread
// issues kStageBatch independent K and V loads before its first store,
// so a block keeps ~4K loads in flight instead of walking rows one
// latency at a time.
constexpr int kStageBatch = 16;

template <typename P>
__device__ __forceinline__ void stage_kv(
    const P* __restrict__ k_pool, const P* __restrict__ v_pool,
    const int* pages_s, const float* ks_s, const float* vs_s, int k0,
    int nk, int v_end, int H, int h, int D, int ps, float* k_s, int kstride,
    float* v_s) {
  const int total = kSplitKeys * D;
  for (int base = 0; base < total; base += kThreads * kStageBatch) {
    float kr[kStageBatch], vr[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + threadIdx.x + u * kThreads;
      const int t = e / D, d = e - t * D;
      kr[u] = 0.f;
      vr[u] = 0.f;
      if (e < total && t < nk) {
        const int pos = k0 + t;
        const int64_t off =
            (((int64_t)pages_s[t] * H + h) * ps + pos % ps) * D + d;
        kr[u] = to_float(k_pool[off]);
        if constexpr (kQuantized<P>) kr[u] *= ks_s[t];
        if (pos < v_end) {
          vr[u] = to_float(v_pool[off]);
          if constexpr (kQuantized<P>) vr[u] *= vs_s[t];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + threadIdx.x + u * kThreads;
      if (e < total) {
        const int t = e / D, d = e - t * D;
        k_s[t * kstride + d] = kr[u];
        v_s[e] = vr[u];
      }
    }
  }
}

// A verify window's bounds for slot s (W rows, kmax = the page row's
// capacity): L = keys visible to row 0 (0: a dead slot), dl = the slot's
// draft count (its last consumed row; a null draft_len, the decode step,
// means 0), key_end = the keys any consumed row reads, min(L + dl, kmax);
// 0: nothing to read.
struct VerifySpan {
  int L, dl, key_end;                       // key_end 0: nothing to read
};

__device__ __forceinline__ VerifySpan verify_span(const int* lengths,
                                                  const int* draft_len,
                                                  int s, int W, int kmax) {
  VerifySpan v;
  v.L = min(max(lengths[s], 0), kmax);
  v.dl = draft_len != nullptr ? min(max(draft_len[s], 0), W - 1) : 0;
  v.key_end = v.L > 0 ? min(v.L + v.dl, kmax) : 0;
  return v;
}

inline size_t split_parts_floats(int rows, int H, int D, int nsplit) {
  return (size_t)rows * H * nsplit * (D + 2);
}

// Opt a kernel into more than the static 48 KB of shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 46 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename X>
struct Tag {
  using type = X;
};

// Call launch(Tag<T>{}, Tag<P>{}) for the (q dtype, payload dtype) codes
// of a C entry point: a raw pool has the q dtype, a code pool int8 or
// fp8 with scales. Any other pair is cudaErrorInvalidValue.
template <typename F>
inline cudaError_t dispatch_types(int dtype, int kv_dtype, bool has_scales,
                                  F&& launch) {
  const bool quant = kv_dtype == MXT_KV_INT8 || kv_dtype == MXT_KV_FP8;
  if (quant != has_scales || (!quant && kv_dtype != dtype))
    return cudaErrorInvalidValue;
  if (dtype == MXT_DTYPE_F32) {
    if (kv_dtype == MXT_KV_INT8) return launch(Tag<float>{}, Tag<int8_t>{});
    if (kv_dtype == MXT_KV_FP8)
      return launch(Tag<float>{}, Tag<__nv_fp8_e4m3>{});
    return launch(Tag<float>{}, Tag<float>{});
  }
  if (dtype == MXT_DTYPE_BF16) {
    if (kv_dtype == MXT_KV_INT8)
      return launch(Tag<__nv_bfloat16>{}, Tag<int8_t>{});
    if (kv_dtype == MXT_KV_FP8)
      return launch(Tag<__nv_bfloat16>{}, Tag<__nv_fp8_e4m3>{});
    return launch(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace mxt
