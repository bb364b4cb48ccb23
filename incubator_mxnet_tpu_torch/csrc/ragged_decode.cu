// Ragged paged-attention DECODE kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel incubator_mxnet_tpu/ops/ragged_attention.py
// `_ragged_kernel`, launched by `_ragged_pallas` (raw pools) and by
// `_ragged_pallas_q` (int8 / fp8 code pools with per-page scales, here
// the int8_t / __nv_fp8_e4m3 instantiations): one query per slot attends
// that slot's live keys [0, L) through its page-table row.
//
// What bounds it on an H100: the bytes of the live K/V pages. Each
// (slot, head) reads L keys of K and V once and does 4 * L * D flops on
// them: about one flop per byte, far below the card's ~295 flop/byte
// balance point, so the roofline is live-K/V bytes over 3.35 TB/s (one
// byte per element for a code pool: half the bf16 bound). At serving
// sizes (8 slots, <= 1024 keys: ~2.5 us of bytes) launch and load
// latency dominate.
//
// The TPU grid walks (slot, page) in order and carries m/l/acc in VMEM
// scratch from one grid step to the next; blocks on the GPU run in no
// order, so the keys are split and the splits merged. The split plan
// comes from the wrapper (ops/ragged_attention.decode_plan), computed
// from the page row's capacity maxp * ps alone (each slot's length sits
// on the device), so it is fixed by the shapes. Two bodies, chosen from
// the dtype and D before the launch:
//
// 1. bf16 queries with D = 64 (gpt_small's serving path): the tensor-core
//    body of ragged_mma.cuh (shared with the prefill and verify kernels)
//    as decode_mma_kernel. A decode step is a verify window of one row
//    with no draft: grid (split, head, slot), each block reads its slot's
//    length on the device (verify_span with a null draft_len) and owns
//    one (slot, head, key split); it stages the one query row (rows 1-15
//    of the m16 tile zero-filled), the split's page ids (and scales), then
//    each 64-key tile of K and V with 16-byte cp.async, double-buffered,
//    codes converted to bf16 in shared memory; the four warps take 16 keys
//    each of every tile (S and P V on mma.sync, V through
//    ldmatrix.trans, the k scale on the f32 score and p' = p * v_scale as
//    bf16 hi + lo on code pools) and merge in shared memory. The splits of
//    a (slot, head) are one thread-block cluster (whole 64-key tiles, at
//    most 16, as many as keep S H nsplit blocks to about one wave) and
//    merge through distributed shared memory: one launch, no scratch. A
//    block past its slot's keys, and every block of a dead slot (L = 0),
//    still joins the cluster's barriers and offers an empty partial; a
//    dead slot's output is exact zeros;
// 2. every other case (f32 queries, other head dims): CUDA cores, two
//    launches:
//    - pass 1, grid (slot, head, 64-key split): blocks whose split starts
//      at or past the length exit at once. It stages the split's page
//      indices (and scales), then its K and V rows as f32 (codes
//      dequantized there; positions >= L load as 0: V is selected out,
//      never multiplied by a zero weight or a scale); scores a warp per
//      key (a shuffle-reduced dot), softmax by warp 0, P V a thread per
//      output column; it writes the split's (m, l, acc) to the wrapper's
//      scratch;
//    - pass 2, grid (slot, head): merges ceil(L / 64) partials.
// No atomics: the output is bitwise the same from run to run.

#include "ragged_mma.cuh"     // body 1, shared with prefill and verify

namespace mxt {

// body 1: the tensor-core body of ragged_mma.cuh, one slot a grid row, one
// query row (C = 1) over the four warps' key quarters (KW)
template <typename P>
__global__ void __launch_bounds__(kMmaThreads)
decode_mma_kernel(const bf16* __restrict__ q, const P* __restrict__ k_pool,
                  const P* __restrict__ v_pool,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lengths,
                  const int* __restrict__ draft_len,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, bf16* __restrict__ out,
                  int C, int H, int ps, int maxp, int split_keys, int nsplit,
                  float scale) {
  ragged_mma_body<P, 1, true, true>(q, k_pool, v_pool, page_table, lengths,
                                    draft_len, k_scale, v_scale, out, C, H, ps,
                                    maxp, split_keys, nsplit, scale);
}

// body 2: CUDA cores
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    float* __restrict__ part, int S, int H, int D, int ps,
                    int maxp, int nsplit, float scale) {
  const int s = blockIdx.x, h = blockIdx.y, j = blockIdx.z;
  const int L = min(max(lengths[s], 0), maxp * ps);
  const int k0 = j * kSplitKeys;
  if (k0 >= L) return;
  const int nk = min(kSplitKeys, L - k0);

  extern __shared__ float smem[];
  float* q_s = smem;                         // (D,)
  float* k_s = q_s + D;                      // (kSplitKeys, D)
  float* v_s = k_s + kSplitKeys * D;         // (kSplitKeys, D)
  float* s_s = v_s + kSplitKeys * D;         // (kSplitKeys,)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ int pages_s[kSplitKeys];
  __shared__ float ks_s[kSplitKeys], vs_s[kSplitKeys];
  const T* qrow = q + ((int64_t)s * H + h) * D;
  for (int d = tid; d < D; d += kThreads) q_s[d] = to_float(qrow[d]);
  stage_pages<P>(page_table + (int64_t)s * maxp, k0, nk, ps, k_scale,
                 v_scale, pages_s, ks_s, vs_s);
  __syncthreads();
  stage_kv(k_pool, v_pool, pages_s, ks_s, vs_s, k0, nk, L, H, h, D, ps,
           k_s, D, v_s);
  __syncthreads();

  for (int t = warp; t < kSplitKeys; t += kWarps) {
    const float* kd = k_s + t * D;
    float part_dot = 0.f;
    for (int d = lane; d < D; d += 32) part_dot += q_s[d] * kd[d];
    part_dot = warp_sum(part_dot);
    if (lane == 0) s_s[t] = (t < nk) ? part_dot * scale : kNegInf;
  }
  __syncthreads();

  __shared__ float row_ml[2];
  if (warp == 0) {
    float m, l;
    warp_softmax(s_s, kSplitKeys, m, l);
    if (lane == 0) {
      row_ml[0] = m;
      row_ml[1] = l;
    }
  }
  __syncthreads();

  const int64_t nparts = (int64_t)S * H * nsplit;
  const int64_t idx = ((int64_t)s * H + h) * nsplit + j;
  if (tid == 0) {
    part[idx] = row_ml[0];
    part[nparts + idx] = row_ml[1];
  }
  float* pacc = part + 2 * nparts + idx * D;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int t = 0; t < nk; ++t) a += s_s[t] * v_s[t * D + d];
    pacc[d] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      int S, int H, int D, int ps, int maxp, int nsplit) {
  const int s = blockIdx.x, h = blockIdx.y;
  const int L = min(max(lengths[s], 0), maxp * ps);
  combine_row<T>(part, S, H, D, nsplit, s, h,
                 (L + kSplitKeys - 1) / kSplitKeys, out);
}

template <typename T, typename P>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* pt, const int* len, const float* ks,
                          const float* vs, void* out, float* part, int S,
                          int H, int D, int ps, int maxp, int nsplit,
                          float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D + 2 * kSplitKeys * D +
                                       kSplitKeys);
  cudaError_t e = allow_smem(decode_split_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  decode_split_kernel<T, P><<<dim3(S, H, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), pt, len, ks, vs, part, S, H, D, ps, maxp,
      nsplit, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<dim3(S, H), kThreads, 0, stream>>>(
      part, len, static_cast<T*>(out), S, H, D, ps, maxp, nsplit);
  return cudaGetLastError();
}

}  // namespace mxt

// q (S, H, D); k_pool / v_pool (P, H, ps, D); page_table (S, maxp) int32;
// lengths (S,) int32; out (S, H, D). The split plan comes from the wrapper
// (ops/ragged_attention.decode_plan) and covers the capacity maxp * ps:
// `nsplit` splits of `split_keys` keys. The tensor-core body (bf16 q,
// D = 64) takes whole 64-key tiles, at most 16 splits, and no scratch
// (`part` may be null); the CUDA-core body takes 64-key splits and `part`,
// f32 scratch of S * H * nsplit * (D + 2) floats. All contiguous (the
// tensor-core body also needs q and the pools 16-byte aligned). q / out
// are of `dtype` (MXT_DTYPE_F32 or MXT_DTYPE_BF16); the pools of
// `kv_dtype`: the same dtype with null scales, or MXT_KV_INT8 /
// MXT_KV_FP8 codes with k_scale / v_scale (P,) f32. Page-table entries
// must lie in [0, P). Returns a cudaError_t (0 = launched).
extern "C" int mx_ragged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const int* page_table,
                                const int* lengths, const float* k_scale,
                                const float* v_scale, void* out, float* part,
                                int S, int H, int D, int ps, int maxp,
                                int split_keys, int nsplit, float scale,
                                int dtype, int kv_dtype, void* stream) {
  if (S < 0 || H <= 0 || H > 65535 || D <= 0 || D > mxt::kMaxHeadDim ||
      ps <= 0 || maxp <= 0 || (k_scale == nullptr) != (v_scale == nullptr) ||
      split_keys <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  // the plan must cover the capacity with no split wholly past it
  const int64_t cap = (int64_t)maxp * ps;
  if ((int64_t)nsplit * split_keys < cap ||
      (int64_t)(nsplit - 1) * split_keys >= cap)
    return (int)cudaErrorInvalidValue;
  const bool mma = mxt::use_mma(dtype, D);
  if (mma ? (split_keys % mxt::kKeyTile != 0 ||
             nsplit > mxt::kMaxClusterSplits || S > 65535)
          : (split_keys != mxt::kSplitKeys || (part == nullptr && S > 0)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)mxt::dispatch_types(
      dtype, kv_dtype, k_scale != nullptr, [&](auto tt, auto tp) {
        using T = typename decltype(tt)::type;
        using P = typename decltype(tp)::type;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          if (mma)                           // C = 1, no draft_len
            return mxt::launch_ragged_mma<P, 1, true>(
                mxt::decode_mma_kernel<P>, q, k_pool, v_pool, page_table,
                lengths, nullptr, k_scale, v_scale, out, 1, H, ps,
                maxp, split_keys, nsplit, S, scale, st);
        }
        return mxt::launch_decode<T, P>(q, k_pool, v_pool, page_table,
                                        lengths, k_scale, v_scale, out, part,
                                        S, H, D, ps, maxp, nsplit, scale, st);
      });
}
