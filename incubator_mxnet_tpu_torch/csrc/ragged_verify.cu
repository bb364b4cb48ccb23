// Ragged paged-attention SPECULATIVE-VERIFY kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel incubator_mxnet_tpu/ops/ragged_attention.py
// `_ragged_verify_kernel`, launched by `_ragged_verify_pallas` (raw
// pools) and by `_ragged_verify_pallas_q` (int8 / fp8 code pools with
// per-page scales: the int8_t / __nv_fp8_e4m3 instantiations below). Each
// slot has W queries: row r sits at position length - 1 + r and attends
// keys [0, length - 1 + r] (the paged prefix plus the causal part of the
// draft window), through one predicate pos_k < length + r.
//
// What bounds it on an H100: the bytes of the live K/V pages. W rows
// share each K/V read, so it does 4 * W * L * D flops on 2 * L * D
// elements: ~W flops per bf16 byte, far below the ~295 flop/byte balance
// point; the floor is the live K/V bytes over 3.35 TB/s. At serving sizes
// (8 slots, <= 1024 keys) launch and load latency dominate.
//
// A verify window is a prefill chunk of W rows for each slot: row r at
// position L - 1 + r, keys bounded by L + dl. Every block reads its slot's
// L and dl (verify_span) on the device; the wrapper's split plan
// (ops/ragged_attention.verify_plan) comes from the page row's capacity
// maxp * ps, the only bound the host knows. Blocks whose split lies past
// their slot's keys walk nothing. V positions >= L + dl are selected out:
// the bound is the slot's written extent L + dl, NOT L + W - 1 (a slot
// drafting fewer than W - 1 tokens leaves [L + dl, L + W - 1) unwritten
// this step, and a recycled page can hold a quarantined slot's NaN
// there). Rows past dl (discarded by the engine) and a dead slot (L = 0)
// get exact zeros. Two bodies, chosen from the dtype, D and W before the
// launch:
//
// 1. bf16 queries, D = 64 and W <= 64 (gpt_small at spec_k = 4): the
//    tensor-core body of the prefill kernel (ragged_mma.cuh) as
//    verify_mma_kernel, grid (split, head, slot): a block owns one (slot,
//    head, key split) and the slot's W rows in one 64-row tile (W <= 16:
//    one m16 tile, and the 4 warps take 16 keys each of every key tile,
//    merging in shared memory before the cluster), 16-byte cp.async double-
//    buffered after the page ids (and scales), codes converted to bf16 in
//    shared memory, the k scale on the f32 score and the v scale on p as
//    bf16 hi + lo, S and P V on mma.sync (V through ldmatrix.trans). The
//    splits of a (slot, head) are one thread-block cluster (whole 64-key
//    tiles, at most 16, as many as keep S H nsplit blocks to about one
//    wave of the card: more waves cost more than a longer walk, PERF.md)
//    and merge through distributed shared memory: one launch, no scratch.
//    A block past its slot's keys, and every block of a dead slot, still
//    joins the cluster's barriers and offers an empty partial;
// 2. every other case (f32 queries, other head dims, W > 64): the
//    CUDA-core design of the decode kernel, two launches:
//    - pass 1, grid (slot, head, 64-key split): blocks whose split starts
//      at or past L + dl exit at once. It stages the split's page indices
//      (and scales), then its K and V rows once, as f32 (V past L + dl as
//      0); the consumed rows 0..dl go through in tiles of kVRows (any W):
//      each tile stages its queries, scores them against the staged keys
//      with the causal mask, runs a warp-per-row softmax and P V, and
//      writes each row's (m, l, acc) for the split to the scratch;
//    - pass 2, grid (slot * W + row, head): merges the row's splits; rows
//      past dl get exact zeros.
// A NaN propagates at window granularity, as in the TPU kernel: a NaN V
// at a position some consumed row sees reaches the rows that see it, and
// may reach earlier rows of the window through a zero weight. No atomics:
// the output is bitwise the same from run to run.

#include "ragged_mma.cuh"     // body 1, shared with the prefill kernel

namespace mxt {

// body 1: the tensor-core body of ragged_mma.cuh, one slot a grid row;
// KW (W <= 16): the four warps split each key tile instead of the rows
template <typename P, bool KW>
__global__ void __launch_bounds__(kMmaThreads)
verify_mma_kernel(const bf16* __restrict__ q, const P* __restrict__ k_pool,
                  const P* __restrict__ v_pool,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lengths,
                  const int* __restrict__ draft_len,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, bf16* __restrict__ out,
                  int C, int H, int ps, int maxp, int split_keys, int nsplit,
                  float scale) {
  ragged_mma_body<P, 1, true, KW>(q, k_pool, v_pool, page_table, lengths,
                                  draft_len, k_scale, v_scale, out, C, H, ps,
                                  maxp, split_keys, nsplit, scale);
}

// body 2: CUDA cores
constexpr int kVRows = 8;                   // query rows per tile
constexpr int kVAcc = kVRows * kMaxHeadDim / kThreads;

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
verify_split_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const int* __restrict__ draft_len,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    float* __restrict__ part, int S, int W, int H, int D,
                    int ps, int maxp, int nsplit, float scale) {
  const int s = blockIdx.x, h = blockIdx.y, j = blockIdx.z;
  const VerifySpan sp = verify_span(lengths, draft_len, s, W, maxp * ps);
  const int k0 = j * kSplitKeys;
  if (k0 >= sp.key_end) return;
  const int nk = min(kSplitKeys, sp.key_end - k0);

  extern __shared__ float smem[];
  const int kstride = D + 1;                 // pad: conflict-free dots
  float* q_s = smem;                         // (kVRows, D)
  float* k_s = q_s + kVRows * D;             // (kSplitKeys, D + 1)
  float* v_s = k_s + kSplitKeys * kstride;   // (kSplitKeys, D)
  float* s_s = v_s + kSplitKeys * D;         // (kVRows, kSplitKeys)
  __shared__ float row_m[kVRows], row_l[kVRows];
  __shared__ int pages_s[kSplitKeys];
  __shared__ float ks_s[kSplitKeys], vs_s[kSplitKeys];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_pages<P>(page_table + (int64_t)s * maxp, k0, nk, ps, k_scale,
                 v_scale, pages_s, ks_s, vs_s);
  __syncthreads();
  stage_kv(k_pool, v_pool, pages_s, ks_s, vs_s, k0, nk, sp.L + sp.dl, H, h,
           D, ps, k_s, kstride, v_s);

  const int64_t nparts = (int64_t)S * W * H * nsplit;
  for (int r0 = 0; r0 <= sp.dl; r0 += kVRows) {
    const int rows = min(kVRows, sp.dl + 1 - r0);
    for (int e = tid; e < kVRows * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      q_s[e] = i < rows
          ? to_float(q[(((int64_t)s * W + r0 + i) * H + h) * D + d]) : 0.f;
    }
    __syncthreads();                         // q tile (and, first, K/V)

    for (int e = tid; e < kVRows * kSplitKeys; e += kThreads) {
      const int i = e / kSplitKeys, t = e % kSplitKeys;
      const float* qr = q_s + i * D;
      const float* kr = k_s + t * kstride;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      const bool seen = i < rows && t < nk && k0 + t < sp.L + r0 + i;
      s_s[e] = seen ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int i = warp; i < kVRows; i += kWarps) {
      float m, l;
      warp_softmax(s_s + i * kSplitKeys, kSplitKeys, m, l);
      if (lane == 0) {
        row_m[i] = m;
        row_l[i] = l;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows; i += kThreads) {
      const int64_t idx = (((int64_t)s * W + r0 + i) * H + h) * nsplit + j;
      part[idx] = row_m[i];
      part[nparts + idx] = row_l[i];
    }
#pragma unroll
    for (int c = 0; c < kVAcc; ++c) {
      const int e = tid + c * kThreads;
      if (e < rows * D) {
        const int i = e / D, d = e % D;
        const float* pr = s_s + i * kSplitKeys;
        float a = 0.f;
        for (int t = 0; t < nk; ++t) a += pr[t] * v_s[t * D + d];
        const int64_t idx =
            (((int64_t)s * W + r0 + i) * H + h) * nsplit + j;
        part[2 * nparts + idx * D + d] = a;
      }
    }
    __syncthreads();                         // before the next tile
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
verify_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ lengths,
                      const int* __restrict__ draft_len, T* __restrict__ out,
                      int S, int W, int H, int D, int ps, int maxp,
                      int nsplit) {
  const int row = blockIdx.x, h = blockIdx.y;
  const int s = row / W, r = row - s * W;
  const VerifySpan sp = verify_span(lengths, draft_len, s, W, maxp * ps);
  const int n_split = r <= sp.dl
      ? (sp.key_end + kSplitKeys - 1) / kSplitKeys : 0;
  combine_row<T>(part, S * W, H, D, nsplit, row, h, n_split, out);
}

template <typename T, typename P>
cudaError_t launch_verify(const void* q, const void* k, const void* v,
                          const int* pt, const int* len, const int* dl,
                          const float* ks, const float* vs, void* out,
                          float* part, int S, int W, int H, int D, int ps,
                          int maxp, int nsplit, float scale,
                          cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kVRows * D + (size_t)kSplitKeys * (D + 1) +
                       (size_t)kSplitKeys * D + (size_t)kVRows * kSplitKeys);
  cudaError_t e = allow_smem(verify_split_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  verify_split_kernel<T, P><<<dim3(S, H, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), pt, len, dl, ks, vs, part, S, W, H, D, ps,
      maxp, nsplit, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  verify_combine_kernel<T><<<dim3(S * W, H), kThreads, 0, stream>>>(
      part, len, dl, static_cast<T*>(out), S, W, H, D, ps, maxp, nsplit);
  return cudaGetLastError();
}

}  // namespace mxt

// q (S, W, H, D); k_pool / v_pool (P, H, ps, D); page_table (S, maxp)
// int32; lengths (S,) int32 = keys visible to row 0 (0 = dead slot);
// draft_len (S,) int32 = the slot's real draft count; out (S, W, H, D).
// The split plan comes from the wrapper (ops/ragged_attention.verify_plan)
// and covers the capacity maxp * ps: `nsplit` splits of `split_keys` keys.
// The tensor-core body (bf16 q, D = 64, W <= 64) takes whole 64-key tiles,
// at most 16 splits, and no scratch (`part` may be null); the CUDA-core
// body takes 64-key splits and `part`, f32 scratch of S * W * H * nsplit *
// (D + 2) floats. All contiguous (the tensor-core body also needs q and
// the pools 16-byte aligned); dtypes and scales as for mx_ragged_decode.
// Page-table entries must lie in [0, P). Returns a cudaError_t (0 =
// launched).
extern "C" int mx_ragged_verify(const void* q, const void* k_pool,
                                const void* v_pool, const int* page_table,
                                const int* lengths, const int* draft_len,
                                const float* k_scale, const float* v_scale,
                                void* out, float* part, int S, int W, int H,
                                int D, int ps, int maxp, int split_keys,
                                int nsplit, float scale, int dtype,
                                int kv_dtype, void* stream) {
  if (S < 0 || W <= 0 || H <= 0 || H > 65535 || D <= 0 ||
      D > mxt::kMaxHeadDim || ps <= 0 || maxp <= 0 ||
      (k_scale == nullptr) != (v_scale == nullptr) || split_keys <= 0 ||
      nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  // the plan must cover the capacity with no split wholly past it
  const int64_t cap = (int64_t)maxp * ps;
  if ((int64_t)nsplit * split_keys < cap ||
      (int64_t)(nsplit - 1) * split_keys >= cap)
    return (int)cudaErrorInvalidValue;
  const bool mma = mxt::use_mma(dtype, D) && W <= mxt::kMmaTile;
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
          if (mma && W <= 16)                // KW: one m16 tile of rows
            return mxt::launch_ragged_mma<P, 1, true>(
                mxt::verify_mma_kernel<P, true>, q, k_pool, v_pool,
                page_table, lengths, draft_len, k_scale, v_scale, out, W, H,
                ps, maxp, split_keys, nsplit, S, scale, st);
          if (mma)
            return mxt::launch_ragged_mma<P, 1, false>(
                mxt::verify_mma_kernel<P, false>, q, k_pool, v_pool,
                page_table, lengths, draft_len, k_scale, v_scale, out, W, H,
                ps, maxp, split_keys, nsplit, S, scale, st);
        }
        return mxt::launch_verify<T, P>(q, k_pool, v_pool, page_table,
                                        lengths, draft_len, k_scale, v_scale,
                                        out, part, S, W, H, D, ps, maxp,
                                        nsplit, scale, st);
      });
}
