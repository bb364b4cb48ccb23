// Ragged paged-attention DECODE kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel incubator_mxnet_tpu/ops/ragged_attention.py
// `_ragged_kernel`, launched by `_ragged_pallas` (raw pools) and by
// `_ragged_pallas_q` (int8 / fp8 code pools with per-page scales, here
// the int8_t / __nv_fp8_e4m3 instantiations): one query per slot attends
// that slot's live keys through its page-table row.
//
// What bounds it on an H100: the bytes of the live K/V pages. Each
// (slot, head) reads L keys of K and V once and does 4 * L * D flops on
// them: about one flop per byte, far below the card's ~295 flop/byte
// balance point, so the roofline is live-K/V bytes over 3.35 TB/s (one
// byte per element for a code pool: half the bf16 bound).
//
// Design: the TPU grid walks (slot, page) in order and carries m/l/acc
// in VMEM scratch from one grid step to the next. Blocks on the GPU run
// in no order, and one block walking a slot's pages one after another
// is latency-bound (each page waits for its loads and three barriers —
// the first version of this file measured 0.53 ms at the serving
// shapes, against a 2.5 us bound). So the keys are split instead:
//   - pass 1, grid (slot, head, split): each block owns kSplitKeys = 64
//     consecutive keys of one (slot, head); it reads its own length and
//     page-table entries, and blocks whose split starts at or past the
//     length exit at once — dead pages cost nothing;
//   - the block stages the split's page indices (and the pages' scales
//     for a code pool), then its K and V rows in shared memory as f32
//     (codes dequantized there), each thread issuing 16 K and 16 V loads
//     before its first store (consecutive threads on consecutive
//     elements); positions >= L load as 0 (V is selected out, never
//     multiplied by a zero weight or a scale);
//   - scores: a warp per key, a shuffle-reduced dot; softmax over the
//     split by warp 0; P V with one thread per output column;
//   - it writes the split's (m, l, acc) to the wrapper's scratch;
//   - pass 2, grid (slot, head): merges ceil(L / 64) partials.
// Everything is f32 in registers and shared memory; no tensor cores,
// no TMA (later work).

#include "ragged_common.cuh"

namespace mxt {

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
                          int H, int D, int ps, int maxp, float scale,
                          cudaStream_t stream) {
  const int nsplit = (maxp * ps + kSplitKeys - 1) / kSplitKeys;
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

// Floats of scratch the wrapper must pass as `part` for these shapes.
extern "C" long long mx_ragged_decode_scratch(int S, int H, int D, int ps,
                                              int maxp) {
  const int nsplit = (maxp * ps + mxt::kSplitKeys - 1) / mxt::kSplitKeys;
  return (long long)mxt::split_parts_floats(S, H, D, nsplit);
}

// q (S, H, D); k_pool / v_pool (P, H, ps, D); page_table (S, maxp) int32;
// lengths (S,) int32; out (S, H, D); part: f32 scratch of
// mx_ragged_decode_scratch floats. All contiguous. q / out are of
// `dtype` (MXT_DTYPE_F32 or MXT_DTYPE_BF16); the pools of `kv_dtype`:
// the same dtype with null scales, or MXT_KV_INT8 / MXT_KV_FP8 codes
// with k_scale / v_scale (P,) f32. Page-table entries must lie in
// [0, P). Returns a cudaError_t (0 = launched).
extern "C" int mx_ragged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const int* page_table,
                                const int* lengths, const float* k_scale,
                                const float* v_scale, void* out, float* part,
                                int S, int H, int D, int ps, int maxp,
                                float scale, int dtype, int kv_dtype,
                                void* stream) {
  if (S < 0 || H <= 0 || D <= 0 || D > mxt::kMaxHeadDim || ps <= 0 ||
      maxp <= 0 || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)mxt::dispatch_types(
      dtype, kv_dtype, k_scale != nullptr, [&](auto tt, auto tp) {
        using T = typename decltype(tt)::type;
        using P = typename decltype(tp)::type;
        return mxt::launch_decode<T, P>(q, k_pool, v_pool, page_table,
                                        lengths, k_scale, v_scale, out, part,
                                        S, H, D, ps, maxp, scale, st);
      });
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
