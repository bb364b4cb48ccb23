// Flash-attention FORWARD kernel for Hopper (sm_90a).
//
// Replaces both forward Pallas kernels of
// incubator_mxnet_tpu/ops/pallas_attention.py: the streaming
// `_flash_kernel` (wrapper `_flash_fwd_lse`, the arm for max(Tq, Tk) > 512)
// and the single-tile `_dense_fwd_kernel` (wrapper `_dense_fwd_lse`, the arm
// BERT at T = 512 runs). Their split is a TPU VMEM artifact: a 512 x 512 f32
// score tile is 1 MB, which no Hopper block can hold, so one tiled kernel
// serves both under one contract:
//   - q / k / v (B, H, T, D) f32 or bf16, D <= 256 and a multiple of 8;
//     out (B, H, Tq, D) in q's type, lse (B, H, Tq) f32;
//   - keys >= min(valid_len[b], Tk) are selected out of the scores (-1e30);
//     causal is top-left (key j <= query i, square only);
//   - a row whose running max never left -1e30 writes 0 and lse = -1e30
//     (the reference's `m > -1e30 / 2` test, so a NaN row does too); the
//     running max keeps NaN (jnp.maximum semantics, which fmaxf lacks).
//
// What bounds it on an H100: operations. One (query tile, head) does
// 4 * BM * keys * D flops on (BM + 2 keys) * D operands; at BERT's T = 512,
// D = 64 that is ~100 flops per bf16 byte read once, so against the bf16
// tensor-core peak (989 TFLOP/s) the floor is ~0.02 ms for B = 32, H = 12.
//
// Design: grid (ceil(Tq / 64), H, B). A block stages its query rows once,
// then walks the K/V tiles in order, stopping at the tile's key end (past
// valid_len, or past the diagonal when causal: dead tiles are never
// loaded), with the online softmax (m, l) per row and the acc rescaled by
// alpha = e^(m_old - m_new) per tile. Two bodies:
//   - bf16 with D = 64 (BERT, GPT-2): tensor cores through mma.sync
//     m16n8k16 (flash_common.cuh): 4 warps x 16 rows; Q's fragments in
//     registers, S = Q K^T and P V by mma, p passed from the first
//     product's accumulators to the second's operands in registers;
//   - every other case (f32, other head dims up to 256): the f32 CUDA
//     cores, 256 threads, each 4 x 4 scores from shared memory (f32
//     staging, padded rows) and 4 rows x D / 16 acc columns; p rounded to
//     the operand type through shared memory. Its limit is the
//     shared-memory traffic of the scalar products.
// No TMA, wgmma or pipelining of the loads yet (later work).

#include "flash_common.cuh"

namespace mxt {

template <typename T, int BM, int NC>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ valid_len,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Tq,
                 int Tk, int D, float scale, int causal) {
  constexpr int BN = BM, RM = BM / 16, RN = BN / 16;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ld = D + 1;
  const int64_t bh = (int64_t)b * H + h;
  const T* qb = q + bh * Tq * D;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const int key_end = tile_key_end(valid_len[b], Tk, q0, BM, causal);

  extern __shared__ float smem[];
  float* q_s = smem;                 // (BM, ld)
  float* k_s = q_s + BM * ld;        // (BN, ld)
  float* v_s = k_s + BN * ld;        // (BN, ld)
  float* p_s = v_s + BN * ld;        // (BM, BN)

  stage_rows(qb, q0, min(BM, Tq - q0), BM, D, ld, q_s);

  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < key_end; k0 += BN) {
    const int nk = min(BN, key_end - k0);
    __syncthreads();                  // the previous tile's readers are done
    stage_rows(kb, k0, nk, BN, D, ld, k_s);
    stage_rows(vb, k0, nk, BN, D, ld, v_s);
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[RM], ka[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) ka[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] += qa[i] * ka[j];
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int t = tx + 16 * j, key = k0 + t;
        const bool live = t < nk && (!causal || key <= row);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = nan_max(mx, s[i][j]);
      }
      const float m_new = nan_max(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        p_s[(ty + 16 * i) * BN + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < nk; ++t) {
      float pa[RM], va[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = p_s[(ty + 16 * i) * BN + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        va[c] = d < D ? v_s[t * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += pa[i] * va[c];
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const bool row_ok = m[i] > kNegInf / 2;
    const float l_safe = nan_max(l[i], 1e-30f);
    T* orow = out + (bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_float<T>(row_ok ? acc[i][c] / l_safe : 0.f);
    }
    if (tx == 0) lse[bh * Tq + row] = row_ok ? m[i] + logf(l_safe) : kNegInf;
  }
}

// The tensor-core forward (bf16, D = kMmaD): 4 warps, each owning 16 of
// the block's 64 query rows. Per K/V tile: S = Q K^T by mma (Q's fragments
// stay in registers for the whole walk), the online softmax on the C
// fragments (a row lives in one quad of lanes), p rounded to bf16 and fed
// back as the A operand of P V (V staged transposed).
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ valid_len, bf16* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     float scale, int causal) {
  constexpr int NT = kMmaTile / 8, ND = kMmaD / 8;
  const int q0 = blockIdx.x * kMmaTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = (int64_t)b * H + h;
  const bf16* kb = k + bh * Tk * kMmaD;
  const bf16* vb = v + bh * Tk * kMmaD;
  const int key_end = tile_key_end(valid_len[b], Tk, q0, kMmaTile, causal);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // (64, kMmaLd)
  bf16* k_s = q_s + kMmaTile * kMmaLd;               // (64, kMmaLd)
  bf16* vt_s = k_s + kMmaTile * kMmaLd;              // (kMmaD, kMmaLdT)

  stage_tile(q + bh * Tq * kMmaD, q0, min(kMmaTile, Tq - q0), q_s);
  __syncthreads();
  uint32_t qa[kMmaD / 16][4];
  load_a_frags(q_s, 16 * warp, qa);

  // rows r[0] = g and r[1] = g + 8 of this warp's 16
  const int row0 = q0 + 16 * warp + g;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int k0 = 0; k0 < key_end; k0 += kMmaTile) {
    const int nk = min(kMmaTile, key_end - k0);
    __syncthreads();
    stage_tile(kb, k0, nk, k_s);
    stage_tile_t(vb, k0, nk, vt_s);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows_t(qa, k_s, s);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
        const bool live = col < nk && (!causal || k0 + col <= row);
        s[j][e] = live ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = nan_max(mx[e >> 1], s[j][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = nan_max(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];
    mma_p_m(s, vt_s, o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const bool row_ok = m[r] > kNegInf / 2;
    const float l_safe = nan_max(l[r], 1e-30f);
    bf16* orow = out + (bh * Tq + row) * kMmaD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float x0 = row_ok ? o[nd][2 * r] / l_safe : 0.f;
      const float x1 = row_ok ? o[nd][2 * r + 1] / l_safe : 0.f;
      *reinterpret_cast<uint32_t*>(orow + 8 * nd + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0) lse[bh * Tq + row] = row_ok ? m[r] + logf(l_safe) : kNegInf;
  }
}

cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const int* valid_len, void* out, float* lse, int B,
                           int H, int Tq, int Tk, float scale, int causal,
                           cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kMmaTile * kMmaLd +
                                      kMmaD * kMmaLdT);
  cudaError_t e = allow_smem(flash_fwd_mma_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + kMmaTile - 1) / kMmaTile, H, B);
  flash_fwd_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), valid_len, static_cast<bf16*>(out), lse,
      H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int BM, int NC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* valid_len, void* out, float* lse, int B,
                       int H, int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * BM * (D + 1) + (size_t)BM * BM);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, BM, NC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  flash_fwd_kernel<T, BM, NC><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, static_cast<T*>(out), lse, H, Tq,
      Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace mxt

// q (B, H, Tq, D), k / v (B, H, Tk, D), all contiguous and of one dtype
// (0 = f32, 1 = bf16); valid_len (B,) int32 (capped at Tk inside); out
// (B, H, Tq, D) of that dtype and lse (B, H, Tq) f32, written in full.
// causal = 1 requires Tq == Tk. Returns a cudaError_t (0 = launched).
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            const int* valid_len, void* out, float* lse,
                            int B, int H, int Tq, int Tk, int D, float scale,
                            int causal, int dtype, void* stream) {
  if (B < 0 || H <= 0 || Tq < 0 || Tk < 0 || D <= 0 ||
      D > mxt::kMaxHeadDim || D % 8 || (causal && Tq != Tk) || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxt::use_mma(dtype, D))
    return (int)mxt::launch_fwd_mma(q, k, v, valid_len, out, lse, B, H, Tq,
                                    Tk, scale, causal, st);
  return (int)mxt::dispatch_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return mxt::dispatch_head_dim(D, [&](auto bm, auto nc) {
      return mxt::launch_fwd<T, decltype(bm)::value, decltype(nc)::value>(
          q, k, v, valid_len, out, lse, B, H, Tq, Tk, D, scale, causal, st);
    });
  });
}
