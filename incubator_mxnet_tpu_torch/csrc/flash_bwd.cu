// Flash-attention BACKWARD kernels for Hopper (sm_90a): the
// FlashAttention-2 recurrences as two kernels, dq and dk/dv.
//
// Replaces the three backward Pallas kernels of
// incubator_mxnet_tpu/ops/pallas_attention.py: `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (wrapper `_flash_backward`, the arm for
// max(Tq, Tk) > 512) and the fused single-tile `_dense_bwd_kernel` (wrapper
// `_dense_backward`, the arm BERT at T = 512 runs). The fused form needs
// the whole (Tq, Tk) score tile resident, which a Hopper block cannot hold
// at T = 512, so both arms take the two-kernel form here; the price is one
// extra rebuild of the scores (dq and dk/dv each recompute s = q k^T).
// Neither kernel uses atomics: every output element is owned by one block,
// so the result is deterministic.
//
// Inputs: q / dO (B, H, Tq, D), k / v (B, H, Tk, D) of one type (f32 or
// bf16), the forward's lse (B, H, Tq) f32, and delta = rowsum(dO * O)
// (B, H, Tq) f32, computed by the caller as the JAX package does in XLA.
// Both kernels rebuild p = exp(s * scale - lse) UNDER A SELECT on the mask:
// for a fully masked row lse = -1e30, so s - lse is ~ +1e30 and exp
// overflows to inf, and inf * 0 would be NaN. Then
//   ds = p (dp - delta) scale,   dp = dO v^T,
//   dq = ds k,  dk = ds^T q,  dv = p^T dO,
// with ds rounded to k's type before dq / dk and p before dv, as the
// Pallas kernels round.
//
// What bounds them on an H100: operations (6 * BM * keys * D flops for dq,
// 8 * ... for dk/dv, on operands read once per tile pass). As in the
// forward, bf16 with D = 64 runs on the tensor cores (mma.sync m16n8k16,
// 4 warps x 16 rows or keys, ds / p handed from the S / dP accumulators
// to the next product's operands in registers, the operand that a
// product needs with k along its rows staged transposed), everything
// else on the f32 CUDA cores (256 threads, 4 x 4 scores each).
//
// Design:
//   - dq: grid (ceil(Tq / BM), H, B). A block stages its q and dO rows
//     with their lse and delta, walks the K/V tiles up to the tile's key
//     end (tiles past valid_len or past the diagonal are skipped), and
//     keeps dq (BM x D) in registers;
//   - dk/dv: grid (ceil(Tk / BN), H, B). A block stages its K and V rows
//     and walks the q tiles that can see them (all of them, or from the
//     diagonal on when causal), keeping dk and dv (BN x D) in registers.
//     A block whose keys all lie past valid_len writes zeros and exits.

#include "flash_common.cuh"

namespace mxt {

// s = q k^T and dp = dO v^T for one (BM x BN) tile, each thread 4 x 4
template <int RM, int RN>
__device__ __forceinline__ void scores_and_dp(const float* q_s,
                                              const float* do_s,
                                              const float* k_s,
                                              const float* v_s, int D,
                                              int ld, int ty, int tx,
                                              float (&s)[RM][RN],
                                              float (&dp)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qa[RM], oa[RM], ka[RN], va[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      qa[i] = q_s[(ty + 16 * i) * ld + d];
      oa[i] = do_s[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      ka[j] = k_s[(tx + 16 * j) * ld + d];
      va[j] = v_s[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] += qa[i] * ka[j];
        dp[i][j] += oa[i] * va[j];
      }
  }
}

template <typename T, int BM, int NC>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ valid_len, T* __restrict__ dq,
                    int H, int Tq, int Tk, int D, float scale, int causal) {
  constexpr int BN = BM, RM = BM / 16, RN = BN / 16;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ld = D + 1;
  const int64_t bh = (int64_t)b * H + h;
  const int key_end = tile_key_end(valid_len[b], Tk, q0, BM, causal);
  const int nq = min(BM, Tq - q0);

  extern __shared__ float smem[];
  float* q_s = smem;                 // (BM, ld)
  float* do_s = q_s + BM * ld;       // (BM, ld)
  float* k_s = do_s + BM * ld;       // (BN, ld)
  float* v_s = k_s + BN * ld;        // (BN, ld)
  float* ds_s = v_s + BN * ld;       // (BM, BN)

  stage_rows(q + bh * Tq * D, q0, nq, BM, D, ld, q_s);
  stage_rows(dout + bh * Tq * D, q0, nq, BM, D, ld, do_s);
  float lse_r[RM], delta_r[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Tq ? lse[bh * Tq + row] : 0.f;
    delta_r[i] = row < Tq ? delta[bh * Tq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < key_end; k0 += BN) {
    const int nk = min(BN, key_end - k0);
    __syncthreads();
    stage_rows(k + bh * Tk * D, k0, nk, BN, D, ld, k_s);
    stage_rows(v + bh * Tk * D, k0, nk, BN, D, ld, v_s);
    __syncthreads();

    float s[RM][RN], dp[RM][RN];
    scores_and_dp<RM, RN>(q_s, do_s, k_s, v_s, D, ld, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int t = tx + 16 * j, key = k0 + t;
        const bool live = t < nk && row < Tq && (!causal || key <= row);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(ty + 16 * i) * BN + t] =
            round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    }
    __syncthreads();

    for (int t = 0; t < nk; ++t) {
      float da[RM], ka[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) da[i] = ds_s[(ty + 16 * i) * BN + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        ka[c] = d < D ? k_s[t * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += da[i] * ka[c];
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    T* drow = dq + (bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) drow[d] = from_float<T>(acc[i][c]);
    }
  }
}

template <typename T, int BN, int NC>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ valid_len, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int D,
                     float scale, int causal) {
  constexpr int BM = BN, RM = BM / 16, RN = BN / 16;
  const int n0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ld = D + 1;
  const int64_t bh = (int64_t)b * H + h;
  const int vl = max(0, min(valid_len[b], Tk));
  const int nkeys = min(BN, Tk - n0);          // rows of this key tile
  const int nlive = max(0, min(BN, vl - n0));  // of them, keys < valid_len

  float dk_acc[RN][NC], dv_acc[RN][NC];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  extern __shared__ float smem[];
  float* k_s = smem;                 // (BN, ld)
  float* v_s = k_s + BN * ld;        // (BN, ld)
  float* q_s = v_s + BN * ld;        // (BM, ld)
  float* do_s = q_s + BM * ld;       // (BM, ld)
  float* p_s = do_s + BM * ld;       // (BM, BN)
  float* ds_s = p_s + BM * BN;       // (BM, BN)
  float* lse_s = ds_s + BM * BN;     // (BM)
  float* delta_s = lse_s + BM;       // (BM)

  if (nlive > 0) {
    stage_rows(k + bh * Tk * D, n0, nlive, BN, D, ld, k_s);
    stage_rows(v + bh * Tk * D, n0, nlive, BN, D, ld, v_s);
    // queries that can see a key of this tile: all, or from the diagonal
    const int m_start = causal ? (n0 / BM) * BM : 0;
    for (int m0 = m_start; m0 < Tq; m0 += BM) {
      const int nq = min(BM, Tq - m0);
      __syncthreads();
      stage_rows(q + bh * Tq * D, m0, nq, BM, D, ld, q_s);
      stage_rows(dout + bh * Tq * D, m0, nq, BM, D, ld, do_s);
      if (tid < BM) {
        lse_s[tid] = tid < nq ? lse[bh * Tq + m0 + tid] : 0.f;
        delta_s[tid] = tid < nq ? delta[bh * Tq + m0 + tid] : 0.f;
      }
      __syncthreads();

      float s[RM][RN], dp[RM][RN];
      scores_and_dp<RM, RN>(q_s, do_s, k_s, v_s, D, ld, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i, row = m0 + r;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int t = tx + 16 * j, key = n0 + t;
          const bool live = t < nlive && r < nq && (!causal || key <= row);
          const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * BN + t] = round_to<T>(p);
          ds_s[r * BN + t] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
        }
      }
      __syncthreads();

      // dv[key] += p[:, key]^T dO,  dk[key] += ds[:, key]^T q
      for (int r = 0; r < nq; ++r) {
        float pa[RN], da[RN], oa[NC], qa[NC];
#pragma unroll
        for (int i = 0; i < RN; ++i) {
          pa[i] = p_s[r * BN + ty + 16 * i];
          da[i] = ds_s[r * BN + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = tx + 16 * c;
          oa[c] = d < D ? do_s[r * ld + d] : 0.f;
          qa[c] = d < D ? q_s[r * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] += pa[i] * oa[c];
            dk_acc[i][c] += da[i] * qa[c];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int t = ty + 16 * i;
    if (t >= nkeys) continue;
    const int64_t off = (bh * Tk + n0 + t) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[off + d] = from_float<T>(dk_acc[i][c]);
        dv[off + d] = from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// The tensor-core dq (bf16, D = kMmaD): 4 warps x 16 query rows. Q's and
// dO's fragments stay in registers; per K/V tile, S = Q K^T and
// dP = dO V^T by mma, p and ds on the C fragments, ds rounded to bf16 and
// fed back as the A operand of dq += ds K (K staged transposed too).
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ valid_len,
                        bf16* __restrict__ dq, int H, int Tq, int Tk,
                        float scale, int causal) {
  constexpr int NT = kMmaTile / 8, ND = kMmaD / 8;
  const int q0 = blockIdx.x * kMmaTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = (int64_t)b * H + h;
  const bf16* kb = k + bh * Tk * kMmaD;
  const bf16* vb = v + bh * Tk * kMmaD;
  const int key_end = tile_key_end(valid_len[b], Tk, q0, kMmaTile, causal);
  const int nq = min(kMmaTile, Tq - q0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // (64, kMmaLd)
  bf16* do_s = q_s + kMmaTile * kMmaLd;              // (64, kMmaLd)
  bf16* k_s = do_s + kMmaTile * kMmaLd;              // (64, kMmaLd)
  bf16* v_s = k_s + kMmaTile * kMmaLd;               // (64, kMmaLd)
  bf16* kt_s = v_s + kMmaTile * kMmaLd;              // (kMmaD, kMmaLdT)

  stage_tile(q + bh * Tq * kMmaD, q0, nq, q_s);
  stage_tile(dout + bh * Tq * kMmaD, q0, nq, do_s);
  __syncthreads();
  uint32_t qa[kMmaD / 16][4], oa[kMmaD / 16][4];
  load_a_frags(q_s, 16 * warp, qa);
  load_a_frags(do_s, 16 * warp, oa);

  const int row0 = q0 + 16 * warp + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < Tq ? lse[bh * Tq + row] : 0.f;
    delta_r[r] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int k0 = 0; k0 < key_end; k0 += kMmaTile) {
    const int nk = min(kMmaTile, key_end - k0);
    __syncthreads();
    stage_tile(kb, k0, nk, k_s);
    stage_tile(vb, k0, nk, v_s);
    stage_tile_t(kb, k0, nk, kt_s);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_t(qa, k_s, s);
    mma_rows_t(oa, v_s, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), r = e >> 1;
        const int row = row0 + 8 * r;
        const bool live = col < nk && row < Tq && (!causal || k0 + col <= row);
        const float p = live ? expf(s[j][e] * scale - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;       // ds
      }
    mma_p_m(s, kt_s, acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    bf16* drow = dq + (bh * Tq + row) * kMmaD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(drow + 8 * nd + 2 * t) =
          pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

// The tensor-core dk/dv (bf16, D = kMmaD): 4 warps x 16 keys of the
// block's 64. K's and V's fragments stay in registers; per q tile,
// S^T = K Q^T and dP^T = V dO^T by mma (so p^T and ds^T come out as C
// fragments with the keys along the rows), then dv += p^T dO and
// dk += ds^T Q with Q and dO staged transposed.
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ valid_len,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Tq, int Tk, float scale, int causal) {
  constexpr int NT = kMmaTile / 8, ND = kMmaD / 8;
  const int n0 = blockIdx.x * kMmaTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = (int64_t)b * H + h;
  const int vl = max(0, min(valid_len[b], Tk));
  const int nkeys = min(kMmaTile, Tk - n0);
  const int nlive = max(0, min(kMmaTile, vl - n0));
  const bf16* qb = q + bh * Tq * kMmaD;
  const bf16* ob = dout + bh * Tq * kMmaD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // (64, kMmaLd)
  bf16* v_s = k_s + kMmaTile * kMmaLd;               // (64, kMmaLd)
  bf16* q_s = v_s + kMmaTile * kMmaLd;               // (64, kMmaLd)
  bf16* do_s = q_s + kMmaTile * kMmaLd;              // (64, kMmaLd)
  bf16* qt_s = do_s + kMmaTile * kMmaLd;             // (kMmaD, kMmaLdT)
  bf16* dot_s = qt_s + kMmaD * kMmaLdT;              // (kMmaD, kMmaLdT)
  float* lse_s = reinterpret_cast<float*>(dot_s + kMmaD * kMmaLdT);
  float* delta_s = lse_s + kMmaTile;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // this warp's keys: rows key0 = n0 + 16 warp + g and key0 + 8
  const int kr0 = 16 * warp + g;
  if (nlive > 0) {
    stage_tile(k + bh * Tk * kMmaD, n0, nlive, k_s);
    stage_tile(v + bh * Tk * kMmaD, n0, nlive, v_s);
    __syncthreads();
    uint32_t ka[kMmaD / 16][4], va[kMmaD / 16][4];
    load_a_frags(k_s, 16 * warp, ka);
    load_a_frags(v_s, 16 * warp, va);
    const int m_start = causal ? n0 : 0;
    for (int m0 = m_start; m0 < Tq; m0 += kMmaTile) {
      const int nq = min(kMmaTile, Tq - m0);
      __syncthreads();
      stage_tile(qb, m0, nq, q_s);
      stage_tile(ob, m0, nq, do_s);
      stage_tile_t(qb, m0, nq, qt_s);
      stage_tile_t(ob, m0, nq, dot_s);
      if (threadIdx.x < kMmaTile) {
        const int i = threadIdx.x;
        lse_s[i] = i < nq ? lse[bh * Tq + m0 + i] : 0.f;
        delta_s[i] = i < nq ? delta[bh * Tq + m0 + i] : 0.f;
      }
      __syncthreads();

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_rows_t(ka, q_s, s);            // S^T: keys x queries
      mma_rows_t(va, do_s, dp);          // dP^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);       // query in tile
          const int kr = kr0 + 8 * (e >> 1);             // key in tile
          const bool live = kr < nlive && col < nq &&
                            (!causal || n0 + kr <= m0 + col);
          const float p = live ? expf(s[j][e] * scale - lse_s[col]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[col]) * scale;   // ds^T
        }
      mma_p_m(s, dot_s, dv_acc);
      mma_p_m(dp, qt_s, dk_acc);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = kr0 + 8 * r;
    if (kr >= nkeys) continue;
    const int64_t off = (bh * Tk + n0 + kr) * kMmaD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * nd + 2 * t) =
          pack_bf16(dk_acc[nd][2 * r], dk_acc[nd][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * nd + 2 * t) =
          pack_bf16(dv_acc[nd][2 * r], dv_acc[nd][2 * r + 1]);
    }
  }
}

cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const int* valid_len, void* dq,
                          int B, int H, int Tq, int Tk, float scale,
                          int causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (4 * kMmaTile * kMmaLd +
                                      kMmaD * kMmaLdT);
  cudaError_t e = allow_smem(flash_bwd_dq_mma_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + kMmaTile - 1) / kMmaTile, H, B);
  flash_bwd_dq_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, valid_len, static_cast<bf16*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const int* valid_len,
                           void* dk, void* dv, int B, int H, int Tq, int Tk,
                           float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (4 * kMmaTile * kMmaLd +
                                      2 * kMmaD * kMmaLdT) +
                      sizeof(float) * 2 * kMmaTile;
  cudaError_t e = allow_smem(flash_bwd_dkv_mma_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tk + kMmaTile - 1) / kMmaTile, H, B);
  flash_bwd_dkv_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, valid_len, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
      Tq, Tk, scale, causal);
  return cudaGetLastError();
}

inline size_t dq_smem(int BM, int D) {
  return sizeof(float) * ((size_t)4 * BM * (D + 1) + (size_t)BM * BM);
}

inline size_t dkv_smem(int BN, int D) {
  return sizeof(float) *
         ((size_t)4 * BN * (D + 1) + (size_t)2 * BN * BN + 2 * BN);
}

template <typename T, int BM, int NC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* valid_len, void* dq, int B, int H, int Tq,
                      int Tk, int D, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_smem(BM, D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, BM, NC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  flash_bwd_dq_kernel<T, BM, NC><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      valid_len, static_cast<T*>(dq), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename T, int BN, int NC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* valid_len, void* dk, void* dv, int B, int H,
                       int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem(BN, D);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, BN, NC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tk + BN - 1) / BN, H, B);
  flash_bwd_dkv_kernel<T, BN, NC><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      valid_len, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, D,
      scale, causal);
  return cudaGetLastError();
}

inline bool bad_shape(int B, int H, int Tq, int Tk, int D, int causal) {
  return B < 0 || H <= 0 || Tq < 0 || Tk < 0 || D <= 0 ||
         D > kMaxHeadDim || D % 8 || (causal && Tq != Tk) || B > 65535 ||
         H > 65535;
}

}  // namespace mxt

// q / dout (B, H, Tq, D), k / v (B, H, Tk, D), one dtype (0 = f32,
// 1 = bf16), contiguous; lse / delta (B, H, Tq) f32; valid_len (B,)
// int32. Writes dq (B, H, Tq, D) in full. Returns a cudaError_t.
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, const int* valid_len,
                               void* dq, int B, int H, int Tq, int Tk, int D,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (mxt::bad_shape(B, H, Tq, Tk, D, causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxt::use_mma(dtype, D))
    return (int)mxt::launch_dq_mma(q, k, v, dout, lse, delta, valid_len, dq,
                                   B, H, Tq, Tk, scale, causal, st);
  return (int)mxt::dispatch_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return mxt::dispatch_head_dim(D, [&](auto bm, auto nc) {
      return mxt::launch_dq<T, decltype(bm)::value, decltype(nc)::value>(
          q, k, v, dout, lse, delta, valid_len, dq, B, H, Tq, Tk, D, scale,
          causal, st);
    });
  });
}

// As mx_flash_bwd_dq; writes dk and dv (B, H, Tk, D) in full (zeros for
// keys at or past valid_len).
extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, const int* valid_len,
                                void* dk, void* dv, int B, int H, int Tq,
                                int Tk, int D, float scale, int causal,
                                int dtype, void* stream) {
  if (mxt::bad_shape(B, H, Tq, Tk, D, causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxt::use_mma(dtype, D))
    return (int)mxt::launch_dkv_mma(q, k, v, dout, lse, delta, valid_len, dk,
                                    dv, B, H, Tq, Tk, scale, causal, st);
  return (int)mxt::dispatch_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return mxt::dispatch_head_dim(D, [&](auto bn, auto nc) {
      return mxt::launch_dkv<T, decltype(bn)::value, decltype(nc)::value>(
          q, k, v, dout, lse, delta, valid_len, dk, dv, B, H, Tq, Tk, D,
          scale, causal, st);
    });
  });
}
