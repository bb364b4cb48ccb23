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
// so the result is bitwise the same from run to run.
//
// Inputs: q / dO / O (B, H, Tq, D), k / v (B, H, Tk, D) of one type (f32
// or bf16), the forward's lse (B, H, Tq) f32. The dq launch computes
// delta = rowsum(dO * O) (B, H, Tq) in f32 from the dO rows it stages and
// the O rows it reads, uses it and writes it; the dk/dv launch, which
// follows it on the stream, reads it. Both kernels rebuild
// p = exp(s * scale - lse) UNDER A SELECT on the mask: for a fully masked
// row lse = -1e30, so s - lse is ~ +1e30 and exp overflows to inf, and
// inf * 0 would be NaN. Then
//   ds = p (dp - delta) scale,   dp = dO v^T,
//   dq = ds k,  dk = ds^T q,  dv = p^T dO,
// with ds rounded to k's type before dq / dk and p before dv, as the
// Pallas kernels round.
//
// What bounds them on an H100, at bert_base's bench shape (B = 32, H = 12,
// T = 512, D = 64, bf16, ~386 live keys a batch row):
//   - dk/dv: operations, 8 B H Tq keys D flops (~39 GFLOP, 0.040 ms at
//     989 TFLOP/s) against ~100 MB of q, dO, live K/V and dk/dv (0.030 ms
//     at 3.35 TB/s);
//   - dq (delta included): bytes, the q, dO, O and dq rows and the live
//     K/V once, ~140 MB (0.042 ms), against 6 B H Tq keys D flops
//     (0.030 ms).
// Both sit near the balance point, and on the card the tensor-core bodies
// are bound by latency: a block's steps form one chain (tile copy ->
// scores -> exponentials -> second product), so the design keeps copies
// off the chain, shortens it, and keeps as many blocks resident as the
// registers allow:
//   1. TMA copies: one thread asks for each tile (q, dO, K, V: 128-byte
//      rows) and an mbarrier counts its bytes; the streamed operand (K/V
//      for dq, q/dO for dk/dv) goes through a two-stage ring, tile i + 1
//      in flight while tile i's products run, one block barrier a step.
//      Measured on the card, issuing the same tiles as per-thread 16-byte
//      cp.async took a third of a step. The resident operand is copied
//      once: dq reads q / dO from their tiles through wgmma descriptors,
//      dk/dv holds K / V in registers as A fragments;
//   2. no transposed copies: every tile is staged once, row-major, in the
//      128-byte swizzle. dq's wgmma reads the tiles in place: q, dO and
//      the K / V stage K-major (the head dim is the reduction axis of S =
//      Q K^T and dP = dO V^T), the K stage MN-major for dS K (its key
//      rows are the reduction axis: wgmma's transpose bit for 16-bit
//      types). In dk/dv the A fragments and the B operands with the head
//      dim along their rows (q, dO in S^T, dP^T) come from ldmatrix.x4,
//      those with the reduction axis along the stored rows (dO in P^T dO,
//      q in dS^T Q) from ldmatrix.x4.trans on the same tile;
//   3. chunks: dq takes a 64-key tile in two 32-key halves: S and dP for
//      the half (m64n32, 16 registers each), the exponentials, then the
//      half's two k steps of dq += dS K (m64n64, dS from registers), which
//      run while the next half's S and dP are issued. A dk/dv warp streams
//      each 64-query tile in chunks of 16 queries: the chunk's two score
//      products, its exponentials, then its k step of the second
//      products; ptxas overlaps one chunk's mma.sync with the previous
//      chunk's exponentials. Chunks (halves) that no row can see (causal,
//      ragged edge) are skipped, interior ones take a path without mask
//      predicates (decided per warp: 16 rows);
//   4. tile shapes: dq one warpgroup (4 warps, each owning 16 rows of the
//      wgmma accumulators) on a 64-row tile, <= 128 registers: four
//      blocks an SM. The diagonal tile is computed whole under the mask
//      (a warpgroup's product covers all 64 rows, so a warp cannot skip
//      the keys past its rows as an mma.sync warp could: at T = 512
//      ~8% more products than the mask keeps). dk/dv 4 warps x 16 keys,
//      64 queries a step (three blocks an SM). A dk/dv block of 128 keys
//      (8 warps) halves the re-reads of q and dO but fits one block an
//      SM; it, 32 queries a dk/dv step and 8-warp dq blocks all measured
//      slower (PERF.md);
//   5. tensor cores: dq wgmma (m64nNk16, bf16 operands, f32 accumulation;
//      the only way to Hopper's full tensor-core rate), dk/dv mma.sync
//      m16n8k16. The accumulators of S / dP (S^T / dP^T) hold, per warp,
//      the C fragment layout of mma.sync, so p and ds pass to the A
//      fragments of the next product in registers. p is formed as
//      ex2(s * (scale log2e) - lse log2e), one FMA and one MUFU.EX2; its
//      f32 value differs from exp(s * scale - lse) far below the bf16
//      rounding of p and ds (ROADMAP.md, Queue 3);
//   6. delta inside the dq launch (no eager passes over dO and O): bf16
//      products are exact in f32, so only the summation order differs
//      from XLA's (a row's two 32-column halves in order, then their sum).
// bf16 with D = 64 (bert_base, bert_large, gpt_small) runs those bodies;
// f32 operands, other head dims and empty sequences run the CUDA-core
// bodies (256 threads, 4 x 4 scores each, operands staged as f32), whose
// dq computes delta the same way (16 lanes a row, then a half-warp tree).
//
// Grids: the tensor-core bodies take their unit from `flash_unit`
// (flash_common.cuh) on a 1-D grid: causal, the units are numbered
// heaviest first and the in-order dispatch schedules longest first; not
// causal, in the (tile, head, batch) order of the other grids.
//   - dq: a unit is a (query tile, batch, head); causal, query tile i
//     walks i + 1 key tiles (`grows`). A block stages its q and dO rows,
//     reads its O rows, computes delta, and walks the K/V tiles up to the
//     tile's key end (tiles past valid_len or past the diagonal are
//     skipped), keeping dq (64 x D) in the wgmma accumulators. The
//     CUDA-core body: a (ceil(Tq / BM), H, B) grid;
//   - dk/dv: a unit is a (key tile, batch, head), ceil(Tk / BN) H B
//     blocks; causal, key block j walks ceil(Tq / 64) - j query tiles.
//     A block stages its K and V rows and walks the q tiles that can see
//     them (all of them, or from the diagonal on when causal), keeping
//     dk and dv (BN x D) in registers. A block whose keys all lie past
//     valid_len writes zeros. The CUDA-core body: a (ceil(Tk / BN), H, B)
//     grid.

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
                    const T* __restrict__ out, const float* __restrict__ lse,
                    float* __restrict__ delta,
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
  // delta = rowsum(dO * O) in f32: the 16 lanes of row ty + 16 i each
  // sum columns tx + 16 c, then a half-warp tree; written for the dk/dv
  // launch that follows on the stream
  float lse_r[RM], delta_r[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Tq ? lse[bh * Tq + row] : 0.f;
    float d = 0.f;
    if (row < Tq) {
      const T* grow = dout + (bh * Tq + row) * D;
      const T* orow = out + (bh * Tq + row) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) d += to_float(grow[col]) * to_float(orow[col]);
      }
    }
    delta_r[i] = row_sum16(d);
    if (tx == 0 && row < Tq) delta[bh * Tq + row] = delta_r[i];
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

// ---------------------------------------------------------------------
// Tensor-core bodies (bf16, D = kMmaD)
// ---------------------------------------------------------------------

// Tile shapes (the source note, point 4)
constexpr int kDqWarps = 4;                    // one warpgroup
constexpr int kDqRows = 16 * kDqWarps;         // query rows a dq block
static_assert(kDqWarps == 4, "the dq body is one warpgroup of 4 warps");
constexpr int kDkvWarps = 4;                   // 16 keys each
constexpr int kDkvKeys = 16 * kDkvWarps;       // keys a dk/dv block
constexpr int kDkvQ = 64;                      // queries a dk/dv step

// p and ds^T on one n tile of the S^T / dP^T C fragments of a dk/dv
// body (keys along the rows, queries col0 and col0 + 1 of the tile):
// p = 2^(s scale log2e - lse log2e) under the mask, ds = p (dp scale -
// delta scale); masked entries are selected to 0 (never multiplied), so
// a non-finite value past the bound cannot leak. `full`: no mask inside
// the chunk (the fast path).
// mq = m0 - n0: a query col of the tile sees key kr of the block when
// kr <= col + mq.
__device__ __forceinline__ void ds_t_chunk(float (&s)[4], float (&dp)[4],
                                           bool full, const float (&l2)[2],
                                           const float (&dls)[2], float sl2,
                                           float scale, int col0, int kr0,
                                           int nlive, int nq, int causal,
                                           int mq) {
  if (full) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[e], sl2, -l2[e & 1]));
      s[e] = p;
      dp[e] = p * fmaf(dp[e], scale, -dls[e & 1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + (e & 1), kr = kr0 + 8 * (e >> 1);
      const bool live =
          kr < nlive && col < nq && (!causal || kr <= col + mq);
      const float p = live ? ex2(fmaf(s[e], sl2, -l2[e & 1])) : 0.f;
      s[e] = p;
      dp[e] = live ? p * fmaf(dp[e], scale, -dls[e & 1]) : 0.f;
    }
  }
}

// dq: one warpgroup (kDqWarps = 4 warps) a 64-row query tile, the unit
// from `flash_unit` (heaviest first when causal). q and dO arrive as two
// TMA boxes (O's rows are read into registers meanwhile): delta =
// rowsum(dO * O) is formed from them and written for the dk/dv launch.
// Each 64-key tile of K and V arrives as two more boxes in a
// kStages-deep ring (thread 0 issues after the step's barrier, an
// mbarrier per stage counts the bytes). Key rows of the last tile at or
// past key_end are zeroed in shared memory once it lands (TMA zero-fills
// only past Tk), so no value past the bound reaches a product. A tile is
// taken in two 32-key halves: S = Q K^T and dP = dO V^T by wgmma m64n32
// with A the swizzled q / dO tile and B the K / V stage (K-major: the
// head dim is the reduction axis), p and ds on the accumulator fragments
// (each warp owns 16 rows, as the mma.sync C fragments did: full halves
// take the path without mask predicates), then dq += dS K by wgmma
// m64n64 with A = dS from registers and B the same K stage read MN-major
// (its key rows are the reduction axis: the transpose bit). A half's dq
// product runs while the next half's S and dP are issued. On the
// diagonal tile the whole 64 x 64 tile is computed under the mask.
__global__ void __launch_bounds__(32 * kDqWarps, 16 / kDqWarps)
flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const bf16* __restrict__ out,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        const int* __restrict__ valid_len,
                        bf16* __restrict__ dq, int H, int Tq, int Tk,
                        float scale, int causal) {
  constexpr int BM = kDqRows, NTHR = 32 * kDqWarps, ND = kMmaD / 8;
  constexpr int kTile = kMmaTile * 128;      // one 64-row tile, bytes
  constexpr int kHalf = kMmaTile / 2;        // keys of one S / dP product
  const FlashUnit u = flash_unit((Tq + BM - 1) / BM, causal, true);
  const int q0 = u.tile * BM, bhi = u.bh, b = bhi / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = bhi;
  const int key_end = tile_key_end(valid_len[b], Tk, q0, BM, causal);
  const int nkt = (key_end + kMmaTile - 1) / kMmaTile;
  const int nq = min(BM, Tq - q0);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* do_s = q_s + BM * 128;
  unsigned char* ring = do_s + BM * 128;             // kStages x (K, V)
  float* delta_s = reinterpret_cast<float*>(ring + kStages * 2 * kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + BM);  // 1 + kStages

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue_kv = [&](int kt) {              // thread 0
    uint64_t* bar = bars + 1 + kt % kStages;
    unsigned char* st = ring + (kt % kStages) * 2 * kTile;
    mbar_expect_tx(bar, 2 * kTile);
    tma_load_rows(st, &tm_k, kt * kMmaTile, bhi, bar);
    tma_load_rows(st + kTile, &tm_v, kt * kMmaTile, bhi, bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, 2 * BM * 128);
    tma_load_rows(q_s, &tm_q, q0, bhi, bars);
    tma_load_rows(do_s, &tm_do, q0, bhi, bars);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i)
      if (i < nkt) issue_kv(i);
  }

  // delta: lanes 2r and 2r + 1 of a warp take the two 32-column halves of
  // its row 16 warp + r; O's half row is read while the copies fly
  const int dr = 16 * warp + (lane >> 1), dc = 32 * (lane & 1);
  uint4 ov[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ov[i] = dr < nq ? *reinterpret_cast<const uint4*>(
                          out + (bh * Tq + q0 + dr) * kMmaD + dc + 8 * i)
                    : make_uint4(0, 0, 0, 0);
  mbar_wait(bars, 0);                        // q and dO have landed
  {
    float d = 0.f;           // bf16 products are exact in f32; in order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 gv = *reinterpret_cast<const uint4*>(
          do_s + sw128(dr, (dc >> 3) + i));
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(g2[j]);
        const float2 y = __bfloat1622float2(o2[j]);
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((lane & 1) == 0) {
      delta_s[dr] = d;
      if (dr < nq) delta[bh * Tq + q0 + dr] = d;
    }
    __syncwarp();
  }

  const int row0 = q0 + 16 * warp + g;
  const float sl2 = scale * kLog2e;
  float lse2[2], dls[2];                     // lse log2e, delta scale
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Tq ? lse[bh * Tq + row] * kLog2e : 0.f;
    dls[r] = delta_s[16 * warp + g + 8 * r] * scale;
  }
  const uint64_t q_desc = wgmma_desc(q_s, false);
  const uint64_t do_desc = wgmma_desc(do_s, false);
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const int w0 = q0 + 16 * warp;
  const bool rows_full = w0 + 16 <= Tq;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt > 0) __syncthreads();             // tile kt - 1's stage is free
    if (threadIdx.x == 0 && kt + kStages - 1 < nkt)
      issue_kv(kt + kStages - 1);
    mbar_wait(bars + 1 + kt % kStages, (kt / kStages) & 1);
    unsigned char* k_t = ring + (kt % kStages) * 2 * kTile;
    unsigned char* v_t = k_t + kTile;
    const int nk = key_end - kt * kMmaTile;
    if (nk < kMmaTile) {                     // the last tile: zero its tail
      for (int e = threadIdx.x; e < (kMmaTile - nk) * 8; e += NTHR) {
        const int off = (nk + (e >> 3)) * 128 + ((e & 7) << 4);
        *reinterpret_cast<uint4*>(k_t + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(v_t + off) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async_smem();              // seen by wgmma's reads
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = kt * kMmaTile + kHalf * h;        // the half's keys
      if (c0 >= key_end) break;              // the same in every warp
      const uint64_t k_desc = wgmma_desc(k_t + kHalf * h * 128, false);
      const uint64_t v_desc = wgmma_desc(v_t + kHalf * h * 128, false);
      float s[kHalf / 8][4], dp[kHalf / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMmaD / 16; ++kk)          // 32 bytes a k step
        wgmma_m64n32_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < kMmaD / 16; ++kk)
        wgmma_m64n32_ss(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();                       // (and the last half's dq)
      wgmma_fence_operand(s);
      wgmma_fence_operand(dp);
      // no mask inside the half for this warp: every key live and seen by
      // every row
      const bool full = c0 + kHalf <= key_end && rows_full &&
                        (!causal || c0 + kHalf - 1 <= w0);
      // ds = p (dp - delta) scale = p (dp scale - delta scale)
      if (full) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1])) *
                      fmaf(dp[j][e], scale, -dls[e >> 1]);
      } else {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
            const int row = row0 + 8 * r;
            const bool live = key < key_end && row < Tq &&
                              (!causal || key <= row);
            s[j][e] = live ? ex2(fmaf(s[j][e], sl2, -lse2[r])) *
                                 fmaf(dp[j][e], scale, -dls[r])
                           : 0.f;
          }
      }
      uint32_t a[kHalf / 16][4];
#pragma unroll
      for (int k2 = 0; k2 < kHalf / 16; ++k2)
        pack_a(s[2 * k2], s[2 * k2 + 1], a[k2]);
      wgmma_fence();
      wgmma_fence_operand(acc);
#pragma unroll
      for (int k2 = 0; k2 < kHalf / 16; ++k2)         // 16 key rows a k step
        wgmma_m64n64_rs_t(acc, a[k2],
                          wgmma_desc(k_t + (kHalf * h + 16 * k2) * 128,
                                     true));
      wgmma_commit();
    }
    wgmma_wait<0>();                         // the stage is read
    wgmma_fence_operand(acc);
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

// dk/dv: kDkvKeys keys a block, 16 a warp. K and V arrive as two TMA boxes and
// stay as A fragments in registers; each kDkvQ-query tile of q and dO
// arrives as two more in a kStages-deep ring (lse and delta by 4-byte
// cp.async, one element a thread). Rows past Tq are zero-filled by the
// copy; key rows at or past valid_len are real data, so p and ds are
// selected to 0 there. A warp streams each tile in 16-query chunks:
// S^T = K Q^T and dP^T = V dO^T for the chunk (keys along the C rows), p
// and ds on their C fragments, then the chunk's k step of dv += p^T dO and
// dk += ds^T Q (dO and Q read through ldmatrix.trans).
__global__ void __launch_bounds__(32 * kDkvWarps)
flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ valid_len,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Tq, int Tk, float scale, int causal) {
  constexpr int BN = kDkvKeys, NTHR = 32 * kDkvWarps, ND = kMmaD / 8;
  constexpr int QT = kDkvQ;
  constexpr int kQTile = QT * 128;           // one q (or dO) tile, bytes
  const FlashUnit u = flash_unit((Tk + BN - 1) / BN, causal, false);
  const int n0 = u.tile * BN, bhi = u.bh, b = bhi / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = bhi;
  const int vl = max(0, min(valid_len[b], Tk));
  const int nkeys = min(BN, Tk - n0);
  const int nlive = max(0, min(BN, vl - n0));
  const float* lb = lse + bh * Tq;
  const float* db = delta + bh * Tq;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* v_s = k_s + BN * 128;
  unsigned char* ring = v_s + BN * 128;              // kStages x (q, dO)
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * kQTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + kStages * 2 * QT);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // this warp's keys: rows kr0 = 16 warp + g and kr0 + 8 of the block
  const int kr0 = 16 * warp + g;
  if (nlive > 0) {
    // queries that can see a key of this block: all, or from the diagonal
    const int m_start = causal ? n0 : 0;
    const int nmt = Tq > m_start ? (Tq - m_start + QT - 1) / QT : 0;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(bars + i, 1);
      mbar_fence_init();
    }
    __syncthreads();
    // q tile mt into ring stage mt % kStages: q and dO by TMA (thread 0),
    // lse and delta by cp.async (one commit group a tile, empty past the
    // last)
    auto issue_q = [&](int mt) {
      if (mt < nmt) {
        const int m0 = m_start + mt * QT, n = min(QT, Tq - m0);
        const int st = mt % kStages;
        if (threadIdx.x == 0) {
          uint64_t* bar = bars + 1 + st;
          mbar_expect_tx(bar, 2 * kQTile);
          tma_load_rows(ring + st * 2 * kQTile, &tm_q, m0, bhi, bar);
          tma_load_rows(ring + st * 2 * kQTile + kQTile, &tm_do, m0, bhi,
                        bar);
        }
        for (int i = threadIdx.x; i < 2 * QT; i += NTHR) {
          const int r = i % QT;
          const bool ok = r < n;
          cp_async4(stats + st * 2 * QT + i,
                    (i < QT ? lb : db) + (ok ? m0 + r : 0), ok);
        }
      }
      cp_async_commit();
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, 2 * BN * 128);
      tma_load_rows(k_s, &tm_k, n0, bhi, bars);
      tma_load_rows(v_s, &tm_v, n0, bhi, bars);
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue_q(i);
    mbar_wait(bars, 0);                      // K and V have landed
    uint32_t ka[kMmaD / 16][4], va[kMmaD / 16][4];
    ldsm_a_frags_sw(k_s, 16 * warp, ka);
    ldsm_a_frags_sw(v_s, 16 * warp, va);
    const float sl2 = scale * kLog2e;
    // the warp's keys: [k_first, k_first + 16); all of them live or not
    const int k_first = n0 + 16 * warp;
    const bool keys_full = 16 * warp + 16 <= nlive;

    for (int mt = 0; mt < nmt; ++mt) {
      cp_async_wait<kStages - 2>();           // tile mt's lse and delta
      __syncthreads();                       // ... for every thread; and
      issue_q(mt + kStages - 1);              // tile mt - 1's stage is free
      mbar_wait(bars + 1 + mt % kStages, (mt / kStages) & 1);
      if (16 * warp >= nlive) continue;      // no live key; no barrier follows
      const int m0 = m_start + mt * QT, nq = min(QT, Tq - m0);
      const unsigned char* q_t = ring + (mt % kStages) * 2 * kQTile;
      const unsigned char* do_t = q_t + kQTile;
      const float* lse_s = stats + (mt % kStages) * 2 * QT;
      const float* delta_s = lse_s + QT;
#pragma unroll
      for (int j2 = 0; j2 < QT / 16; ++j2) {
        const int cq = m0 + 16 * j2;                    // the chunk's queries
        if (16 * j2 >= nq || (causal && cq + 15 < k_first)) continue;
        float s[2][4] = {}, dp[2][4] = {};
        mma_rows2_chunk(ka, q_t, s, va, do_t, dp, j2);  // S^T, dP^T
        // no mask inside the chunk: every key live, every query < Tq and
        // at or past every key
        const bool full = keys_full && 16 * j2 + 16 <= nq &&
                          (!causal || cq >= k_first + 15);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col0 = 16 * j2 + 8 * jj + 2 * t;    // query in tile
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + col0);
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + col0);
          const float l2[2] = {ls.x * kLog2e, ls.y * kLog2e};
          const float dls[2] = {dl.x * scale, dl.y * scale};
          ds_t_chunk(s[jj], dp[jj], full, l2, dls, sl2, scale, col0, kr0,
                     nlive, nq, causal, m0 - n0);
        }
        uint32_t ap[4], ad[4];
        pack_a(s, ap);
        pack_a(dp, ad);
        mma_p_step(ap, do_t, j2, dv_acc);
        mma_p_step(ad, q_t, j2, dk_acc);
      }
    }
    cp_async_wait<0>();
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

cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* out,
                         const float* lse, float* delta,
                         const int* valid_len, void* dq, int B, int H, int Tq,
                         int Tk, float scale, int causal,
                         cudaStream_t stream) {
  constexpr int BM = kDqRows;
  CUtensorMap maps[4];
  const int BH = B * H;
  cudaError_t e = rows_map(&maps[0], q, Tq, BH, BM);
  if (e == cudaSuccess) e = rows_map(&maps[1], dout, Tq, BH, BM);
  if (e == cudaSuccess) e = rows_map(&maps[2], k, Tk, BH, kMmaTile);
  if (e == cudaSuccess) e = rows_map(&maps[3], v, Tk, BH, kMmaTile);
  if (e != cudaSuccess) return e;
  const size_t smem = 1024 + kRowBytes * (2 * BM + 2 * kStages * kMmaTile) +
                      sizeof(float) * BM + 8 * (kStages + 1);
  const auto kernel = flash_bwd_dq_tma_kernel;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = flash_grid((Tq + BM - 1) / BM, B, H);
  if (grid == 0) return cudaErrorInvalidValue;
  kernel<<<grid, 32 * kDqWarps, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(out), lse,
      delta, valid_len, static_cast<bf16*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const int* valid_len, void* dk,
                          void* dv, int B, int H, int Tq, int Tk, float scale,
                          int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int BH = B * H;
  cudaError_t e = rows_map(&maps[0], q, Tq, BH, kDkvQ);
  if (e == cudaSuccess) e = rows_map(&maps[1], dout, Tq, BH, kDkvQ);
  if (e == cudaSuccess) e = rows_map(&maps[2], k, Tk, BH, kDkvKeys);
  if (e == cudaSuccess) e = rows_map(&maps[3], v, Tk, BH, kDkvKeys);
  if (e != cudaSuccess) return e;
  const size_t smem =
      1024 + kRowBytes * (2 * kDkvKeys + 2 * kStages * kDkvQ) +
      sizeof(float) * 2 * kStages * kDkvQ + 8 * (kStages + 1);
  const auto kernel = flash_bwd_dkv_tma_kernel;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = flash_grid((Tk + kDkvKeys - 1) / kDkvKeys, B, H);
  if (grid == 0) return cudaErrorInvalidValue;
  kernel<<<grid, 32 * kDkvWarps, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, valid_len,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, scale,
      causal);
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
                      const void* dout, const void* out, const float* lse,
                      float* delta, const int* valid_len, void* dq, int B,
                      int H, int Tq, int Tk, int D, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_smem(BM, D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, BM, NC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  flash_bwd_dq_kernel<T, BM, NC><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(out), lse, delta, valid_len,
      static_cast<T*>(dq), H, Tq, Tk, D, scale, causal);
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

// q / dout / out (B, H, Tq, D), k / v (B, H, Tk, D), one dtype (0 = f32,
// 1 = bf16), contiguous; lse (B, H, Tq) f32; valid_len (B,) int32.
// Writes dq (B, H, Tq, D) and delta = rowsum(dout * out) (B, H, Tq) f32
// in full. Returns a cudaError_t.
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* out,
                               const float* lse, float* delta,
                               const int* valid_len, void* dq, int B, int H,
                               int Tq, int Tk, int D, float scale,
                               int causal, int dtype, void* stream) {
  if (mxt::bad_shape(B, H, Tq, Tk, D, causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxt::use_mma(dtype, D) && Tk > 0)
    return (int)mxt::launch_dq_tc(q, k, v, dout, out, lse, delta, valid_len,
                                  dq, B, H, Tq, Tk, scale, causal, st);
  return (int)mxt::dispatch_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return mxt::dispatch_head_dim(D, [&](auto bm, auto nc) {
      return mxt::launch_dq<T, decltype(bm)::value, decltype(nc)::value>(
          q, k, v, dout, out, lse, delta, valid_len, dq, B, H, Tq, Tk, D,
          scale, causal, st);
    });
  });
}

// q / dout (B, H, Tq, D), k / v (B, H, Tk, D); lse and the dq launch's
// delta (B, H, Tq) f32. Writes dk and dv (B, H, Tk, D) in full (zeros for
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
  if (mxt::use_mma(dtype, D) && Tq > 0)
    return (int)mxt::launch_dkv_tc(q, k, v, dout, lse, delta, valid_len, dk,
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
