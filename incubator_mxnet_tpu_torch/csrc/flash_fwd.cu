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
// What bounds it on an H100: bytes and operations are close. One (query
// tile, head) does 4 * BM * keys * D flops on (BM + 2 keys) * D operands;
// at bert_base's bench shape (B = 32, H = 12, T = 512, D = 64, ~386 live
// keys a batch row) that is ~39 GFLOP (0.020 ms at 989 TFLOP/s) against
// ~89 MB of q, out, live K/V and lse (0.027 ms at 3.35 TB/s). On the card
// the tensor-core body is bound by latency: a block's steps form one
// chain (tile copy -> scores -> exponentials -> P V), so the design keeps
// copies off the chain, shortens it, and keeps as many blocks resident as
// the registers allow.
//
// Design: grid (ceil(Tq / 64), H, B). A block holds its query rows for the
// whole walk and goes over the K/V tiles in order, stopping at the tile's
// key end (past valid_len, or past the diagonal when causal: dead tiles
// are never loaded), with the online softmax (m, l) per row. Two bodies:
//   - bf16 with D = 64 (BERT, GPT-2): the design of the backward's dq body
//     (flash_bwd.cu), with one product fewer a step:
//     1. TMA copies: one thread asks for each tile (q, then K and V in a
//        two-stage ring, tile kt + 1 in flight while tile kt's products
//        run), an mbarrier per stage counts its bytes; one block barrier a
//        step;
//     2. no transposed copy: K and V are staged once, row-major, in the
//        128-byte swizzle; K's B fragments come from ldmatrix.x4, V's (for
//        P V, keys along the stored rows) from ldmatrix.x4.trans, Q's A
//        fragments once from ldmatrix.x4;
//     3. a whole 64-key S a step: S for the tile (32 mma.sync, 32
//        registers of scores), one row max and one rescale of o a tile,
//        the exponentials, then P V streamed in four 16-key k steps (32
//        mma.sync); interior tiles (every key live and seen by every row
//        of the warp) take a path without mask predicates. Unlike dq, the
//        forward learns the row max only from the scores, so 16-key chunks
//        (dq's shape) cost a rescale of o a chunk: 0.128 ms on an H100
//        against 0.105 for whole tiles (PERF.md);
//     4. p = 2^(s scale log2e - m) with m in the same log2 units (one
//        FMUL, one FADD, one MUFU.EX2), lse = (m + log2 l) ln 2 for a live
//        row; its f32 value differs from exp(s scale - m) far below the
//        bf16 rounding of p (ROADMAP.md, Queue 3). The sentinel -1e30 is
//        never scaled;
//     5. 4 warps x 16 query rows, <= 128 registers (no spills): four
//        blocks an SM.
//     TMA zero-fills only past Tk, so the rows of the last tile at or past
//     key_end are zeroed in shared memory: V past valid_len is SELECTED
//     out of P V (a NaN there cannot reach the output; the Pallas kernel
//     forms p @ v on those keys, ROADMAP.md Queue 3);
//   - every other case (f32, other head dims up to 256, Tk = 0): the f32
//     CUDA cores, 256 threads, each 4 x 4 scores from shared memory (f32
//     staging, padded rows) and 4 rows x D / 16 acc columns; p rounded to
//     the operand type through shared memory. Its limit is the
//     shared-memory traffic of the scalar products.

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

// Tile shape of the tensor-core body (the source note, points 3 and 5)
constexpr int kFwdWarps = 4;                    // 16 query rows each
constexpr int kFwdRows = 16 * kFwdWarps;        // query rows a block

// The tensor-core forward (bf16, D = kMmaD): kFwdRows query rows a block,
// 16 a warp. The query tile arrives as one TMA box and stays in registers
// as A fragments; each 64-key tile of K and V arrives as two more boxes in
// a kStages-deep ring (thread 0 issues tile kt + 1 after step kt's
// barrier; an mbarrier per stage counts the bytes). Key rows of the last
// tile at or past key_end are zeroed in shared memory once it lands (TMA
// zero-fills only past Tk), so no value past the bound reaches P V. A warp
// takes each 64-key tile whole: S for the tile, the online softmax on its C
// fragments in the log2 domain (one rescale of o a tile), then P V in four
// 16-key k steps (V read through ldmatrix.trans).
__global__ void __launch_bounds__(32 * kFwdWarps, 16 / kFwdWarps)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int* __restrict__ valid_len, bf16* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     float scale, int causal) {
  constexpr int BM = kFwdRows, NTHR = 32 * kFwdWarps, ND = kMmaD / 8;
  constexpr int NJ = kMmaTile / 8;           // n tiles (8 keys) of S
  constexpr int kTile = kMmaTile * 128;      // one 64-row tile, bytes
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhi = b * H + h;
  const int64_t bh = bhi;
  const int key_end = tile_key_end(valid_len[b], Tk, q0, BM, causal);
  const int nkt = (key_end + kMmaTile - 1) / kMmaTile;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = q_s + BM * 128;              // kStages x (K, V)
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);

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
    mbar_expect_tx(bars, BM * 128);
    tma_load_rows(q_s, &tm_q, q0, bhi, bars);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i)
      if (i < nkt) issue_kv(i);
  }
  mbar_wait(bars, 0);                        // the query tile has landed
  uint32_t qa[kMmaD / 16][4];
  ldsm_a_frags_sw(q_s, 16 * warp, qa);

  // rows g and g + 8 of the warp's 16: running max m (log2 units of the
  // scaled score), this thread's share of the row sum l, and o
  const int w0 = q0 + 16 * warp, row0 = w0 + g;
  const float sl2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

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
      __syncthreads();
    }
    if (w0 >= Tq) continue;
    const int k0 = kt * kMmaTile;            // the tile's first key
    if (causal && k0 > w0 + 15) continue;    // no row of the warp sees it
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NJ / 2; ++j2)
      mma_rows_chunk(qa, [k_t](int r, int ch) {
        return reinterpret_cast<const bf16*>(k_t + sw128(r, ch));
      }, s[2 * j2], s[2 * j2 + 1], j2);
    // no mask inside the tile: every key live and seen by every row
    const bool full = k0 + kMmaTile <= key_end &&
                      (!causal || k0 + kMmaTile - 1 <= w0);
    float mx[2] = {kNegInf, kNegInf};
    if (full) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= sl2;
          mx[e >> 1] = nan_max(mx[e >> 1], s[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          const bool live = key < key_end && (!causal || key <= row);
          s[j][e] = live ? s[j][e] * sl2 : kNegInf;
          mx[e >> 1] = nan_max(mx[e >> 1], s[j][e]);
        }
    }
    // p = 2^(s scale log2e - m); o and l rescaled by 2^(m_old - m_new).
    // The sentinel -1e30 is never scaled: a row that has seen no live key
    // keeps m = -1e30 exactly.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = nan_max(m[r], quad_max(mx[r]));
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];
#pragma unroll
    for (int k2 = 0; k2 < NJ / 2; ++k2) {
      uint32_t a[4];
      pack_a(s[2 * k2], s[2 * k2 + 1], a);
      mma_p_step(a, v_t, k2, o);
    }
  }

  // lse = (m + log2 l) ln 2 in natural-log units for a live row; a row
  // whose max never left -1e30 (or is NaN) writes 0 and lse = -1e30
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row >= Tq) continue;
    const bool row_ok = m[r] > kNegInf / 2;
    const float l_safe = nan_max(lr, 1e-30f);
    bf16* orow = out + (bh * Tq + row) * kMmaD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float x0 = row_ok ? o[nd][2 * r] / l_safe : 0.f;
      const float x1 = row_ok ? o[nd][2 * r + 1] / l_safe : 0.f;
      *reinterpret_cast<uint32_t*>(orow + 8 * nd + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0)
      lse[bh * Tq + row] = row_ok ? (m[r] + log2f(l_safe)) * kLn2 : kNegInf;
  }
}

cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          const int* valid_len, void* out, float* lse, int B,
                          int H, int Tq, int Tk, float scale, int causal,
                          cudaStream_t stream) {
  constexpr int BM = kFwdRows;
  CUtensorMap maps[3];
  const int BH = B * H;
  cudaError_t e = rows_map(&maps[0], q, Tq, BH, BM);
  if (e == cudaSuccess) e = rows_map(&maps[1], k, Tk, BH, kMmaTile);
  if (e == cudaSuccess) e = rows_map(&maps[2], v, Tk, BH, kMmaTile);
  if (e != cudaSuccess) return e;
  const size_t smem = 1024 + kRowBytes * (BM + 2 * kStages * kMmaTile) +
                      8 * (kStages + 1);
  const auto kernel = flash_fwd_tma_kernel;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  kernel<<<grid, 32 * kFwdWarps, smem, stream>>>(
      maps[0], maps[1], maps[2], valid_len, static_cast<bf16*>(out), lse, H,
      Tq, Tk, scale, causal);
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
  if (mxt::use_mma(dtype, D) && Tk > 0)
    return (int)mxt::launch_fwd_tc(q, k, v, valid_len, out, lse, B, H, Tq,
                                   Tk, scale, causal, st);
  return (int)mxt::dispatch_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return mxt::dispatch_head_dim(D, [&](auto bm, auto nc) {
      return mxt::launch_fwd<T, decltype(bm)::value, decltype(nc)::value>(
          q, k, v, valid_len, out, lse, B, H, Tq, Tk, D, scale, causal, st);
    });
  });
}
