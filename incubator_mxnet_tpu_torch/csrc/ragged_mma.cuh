// The tensor-core body of the ragged prefill, verify and decode kernels
// (ragged_prefill.cu, ragged_verify.cu, ragged_decode.cu): bf16 queries,
// head dim 64, raw bf16 pools or int8 / fp8 code pools with per-page
// scales.
//
// All compute one thing: C query rows of ONE slot at positions start + i
// (i < C) attend the slot's paged keys through the predicate pos_k <=
// start + i, every key at or past key_end is selected out (never read),
// and rows >= n_real are written as zeros. Every block reads its bounds on
// the device, so a launch's arguments are fixed by shapes alone (what a
// CUDA graph replays). A prefill chunk's come from its span [start,
// n_real] (chunk_span; key_end = min(start + n_real, capacity)). A verify
// window is the same chunk for every slot at once: row r of slot s sits
// at position L - 1 + r (L = lengths[s]), its consumed rows are 0..dl (dl
// = draft_len[s]) and its keys end at min(L + dl, capacity)
// (verify_span).
// A decode step is a verify window of C = W = 1 with no draft (draft_len
// null: dl = 0): its row sits at L - 1, sees keys [0, L) and V is selected
// out from L.
//
// Design (it bounds on latency, not bytes: see ragged_prefill.cu's note):
//   - one read of each live K/V byte: a block owns one (key split, head)
//     and every query row of its group, a group being 1 or 2 tiles of 64
//     rows (a warp owns 16 rows of each; the second tile's state is held
//     in registers beside the first). A verify block owns one (key split,
//     head, slot) and the slot's W <= 64 rows in one tile. With W <= 16
//     (spec_k <= 15) the rows fill one m16 tile, so the four warps split
//     each 64-key tile instead, 16 keys each, and merge their (o, m, l)
//     in shared memory after the walk: a tile's chain is a quarter as
//     long (KW below; a decode block is one row, W = 1). A warp skips
//     every tile (or key chunk) that none of its rows sees; a block no
//     live row of its group sees walks nothing;
//   - staging: Q once (with KW only the one m16 tile the warps read, rows
//     past C zero-filled: a decode block copies one live row); the
//     split's page ids (and page scales) go to shared memory first; then
//     each 64-key tile of K and V is copied with 16-byte cp.async per
//     thread (a page's head slice is contiguous), double-buffered: tile
//     kt + 1 is in flight while tile kt is used.
//     Keys past the block's bound (>= key_end) are zero-filled by the copy
//     itself (src-size 0): V is SELECTED out, never 0 * NaN;
//   - products: S = Q K^T and P V on mma.sync.m16n8k16 (bf16 operands,
//     f32 accumulation; flash_common.cuh), Q's fragments held in registers
//     for the whole walk, V read as the B operand through ldmatrix.trans,
//     p passed from S's C fragments to P V's A fragments in registers.
//     Rounding points of the Pallas kernels for a raw pool: bf16 q . k
//     with f32 accumulation, the scale on the f32 score, p.astype(bf16)
//     before P V;
//   - code pools on the same body: every int8 code (|c| <= 127) and every
//     e4m3 value is exact in bf16, so codes are converted to bf16 in
//     shared memory after they land and the scales stay out of the
//     products. K: each key's f32 score is multiplied by its page's k
//     scale, q . (k sk) up to summation order. V: the Pallas kernels form
//     P V in f32 on dequantized values (p is not rounded there), so each
//     key's weight is multiplied by its page's v scale in f32, p' = p sv,
//     and split into bf16 hi + lo = p' (two mmas on the same codes): ~16
//     bits of p' survive, against 8 for one bf16 product. A key past the
//     bound gets scale 0 by a select, never a multiply, so a NaN scale on
//     a masked page cannot leak; one on a live page propagates (0 * NaN =
//     NaN in the product, as in the Pallas kernels);
//   - a row that sees no key of the split gets zero weights (its max still
//     -1e30); every max keeps NaN (nan_max);
//   - the merge: the splits of one (head, group) or (head, slot) are one
//     thread-block cluster (at most 16). Each block leaves its rows' (o, m,
//     l) in its shared memory; after the cluster barrier block j merges
//     rows j, j + nsplit, ... reading the partials of the splits each row
//     sees, in split order, through distributed shared memory. No scratch
//     in device memory and no second launch; one split finalizes alone.
//     Every block, also one past its slot's keys or of a dead slot (L =
//     0), joins both cluster barriers: none exits while a peer can still
//     read its shared memory.
// No atomics: the output is bitwise the same from run to run. No TMA or
// wgmma (the tiles are 64 x 64 and gathered page by page: mma.sync and
// cp.async suffice here).
#pragma once

#include <cooperative_groups.h>

#include "flash_common.cuh"   // mma.sync, cp.async and ldmatrix helpers;
                              // includes ragged_common

namespace mxt {

namespace cg = cooperative_groups;

// keys [0, end) cover every live row of rows [i0, i0 + n); 0 = no live
// row. key_end = min(start + n_real, the page row's capacity).
__device__ __forceinline__ int rows_key_end(int i0, int n, int start,
                                            int n_real, int key_end) {
  const int live = min(i0 + n, n_real) - i0;
  return live > 0 ? min(start + i0 + live, key_end) : 0;
}

constexpr int kKeyTile = kMmaTile;           // keys per staged tile
constexpr int kMaxClusterSplits = 16;        // largest (non-portable) cluster
constexpr int kTileElems = kMmaTile * kMmaLd;   // one padded bf16 tile

template <typename P>
__device__ __forceinline__ float code_value(uint8_t b);
template <>
__device__ __forceinline__ float code_value<int8_t>(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}
template <>
__device__ __forceinline__ float code_value<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 x;
  x.__x = b;
  return static_cast<float>(x);
}

// Shared-memory layout of the tensor-core body, in bytes: Q tiles (64
// rows each; with KW one tile of the 16 rows every warp reads), the K/V
// ring (raw: two stages of bf16 tiles; codes: two stages of code tiles
// plus one bf16 tile each for K and V, and the current tile's per-key
// scales), then the split's page ids (and page scales). After the walk
// the ring holds the block's per-row (o, m, l) for the merge across its
// cluster.
template <typename P, int QT, bool KW = false>
struct MmaSmem {
  static constexpr bool kQuant = kQuantized<P>;
  static constexpr int kQRows = KW ? 16 : kMmaTile;  // staged rows a tile
  static constexpr size_t kQ = sizeof(bf16) * QT * kQRows * kMmaLd;
  static constexpr size_t kBf = sizeof(bf16) * kTileElems;     // one tile
  static constexpr size_t kCode = (size_t)kKeyTile * kMmaD;    // one tile
  static constexpr size_t kRing = kQuant ? 2 * 2 * kCode + 2 * kBf
                                         : 2 * 2 * kBf;
  static constexpr size_t kKeyScales = kQuant ? 2 * kKeyTile * 4 : 0;
  static constexpr size_t kFixed = kQ + kRing + kKeyScales;
  static constexpr int kXLd = kMmaD + 2;        // a partial's o row (floats)
  static_assert(sizeof(float) * QT * kMmaTile * (kXLd + 2) <= kRing,
                "the partials must fit in the ring");
  static size_t bytes(int npg) {
    return kFixed + (size_t)npg * 4 * (kQuant ? 3 : 1);
  }
};

// The body of a block of grid (split, head, z); the splits of one (head,
// z) form one thread-block cluster. Prefill (kVerify false): z is the
// query group, C the chunk's rows, `bounds` its span [start, n_real]
// (chunk_span), page_table its page row. Verify: z is the slot, C = W its
// rows, page_table (S, maxp), and the chunk of slot z comes from `bounds`
// = lengths (S,) and draft_len (verify_span). Warp w owns rows 16 w of each 64-row query
// tile of the group; with KW (verify, W <= 16) every warp owns rows 0-15
// instead and keys 16 w .. 16 w + 15 of each tile, and the four warps'
// states merge in shared memory after the walk. Each kernel file wraps it
// in its own __global__ (prefill_mma_kernel, verify_mma_kernel), so
// profiles name them apart.
template <typename P, int QT, bool kVerify, bool KW>
__device__ __forceinline__ void ragged_mma_body(
    const bf16* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ bounds, const int* __restrict__ draft_len,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    bf16* __restrict__ out, int C, int H, int ps, int maxp, int split_keys,
    int nsplit, float scale) {
  using L = MmaSmem<P, QT, KW>;
  constexpr bool kQuant = L::kQuant;
  static_assert(!KW || QT == 1, "key-split warps share one 16-row tile");
  constexpr int ND = kMmaD / 8;
  constexpr int WR = KW ? 0 : 16;            // a warp's first row: WR warp
  constexpr int NT = KW ? 2 : kKeyTile / 8;  // its n tiles (8 keys) a tile
  constexpr int kChunks = kMmaD * (int)sizeof(P) / 16;  // 16 B per row
  const int j = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = j * split_keys;
  int grp = blockIdx.z;
  const int* page_row = page_table;
  int start, n_real, key_end;
  if constexpr (kVerify) {                   // z is the slot
    const int s = blockIdx.z;
    const VerifySpan sp = verify_span(bounds, draft_len, s, C, maxp * ps);
    start = sp.L - 1;
    n_real = sp.L > 0 ? sp.dl + 1 : 0;
    key_end = sp.key_end;
    page_row = page_table + (int64_t)s * maxp;
    q += (int64_t)s * C * H * kMmaD;
    out += (int64_t)s * C * H * kMmaD;
    grp = 0;
  } else {                                   // z is the query group
    const ChunkSpan sp = chunk_span(bounds, C, maxp * ps);
    start = sp.start;
    n_real = sp.n_real;
    key_end = sp.key_end;
  }
  const int q0 = grp * QT * kMmaTile;        // first query row of the group

  // the keys each query tile of the group, and each warp's 16 rows of it,
  // can see; the block's bound. A block that no live row of the group sees
  // walks nothing (it still joins its cluster's barriers).
  int tile_end[QT], warp_end[QT];
  int kend = 0;
#pragma unroll
  for (int u = 0; u < QT; ++u) {
    tile_end[u] = rows_key_end(q0 + u * kMmaTile, kMmaTile, start, n_real,
                               key_end);
    warp_end[u] = rows_key_end(q0 + u * kMmaTile + WR * warp, 16, start,
                               n_real, key_end);
    kend = max(kend, tile_end[u]);
  }
  kend = min(kend, k0 + split_keys);
  const int nkt = kend > k0 ? (kend - k0 + kKeyTile - 1) / kKeyTile : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ;
  float* key_sc = reinterpret_cast<float*>(ring + L::kRing);  // codes
  int* pages_s = reinterpret_cast<int*>(ring + L::kRing + L::kKeyScales);

  // Q rows of every tile of the group (rows >= C zero-filled; with KW
  // the 16 rows of one m16 tile, a copy a thread)
  if (nkt > 0) {
#pragma unroll
    for (int u = 0; u < QT; ++u)
      for (int e = tid; e < L::kQRows * 8; e += kMmaThreads) {
        const int r = e >> 3, c = (e & 7) * 8;
        const int row = q0 + u * kMmaTile + r;
        const bool ok = row < C;
        cp_async16(q_s + (u * L::kQRows + r) * kMmaLd + c,
                   ok ? q + ((int64_t)row * H + h) * kMmaD + c : q, ok);
      }
  }
  cp_async_commit();

  // the split's page ids (and page scales), first page p0
  const int p0 = k0 / ps;
  const int npg = nkt > 0 ? (kend - 1) / ps - p0 + 1 : 0;
  float* pks_s = reinterpret_cast<float*>(pages_s + npg);
  float* pvs_s = pks_s + npg;
  for (int i = tid; i < npg; i += kMmaThreads) {
    const int pg = page_row[p0 + i];
    pages_s[i] = pg;
    if constexpr (kQuant) {
      pks_s[i] = k_scale[pg];
      pvs_s[i] = v_scale[pg];
    }
  }
  __syncthreads();

  // one 64-key tile of K and V into ring stage `st`; keys >= kend
  // zero-filled
  auto issue_tile = [&](int kt, int st) {
    const int tk0 = k0 + kt * kKeyTile;
    for (int e = tid; e < kKeyTile * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const int pos = tk0 + r;
      const bool ok = pos < kend;
      int64_t off = 0;
      if (ok) {
        const int pg = pages_s[pos / ps - p0];
        off = (((int64_t)pg * H + h) * ps + pos % ps) * kMmaD +
              c * (16 / (int)sizeof(P));
      }
      unsigned char* kd;
      unsigned char* vd;
      if constexpr (kQuant) {
        kd = ring + (size_t)(2 * st) * L::kCode + r * kMmaD + c * 16;
        vd = kd + L::kCode;
      } else {
        kd = ring + (size_t)(2 * st) * L::kBf +
             (r * kMmaLd + c * 8) * sizeof(bf16);
        vd = kd + L::kBf;
      }
      cp_async16(kd, k_pool + off, ok);
      cp_async16(vd, v_pool + off, ok);
    }
  };

  if (nkt > 0) issue_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();                        // Q has landed
  __syncthreads();

  uint32_t qa[QT][kMmaD / 16][4];
  if (nkt > 0) {
#pragma unroll
    for (int u = 0; u < QT; ++u)
      load_a_frags(q_s + u * L::kQRows * kMmaLd, WR * warp, qa[u]);
  }
  float m[QT][2], l[QT][2], o[QT][ND][4];
#pragma unroll
  for (int u = 0; u < QT; ++u) {
    m[u][0] = m[u][1] = kNegInf;
    l[u][0] = l[u][1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      o[u][nd][0] = o[u][nd][1] = o[u][nd][2] = o[u][nd][3] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      issue_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tk0 = k0 + kt * kKeyTile;
    const bf16* k_t;
    const bf16* v_t;
    if constexpr (kQuant) {
      // codes -> bf16 (exact), and this tile's per-key scales (0 past
      // the bound: a select, so a NaN scale there is never read)
      const unsigned char* kc = ring + (size_t)(2 * (kt & 1)) * L::kCode;
      bf16* kb = reinterpret_cast<bf16*>(ring + 4 * L::kCode);
      bf16* vb = kb + kTileElems;
      for (int e = tid; e < 2 * kKeyTile * (kMmaD / 16);
           e += kMmaThreads) {
        const int which = e / (kKeyTile * (kMmaD / 16));
        const int e2 = e % (kKeyTile * (kMmaD / 16));
        const int r = e2 / (kMmaD / 16), c = (e2 % (kMmaD / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kc + which * L::kCode + r * kMmaD + c);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = pack_bf16(code_value<P>(b[2 * i]),
                           code_value<P>(b[2 * i + 1]));
        bf16* dst = (which ? vb : kb) + r * kMmaLd + c;
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      if (tid < kKeyTile) {
        const int pos = tk0 + tid;
        const bool ok = pos < kend;
        const int slot = ok ? pos / ps - p0 : 0;
        key_sc[tid] = ok ? pks_s[slot] : 0.f;
        key_sc[kKeyTile + tid] = ok ? pvs_s[slot] : 0.f;
      }
      __syncthreads();
      k_t = kb;
      v_t = vb;
    } else {
      k_t = reinterpret_cast<const bf16*>(ring +
                                          (size_t)(2 * (kt & 1)) * L::kBf);
      v_t = k_t + kTileElems;
    }

    const int kw0 = KW ? 16 * warp : 0;      // the warp's first key of it
#pragma unroll
    for (int u = 0; u < QT; ++u) {
      if (tk0 + kw0 >= warp_end[u]) continue;   // none of the warp's rows
      float s[NT][4];                           // sees any of its keys
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
      if constexpr (KW)
        mma_rows_chunk(qa[u], [k_t](int r, int ch) {
          return k_t + r * kMmaLd + 8 * ch;
        }, s[0], s[1], warp);
      else
        mma_rows_t(qa[u], k_t, s);

      const int row0 = q0 + u * kMmaTile + WR * warp + g;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kw0 + 8 * jj + 2 * t + (e & 1), pos = tk0 + col;
          const int row = row0 + 8 * (e >> 1);
          float x = s[jj][e];
          if constexpr (kQuant) x *= key_sc[col];
          x *= scale;
          const bool live = pos < kend && pos <= start + row;
          s[jj][e] = live ? x : kNegInf;
          mx[e >> 1] = nan_max(mx[e >> 1], s[jj][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
      bool dead[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = nan_max(m[u][r], quad_max(mx[r]));
        alpha[r] = __expf(m[u][r] - m_new);
        dead[r] = m_new <= kNegInf / 2;       // NaN is not dead
        m[u][r] = m_new;
      }
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[jj][e] = dead[r] ? 0.f : __expf(s[jj][e] - m[u][r]);
          psum[r] += s[jj][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[u][r] = l[u][r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[u][nd][e] *= alpha[e >> 1];

      // P V: A from the score fragments, B = V (keys, d) by ldmatrix.trans
      const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
      const int lcol = 8 * (lane >> 4);
#pragma unroll
      for (int k2 = 0; k2 < NT / 2; ++k2) {
        const int kk = kw0 / 16 + k2;           // the k step in the tile
        uint32_t a[4], lo[4];
        if constexpr (kQuant) {
          // p' = p * sv in f32, then bf16 hi + lo
          const float* vsc = key_sc + kKeyTile + 16 * kk + 2 * t;
          const float x[8] = {
              s[2 * k2][0] * vsc[0],     s[2 * k2][1] * vsc[1],
              s[2 * k2][2] * vsc[0],     s[2 * k2][3] * vsc[1],
              s[2 * k2 + 1][0] * vsc[8], s[2 * k2 + 1][1] * vsc[9],
              s[2 * k2 + 1][2] * vsc[8], s[2 * k2 + 1][3] * vsc[9]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 hb =
                __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
            const float2 hf = __bfloat1622float2(hb);
            a[i] = *reinterpret_cast<const uint32_t*>(&hb);
            lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
          }
        } else {
          a[0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
          a[1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
          a[2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
          a[3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_t(b, v_t + (16 * kk + lrow) * kMmaLd + 16 * n2 + lcol);
          mma_bf16(o[u][2 * n2], a, b[0], b[1]);
          mma_bf16(o[u][2 * n2 + 1], a, b[2], b[3]);
          if constexpr (kQuant) {
            mma_bf16(o[u][2 * n2], lo, b[0], b[1]);
            mma_bf16(o[u][2 * n2 + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                         // this stage may be refilled
  }
  if (nkt == 0) cp_async_wait<0>();

  if (nsplit == 1 && !KW) {                  // the only split: finalize
#pragma unroll
    for (int u = 0; u < QT; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + u * kMmaTile + 16 * warp + g + 8 * r;
        if (row >= C) continue;
        const float ls = nan_max(l[u][r], 1e-30f);
        const bool row_ok = row < n_real && !(m[u][r] <= kNegInf / 2);
        bf16* orow = out + ((int64_t)row * H + h) * kMmaD;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const float x0 = row_ok ? o[u][nd][2 * r] / ls : 0.f;
          const float x1 = row_ok ? o[u][nd][2 * r + 1] / ls : 0.f;
          *reinterpret_cast<uint32_t*>(orow + 8 * nd + 2 * t) =
              pack_bf16(x0, x1);
        }
      }
    return;
  }

  // The cluster's merge. Each block leaves its rows' (o, m, l) in its
  // own shared memory (the ring: free after the walk's last barrier);
  // after the cluster barrier, block j merges rows j, j + nsplit, ...
  // reading every split's partial of the row in split order through
  // distributed shared memory, as the merge kernel does from the scratch.
  // With KW each warp first leaves its state of rows 0-15 at rows 16 w,
  // and the block merges the four into rows 0-15 (a cluster of one split
  // then finalizes through the same path).
  float* xo = reinterpret_cast<float*>(ring);
  float* xm = xo + QT * kMmaTile * L::kXLd;
  float* xl = xm + QT * kMmaTile;
#pragma unroll
  for (int u = 0; u < QT; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = u * kMmaTile + 16 * warp + g + 8 * r;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<float2*>(xo + rr * L::kXLd + 8 * nd + 2 * t) =
            make_float2(o[u][nd][2 * r], o[u][nd][2 * r + 1]);
      if (t == 0) {
        xm[rr] = m[u][r];
        xl[rr] = l[u][r];
      }
    }
  if constexpr (KW) {
    __syncthreads();
    const int r = tid >> 3, c0 = (tid & 7) * 8;   // 16 rows x 8 threads
    const bool live = r < C;                      // rows >= C: never read
    float mw[kWarps], M = kNegInf;
    float lsum = 0.f, acc[8] = {};
    if (live) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mw[w] = xm[16 * w + r];
        M = nan_max(M, mw[w]);
      }
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(mw[w] - M);
        lsum += xl[16 * w + r] * e;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] += xo[(16 * w + r) * L::kXLd + c0 + i] * e;
      }
    }
    __syncthreads();                         // every warp's state is read
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) xo[r * L::kXLd + c0 + i] = acc[i];
      if ((tid & 7) == 0) {
        xm[r] = M;
        xl[r] = lsum;
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int rr = j + nsplit * warp; rr < (KW ? 16 : QT * kMmaTile);
       rr += nsplit * kWarps) {
    const int row = q0 + rr;
    if (row >= C) break;
    bf16* orow = out + ((int64_t)row * H + h) * kMmaD;
    int n = 0;                               // the splits the row sees
    if (row < n_real) {
      const int vis = min(start + row + 1, key_end);
      n = min(nsplit, (vis + split_keys - 1) / split_keys);
    }
    float mj = kNegInf, lj = 0.f;            // lane s: split s's m, l
    if (lane < n) {
      mj = cluster.map_shared_rank(xm, lane)[rr];
      lj = cluster.map_shared_rank(xl, lane)[rr];
    }
    float2 y[kMaxClusterSplits];             // every load before any use
#pragma unroll
    for (int s2 = 0; s2 < kMaxClusterSplits; ++s2) {
      const float* src = cluster.map_shared_rank(xo, s2 < n ? s2 : 0);
      y[s2] = s2 < n ? *reinterpret_cast<const float2*>(
                           src + rr * L::kXLd + 2 * lane)
                     : make_float2(0.f, 0.f);
    }
    const float M = warp_max(mj);
    const float w = lane < n ? expf(mj - M) : 0.f;
    const float lsum = warp_sum(lj * w);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kMaxClusterSplits; ++s2) {
      const float ws = __shfl_sync(0xffffffffu, w, s2);
      a0 += ws * y[s2].x;
      a1 += ws * y[s2].y;
    }
    *reinterpret_cast<uint32_t*>(orow + 2 * lane) =
        pack_bf16(finalize(a0, M, lsum), finalize(a1, M, lsum));
  }
  cluster.sync();                            // readers done with our smem
}

// A kernel of the tensor-core body (the signature of ragged_mma_body)
template <typename P>
using RaggedMmaKernel = void (*)(const bf16*, const P*, const P*, const int*,
                                 const int*, const int*, const float*,
                                 const float*, bf16*, int, int, int, int, int,
                                 int, float);

// Launch grid (nsplit, H, z) with the nsplit splits of each (head, z) as
// one cluster, and MmaSmem<P, QT, KW>'s shared memory. Prefill: z = query
// groups, bounds = the span, draft_len = nullptr; verify: z = S slots,
// QT = 1, C = W, bounds = lengths; decode: verify with C = 1, KW and
// draft_len = nullptr.
template <typename P, int QT, bool KW = false>
cudaError_t launch_ragged_mma(RaggedMmaKernel<P> kernel, const void* q,
                              const void* k, const void* v,
                              const int* page_table, const int* bounds,
                              const int* draft_len, const float* ks,
                              const float* vs, void* out, int C, int H,
                              int ps, int maxp, int split_keys, int nsplit,
                              int z, float scale, cudaStream_t stream) {
  const size_t smem = MmaSmem<P, QT, KW>::bytes(split_keys / ps + 2);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (nsplit > 8) {                          // clusters of 9-16 blocks
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, H, z);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;         // one cluster: a head's splits
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                            static_cast<const P*>(k),
                            static_cast<const P*>(v), page_table, bounds,
                            draft_len, ks, vs, static_cast<bf16*>(out), C,
                            H, ps, maxp, split_keys, nsplit, scale);
}

}  // namespace mxt
