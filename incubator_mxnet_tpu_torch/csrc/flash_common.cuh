// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) and the tensor-core bodies of the ragged kernels
// (ragged_mma.cuh): (B, H, T, D) attention with a per-batch key-length
// prefix mask and optional top-left causal masking (key j <= query i,
// Tq == Tk).
//
// The CUDA-core bodies are templates on the operand type T (float or bf16)
// and on the tile shape: BM query rows and BN keys per tile, and NC column
// groups of 16 for the head dim (D <= 16 * NC). 256 threads form a 16 x 16
// grid (ty, tx): a thread owns rows ty + 16 i of a tile and columns tx +
// 16 j of a score tile, or columns tx + 16 c of a (rows, D) accumulator.
// Operands are staged into shared memory as f32 (exact for bf16) with a row
// stride of D + 1 (D is a multiple of 8, so the stride is odd and the 16
// rows a half-warp reads sit in 16 different banks); every product
// accumulates in f32. Rounding points follow the JAX package's Pallas
// kernels: the scale multiplies the f32 scores, and p (forward, and dv) and
// ds (dq, dk) are rounded to the operand type before their products.
//
// The tensor-core bodies (bf16, D = 64) use the sections below: mma.sync
// fragments, cp.async and ldmatrix, and the TMA / mbarrier / 128-byte
// swizzle / wgmma / ex2 helpers of the flash bodies with their
// tensor-map encoder.
#pragma once

#include <cuda.h>   // CUtensorMap (the encoder comes through the runtime)

#include "ragged_common.cuh"   // to_float, from_float, nan_max, allow_smem

namespace mxt {

constexpr int kFlashThreads = 256;

// The tile configuration for a head dim: D <= 64 and D <= 128 take 64 x 64
// tiles (64 x 128 acc columns a block), D <= 256 takes 32 x 32 tiles so the
// staged operands stay inside a block's 227 KB of shared memory.
template <typename F>
inline cudaError_t dispatch_head_dim(int D, F&& launch) {
  if (D <= 64) return launch(std::integral_constant<int, 64>{},
                             std::integral_constant<int, 4>{});
  if (D <= 128) return launch(std::integral_constant<int, 64>{},
                              std::integral_constant<int, 8>{});
  return launch(std::integral_constant<int, 32>{},
                std::integral_constant<int, 16>{});
}

template <typename F>
inline cudaError_t dispatch_dtype(int dtype, F&& launch) {
  if (dtype == MXT_DTYPE_F32) return launch(Tag<float>{});
  if (dtype == MXT_DTYPE_BF16) return launch(Tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// x rounded to T and back (the cast a Pallas kernel makes before a dot)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// reductions over the 16 lanes of a half-warp (one score-tile row)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [r0, r0 + n) of a (T_, D) matrix into dst (rows x ld f32);
// rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0,
                                           int n, int rows, int D, int ld,
                                           float* dst) {
  for (int e = threadIdx.x; e < rows * D; e += kFlashThreads) {
    const int i = e / D, d = e - i * D;
    dst[i * ld + d] = i < n ? to_float(src[(int64_t)(r0 + i) * D + d]) : 0.f;
  }
}

// the keys a query tile [q0, q0 + BM) can see: [0, key_end)
__device__ __forceinline__ int tile_key_end(int vl, int Tk, int q0, int BM,
                                            int causal) {
  int end = max(0, min(vl, Tk));
  if (causal) end = min(end, q0 + BM);
  return end;
}

// The work order of a tensor-core flash launch (forward, dq, dk/dv): a 1-D
// grid of ntiles x BH units, a unit one 64-row tile of one (batch, head)
// row bh = b H + h. The hardware hands out blocks in linear-index order as
// slots free.
//   - Not causal, every tile of a row does the same work: the units go in
//     the order of a (ntiles, H, B) grid, the tiles of one row side by
//     side (they share its K/V, or its q/dO, in L2).
//   - Causal, a unit's work grows with its tile index (a query tile i
//     walks i + 1 key tiles: `grows`) or shrinks with it (key block j
//     walks ntiles - j query tiles): the units are numbered by decreasing
//     work, the heaviest tile of every row first, then the next, so the
//     dispatch order is longest-first scheduling and the last blocks
//     handed out are the shortest. No scratch, no host state.
struct FlashUnit {
  int tile, bh;
};

__device__ __forceinline__ FlashUnit flash_unit(int ntiles, int causal,
                                                bool grows) {
  const int i = blockIdx.x;
  if (!causal) return {i % ntiles, i / ntiles};
  const int BH = gridDim.x / ntiles, rank = i / BH;   // 0: the heaviest
  return {grows ? ntiles - 1 - rank : rank, i - rank * BH};
}

// the 1-D grid of flash_unit, or 0 blocks when it would not fit
inline unsigned flash_grid(int ntiles, int B, int H) {
  const long long n = (long long)ntiles * B * H;
  return n <= 0x7fffffffLL ? (unsigned)n : 0u;
}

// ---------------------------------------------------------------------
// Tensor-core path (bf16 operands, head dim kMmaD): mma.sync m16n8k16
// with f32 accumulation. With g = lane / 4 and t = lane % 4, a thread
// holds (PTX ISA fragment layouts):
//   A (16 x 16, row major): a0 = A[g][2t, 2t+1],    a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9],  a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8, k x n):      b0 = B[2t, 2t+1][g],    b1 = B[2t+8, 2t+9][g];
//   C (16 x 8):             c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// Two adjacent C tiles (n = 16 k2 .. 16 k2 + 15) therefore are exactly the
// A fragment of the next product (k = those 16 columns), so p and ds move
// from one product to the next in registers. Operand tiles sit in shared
// memory as bf16 rows of kMmaD + 8 elements (a 16-byte pad: the 8 rows g
// of a fragment load fall in 8 different bank quads); the flash bodies
// keep their TMA tiles unpadded in the 128-byte swizzle instead. A tile
// that is needed as B with k along its rows is read from the same
// row-major copy through ldmatrix.trans.
// ---------------------------------------------------------------------

constexpr int kMmaD = 64;                 // head dim of the tensor-core path
constexpr int kMmaThreads = 128;          // 4 warps x 16 rows = 64 rows
constexpr int kMmaTile = 64;              // rows / keys per tile
constexpr int kMmaLd = kMmaD + 8;         // padded row (bf16 elements)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of rows [r0, r0 + 16) of a staged (rows, kMmaLd) tile, for
// every k step of 16 along the head dim
__device__ __forceinline__ void load_a_frags(const bf16* tile, int r0,
                                             uint32_t (&a)[kMmaD / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk) {
    const bf16* p = tile + (r0 + g) * kMmaLd + 16 * kk + 2 * t;
    a[kk][0] = ld_pair(p);
    a[kk][1] = ld_pair(p + 8 * kMmaLd);
    a[kk][2] = ld_pair(p + 8);
    a[kk][3] = ld_pair(p + 8 * kMmaLd + 8);
  }
}

// C[16 x 64] += A[16 x kMmaD] . rows(tile)^T: the 64 rows of a staged
// (64, kMmaLd) tile are the columns n, its head dim the k axis
__device__ __forceinline__ void mma_rows_t(const uint32_t (&a)[kMmaD / 16][4],
                                           const bf16* tile,
                                           float (&c)[kMmaTile / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kMmaTile / 8; ++j) {
    const bf16* p = tile + (8 * j + g) * kMmaLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      mma_bf16(c[j], a[kk], ld_pair(p + 16 * kk), ld_pair(p + 16 * kk + 8));
  }
}

// ---------------------------------------------------------------------
// Asynchronous copies and ldmatrix (the prefill kernel and the tensor-core
// backward bodies): 16-byte cp.async straight into shared memory, with a
// zero-fill past a ragged edge, and fragment loads of four 8 x 8 bf16
// matrices an instruction.
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;              // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// one 4-byte element (an f32 row statistic), zero past the edge
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices out of shared memory, as stored: lane l gives
// the address of row l % 8 of matrix l / 8; register i holds matrix i's
// row lane / 4, columns 2 (lane % 4) and + 1 (an A fragment, or the B
// fragment of an operand stored (n, k) row-major).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Four 8x8 bf16 matrices transposed out of shared memory: the B fragments
// of two adjacent n tiles for one k step when the operand is stored
// (k, n) row-major.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// reductions over the 4 lanes of a quad (one C-fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return nan_max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------
// TMA, mbarriers, the 128-byte swizzle and ex2 (the flash bodies: forward,
// dq and dk/dv). Tiles of (BH, T, 64) bf16 tensors arrive whole by TMA,
// kStages-deep rings of them with one mbarrier a stage.
// ---------------------------------------------------------------------

constexpr int kStages = 2;                     // each ring's depth in tiles
constexpr int kRowBytes = kMmaD * 2;           // a staged bf16 row

// TMA: one thread asks for a whole tile; the copy engine writes it into
// shared memory in the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), zero-fills rows past the tensor's end, and counts its
// bytes on an mbarrier that the consumers wait on.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the issuing thread's arrival, with the bytes the copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// box {64, rows, 1} of a (BH, T, 64) bf16 tensor at (0, y, z)
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(0), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// A fragments of rows [r0, r0 + 16) of a swizzled tile, every k step of
// 16 along the head dim: one ldmatrix.x4 each
__device__ __forceinline__ void ldsm_a_frags_sw(
    const unsigned char* tile, int r0, uint32_t (&a)[kMmaD / 16][4]) {
  const int lane = threadIdx.x & 31, r = r0 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk)
    ldsm_x4(a[kk], reinterpret_cast<const bf16*>(
                       tile + sw128(r, 2 * kk + (lane >> 4))));
}

// C1 += A1 . rows(t1)^T and C2 += A2 . rows(t2)^T (S = Q K^T with dP =
// dO V^T, or S^T = K Q^T with dP^T = V dO^T) for 16 columns: rows
// [16 j2, 16 j2 + 16) of each swizzled tile are the columns (two n tiles),
// the head dim the k axis. Per k step one ldmatrix.x4 a tile gives both n
// tiles' B fragments; four mma.sync on four accumulators follow.
__device__ __forceinline__ void mma_rows2_chunk(
    const uint32_t (&a1)[kMmaD / 16][4], const unsigned char* t1,
    float (&c1)[2][4], const uint32_t (&a2)[kMmaD / 16][4],
    const unsigned char* t2, float (&c2)[2][4], int j2) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * j2 + (lane & 7) + 8 * (lane >> 4);
  const int cb = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk) {
    uint32_t b1[4], b2[4];
    const int off = sw128(r, 2 * kk + cb);
    ldsm_x4(b1, reinterpret_cast<const bf16*>(t1 + off));
    ldsm_x4(b2, reinterpret_cast<const bf16*>(t2 + off));
    mma_bf16(c1[0], a1[kk], b1[0], b1[1]);
    mma_bf16(c1[1], a1[kk], b1[2], b1[3]);
    mma_bf16(c2[0], a2[kk], b2[0], b2[1]);
    mma_bf16(c2[1], a2[kk], b2[2], b2[3]);
  }
}

// C += A . rows(tile)^T for 16 columns (S = Q K^T on one 16-key chunk):
// rows [16 j2, 16 j2 + 16) of the tile are the columns (two n tiles), the
// head dim the k axis; `at(r, c)` is the address of 16-byte chunk c of row
// r. One ldmatrix.x4 and two mma.sync a k step.
template <typename At>
__device__ __forceinline__ void mma_rows_chunk(
    const uint32_t (&a)[kMmaD / 16][4], At at, float (&c0)[4],
    float (&c1)[4], int j2) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * j2 + (lane & 7) + 8 * (lane >> 4);
  const int cb = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, at(r, 2 * kk + cb));
    mma_bf16(c0, a[kk], b[0], b[1]);
    mma_bf16(c1, a[kk], b[2], b[3]);
  }
}

// 16 columns of P held as two C tiles, rounded to bf16: the A fragment of
// one k step of the next product
__device__ __forceinline__ void pack_a(const float (&p0)[4],
                                       const float (&p1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(p0[0], p0[1]);
  a[1] = pack_bf16(p0[2], p0[3]);
  a[2] = pack_bf16(p1[0], p1[1]);
  a[3] = pack_bf16(p1[2], p1[3]);
}

__device__ __forceinline__ void pack_a(const float (&p)[2][4],
                                       uint32_t (&a)[4]) {
  pack_a(p[0], p[1], a);
}

// C[16 x kMmaD] += A . tile[16 k2 .. 16 k2 + 16, :], one k step: the
// tile's rows are the k axis, read transposed by ldmatrix.x4.trans (two n
// tiles a load; `at(r, c)` is the address of 16-byte chunk c of row r);
// the four loads come first, then eight independent mma.sync
template <typename At>
__device__ __forceinline__ void mma_p_step_at(const uint32_t (&a)[4], At at,
                                              int k2,
                                              float (&c)[kMmaD / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * k2 + (lane & 7) + 8 * ((lane >> 3) & 1);
  uint32_t b[kMmaD / 16][4];
#pragma unroll
  for (int n2 = 0; n2 < kMmaD / 16; ++n2)
    ldsm_x4_t(b[n2], at(r, 2 * n2 + (lane >> 4)));
#pragma unroll
  for (int n2 = 0; n2 < kMmaD / 16; ++n2) {
    mma_bf16(c[2 * n2], a, b[n2][0], b[n2][1]);
    mma_bf16(c[2 * n2 + 1], a, b[n2][2], b[n2][3]);
  }
}

// the same on a 128-byte-swizzled TMA tile
__device__ __forceinline__ void mma_p_step(const uint32_t (&a)[4],
                                           const unsigned char* tile, int k2,
                                           float (&c)[kMmaD / 8][4]) {
  mma_p_step_at(a, [tile](int r, int ch) {
    return reinterpret_cast<const bf16*>(tile + sw128(r, ch));
  }, k2, c);
}

// ---------------------------------------------------------------------
// wgmma (the dq body): one warpgroup of 4 warps issues an asynchronous
// product of a 64-row tile, B (and A, or A from registers) read from the
// 128-byte-swizzled TMA tiles through shared-memory matrix descriptors.
// The f32 accumulator of m64nN is, per warp w, the C fragments of rows
// [16 w, 16 w + 16) of N / 8 mma.sync n tiles: d[j][e] is row 16 w + g
// (+ 8 for e >= 2), column 8 j + 2 t + (e & 1). A from registers is the
// mma.sync A fragment of the warp's 16 rows. Operands and accumulators
// are fenced (wgmma.fence) after ordinary instructions touched them.
// ---------------------------------------------------------------------

// descriptor of a 1024-byte-aligned (rows, 64) bf16 tile in the 128-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B), from `p` on: 8-row groups
// 1024 bytes apart. K-major (the head dim, along the rows, is the
// reduction axis): the leading offset is unused (1); a k step of 16
// moves the start 32 bytes within the swizzled row. MN-major (the rows
// are the reduction axis, read through the transpose bit): 64 elements
// are one swizzle atom, so only the 8-row stride counts, given as both
// offsets.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, bool mn_major) {
  const uint64_t lead = mn_major ? 1024 >> 4 : 1;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (lead << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties an accumulator's registers to this point of the program, so that
// no ordinary instruction moves across an issue or a wait
template <int J>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared
// memory; `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[4][4], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the mma.sync A
// fragment of each warp's 16 rows), B MN-major in shared memory (its
// rows are the k axis: the transpose bit)
__device__ __forceinline__ void wgmma_m64n64_rs_t(float (&d)[8][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's and TMA's reads) after the next barrier
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (MUFU.EX2): p = exp(s scale - lse) = 2^(s scale log2e - lse log2e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the map of a (BH, T, 64) bf16 tensor read in boxes of `rows` rows,
// 128-byte swizzled, rows past T zero-filled
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int T,
                            int BH, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)kMmaD, (cuuint64_t)T,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)kMmaD * 2,
                                 (cuuint64_t)T * kMmaD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kMmaD, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tensor-core path takes bf16 operands of head dim kMmaD
inline bool use_mma(int dtype, int D) {
  return dtype == MXT_DTYPE_BF16 && D == kMmaD;
}

}  // namespace mxt

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
