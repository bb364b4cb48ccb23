// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): (B, H, T, D) attention with a per-batch key-length prefix
// mask and optional top-left causal masking (key j <= query i, Tq == Tk).
//
// Every kernel is a template on the operand type T (float or bf16) and on
// the tile shape: BM query rows and BN keys per tile, and NC column groups
// of 16 for the head dim (D <= 16 * NC). 256 threads form a 16 x 16 grid
// (ty, tx): a thread owns rows ty + 16 i of a tile and columns tx + 16 j of
// a score tile, or columns tx + 16 c of a (rows, D) accumulator. Operands
// are staged into shared memory as f32 (exact for bf16) with a row stride
// of D + 1 (D is a multiple of 8, so the stride is odd and the 16 rows a
// half-warp reads sit in 16 different banks); every product accumulates in
// f32. Rounding points follow the JAX package's Pallas kernels: the scale
// multiplies the f32 scores, and p (forward, and dv) and ds (dq, dk) are
// rounded to the operand type before their products.
#pragma once

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
// of a fragment load fall in 8 different bank quads); a tile that is
// needed as B with k along its rows is staged transposed.
// ---------------------------------------------------------------------

constexpr int kMmaD = 64;                 // head dim of the tensor-core path
constexpr int kMmaThreads = 128;          // 4 warps x 16 rows = 64 rows
constexpr int kMmaTile = 64;              // rows / keys per tile
constexpr int kMmaLd = kMmaD + 8;         // padded row (bf16 elements)
constexpr int kMmaLdT = kMmaTile + 8;     // padded row of a transposed tile

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

// C[16 x kMmaD] += P[16 x 64] . M[64 x kMmaD], P held as C tiles of a
// 16 x 64 product (rounded to bf16 here), M given transposed: tile_t is
// (kMmaD, kMmaLdT) with M's 64 rows along each row
__device__ __forceinline__ void mma_p_m(const float (&p)[kMmaTile / 8][4],
                                        const bf16* tile_t,
                                        float (&c)[kMmaD / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k2 = 0; k2 < kMmaTile / 16; ++k2) {
    const uint32_t a[4] = {pack_bf16(p[2 * k2][0], p[2 * k2][1]),
                           pack_bf16(p[2 * k2][2], p[2 * k2][3]),
                           pack_bf16(p[2 * k2 + 1][0], p[2 * k2 + 1][1]),
                           pack_bf16(p[2 * k2 + 1][2], p[2 * k2 + 1][3])};
#pragma unroll
    for (int nd = 0; nd < kMmaD / 8; ++nd) {
      const bf16* q = tile_t + (8 * nd + g) * kMmaLdT + 16 * k2 + 2 * t;
      mma_bf16(c[nd], a, ld_pair(q), ld_pair(q + 8));
    }
  }
}

// Stage rows [r0, r0 + n) of a (rows, kMmaD) bf16 matrix into a
// (kMmaTile, kMmaLd) tile, 16 bytes a load; rows past n are zero.
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src,
                                           int r0, int n, bf16* dst) {
  constexpr int kVec = kMmaD / 8;             // 16-byte vectors per row
  for (int e = threadIdx.x; e < kMmaTile * kVec; e += kMmaThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) *
                                                   kMmaD + c);
    *reinterpret_cast<uint4*>(dst + r * kMmaLd + c) = v;
  }
}

// The same rows staged transposed: dst is (kMmaD, kMmaLdT), dst[d][r].
// Consecutive threads take consecutive rows, so a warp's stores fill one
// row of dst.
__device__ __forceinline__ void stage_tile_t(const bf16* __restrict__ src,
                                             int r0, int n, bf16* dst) {
  for (int e = threadIdx.x; e < kMmaTile * (kMmaD / 8); e += kMmaThreads) {
    const int r = e % kMmaTile, c = (e / kMmaTile) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) *
                                                   kMmaD + c);
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * kMmaLdT + r] = h[i];
  }
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

// the tensor-core path takes bf16 operands of head dim kMmaD
inline bool use_mma(int dtype, int D) {
  return dtype == MXT_DTYPE_BF16 && D == kMmaD;
}

}  // namespace mxt

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
