// Warp-level bf16 tensor-core product for the joint kernels (sm_80+), and
// the int8 one of the W8A8 LSTM.
//
// mma_16816: D (16 x 8, f32) += A (16 x 16, bf16, row-major) . B (16 x 8,
// bf16, column-major), one `mma.sync.aligned.m16n8k16` per call, fp32
// accumulate: the JAX package's `preferred_element_type=float32` on bf16
// operands, exactly (a product of two bf16 values is exact in f32).
//
// Fragment layout of the PTX ISA for m16n8k16 (g = lane / 4, q = lane % 4;
// each 32-bit register holds two bf16, the lower index in the low half):
//   A  a[0] = (row g,     cols 2q, 2q+1)     a[1] = (row g + 8, cols 2q, 2q+1)
//      a[2] = (row g,     cols 2q+8, 2q+9)   a[3] = (row g + 8, cols 2q+8, 2q+9)
//   B  b[0] = (rows 2q, 2q+1,   col g)       b[1] = (rows 2q+8, 2q+9, col g)
//   D  d[0], d[1] = (row g, cols 2q, 2q+1)   d[2], d[3] = (row g + 8, same)
// So with A stored row-major and B stored column-major (n-major, k
// contiguous) in shared memory, every register is one aligned 32-bit load:
// `frag_a` and `frag_b` below. A row pitch of 4 (mod 32) words puts the 8
// rows g of a fragment on distinct banks.
//
// Below them, the block shape and z's row pitch that the rings
// (wt_ring.cuh, zb_ring.cuh) share.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace joint_mma {

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0..r0+15, cols k0..k0+15 of a row-major bf16 tile
// with `pitch` elements per row (pitch and k0 even).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int pitch,
                                       int r0, int k0, int lane) {
  const int g = lane >> 2;
  const int q = lane & 3;
  const __nv_bfloat16* p = base + (size_t)(r0 + g) * pitch + k0 + 2 * q;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// A fragment of rows m0..m0+15, cols k0..k0+15 of A = T^T, where T is a
// row-major bf16 tile with `pitch` elements per row (element (m, k) of A
// at base[k * pitch + m]), by one `ldmatrix.x4.trans`: matrix i (lanes
// 8i .. 8i+7 give its row addresses) is T's rows k0 + 8 (i / 2) + 0..7 at
// columns m0 + 8 (i % 2), which .trans hands out as a[i]. Rows of T start
// on 16 bytes (pitch and m0 multiples of 8); a pitch of 4 (mod 32) words
// puts the 8 rows of a matrix on distinct banks.
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* base,
                                             int pitch, int m0, int k0,
                                             int lane) {
  const __nv_bfloat16* p = base
                           + (size_t)(k0 + ((lane >> 4) << 3) + (lane & 7))
                                 * pitch
                           + m0 + (((lane >> 3) & 1) << 3);
  const unsigned int addr =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// B fragments of two n-tiles, k0..k0+15 x n0..n0+7 into b[0] and
// k0..k0+15 x n0+8..n0+15 into b[1], from a tile stored k-major (element
// (k, n) at base[k * pitch + n]), by one `ldmatrix.x4.trans`: matrix i
// (lanes 8i .. 8i+7 give its row addresses) is the tile's rows
// k0 + 8 (i % 2) + 0..7 at columns n0 + 8 (i / 2), which .trans hands out
// as b[i / 2][i % 2]. Rows start on 16 bytes (pitch and n0 multiples of
// 8); a pitch of 4 (mod 32) words puts the 8 rows of a matrix on distinct
// banks.
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[2][2],
                                             const __nv_bfloat16* base,
                                             int pitch, int n0, int k0,
                                             int lane) {
  const __nv_bfloat16* p = base
                           + (size_t)(k0 + (((lane >> 3) & 1) << 3)
                                      + (lane & 7)) * pitch
                           + n0 + ((lane >> 4) << 3);
  const unsigned int addr =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(addr)
      : "memory");
}

// B fragment of k0..k0+15 x n0..n0+7 from a tile stored n-major: element
// (k, n) at base[n * pitch + k].
__device__ __forceinline__ void frag_b(uint32_t (&b)[2],
                                       const __nv_bfloat16* base, int pitch,
                                       int n0, int k0, int lane) {
  const int g = lane >> 2;
  const int q = lane & 3;
  const __nv_bfloat16* p = base + (size_t)(n0 + g) * pitch + k0 + 2 * q;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// The int8 product of the W8A8 LSTM (lstm_fwd_q.cu): D (16 x 8, s32) += A
// (16 x 32, s8, row-major) . B (32 x 8, s8, column-major), one
// `mma.sync.aligned.m16n8k32`, exact in int32. Its fragments have the byte
// layout of the bf16 ones above: each 32-bit register holds four int8 of
// consecutive k (the lowest k in the low byte) where it holds two bf16, so
// every k index doubles:
//   A  a[0] = (row g,     cols 4q .. 4q+3)    a[1] = (row g + 8, same)
//      a[2] = (row g,     cols 4q+16 .. 4q+19) a[3] = (row g + 8, same)
//   B  b[0] = (rows 4q .. 4q+3, col g)         b[1] = (rows 4q+16 .. 4q+19)
//   D  as above, in s32.
// `frag_a` on an int8 tile loads A with the bf16 addressing: row-major, a
// row pitch of 4 (mod 32) words. (K7 builds its B fragments from an f32
// stage, quantizing them as it reads.)
__device__ __forceinline__ void mma_16832_s8(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0..r0+15, cols k0..k0+31 of a row-major int8 tile
// with `pitch` bytes per row (pitch and k0 multiples of 4).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const int8_t* base,
                                       int pitch, int r0, int k0, int lane) {
  const int g = lane >> 2;
  const int q = lane & 3;
  const int8_t* p = base + (size_t)(r0 + g) * pitch + k0 + 4 * q;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * pitch + 16);
}

constexpr int kMmaThreads = 256;
constexpr int kMR = 64;  // rows (cells) a block

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// bf16 row pitch of z: 4 (mod 32) words.
__host__ __device__ constexpr int pitch_j(int J) { return round_up(J, 64) + 8; }

}  // namespace joint_mma
