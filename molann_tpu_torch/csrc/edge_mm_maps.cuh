// Where each value sits in the fragments of edge_mm.cu's tensor-core bodies:
// plain functions of the lane (and register, byte), so that the same code
// builds the kernels' loads and stores and, compiled with a host C++
// compiler, the CPU test that holds them against the PTX ISA's fragment
// layouts and against the host's image of D
// (tests/test_torch_port_edge_mm.py).
//
// One image of D serves every tensor-core body. It is cut into tiles of 16
// rows by 32 columns (an m16n8k32 s8 A operand), and a tile is stored as its
// 32 lanes' registers, 16 bytes a lane: lane L, register r, byte i holds
// the code (kEmmPlus, below) of D[emm_a_row(L, r)][emm_a_col(L, r, i)] of
// the tile. The bf16 bodies read
// the same 16 bytes as two m16n8k16 A operands (the tile's two 16-column
// halves): they permute k inside a half, so that the bf16 fragment's pair of
// columns (2t, 2t + 1) is the s8 fragment's (4t, 4t + 1) and (2t + 8, 2t +
// 9) its (4t + 2, 4t + 3), and x's B fragment takes the same rows. A
// permutation of k inside a product's sum changes neither its terms nor the
// set each 16-deep step adds.

#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

// The image's byte of an entry d of D: 0x40 for +1, 0xC0 for -1, 0 for 0.
// Read as a signed byte it is 64 d, the s8 bodies' A operand; read as the
// high byte of a bf16 it is 2 d, so that one byte permute widens two entries
// into a bf16x2 register (the low byte of +-2 is 0). The s8 bodies scale
// their sums by 1/64 at the end and the bf16 bodies halve theirs: powers of
// two, so exact (the s32 sums stay under 64 * 320 * 128 < 2^24).
constexpr int kEmmPlus = 0x40;
constexpr int kEmmMinus = 0xC0;
constexpr int kEmmS8One = 64;  // kEmmPlus as a signed byte
// __byte_perm selectors: bytes 0 and 1 (kEmmWidenLo) or 2 and 3
// (kEmmWidenHi) of a word into the high bytes of two 16-bit halves.
constexpr unsigned kEmmWidenLo = 0x1404u;
constexpr unsigned kEmmWidenHi = 0x3424u;

// s8 A operand (16 x 32): row and column of register r's byte i.
__host__ __device__ __forceinline__ int emm_a_row(int lane, int r) {
  return (lane >> 2) + 8 * (r & 1);
}
__host__ __device__ __forceinline__ int emm_a_col(int lane, int r, int i) {
  return 4 * (lane & 3) + i + 16 * (r >> 1);
}

// B operand (32 x 8): the row (k) of register h's byte i, and the column.
// For the bf16 bodies register h of x's operand is half h of the chunk and
// its elements (4t .. 4t + 3) come in the same order.
__host__ __device__ __forceinline__ int emm_b_row(int lane, int h, int i) {
  return 4 * (lane & 3) + i + 16 * h;
}
__host__ __device__ __forceinline__ int emm_b_col(int lane) { return lane >> 2; }

// Accumulator (16 x 8, s32 or f32): row and column of element e (0..3).
__host__ __device__ __forceinline__ int emm_c_row(int lane, int e) {
  return (lane >> 2) + 8 * (e >> 1);
}
__host__ __device__ __forceinline__ int emm_c_col(int lane, int e) {
  return 2 * (lane & 3) + (e & 1);
}

// The column, inside a warp's tile of 8 nt columns (nt 1 or 2), of column c
// of the B operand and accumulator of 8-column tile j: with two tiles a
// lane's columns of both sit side by side, so that it loads x 8 bytes at a
// time and stores out 16.
__host__ __device__ __forceinline__ int emm_tile_col(int c, int j, int nt) {
  return nt == 2 ? 2 * c + j : 8 * j + c;
}

// Index, in 16-byte units, of lane's registers of tile (mt, c) in an image
// of kc chunks a row of tiles.
__host__ __device__ __forceinline__ long long emm_image_at(int mt, int c, int kc, int lane) {
  return ((long long)mt * kc + c) * 32 + lane;
}

// __byte_perm(x, y, s) of CUDA, on the host as well.
__host__ __device__ __forceinline__ unsigned emm_byte_perm(unsigned x, unsigned y, unsigned s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int b = 0; b < 4; ++b) r |= (unsigned)((v >> (8 * ((s >> (4 * b)) & 7))) & 0xFF) << (8 * b);
  return r;
#endif
}

// The bf16 A operand of half h of a tile from lane's four image words
// (w[0..3]): registers a0..a3 of mma.m16n8k16, entries 2 d.
__host__ __device__ __forceinline__ void emm_widen(const unsigned* w, int h, unsigned* a) {
  a[0] = emm_byte_perm(w[2 * h], 0u, kEmmWidenLo);
  a[1] = emm_byte_perm(w[2 * h + 1], 0u, kEmmWidenLo);
  a[2] = emm_byte_perm(w[2 * h], 0u, kEmmWidenHi);
  a[3] = emm_byte_perm(w[2 * h + 1], 0u, kEmmWidenHi);
}
