// Tile constants and mma.sync helpers shared by the attention kernels
// (attention_qkv_rope.cu, attention_relpos.cu; attention_hm.cu takes the
// tile constants and the strided views, and attention_qkv.cu the constants,
// both multiplying with wgmma from hopper_common.cuh).
//
// The mma.sync kernels work in tiles of 64 rows staged in shared memory with
// rows padded by 8 elements (72 at head dim 64), and multiply with bf16
// mma.sync.m16n8k16 and fp32 accumulators. The first helpers are fixed at
// head dim 64 (B2-RoPE); the templated ones below take any multiple of 16. The
// fragment layouts below are the PTX ones for that instruction, with
// g = lane / 4 and t = lane % 4:
//
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   B (16 x 8, col-major):  b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g)
//   C (16 x 8):             c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
//
// so the C fragments of two neighbouring n=8 tiles are, packed to bf16, the A
// fragment of one k=16 chunk of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vfmseg_attn {

constexpr int kHeadDim = 64;
constexpr int kBlock = 64;              // rows of a tile (queries or keys)
constexpr int kWarps = kBlock / 16;     // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kHeadDim + 8;      // padded shared-memory row, in elements
constexpr int kNTiles = kBlock / 8;     // n=8 column tiles across a 64-wide tile
constexpr int kDTiles = kHeadDim / 8;   // n=8 column tiles across head dim
constexpr int kDChunks = kHeadDim / 16; // k=16 chunks of a contraction over d
constexpr int kKChunks = kBlock / 16;   // k=16 chunks of a contraction over rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// D += A.B for one m16n8k16 tile, bf16 inputs and fp32 accumulators.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 from shared memory -> one register, the first in the low half.
__device__ __forceinline__ uint32_t pack_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [0, valid) of a 64 x 64 head tile into padded shared memory with
// 16-byte loads; rows past `valid` are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t row_stride,
                                          int valid, int tid) {
#pragma unroll
  for (int i = tid; i < kBlock * (kHeadDim / 8); i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = (i % (kHeadDim / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kRow + c) = v;
  }
}

// Rotate rows [0, valid) of a staged 64 x 64 q or k tile by 2D RoPE in the
// evens|odds layout (vfmseg_tpu/ops/rope.py): x <- x * cos + half_swap(x) * sin,
// half_swap exchanging columns c and c + 32. cos/sin point at the tile's first
// row of fp32 [N, 64] tables. fp32 arithmetic from bf16, rounded once to bf16;
// each thread owns two column pairs (c, c+1) and (c+32, c+33) of one row, so it
// reads both halves before it writes. Rows past `valid` are the zero fill and
// stay zero.
__device__ __forceinline__ void rope_tile(bf16* tile, const float* __restrict__ cos,
                                          const float* __restrict__ sin, int valid, int tid) {
  constexpr int kHalf = kHeadDim / 2;
  constexpr int kUnits = kHalf / 2;  // column pairs per half row
  for (int i = tid; i < kBlock * kUnits; i += kThreads) {
    const int r = i / kUnits;
    if (r >= valid) break;  // i grows with r
    const int c = (i % kUnits) * 2;
    __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(tile + r * kRow + c);
    __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(tile + r * kRow + c + kHalf);
    const float2 xl = __bfloat1622float2(*lo);
    const float2 xh = __bfloat1622float2(*hi);
    const float* cr = cos + static_cast<int64_t>(r) * kHeadDim + c;
    const float* sr = sin + static_cast<int64_t>(r) * kHeadDim + c;
    const float2 cl = *reinterpret_cast<const float2*>(cr);
    const float2 ch = *reinterpret_cast<const float2*>(cr + kHalf);
    const float2 sl = *reinterpret_cast<const float2*>(sr);
    const float2 sh = *reinterpret_cast<const float2*>(sr + kHalf);
    *lo = __floats2bfloat162_rn(xl.x * cl.x + xh.x * sl.x, xl.y * cl.y + xh.y * sl.y);
    *hi = __floats2bfloat162_rn(xh.x * ch.x + xl.x * sh.x, xh.y * ch.y + xl.y * sh.y);
  }
}

// A fragments of this warp's 16 rows of a staged tile, one per k=16 chunk of
// head dim (the left operand of a product that contracts over d).
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[kDChunks][4], const bf16* tile,
                                            int warp, int g, int t) {
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < kDChunks; ++kc) {
    const bf16* p = tile + kc * 16 + 2 * t;
    a[kc][0] = load_u32(p + r0 * kRow);
    a[kc][1] = load_u32(p + (r0 + 8) * kRow);
    a[kc][2] = load_u32(p + r0 * kRow + 8);
    a[kc][3] = load_u32(p + (r0 + 8) * kRow + 8);
  }
}

// acc[16 x 64] = A . tile^T: the right operand is a staged tile whose rows
// are the 64 output columns (S = Q.K^T with tile = K).
__device__ __forceinline__ void mma_rows_t(float (&acc)[kNTiles][4],
                                           const uint32_t (&a)[kDChunks][4],
                                           const bf16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* r = tile + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
    for (int kc = 0; kc < kDChunks; ++kc) {
      mma_m16n8k16(acc[nt], a[kc], load_u32(r + kc * 16), load_u32(r + kc * 16 + 8));
    }
  }
}

// acc[16 x 64] += P . tile, with P [16 x 64] given as fp32 C fragments (packed
// to bf16 here) and the tile's rows the contraction axis (O += P.V).
__device__ __forceinline__ void mma_acc_p(float (&acc)[kDTiles][4],
                                          const float (&p)[kNTiles][4],
                                          const bf16* tile, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < kKChunks; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const bf16* r = tile + (kc * 16 + 2 * t) * kRow + g;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const bf16* q = r + dt * 8;
      mma_m16n8k16(acc[dt], pa, pack_pair(q, q + kRow), pack_pair(q + 8 * kRow, q + 9 * kRow));
    }
  }
}

// Store this warp's 16 x 64 fp32 accumulator rows as bf16 at
// base + row * row_stride (+ column), skipping rows >= n.
__device__ __forceinline__ void store_rows(bf16* base, int64_t row_stride, int row0, int n,
                                           const float (&acc)[kDTiles][4], float s0, float s1,
                                           int t) {
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    if (row0 < n) {
      *reinterpret_cast<uint32_t*>(base + row0 * row_stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][0] * s0, acc[dt][1] * s0);
    }
    if (row0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(base + (row0 + 8) * row_stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2] * s1, acc[dt][3] * s1);
    }
  }
}

// Element strides of one [B, H, N, *] view: batch, head and token.
struct View {
  int64_t b, h, n;
};

// The i-th view of an int64 stride array of (batch, head, token) triples.
inline View view(const long long* s, int i) { return View{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

__device__ __forceinline__ const bf16* at(const bf16* p, const View& s, int b, int h, int row) {
  return p + b * s.b + h * s.h + static_cast<int64_t>(row) * s.n;
}

__device__ __forceinline__ bf16* at(bf16* p, const View& s, int b, int h, int row) {
  return p + b * s.b + h * s.h + static_cast<int64_t>(row) * s.n;
}

// The same tiles and products at any head dim D that is a multiple of 16
// (64, or SAM's 80), for the rel-pos kernel (attention_relpos.cu). Rows of D = 80 bf16 (160 bytes) are staged with 8
// elements of padding, which keeps the fragment loads free of bank conflicts.

// Shapes of a head dim D: staged rows padded by 8 elements, 16-byte vectors
// per row, k=16 chunks of a contraction over d, n=8 tiles across d.
template <int D>
struct Dims {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kRowD = D + 8;
  static constexpr int kVecs = D / 8;
  static constexpr int kChunks = D / 16;
  static constexpr int kTiles = D / 8;
  static constexpr int kTileElems = kBlock * kRowD;
};

// Copy rows [0, valid) of a 64 x D tile into padded shared memory with 16-byte
// loads; rows past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_d(bf16* dst, const bf16* src, int64_t row_stride,
                                            int valid, int tid) {
#pragma unroll
  for (int i = tid; i < kBlock * Dims<D>::kVecs; i += kThreads) {
    const int r = i / Dims<D>::kVecs;
    const int c = (i % Dims<D>::kVecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::kRowD + c) = v;
  }
}

// A fragments of this warp's 16 rows of the staged Q tile, one per k=16 chunk
// of the head dim.
template <int D>
__device__ __forceinline__ void load_a_rows_d(uint32_t (&a)[Dims<D>::kChunks][4],
                                              const bf16* tile, int warp, int g, int t) {
  constexpr int R = Dims<D>::kRowD;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < Dims<D>::kChunks; ++kc) {
    const bf16* p = tile + kc * 16 + 2 * t;
    a[kc][0] = load_u32(p + r0 * R);
    a[kc][1] = load_u32(p + (r0 + 8) * R);
    a[kc][2] = load_u32(p + r0 * R + 8);
    a[kc][3] = load_u32(p + (r0 + 8) * R + 8);
  }
}

// acc[16 x 64] = Q . K^T over the head dim (tile = the staged K tile).
template <int D>
__device__ __forceinline__ void mma_scores(float (&acc)[kNTiles][4],
                                           const uint32_t (&a)[Dims<D>::kChunks][4],
                                           const bf16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* r = tile + (nt * 8 + g) * Dims<D>::kRowD + 2 * t;
#pragma unroll
    for (int kc = 0; kc < Dims<D>::kChunks; ++kc) {
      mma_m16n8k16(acc[nt], a[kc], load_u32(r + kc * 16), load_u32(r + kc * 16 + 8));
    }
  }
}

// acc[16 x D] += P . V, with P [16 x 64] given as fp32 C fragments (packed to
// bf16 here) and the staged V tile's rows the contraction axis.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[Dims<D>::kTiles][4],
                                       const float (&p)[kNTiles][4], const bf16* tile, int g,
                                       int t) {
  constexpr int R = Dims<D>::kRowD;
#pragma unroll
  for (int kc = 0; kc < kKChunks; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const bf16* r = tile + (kc * 16 + 2 * t) * R + g;
#pragma unroll
    for (int dt = 0; dt < Dims<D>::kTiles; ++dt) {
      const bf16* q = r + dt * 8;
      mma_m16n8k16(acc[dt], pa, pack_pair(q, q + R), pack_pair(q + 8 * R, q + 9 * R));
    }
  }
}

// Store this warp's 16 x D accumulator rows, scaled per row, as bf16 at
// base + row * row_stride, skipping rows >= n.
template <int D>
__device__ __forceinline__ void store_rows_d(bf16* base, int64_t row_stride, int row0, int n,
                                             const float (&acc)[Dims<D>::kTiles][4], float s0,
                                             float s1, int t) {
#pragma unroll
  for (int dt = 0; dt < Dims<D>::kTiles; ++dt) {
    if (row0 < n) {
      *reinterpret_cast<uint32_t*>(base + row0 * row_stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][0] * s0, acc[dt][1] * s0);
    }
    if (row0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(base + (row0 + 8) * row_stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2] * s1, acc[dt][3] * s1);
    }
  }
}

}  // namespace vfmseg_attn
