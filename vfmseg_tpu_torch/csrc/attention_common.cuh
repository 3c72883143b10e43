// Tile constants and mma.sync helpers shared by the attention kernels
// (attention_relpos.cu's mma.sync kernel; attention_hm.cu takes the tile
// constants and the strided views, and attention_qkv.cu the constants, both
// multiplying with wgmma from hopper_common.cuh), and B2's host entry over
// views of their own strides (attention_qkv.cu, called by
// attention_qkv_rope.cu).
//
// The mma.sync kernel works in tiles of 64 rows staged in shared memory with
// rows padded by 8 elements, and multiplies with bf16 mma.sync.m16n8k16 and
// fp32 accumulators, at any head dim that is a multiple of 16. The fragment
// layouts below are the PTX ones for that instruction, with g = lane / 4 and
// t = lane % 4:
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

constexpr int kHeadDim = 64;            // B2's and B3's head dim
constexpr int kBlock = 64;              // rows of a tile (queries or keys)
constexpr int kWarps = kBlock / 16;     // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = kBlock / 8;     // n=8 column tiles across a 64-wide tile
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

// Tiles and products at any head dim D that is a multiple of 16 (64, or
// SAM's 80), for the rel-pos kernel (attention_relpos.cu). Rows of D = 80
// bf16 (160 bytes) are staged with 8 elements of padding, which keeps the
// fragment loads free of bank conflicts.

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

// Element strides (batch, token) of one token-major [B, N, H*64] view.
struct TokenStrides {
  int64_t b, n;
};

// B2's kernel (attention_qkv.cu) over bf16 [batch, n, heads * 64] q, k, v
// views with a stride pair each (multiples of 8 elements, the batch stride
// free when batch is 1; unit stride along features, 16-byte aligned), into a
// contiguous bf16 [batch, n, heads * 64] out. Returns a cudaError_t or a
// tensor-map encode failure (vfmseg_error_string).
int attention_qkv_views(const void* q, const void* k, const void* v, void* out, int batch, int n,
                        int heads, const TokenStrides (&views)[3], float scale, void* stream);

}  // namespace vfmseg_attn
