// Multi-scale deformable attention's core in one pass, for Hopper (sm_90a):
// each head's softmax over its levels and points, the bilinear samples and
// their weighted sum.
//
// Replaces the TPU package's ms_deform_attn_core
// (vfmseg_tpu/ops/deform_attn.py:231-257) together with the Pallas sampler
// it calls (_sample_pallas_xy, :107-189), on the route where nothing needs
// a gradient: Mask2Former's pixel decoder at inference and in no-grad
// teacher forwards (models/heads/mask2former.py MSDeformAttention).
// Training keeps B8 (deform_sample.cu) level by level, whose samples its
// backward recomputes through the plain version.
//
// For query q of crop b and head h, with L levels of P points, i = l P + p:
//
//   w_i = softmax_i(logits[b, q, h L P + i])                         (fp32)
//   xn = ref_x[q] + off[b, q, 2 (h L P + i)] * (1 / W_l)
//   yn = ref_y[q] + off[b, q, 2 (h L P + i) + 1] * (1 / H_l)
//        (fp32, the product rounded, then the sum: PyTorch's two ops)
//   out[b, q, h d : h d + d] = sum_i w_i sample_l(xn, yn)
//
// with sample_l B8's zero-padded bilinear sample (align_corners=False) of
// level l's plane, value[b, start_l : start_l + H_l W_l, h d : h d + d],
// in B8's arithmetic and tap order. Softmax, locations, samples and the sum
// stay fp32 in registers; the output is rounded once to the value's dtype.
// Every sample is computed, whatever its weight.
//
// Layout: value contiguous [B, Nv, heads d] (value_proj of the whole token
// stream, the levels' maps back to back, row-major); offsets
// [B, Nq, heads L P 2] and logits [B, Nq, heads L P] contiguous, as the two
// linears write them (feature order head, level, point, axis); ref_x,
// ref_y fp32 [Nq]; out contiguous [B, Nq, heads d], the layout output_proj
// reads.
//
// What bounds it: not device memory. At Rein's slide (18 crops, 8 heads of
// 32 bf16, levels 16^2, 32^2 and 64^2, 4 points, 5376 queries) a layer reads
// the value once (49.5 MB), the offsets and logits (37.2 + 18.6 MB) and
// writes the output (49.5 MB): 0.155 GB, 46 us at 3.35 TB/s. Its 9.3 M
// samples read four 64-byte taps each, 2.4 GB, from a crop's level planes
// (at most 2 MB each, 49.5 MB in all), so from L1 and L2, at ~100
// instructions a sample and lane: the caches' bandwidth and the instruction rate
// set the pace. The chain this replaces wrote every sample to device memory
// (0.2 GB a level) and read it back through copies and a batched gemv.
//
// What the design does about it: keep the taps in L1.
// * A warp takes a tile of neighbouring queries of one crop and head: at
//   d = 32 bf16, 8 queries of 4 lanes, each lane a 16-byte vector of the
//   head's channels (narrower where d * itemsize or alignment asks, B8's
//   rule), so a tap load of the warp reads one head's 64 bytes at 8
//   neighbouring places. (A warp a query, its 8 heads' 512-byte rows,
//   reads 8 unrelated places a load; at random reference points both ran
//   0.68 ms a layer at Rein's slide on an H100 at 700 W.)
// * Tiles run crop by crop, head by head, queries fastest, and blocks are
//   persistent over contiguous runs of them: a block's 8 warps sweep 64
//   neighbouring queries of one head, whose reference points neighbour on a
//   level's grid, so their taps share L1 lines as B8's did. A crop's value
//   (2.75 MB) stays in L2 while its heads pass.
// * The tile's offset and logit rows are read one tile ahead, before this
//   tile's taps, element by element (any alignment, a few registers), then
//   staged in the warp's shared memory, where each lane reads its query's.
// * The softmax is taken once a query: a segment of lanes a query (a power
//   of two >= L P), max and sum by shuffles, the weights into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "deform_common.cuh"

namespace {

using vfmseg_deform::Bits;
using vfmseg_deform::lerp;
using vfmseg_deform::load_tap;
using vfmseg_deform::Raw;
using vfmseg_deform::Taps;
using vfmseg_deform::taps;
using vfmseg_deform::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 4;
constexpr int kPre = 12;              // offsets and logits a lane stages
constexpr int kMaxRow = 32 * kPre;    // ... and a warp
constexpr int kMinBlocks = 3;

// Each level's plane: its size, its first token in the value, and the
// fp32 reciprocals of its width and height.
struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
  float inv_w[kMaxLevels];
  float inv_h[kMaxLevels];
};

// A warp takes a tile: `qpw` neighbouring queries of one crop and head.
// Tiles run crop by crop, head by head, the queries fastest; block k takes
// the k-th of gridDim.x contiguous runs of block rows, warp w the w-th tile
// of each row. A tile's staging buffer holds each query's offsets (2 L P)
// and logits (L P), loaded by `lpi` lanes a query (lane j lpi + s takes
// elements s, s + lpi, ... of query j's), then its weights; its samples
// take `vph` lanes a query, one vector of the head's channels each.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    deform_sample_kernel_fused(const T* __restrict__ value, const T* __restrict__ offsets,
                               const T* __restrict__ logits, const float* __restrict__ ref_x,
                               const float* __restrict__ ref_y, T* __restrict__ out, Levels lv,
                               int nq, int nv, int heads, int d, int levels, int points, int qpw,
                               int lpi, int seg, int64_t tiles, int64_t block_rows) {
  using B = Bits<T>;
  using E = typename Bits<T>::E;
  constexpr int kElems = Vec<T, kVec>::kElems;
  __shared__ E s_row[kWarps][kMaxRow];
  __shared__ float s_w[kWarps][kMaxRow / 3];
  __shared__ float2 s_ref[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lp = levels * points;
  const int c = heads * d;
  const int vph = d / kElems;  // vectors a head
  const int chunks = (nq + qpw - 1) / qpw;
  E* row = s_row[warp];
  float* wt = s_w[warp];
  float2* ref = s_ref[warp];
  const E* off_bits = reinterpret_cast<const E*>(offsets);
  const E* logit_bits = reinterpret_cast<const E*>(logits);
  const int fj = lane / lpi;  // the query this lane stages
  const int fs = lane - fj * lpi;

  const int64_t g0 = block_rows * blockIdx.x / gridDim.x;
  const int64_t g1 = block_rows * (blockIdx.x + 1) / gridDim.x;
  int64_t t = g0 * kWarps + warp;
  E pre[kPre];
  float2 pre_ref = make_float2(0.f, 0.f);
  // stage tile r's offsets, logits and reference points in registers
  auto fetch = [&](int64_t r) {
    const int64_t bh = r / chunks;
    const int q = static_cast<int>(r - bh * chunks) * qpw + fj;
    if (fj >= qpw || q >= nq) return;
    const int64_t item = (bh / heads * nq + q) * heads + bh % heads;
    const E* o = off_bits + item * 2 * lp;
    const E* a = logit_bits + item * lp;
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int m = fs + k * lpi;
      if (m < 2 * lp) {
        pre[k] = o[m];
      } else if (m < 3 * lp) {
        pre[k] = a[m - 2 * lp];
      }
    }
    pre_ref = make_float2(ref_x[q], ref_y[q]);
  };
  if (g0 < g1 && t < tiles) fetch(t);
  for (int64_t g = g0; g < g1 && t < tiles; ++g, t += kWarps) {
    if (fj < qpw) {
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int m = fs + k * lpi;
        if (m < 3 * lp) row[fj * 3 * lp + m] = pre[k];
      }
      if (fs == 0) ref[fj] = pre_ref;
    }
    __syncwarp();
    if (g + 1 < g1 && t + kWarps < tiles) fetch(t + kWarps);
    const int64_t bh = t / chunks;
    const int64_t b = bh / heads;
    const int h = static_cast<int>(bh - b * heads);
    const int q0 = static_cast<int>(t - bh * chunks) * qpw;

    // each query's softmax over its L P logits: `seg` lanes a query (a
    // power of two >= L P), 32 / seg queries at a time
    for (int j0 = 0; j0 < qpw; j0 += 32 / seg) {
      const int j = j0 + lane / seg;
      const int i = lane & (seg - 1);
      const bool valid = j < qpw && q0 + j < nq && i < lp;
      const float x = valid ? B::to_float(row[j * 3 * lp + 2 * lp + i]) : -INFINITY;
      float m = x;
      for (int o = seg >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float ex = valid ? expf(x - m) : 0.f;
      float sum = ex;
      for (int o = seg >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (valid) wt[j * lp + i] = ex / sum;
    }
    __syncwarp();

    for (int v = lane; v < qpw * vph; v += 32) {
      const int j = v / vph;
      if (q0 + j >= nq) break;
      const int ch = h * d + (v - j * vph) * kElems;
      const E* off = row + j * 3 * lp;
      const float* wj = wt + j * lp;
      const float2 r = ref[j];
      float acc[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = 0.f;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l >= levels) break;
        const int hl = lv.h[l];
        const int wl = lv.w[l];
        const float iw = lv.inv_w[l];
        const float ih = lv.inv_h[l];
        const T* plane = value + (b * nv + lv.start[l]) * c + ch;
        const int64_t row_elems = static_cast<int64_t>(wl) * c;
#pragma unroll 2
        for (int p = 0; p < points; ++p) {
          const int i = l * points + p;
          // the location as PyTorch rounds it: the product, then the sum
          const float xn = __fadd_rn(r.x, __fmul_rn(B::to_float(off[2 * i]), iw));
          const float yn = __fadd_rn(r.y, __fmul_rn(B::to_float(off[2 * i + 1]), ih));
          const Taps<T> tp = taps(plane, xn, yn, hl, wl, c);
          const Vec<T, kVec> v00 = load_tap<T, kVec>(tp.r00, tp.i00);
          const Vec<T, kVec> v01 = load_tap<T, kVec>(tp.r00 + c, tp.i01);
          const Vec<T, kVec> v10 = load_tap<T, kVec>(tp.r00 + row_elems, tp.i10);
          const Vec<T, kVec> v11 = load_tap<T, kVec>(tp.r00 + row_elems + c, tp.i11);
          const float a = wj[i];
#pragma unroll
          for (int e = 0; e < kElems; ++e) {
            acc[e] += a * lerp(v00, v01, v10, v11, tp.fx, tp.fy, e);
          }
        }
      }
      Vec<T, kVec> o;
#pragma unroll
      for (int e = 0; e < kElems; ++e) o.e[e] = B::from_float(acc[e]);
      *reinterpret_cast<typename Raw<kVec>::U*>(out + ((b * nq + q0 + j) * c + ch)) = o.raw;
    }
    __syncwarp();  // the staging buffer is free for the next tile
  }
}

template <typename T, int kVec>
int launch(const void* value, const void* offsets, const void* logits, const float* ref_x,
           const float* ref_y, void* out, const Levels& lv, int batch, int nq, int nv, int heads,
           int d, int levels, int points, cudaStream_t stream) {
  const int lp = levels * points;
  int seg = 1;
  while (seg < lp) seg *= 2;
  // queries a tile: as many as a warp's lanes hold vectors of their head,
  // and as its lanes can stage (kPre elements each)
  const int vph = d / Vec<T, kVec>::kElems;
  const int staged = 32 / ((3 * lp + kPre - 1) / kPre);
  int qpw = vph < 32 ? 32 / vph : 1;
  if (qpw > staged) qpw = staged;
  const int lpi = 32 / qpw;
  const int64_t tiles = static_cast<int64_t>(batch) * heads * ((nq + qpw - 1) / qpw);
  const int64_t block_rows = (tiles + kWarps - 1) / kWarps;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deform_sample_kernel_fused<T, kVec>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(block_rows < slots ? block_rows : slots);
  deform_sample_kernel_fused<T, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const T*>(offsets), static_cast<const T*>(logits),
      ref_x, ref_y, static_cast<T*>(out), lv, nq, nv, heads, d, levels, points, qpw, lpi, seg,
      tiles, block_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value: contiguous [batch, nv, heads * head_dim]; offsets: contiguous
// [batch, nq, heads * levels * points * 2]; logits: contiguous
// [batch, nq, heads * levels * points]; all fp32 (dtype 0) or bf16 (dtype 1).
// ref_x, ref_y: contiguous fp32 [nq]. out: contiguous [batch, nq,
// heads * head_dim] in the same dtype. geometry: host int32
// [levels, 3] (h, w, first token of each level in the value); inv: host
// fp32 [levels, 2] (1 / w, 1 / h). Takes 1 to 4 levels and levels * points
// up to 32; batch * nq below 2^31.
// Returns a cudaError_t.
extern "C" int vfmseg_deform_attn(const void* value, const void* offsets, const void* logits,
                                  const void* ref_x, const void* ref_y, void* out,
                                  const int* geometry, const float* inv, int batch, int nq,
                                  int nv, int heads, int head_dim, int levels, int points,
                                  int dtype, void* stream) {
  const int64_t queries = static_cast<int64_t>(batch) * nq;
  if (queries == 0 || heads * head_dim == 0) return static_cast<int>(cudaSuccess);
  if (queries > 0x7fffffff || levels < 1 || levels > kMaxLevels || points < 1 ||
      levels * points > 32 || heads < 1 || head_dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.h[l] = geometry[3 * l];
    lv.w[l] = geometry[3 * l + 1];
    lv.start[l] = geometry[3 * l + 2];
    lv.inv_w[l] = inv[2 * l];
    lv.inv_h[l] = inv[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.start[l] < 0 ||
        static_cast<int64_t>(lv.start[l]) + static_cast<int64_t>(lv.h[l]) * lv.w[l] > nv) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rx = static_cast<const float*>(ref_x);
  const float* ry = static_cast<const float*>(ref_y);
#define VFMSEG_DEFORM_ATTN_LAUNCH(T, V)                                                        \
  launch<T, V>(value, offsets, logits, rx, ry, out, lv, batch, nq, nv, heads, head_dim, levels, \
               points, st)
  if (dtype == 0) {
    switch (vfmseg_deform::vec_bytes(value, out, head_dim, 4)) {
      case 16: return VFMSEG_DEFORM_ATTN_LAUNCH(float, 16);
      case 8: return VFMSEG_DEFORM_ATTN_LAUNCH(float, 8);
      default: return VFMSEG_DEFORM_ATTN_LAUNCH(float, 4);
    }
  }
  if (dtype == 1) {
    switch (vfmseg_deform::vec_bytes(value, out, head_dim, 2)) {
      case 16: return VFMSEG_DEFORM_ATTN_LAUNCH(__nv_bfloat16, 16);
      case 8: return VFMSEG_DEFORM_ATTN_LAUNCH(__nv_bfloat16, 8);
      case 4: return VFMSEG_DEFORM_ATTN_LAUNCH(__nv_bfloat16, 4);
      default: return VFMSEG_DEFORM_ATTN_LAUNCH(__nv_bfloat16, 2);
    }
  }
#undef VFMSEG_DEFORM_ATTN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
