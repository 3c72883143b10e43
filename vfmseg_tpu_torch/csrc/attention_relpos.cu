// Attention with SAM's decomposed relative-position bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel_relpos of vfmseg_tpu/ops/flash_attention.py,
// as launched by _flash_forward_relpos_hm (entry flash_attention_relpos_hm, the
// primal and the training forward of _flash_relpos_hm), which every block of
// SAM's ViT takes: the 28 windowed blocks (N = 14 x 14) and the 4 global ones
// (N = the whole grid). The JAX rule's backward recomputes through the plain
// formulation, and so does the port's (ops/attention.py); there is no backward
// kernel.
//
// For every batch item (or window) b and head h, with q_h, k_h, v_h [N, D] and
// N = kh * kw tokens on a kh x kw grid:
//
//   S[r, c] = (q_h[r] . k_h[c]) * scale + rel_h[r, c / kw] + rel_w[r, c % kw]
//   out_h   = softmax(S) v_h
//
// in fp32, with an online softmax over a running max and a natural exp, P
// rounded to bf16 for P.V with fp32 accumulation, and the output in bf16: the
// numerics of xla_attention_decomposed_hm, not the TPU kernel's no-max exp2
// softmax and its one-hot bias matmuls.
//
// Layout: q, k, v and out are [B, H, N, D] bf16 views with their own element
// strides (batch, head, token) and unit stride along the head dim, so SAM's
// attention reads q, k and v straight out of its fused qkv output [B, N, 3, H,
// D] and writes a token-major output for the proj product. rel_h [B, H, N, kh]
// and rel_w [B, H, N, kw] are contiguous bf16. D is 64 or 80 (SAM ViT-H), a
// template parameter.
//
// What bounds it: at the global blocks, the tensor cores (4*N^2*D flops per
// head on ~(4D + kh + kw)*2 bytes per token: N/2 flops per byte at N = 1024);
// at the windowed blocks (N = 196), the bytes: ~100 flops per byte, under the
// card's ~295 flop/byte ridge.
//
// What the design does about it: B5's tiles and products (attention_common.cuh),
// one block of 4 warps per (64 query rows, head, batch item), 16 rows a warp,
// bf16 mma.sync.m16n8k16 with fp32 accumulators, P re-packed in registers as
// the A operand of P.V, so the N x N scores and the bias never exist outside
// registers. The block stages its 64 rows of rel_h and rel_w once in shared
// memory as fp32 (row strides made odd, so the 8 rows a warp reads at one
// column fall in 8 banks) and adds the bias to each score from the fragment's
// (row, column) coordinates. Rows of D = 80 bf16 (160 bytes) are staged with
// 8 elements of padding, which keeps the fragment loads free of bank
// conflicts. The K tail past N (196 = 3*64 + 4) is zero-filled on load and its
// scores set to -inf; tokens that pad a window to 14 x 14 are real tokens here
// and are not masked. A key's grid row key / kw is taken by a float
// reciprocal, not an integer division per score. Past 48 KB (D = 80 with
// kh + kw = 96 at the stage-1 global blocks) the shared memory is dynamic,
// with the limit raised.
//
// Left for later: wgmma, TMA, asynchronous copies, and a 32-row tile for the
// windowed blocks, whose last query tile holds 4 of 64 rows.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

struct RelposArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* rel_h;
  const bf16* rel_w;
  bf16* out;
  View sq, sk, sv, so;
  int heads, n, kh, kw;
  float scale;
};

// Odd row stride of a staged fp32 rel-term row of c entries.
__host__ __device__ __forceinline__ int odd_stride(int c) { return c | 1; }

template <int D>
size_t smem_bytes(int kh, int kw) {
  return 3 * sizeof(bf16) * Dims<D>::kTileElems +
         sizeof(float) * kBlock * (odd_stride(kh) + odd_stride(kw));
}

// Stage rows [0, valid) of a contiguous [*, c] bf16 rel term as fp32 rows of
// stride `stride`; rows past `valid` are zero.
__device__ __forceinline__ void stage_rel(float* dst, const bf16* src, int c, int stride,
                                          int valid, int tid) {
  for (int i = tid; i < kBlock * c; i += kThreads) {
    const int r = i / c;
    dst[r * stride + (i - r * c)] = r < valid ? __bfloat162float(src[i]) : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_relpos_kernel(const RelposArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + Dims<D>::kTileElems;
  bf16* sv = sk + Dims<D>::kTileElems;
  const int sh = odd_stride(a.kh);
  const int sw = odd_stride(a.kw);
  float* srh = reinterpret_cast<float*>(sv + Dims<D>::kTileElems);
  float* srw = srh + kBlock * sh;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int valid_q = a.n - q0;

  load_tile_d<D>(sq, at(a.q, a.sq, b, h, q0), a.sq.n, valid_q, tid);
  const int64_t rel_row0 = (static_cast<int64_t>(b) * a.heads + h) * a.n + q0;
  stage_rel(srh, a.rel_h + rel_row0 * a.kh, a.kh, sh, valid_q, tid);
  stage_rel(srw, a.rel_w + rel_row0 * a.kw, a.kw, sw, valid_q, tid);
  __syncthreads();
  uint32_t qa[Dims<D>::kChunks][4];
  load_a_rows_d<D>(qa, sq, warp, g, t);

  // this thread's two rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + g;
  const float* rh[2] = {srh + r0 * sh, srh + (r0 + 8) * sh};
  const float* rw[2] = {srw + r0 * sw, srw + (r0 + 8) * sw};
  // key / kw by a float reciprocal: exact while N < 2^16, since (key + 0.5)
  // / kw lies at least 0.5 / kw from an integer
  const float inv_kw = 1.f / static_cast<float>(a.kw);

  float o[Dims<D>::kTiles][4];
#pragma unroll
  for (int i = 0; i < Dims<D>::kTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.n; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_d<D>(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.n - k0, tid);
    load_tile_d<D>(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.n - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    mma_scores<D>(s, qa, sk, g, t);  // S = Q.K^T, 16 rows x 64 keys

    // Scale, add the bias of (row, key) and mask keys past N at -inf; the
    // first tile always holds a real key, so m is finite after it.
    const int valid = a.n - k0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        float x0 = -INFINITY;
        float x1 = -INFINITY;
        if (col < valid) {
          const int key = k0 + col;
          const int i = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_kw);
          const int w = key - i * a.kw;
          x0 = s[nt][j] * a.scale + rh[0][i] + rw[0][w];
          x1 = s[nt][2 + j] * a.scale + rh[1][i] + rw[1][w];
        }
        s[nt][j] = x0;
        s[nt][2 + j] = x1;
        mx[0] = fmaxf(mx[0], x0);
        mx[1] = fmaxf(mx[1], x1);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < Dims<D>::kTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    mma_pv<D>(o, s, sv, g, t);  // O += P.V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows_d<D>(at(a.out, a.so, b, h, 0), a.so.n, q0 + r0, a.n, o, 1.f / l[0], 1.f / l[1], t);
}

template <int D>
int launch(const RelposArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(a.kh, a.kw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_relpos_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.n + kBlock - 1) / kBlock, a.heads, batch);
  attention_relpos_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: [B, H, n, head_dim] bf16 views with unit stride along the head
// dim and 16-byte aligned rows; strides holds 12 int64: (batch, head, token) of
// q, k, v, out. rel_h [B, H, n, kh] and rel_w [B, H, n, kw]: contiguous bf16,
// n = kh * kw < 65536. head_dim: 64 or 80. Returns a cudaError_t.
extern "C" int vfmseg_attention_relpos(const void* q, const void* k, const void* v,
                                       const void* rel_h, const void* rel_w, void* out,
                                       const long long* strides, int batch, int heads, int n,
                                       int kh, int kw, int head_dim, float scale, void* stream) {
  RelposArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.rel_h = static_cast<const bf16*>(rel_h);
  a.rel_w = static_cast<const bf16*>(rel_w);
  a.out = static_cast<bf16*>(out);
  a.sq = view(strides, 0);
  a.sk = view(strides, 1);
  a.sv = view(strides, 2);
  a.so = view(strides, 3);
  a.heads = heads;
  a.n = n;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  if (kh * kw != n || n >= 65536) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(a, batch, s);
  if (head_dim == 80) return launch<80>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
