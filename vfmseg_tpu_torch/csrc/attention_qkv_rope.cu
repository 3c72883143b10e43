// EVA02's inference attention with 2D RoPE, read straight from the q/k/v
// projections, for Hopper (sm_90a): B2-RoPE.
//
// Replaces _fwd_kernel_qkv_tav of vfmseg_tpu/ops/flash_attention.py with
// rope=True (launched by _flash_forward_qkv_tav_main, entry
// flash_attention_qkv_tm with rope_cs; tables :1254-1265). Two fp32 [N, 64]
// tables cos/sin in the evens|odds layout of vfmseg_tpu/ops/rope.py rotate q
// and k in shared memory (rope_tile, attention_common.cuh): the staged Q tile
// once before its mma fragments are read, each K tile after it lands, both
// from bf16 in fp32, rounded once to bf16. The TPU kernel folds scale *
// log2 e into q before rotating and rotates k in bf16 arithmetic; the port's
// numerics are those of its plain twin (ops/attention.py
// attention_qkv_rope_plain), which rotates both in fp32 and rounds.
//
// For every batch item b and head h:
//
//   out[b, :, h*64:(h+1)*64] = softmax(rope(q_h) rope(k_h)^T * scale) v_h
//
// with q_h, k_h, v_h the 64 columns of head h in three [B, N, H*64] bf16
// views that share one (batch, token) stride pair (the thirds of EVA02's
// fused qkv); the output is token-major [B, N, H*64] bf16. Numerics follow
// xla_attention (vfmseg_tpu/ops/attention.py:31-57): fp32 logits, an exact
// online softmax with a running max in the log2 domain, probabilities cast
// to bf16 before the P.V product with fp32 accumulation, and the division by
// the row sum at the end.
//
// What bounds it: the tensor cores (4*N^2*64 flops per head on 4*N*64*2
// bytes, ~N/2 flops a byte at N = 1025 or 2049, above the card's ~295
// flop/byte ridge).
//
// The design is B2's first one, kept for this entry alone: one
// block of 4 warps per (64 queries, head, batch item), each warp owning 16
// query rows; Q staged once into shared memory and kept in registers as
// mma fragments; K and V through shared memory in tiles of 64 keys loaded
// synchronously; S = Q.K^T and O += P.V as bf16 mma.sync.m16n8k16 with fp32
// accumulators, P re-packed in registers as the A operand of P.V.
// Shared-memory rows are padded to 72 elements so the fragment loads are
// free of bank conflicts. The ragged last query and key tiles (N = 1025,
// 2049) are zero-filled on load; masked keys get -inf logits and padded
// query rows are never stored. B2 and B3 left it for the warp-specialised
// TMA + wgmma kernel of attention_qkv.cu; this entry waits for its own
// redesign.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

__global__ void __launch_bounds__(kThreads)
attention_qkv_rope_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          const float* __restrict__ cos, const float* __restrict__ sin, int n,
                          int heads, int stride_b, int stride_n, float scale_log2) {
  __shared__ __align__(16) bf16 sq[kBlock * kRow];
  __shared__ __align__(16) bf16 sk[kBlock * kRow];
  __shared__ __align__(16) bf16 sv[kBlock * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t head = static_cast<int64_t>(b) * stride_b + static_cast<int64_t>(h) * kHeadDim;

  load_tile(sq, q + head + static_cast<int64_t>(q0) * stride_n, stride_n, n - q0, tid);
  __syncthreads();
  rope_tile(sq, cos + static_cast<int64_t>(q0) * kHeadDim, sin + static_cast<int64_t>(q0) * kHeadDim,
            n - q0, tid);
  __syncthreads();

  // A fragments of this warp's 16 query rows, one per 16-wide d chunk.
  uint32_t qa[kDChunks][4];
  load_a_rows(qa, sq, warp, g, t);

  // Each thread holds rows r0 (index 0) and r0 + 8 (index 1).
  float o[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sk, k + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
    load_tile(sv, v + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
    __syncthreads();
    rope_tile(sk, cos + static_cast<int64_t>(k0) * kHeadDim,
              sin + static_cast<int64_t>(k0) * kHeadDim, n - k0, tid);
    __syncthreads();

    // S = Q.K^T for 16 rows x 64 keys.
    float s[kNTiles][4];
    mma_rows_t(s, qa, sk, g, t);

    // Online softmax in the log2 domain: x = logit * scale * log2(e).
    const int valid = n - k0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float x = col < valid ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P.V, with P taken from the S accumulators as bf16 A fragments.
    mma_acc_p(o, s, sv, g, t);
  }

  // The row sums so far are per thread; the quad of a row holds the rest.
  // The running max is already the same across the quad.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
  const int64_t out_row = static_cast<int64_t>(heads) * kHeadDim;
  store_rows(out + static_cast<int64_t>(b) * n * out_row + h * kHeadDim, out_row, row0, n, o,
             1.f / l[0], 1.f / l[1], t);
}

}  // namespace

// q, k, v: bf16 [batch, n, heads * 64] views sharing the element strides
// (stride_b, stride_n), unit stride along features, 16-byte aligned, in the
// evens|odds layout; cos and sin: contiguous fp32 [n, 64] tables (identity
// rows for the cls token), shared by every batch item and head. out:
// contiguous bf16 [batch, n, heads * 64]. Returns a cudaError_t.
extern "C" int vfmseg_attention_qkv_rope(const void* q, const void* k, const void* v, void* out,
                                         const void* cos, const void* sin, int batch, int n,
                                         int heads, int stride_b, int stride_n, float scale,
                                         void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  attention_qkv_rope_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<const float*>(cos), static_cast<const float*>(sin), n,
      heads, stride_b, stride_n, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
