// Attention read straight from q/k/v projections, for Hopper (sm_90a): the
// inference forward and the training forward with its log-sum-exp.
//
// Replaces two TPU kernels of vfmseg_tpu/ops/flash_attention.py:
//
// * vfmseg_attention_qkv: _fwd_kernel_qkv_tav (launched by
//   _flash_forward_qkv_tav_main, entry flash_attention_qkv_tm), the inference
//   primal;
// * vfmseg_attention_qkv_rope: the same kernel with rope=True, EVA02's
//   inference attention. Two fp32 [N, 64] tables cos/sin in the evens|odds
//   layout of vfmseg_tpu/ops/rope.py rotate q and k in shared memory
//   (rope_tile, attention_common.cuh): the staged Q tile once before its mma
//   fragments are read, each K tile after it lands, both from bf16 in fp32,
//   rounded once to bf16. The TPU kernel folds scale * log2 e into q before
//   rotating and rotates k in bf16 arithmetic; the port's numerics are those of
//   its plain twin (ops/attention.py attention_qkv_rope_plain), which rotates
//   both in fp32 and rounds.
// * vfmseg_attention_qkv_fwd_lse: _fwd_kernel_qkv (launched by
//   _flash_forward_qkv with with_lse=True, reached through
//   _flash_qkv_tm_fwd_rule), the training forward. It also writes, per batch
//   item, head and query row, lse = log(sum_k exp(q.k * scale)) in fp32 and
//   natural log, which the fused backward (attention_hm.cu) reads.
//
// For every batch item b and head h:
//
//   out[b, :, h*64:(h+1)*64] = softmax(q_h k_h^T * scale) v_h
//
// where q_h, k_h, v_h are the 64 columns of head h in three [B, N, H*64] bf16
// views that share one (batch, token) stride pair. The three thirds of one
// fused qkv tensor (token stride 3*H*64) and three separate tensors (token
// stride H*64) both qualify, so neither caller concatenates. The output is
// token-major [B, N, H*64] bf16, the layout the proj matmul reads; the LSE is
// [B, H, N] fp32. (The TPU training forward stores head-major and transposes
// after; that answered a TPU store-layout limit and is not copied.)
//
// Numerics follow xla_attention (vfmseg_tpu/ops/attention.py:31-57): fp32
// logits, an exact softmax with a running max (online softmax), probabilities
// cast to bf16 before the P.V product with fp32 accumulation, and the division
// by the row sum at the end. The running max and sum live in the log2 domain
// (x = logit * scale * log2 e), so lse = (m + log2 l) * ln 2. None of the TPU
// kernels' schedule (no-max exp2 softmax, transposed AV, head pairs, batch
// packing, the aligned-tail cls side-chain) is carried over: each answered a
// TPU lane or VMEM limit.
//
// What bounds it: the tensor cores. Per head it does 4*N^2*64 flops on
// 4*N*64*2 bytes, ~N/2 flops per byte (N = 1025 or 2049 on the main paths),
// well above the card's ~295 flop/byte ridge, while the N x N scores and
// probabilities, which would dominate the bytes if they were stored, never
// leave the SM.
//
// What the design does about it: one block of 4 warps per (64 queries, head,
// batch item); each warp owns 16 query rows. Q is staged once into shared
// memory and kept in registers as mma fragments; K and V go through shared
// memory in tiles of 64 keys. S = Q.K^T and O += P.V run as bf16
// mma.sync.m16n8k16 with fp32 accumulators, and the S accumulator is
// re-packed in registers as the A operand of P.V, so P never touches shared
// memory. Shared-memory rows are padded to 72 elements so the fragment loads
// are free of bank conflicts. The ragged last query and key tiles (N = 1025,
// 2049) are zero-filled on load; masked keys get -inf logits and padded
// query rows are never stored.
//
// Left for later: wgmma, TMA and asynchronous copies to overlap the K/V
// loads with the products, warp specialisation and persistent blocks.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

template <bool kWithLse, bool kRope>
__global__ void __launch_bounds__(kThreads)
attention_qkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, const float* __restrict__ cos,
                     const float* __restrict__ sin, int n, int heads, int stride_b,
                     int stride_n, float scale_log2) {
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
  if constexpr (kRope) {
    rope_tile(sq, cos + static_cast<int64_t>(q0) * kHeadDim, sin + static_cast<int64_t>(q0) * kHeadDim,
              n - q0, tid);
    __syncthreads();
  }

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
    if constexpr (kRope) {
      rope_tile(sk, cos + static_cast<int64_t>(k0) * kHeadDim,
                sin + static_cast<int64_t>(k0) * kHeadDim, n - k0, tid);
      __syncthreads();
    }

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
  if constexpr (kWithLse) {
    if (t == 0) {
      float* lrow = lse + (static_cast<int64_t>(b) * heads + h) * n;
      if (row0 < n) lrow[row0] = (m[0] + log2f(l[0])) * kLn2;
      if (row0 + 8 < n) lrow[row0 + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
}

template <bool kWithLse, bool kRope>
int launch_forward(const void* q, const void* k, const void* v, void* out, float* lse,
                   const void* cos, const void* sin, int batch, int n, int heads, int stride_b,
                   int stride_n, float scale, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  attention_qkv_kernel<kWithLse, kRope><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, static_cast<const float*>(cos),
      static_cast<const float*>(sin), n, heads, stride_b, stride_n, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 [batch, n, heads * 64] views sharing the element strides
// (stride_b, stride_n), unit stride along features, 16-byte aligned.
// out: contiguous bf16 [batch, n, heads * 64]. Returns a cudaError_t.
extern "C" int vfmseg_attention_qkv(const void* q, const void* k, const void* v, void* out,
                                    int batch, int n, int heads, int stride_b, int stride_n,
                                    float scale, void* stream) {
  return launch_forward<false, false>(q, k, v, out, nullptr, nullptr, nullptr, batch, n, heads,
                                      stride_b, stride_n, scale, stream);
}

// As vfmseg_attention_qkv, with q and k rotated by 2D RoPE: cos and sin are
// contiguous fp32 [n, 64] tables in the evens|odds layout (identity rows for
// the cls token), shared by every batch item and head.
extern "C" int vfmseg_attention_qkv_rope(const void* q, const void* k, const void* v, void* out,
                                         const void* cos, const void* sin, int batch, int n,
                                         int heads, int stride_b, int stride_n, float scale,
                                         void* stream) {
  return launch_forward<false, true>(q, k, v, out, nullptr, cos, sin, batch, n, heads, stride_b,
                                     stride_n, scale, stream);
}

// As vfmseg_attention_qkv, and lse: contiguous fp32 [batch, heads, n], the
// natural-log log-sum-exp of each row of scaled logits.
extern "C" int vfmseg_attention_qkv_fwd_lse(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int batch, int n, int heads,
                                            int stride_b, int stride_n, float scale,
                                            void* stream) {
  return launch_forward<true, false>(q, k, v, out, static_cast<float*>(lse), nullptr, nullptr,
                                     batch, n, heads, stride_b, stride_n, scale, stream);
}

// Text of a status code returned by any entry of this library.
extern "C" const char* vfmseg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
