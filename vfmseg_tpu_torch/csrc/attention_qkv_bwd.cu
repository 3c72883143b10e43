// Backward of the training attention (attention_qkv.cu, with LSE), for
// Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces the TPU kernels _bwd_dq_kernel_qkv and _bwd_dkv_kernel_qkv of
// vfmseg_tpu/ops/flash_attention.py (launched by _flash_backward_qkv_tm,
// reached through _flash_qkv_tm_bwd_rule). For every batch item b and head h,
// with S = q_h k_h^T (fp32), the forward's lse and the caller's
// delta = rowsum(dO_h * O_h):
//
//   P  = exp(S * scale - lse)            recomputed, never stored
//   dP = dO_h v_h^T
//   dS = P * (dP - delta) * scale
//   dq_h = dS k_h,   dk_h = dS^T q_h,   dv_h = P^T dO_h
//
// P and dS are rounded to bf16 before their products, as the TPU kernels
// round them, and accumulate in fp32. q/k/v are read as [B, N, H*64] bf16
// views sharing one (batch, token) stride pair, exactly as the forward reads
// them; dO is contiguous token-major [B, N, H*64], the layout the proj
// backward hands over; dq/dk/dv are written as [B, N, H*64] views sharing a
// second stride pair. The three thirds of one d(qkv) [B, N, 3*H*64] qualify,
// so the fused caller gets its gradient without a concatenation, and the
// decoder's three separate tensors qualify too.
//
// What bounds it: the tensor cores, as in the forward. Each kernel recomputes
// S and dP and does one (dq) or two (dk, dv) more products, each 2*N^2*64
// flops per head: 7 products in all against the forward's 2, on a few N*64
// vectors of bytes.
//
// What the design does about it: each output tile has one owner, so no
// kernel needs atomics and nothing is summed across blocks.
//
// * dq: one block of 4 warps per (64 queries, head, batch item); each warp
//   owns 16 query rows and keeps their Q and dO as mma A fragments in
//   registers, and their lse and delta in registers. K and V stream through
//   shared memory in tiles of 64 keys; S and dP come out of two m16n8k16
//   passes, and dS, packed to bf16 in registers, is the A operand of dq += dS.K
//   without touching shared memory. Keys >= N (the ragged last tile) get
//   P = 0.
// * dk/dv: one block per (64 keys, head, batch item); each warp owns 16 key
//   rows and keeps their K and V as A fragments. Q, dO and the 64 queries'
//   lse and delta stream through shared memory. The block computes S^T = K.Q^T
//   and dP^T = V.dO^T, so P^T and dS^T land in the A-operand layout of
//   dv += P^T.dO and dk += dS^T.Q. Query rows >= N (63 of the 64 rows of the
//   last tile at N = 1025) get P = dS = 0 explicitly, so padding adds nothing
//   to dk or dv.
//
// Left for later, as in the forward: wgmma, TMA, asynchronous copies and
// persistent blocks.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, int heads, int stride_b, int stride_n,
                        int gstride_b, int gstride_n, float scale, float scale_log2) {
  __shared__ __align__(16) bf16 sq[kBlock * kRow];
  __shared__ __align__(16) bf16 sdo[kBlock * kRow];
  __shared__ __align__(16) bf16 sk[kBlock * kRow];
  __shared__ __align__(16) bf16 sv[kBlock * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t head = static_cast<int64_t>(b) * stride_b + static_cast<int64_t>(h) * kHeadDim;
  const int64_t feat = static_cast<int64_t>(heads) * kHeadDim;
  const int64_t ohead = static_cast<int64_t>(b) * n * feat + static_cast<int64_t>(h) * kHeadDim;

  load_tile(sq, q + head + static_cast<int64_t>(q0) * stride_n, stride_n, n - q0, tid);
  load_tile(sdo, dout + ohead + static_cast<int64_t>(q0) * feat, feat, n - q0, tid);
  __syncthreads();
  uint32_t qa[kDChunks][4];
  uint32_t da[kDChunks][4];
  load_a_rows(qa, sq, warp, g, t);
  load_a_rows(da, sdo, warp, g, t);

  // lse (in the log2 domain) and delta of rows row0 and row0 + 8; padded rows
  // have zero Q and dO, so any finite value gives them dS = 0.
  const int row0 = q0 + warp * 16 + g;
  const float* lrow = lse + (static_cast<int64_t>(b) * heads + h) * n;
  const float* drow = delta + (static_cast<int64_t>(b) * heads + h) * n;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < n ? lrow[row] * kLog2e : 0.f;
    dl[r] = row < n ? drow[row] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlock) {
    __syncthreads();
    load_tile(sk, k + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
    load_tile(sv, v + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    float dp[kNTiles][4];
    mma_rows_t(s, qa, sk, g, t);   // S = Q.K^T
    mma_rows_t(dp, da, sv, g, t);  // dP = dO.V^T
    const int valid = n - k0;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p = col < valid ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]) * scale;  // dS
      }
    }
    mma_acc_p(acc, s, sk, g, t);  // dq += dS.K
  }

  store_rows(dq + static_cast<int64_t>(b) * gstride_b + h * kHeadDim, gstride_n, row0, n, acc,
             1.f, 1.f, t);
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int heads,
                         int stride_b, int stride_n, int gstride_b, int gstride_n, float scale,
                         float scale_log2) {
  __shared__ __align__(16) bf16 sk[kBlock * kRow];
  __shared__ __align__(16) bf16 sv[kBlock * kRow];
  __shared__ __align__(16) bf16 sq[kBlock * kRow];
  __shared__ __align__(16) bf16 sdo[kBlock * kRow];
  __shared__ float slse[kBlock];
  __shared__ float sdelta[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t head = static_cast<int64_t>(b) * stride_b + static_cast<int64_t>(h) * kHeadDim;
  const int64_t feat = static_cast<int64_t>(heads) * kHeadDim;
  const int64_t ohead = static_cast<int64_t>(b) * n * feat + static_cast<int64_t>(h) * kHeadDim;
  const float* lrow = lse + (static_cast<int64_t>(b) * heads + h) * n;
  const float* drow = delta + (static_cast<int64_t>(b) * heads + h) * n;

  load_tile(sk, k + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
  load_tile(sv, v + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
  __syncthreads();
  uint32_t ka[kDChunks][4];
  uint32_t va[kDChunks][4];
  load_a_rows(ka, sk, warp, g, t);
  load_a_rows(va, sv, warp, g, t);

  float dk_acc[kDTiles][4];
  float dv_acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile(sq, q + head + static_cast<int64_t>(q0) * stride_n, stride_n, n - q0, tid);
    load_tile(sdo, dout + ohead + static_cast<int64_t>(q0) * feat, feat, n - q0, tid);
    if (tid < kBlock) {
      const int row = q0 + tid;
      slse[tid] = row < n ? lrow[row] * kLog2e : 0.f;
      sdelta[tid] = row < n ? drow[row] : 0.f;
    }
    __syncthreads();

    float s[kNTiles][4];   // S^T: rows are keys, columns queries
    float dp[kNTiles][4];  // dP^T
    mma_rows_t(s, ka, sq, g, t);   // S^T = K.Q^T
    mma_rows_t(dp, va, sdo, g, t); // dP^T = V.dO^T
    const int valid = n - q0;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = 0.f;
        float ds = 0.f;
        if (col < valid) {
          p = exp2f(s[nt][e] * scale_log2 - slse[col]);
          ds = p * (dp[nt][e] - sdelta[col]) * scale;
        }
        s[nt][e] = p;
        dp[nt][e] = ds;
      }
    }
    mma_acc_p(dv_acc, s, sdo, g, t);  // dv += P^T.dO
    mma_acc_p(dk_acc, dp, sq, g, t);  // dk += dS^T.Q
  }

  const int row0 = k0 + warp * 16 + g;
  const int64_t gbase = static_cast<int64_t>(b) * gstride_b + h * kHeadDim;
  store_rows(dk + gbase, gstride_n, row0, n, dk_acc, 1.f, 1.f, t);
  store_rows(dv + gbase, gstride_n, row0, n, dv_acc, 1.f, 1.f, t);
}

}  // namespace

// q, k, v: bf16 [batch, n, heads * 64] views sharing the element strides
// (stride_b, stride_n), as the forward took them; dout: contiguous bf16
// [batch, n, heads * 64]; lse (natural log) and delta: contiguous fp32
// [batch, heads, n]; dq: bf16 [batch, n, heads * 64] view with strides
// (gstride_b, gstride_n), unit stride along features. Returns a cudaError_t.
extern "C" int vfmseg_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int batch, int n, int heads, int stride_b,
                                       int stride_n, int gstride_b, int gstride_n, float scale,
                                       void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  attention_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n, heads, stride_b, stride_n,
      gstride_b, gstride_n, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// As vfmseg_attention_bwd_dq, writing dk and dv: two bf16 views that share
// the strides (gstride_b, gstride_n).
extern "C" int vfmseg_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, int batch, int n, int heads,
                                        int stride_b, int stride_n, int gstride_b, int gstride_n,
                                        float scale, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  attention_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n,
      heads, stride_b, stride_n, gstride_b, gstride_n, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
