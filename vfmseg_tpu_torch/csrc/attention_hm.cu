// General flash attention over per-head views with their own strides, for
// Hopper (sm_90a): a forward that may write the log-sum-exp, and the two
// backward kernels, dq and dk/dv.
//
// Replaces the TPU kernels _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel of
// vfmseg_tpu/ops/flash_attention.py, as launched by _flash_forward_hm and
// _flash_backward_hm (the custom VJP of flash_attention_headmajor, EVA02's
// training attention) and by _flash_forward / _flash_backward (the [B, N, H, D]
// entry, cross-attention at unmatched lengths). The additive bias and its
// dbias output (impl="pallas_bias", SAM training) are not ported here.
//
// For every batch item b and head h, with q_h [Nq, 64], k_h and v_h [Nk, 64]:
//
//   forward:  S = q_h k_h^T * scale (fp32),  out_h = softmax(S) v_h,
//             lse_h = log(sum_k exp(S))     (natural log, fp32, optional)
//   backward: P = exp(q_h k_h^T * scale - lse_h),  dP = dO_h v_h^T,
//             dS = P * (dP - delta_h) * scale,  delta_h = rowsum(dO_h * out_h)
//             dq_h = dS k_h,  dk_h = dS^T q_h,  dv_h = P^T dO_h
//
// Numerics are the TPU kernels' B5 numerics, not B3's: the scale multiplies the
// fp32 logits, the softmax runs with a natural exp and a running max, and the
// backward recomputes P from the natural-log LSE with no pre-scaled q
// (exp2_scale_q=False). P and dS round to bf16 before their products, which
// accumulate in fp32.
//
// Layout: every tensor is a [B, H, N, 64] bf16 view with its own element
// strides (batch, head, token) and unit stride along the head dim, so the
// training route hands in the token-major outputs of its three projections
// as [B, N, H, 64] views with no transpose, and gets the output and the
// gradients back in the same layout. Nq and Nk are separate. lse and delta are
// contiguous fp32 [B, H, Nq].
//
// What bounds it: the tensor cores. The forward does 4*Nq*Nk*64 flops per head
// (2 products), dq 6*Nq*Nk*64 (3) and dk/dv 8*Nq*Nk*64 (4, with S and dP
// recomputed), on a few N*64 vectors of bytes: ~N/2 flops per byte at
// N = 1025, above the card's ~295 flop/byte ridge.
//
// What the design does about it: the tiles, fragments and products of B3/B4
// (attention_common.cuh): one block of 4 warps per (64 rows, head, batch item),
// 16 rows a warp, bf16 mma.sync.m16n8k16 with fp32 accumulators, P and dS
// re-packed in registers as the A operand of the next product, so the
// Nq x Nk scores never leave the SM. Each output tile has one owner: dq is
// owned by (query tile, head), dk/dv by (key tile, head), so no atomics and
// nothing is summed across blocks. Ragged tiles in both lengths are
// zero-filled on load: keys >= Nk get P = 0; in dk/dv, query rows >= Nq (63 of
// the 64 rows of the last tile at Nq = 1025) get P = dS = 0 explicitly, so the
// padding adds nothing to dk or dv; padded rows are never stored.
//
// Left for later, as in B3/B4: wgmma, TMA, asynchronous copies and persistent
// blocks.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

// Element strides of one [B, H, N, 64] view.
struct View {
  int64_t b, h, n;
};

// The arguments of all three kernels. Unused pointers are null.
struct HmArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;   // backward: dO
  bf16* out;          // forward: the output; dq kernel: dq; dk/dv kernel: dk
  bf16* out2;         // dk/dv kernel: dv
  float* lse;         // forward: written when non-null; backward: read
  const float* delta; // backward
  View sq, sk, sv, sdo, so, so2;
  int heads, nq, nk;
  float scale;
};

__device__ __forceinline__ const bf16* at(const bf16* p, const View& s, int b, int h, int row) {
  return p + b * s.b + h * s.h + static_cast<int64_t>(row) * s.n;
}

__device__ __forceinline__ bf16* at(bf16* p, const View& s, int b, int h, int row) {
  return p + b * s.b + h * s.h + static_cast<int64_t>(row) * s.n;
}

__global__ void __launch_bounds__(kThreads) attention_hm_fwd_kernel(const HmArgs a) {
  __shared__ __align__(16) bf16 sq[kBlock * kRow];
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

  load_tile(sq, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
  __syncthreads();
  uint32_t qa[kDChunks][4];
  load_a_rows(qa, sq, warp, g, t);

  float o[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.nk; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
    load_tile(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    mma_rows_t(s, qa, sk, g, t);  // S = Q.K^T, 16 rows x 64 keys

    // Online softmax with a natural exp: logits scaled in fp32, masked keys
    // at -inf; the first tile always holds a real key, so m is finite after it.
    const int valid = a.nk - k0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float x = col < valid ? s[nt][e] * a.scale : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    mma_acc_p(o, s, sv, g, t);  // O += P.V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
  store_rows(at(a.out, a.so, b, h, 0), a.so.n, row0, a.nq, o, 1.f / l[0], 1.f / l[1], t);
  if (a.lse != nullptr && t == 0) {
    float* lrow = a.lse + (static_cast<int64_t>(b) * a.heads + h) * a.nq;
    if (row0 < a.nq) lrow[row0] = m[0] + logf(l[0]);
    if (row0 + 8 < a.nq) lrow[row0 + 8] = m[1] + logf(l[1]);
  }
}

__global__ void __launch_bounds__(kThreads) attention_hm_dq_kernel(const HmArgs a) {
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

  load_tile(sq, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
  load_tile(sdo, at(a.dout, a.sdo, b, h, q0), a.sdo.n, a.nq - q0, tid);
  __syncthreads();
  uint32_t qa[kDChunks][4];
  uint32_t da[kDChunks][4];
  load_a_rows(qa, sq, warp, g, t);
  load_a_rows(da, sdo, warp, g, t);

  // lse and delta of rows row0 and row0 + 8; padded rows have zero Q and dO
  // and are never stored, so any finite value serves them.
  const int row0 = q0 + warp * 16 + g;
  const float* lrow = a.lse + (static_cast<int64_t>(b) * a.heads + h) * a.nq;
  const float* drow = a.delta + (static_cast<int64_t>(b) * a.heads + h) * a.nq;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < a.nq ? lrow[row] : 0.f;
    dl[r] = row < a.nq ? drow[row] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < a.nk; k0 += kBlock) {
    __syncthreads();
    load_tile(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
    load_tile(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    float dp[kNTiles][4];
    mma_rows_t(s, qa, sk, g, t);   // S = Q.K^T
    mma_rows_t(dp, da, sv, g, t);  // dP = dO.V^T
    const int valid = a.nk - k0;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p = col < valid ? __expf(s[nt][e] * a.scale - lse[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]) * a.scale;  // dS
      }
    }
    mma_acc_p(acc, s, sk, g, t);  // dq += dS.K
  }

  store_rows(at(a.out, a.so, b, h, 0), a.so.n, row0, a.nq, acc, 1.f, 1.f, t);
}

__global__ void __launch_bounds__(kThreads) attention_hm_dkv_kernel(const HmArgs a) {
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
  const float* lrow = a.lse + (static_cast<int64_t>(b) * a.heads + h) * a.nq;
  const float* drow = a.delta + (static_cast<int64_t>(b) * a.heads + h) * a.nq;

  load_tile(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
  load_tile(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
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

  for (int q0 = 0; q0 < a.nq; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile(sq, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
    load_tile(sdo, at(a.dout, a.sdo, b, h, q0), a.sdo.n, a.nq - q0, tid);
    if (tid < kBlock) {
      const int row = q0 + tid;
      slse[tid] = row < a.nq ? lrow[row] : 0.f;
      sdelta[tid] = row < a.nq ? drow[row] : 0.f;
    }
    __syncthreads();

    float s[kNTiles][4];   // S^T: rows are keys, columns queries
    float dp[kNTiles][4];  // dP^T
    mma_rows_t(s, ka, sq, g, t);    // S^T = K.Q^T
    mma_rows_t(dp, va, sdo, g, t);  // dP^T = V.dO^T
    const int valid = a.nq - q0;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = 0.f;
        float ds = 0.f;
        if (col < valid) {
          p = __expf(s[nt][e] * a.scale - slse[col]);
          ds = p * (dp[nt][e] - sdelta[col]) * a.scale;
        }
        s[nt][e] = p;
        dp[nt][e] = ds;
      }
    }
    mma_acc_p(dv_acc, s, sdo, g, t);  // dv += P^T.dO
    mma_acc_p(dk_acc, dp, sq, g, t);  // dk += dS^T.Q
  }

  const int row0 = k0 + warp * 16 + g;
  store_rows(at(a.out, a.so, b, h, 0), a.so.n, row0, a.nk, dk_acc, 1.f, 1.f, t);
  store_rows(at(a.out2, a.so2, b, h, 0), a.so2.n, row0, a.nk, dv_acc, 1.f, 1.f, t);
}

// strides: 3 int64 (batch, head, token) per view, in the order the entry
// names its views.
View view(const long long* s, int i) { return View{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

HmArgs args(const void* q, const void* k, const void* v, const long long* strides, int heads,
            int nq, int nk, float scale) {
  HmArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sq = view(strides, 0);
  a.sk = view(strides, 1);
  a.sv = view(strides, 2);
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.scale = scale;
  return a;
}

}  // namespace

// Forward. q [B, H, nq, 64], k and v [B, H, nk, 64], out [B, H, nq, 64]: bf16
// views with unit stride along the head dim, 16-byte aligned rows; strides
// holds 12 int64: (batch, head, token) of q, k, v, out. lse: contiguous fp32
// [B, H, nq], written when non-null. Returns a cudaError_t.
extern "C" int vfmseg_attention_hm_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const long long* strides, int batch, int heads,
                                       int nq, int nk, float scale, void* stream) {
  HmArgs a = args(q, k, v, strides, heads, nq, nk, scale);
  a.out = static_cast<bf16*>(out);
  a.so = view(strides, 3);
  a.lse = static_cast<float*>(lse);
  const dim3 grid((nq + kBlock - 1) / kBlock, heads, batch);
  attention_hm_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dq. q, k, v as the forward took them; dout [B, H, nq, 64]; lse and delta
// contiguous fp32 [B, H, nq]; dq [B, H, nq, 64]. strides: 15 int64 for q, k, v,
// dout, dq. Returns a cudaError_t.
extern "C" int vfmseg_attention_hm_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, const long long* strides, int batch, int heads,
                                      int nq, int nk, float scale, void* stream) {
  HmArgs a = args(q, k, v, strides, heads, nq, nk, scale);
  a.dout = static_cast<const bf16*>(dout);
  a.sdo = view(strides, 3);
  a.out = static_cast<bf16*>(dq);
  a.so = view(strides, 4);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  const dim3 grid((nq + kBlock - 1) / kBlock, heads, batch);
  attention_hm_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv. Arguments as vfmseg_attention_hm_dq, writing dk and dv
// [B, H, nk, 64]; strides: 18 int64 for q, k, v, dout, dk, dv.
extern "C" int vfmseg_attention_hm_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, const long long* strides, int batch,
                                       int heads, int nq, int nk, float scale, void* stream) {
  HmArgs a = args(q, k, v, strides, heads, nq, nk, scale);
  a.dout = static_cast<const bf16*>(dout);
  a.sdo = view(strides, 3);
  a.out = static_cast<bf16*>(dk);
  a.so = view(strides, 4);
  a.out2 = static_cast<bf16*>(dv);
  a.so2 = view(strides, 5);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  const dim3 grid((nk + kBlock - 1) / kBlock, heads, batch);
  attention_hm_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
