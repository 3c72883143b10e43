// General flash attention over per-head views with their own strides, for
// Hopper (sm_90a): a forward that may write the log-sum-exp, and the two
// backward kernels, dq and dk/dv, each with an optional additive bias.
//
// Replaces the TPU kernels _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel of
// vfmseg_tpu/ops/flash_attention.py, as launched by _flash_forward_hm and
// _flash_backward_hm (the custom VJP of flash_attention_headmajor, EVA02's
// training attention), by _flash_forward / _flash_backward (the [B, N, H, D]
// entry, cross-attention at unmatched lengths) and, with has_bias, by the VJP
// _flash_bias of flash_attention(bias=) (impl="pallas_bias": SAM's blocks with
// the materialised rel-pos bias, inference and training).
//
// For every batch item b and head h, with q_h [Nq, D], k_h and v_h [Nk, D]
// and bias_h [Nq, Nk] (zero without a bias):
//
//   forward:  S = q_h k_h^T * scale + bias_h (fp32),  out_h = softmax(S) v_h,
//             lse_h = log(sum_k exp(S))     (natural log, fp32, optional)
//   backward: P = exp(S - lse_h),  dP = dO_h v_h^T,  delta_h = rowsum(dO_h * out_h)
//             dbias_h = P * (dP - delta_h)  (fp32, the dq kernel writes it)
//             dS = dbias_h * scale,  dq_h = dS k_h,  dk_h = dS^T q_h,  dv_h = P^T dO_h
//
// Numerics are the TPU kernels' B5 numerics, not B3's: the scale multiplies the
// fp32 logits and the bias is added after it (flash_attention.py:316-318,
// :385-388), the softmax runs with a natural exp and a running max (the exact
// softmax of xla_attention, not the TPU primal's no-max exp2 one), and the
// backward recomputes P from the natural-log LSE with no pre-scaled q. P and dS
// round to bf16 before their products, which accumulate in fp32.
//
// Layout: q, k, v, dO and the outputs are [B, H, N, D] bf16 views with their
// own element strides (batch, head, token) and unit stride along the head dim,
// so the training route hands in the token-major outputs of its projections as
// [B, N, H, D] views with no transpose, and SAM's route its q, k, v as views of
// one fused qkv tensor. D is 64 or 80 (SAM ViT-H), a template parameter. Nq and
// Nk are separate. lse and delta are contiguous fp32 [B, H, Nq]. The bias is a
// [B, H, Nq, Nk] bf16 or fp32 view with unit stride along Nk and any other
// strides (0 for a dimension it is broadcast over); dbias is contiguous fp32
// [B, H, Nq, Nk].
//
// What bounds it: without a bias, the tensor cores: the forward does
// 4*Nq*Nk*D flops per head (2 products), dq 6*Nq*Nk*D (3) and dk/dv 8*Nq*Nk*D
// (4, with S and dP recomputed), on a few N*D vectors of bytes: ~N/2 flops per
// byte at N = 1025, above the card's ~295 flop/byte ridge. With a bias, its
// bytes: every score reads 2 (bf16) bias bytes in each kernel and the dq kernel
// writes 4 dbias bytes, against 2*2*D..4*2*D flops a score: 80-160 flops per
// byte at D = 80, under the ridge.
//
// What the design does about it: the tiles, fragments and products of B3/B4
// (attention_common.cuh), one block of 4 warps per (64 rows, head, batch item),
// 16 rows a warp, bf16 mma.sync.m16n8k16 with fp32 accumulators, P and dS
// re-packed in registers as the A operand of the next product, so the Nq x Nk
// scores never leave the SM. Each thread reads the bias of the scores it owns
// in its fragment straight from device memory and adds it in fp32, so each bias
// element is read once per kernel. Each output tile has one owner: dq and the
// [64, Nk] rows of dbias are owned by (query tile, head), dk/dv by (key tile,
// head), so no atomics and nothing is summed across blocks. Ragged tiles in
// both lengths are zero-filled on load: keys >= Nk get P = 0 and no bias read;
// in dk/dv, query rows >= Nq get P = dS = 0 explicitly, so the padding adds
// nothing to dk or dv; padded rows and key columns are never stored, dbias's
// included (Nk = 196 in SAM's windows is ragged).
//
// Left for later, as in B3/B4: wgmma, TMA, asynchronous copies and persistent
// blocks; the bias read in 16-byte vectors through shared memory.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

// The bias operand: none, bf16 or fp32.
enum BiasKind { kNoBias = 0, kBiasBf16 = 1, kBiasF32 = 2 };

// The arguments of all three kernels. Unused pointers are null.
struct HmArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;   // backward: dO
  const void* bias;   // [B, H, Nq, Nk] view, unit stride along Nk
  bf16* out;          // forward: the output; dq kernel: dq; dk/dv kernel: dk
  bf16* out2;         // dk/dv kernel: dv
  float* dbias;       // dq kernel with a bias: contiguous fp32 [B, H, Nq, Nk]
  float* lse;         // forward: written when non-null; backward: read
  const float* delta; // backward
  View sq, sk, sv, sdo, so, so2, sb;
  int heads, nq, nk;
  float scale;
};

// bias[b, h, row, col] as fp32.
template <int kBias>
__device__ __forceinline__ float bias_at(const HmArgs& a, int b, int h, int row, int col) {
  const int64_t off = b * a.sb.b + h * a.sb.h + static_cast<int64_t>(row) * a.sb.n + col;
  if constexpr (kBias == kBiasBf16) {
    return __bfloat162float(static_cast<const bf16*>(a.bias)[off]);
  } else {
    return static_cast<const float*>(a.bias)[off];
  }
}

template <int D, int kBias>
__global__ void __launch_bounds__(kThreads) attention_hm_fwd_kernel(const HmArgs a) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 sq[Dm::kTileElems];
  __shared__ __align__(16) bf16 sk[Dm::kTileElems];
  __shared__ __align__(16) bf16 sv[Dm::kTileElems];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  load_tile_d<D>(sq, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
  __syncthreads();
  uint32_t qa[Dm::kChunks][4];
  load_a_rows_d<D>(qa, sq, warp, g, t);

  float o[Dm::kTiles][4];
#pragma unroll
  for (int i = 0; i < Dm::kTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.nk; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_d<D>(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
    load_tile_d<D>(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    mma_scores<D>(s, qa, sk, g, t);  // S = Q.K^T, 16 rows x 64 keys

    // Online softmax with a natural exp: logits scaled in fp32, the bias
    // added, masked keys at -inf; the first tile always holds a real key, so
    // m is finite after it (the bias is finite).
    const int valid = a.nk - k0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        float x = -INFINITY;
        if (col < valid) {
          x = s[nt][e] * a.scale;
          if constexpr (kBias != kNoBias) {
            if (row < a.nq) x += bias_at<kBias>(a, b, h, row, k0 + col);
          }
        }
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
    for (int dt = 0; dt < Dm::kTiles; ++dt) {
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
  store_rows_d<D>(at(a.out, a.so, b, h, 0), a.so.n, row0, a.nq, o, 1.f / l[0], 1.f / l[1], t);
  if (a.lse != nullptr && t == 0) {
    float* lrow = a.lse + (static_cast<int64_t>(b) * a.heads + h) * a.nq;
    if (row0 < a.nq) lrow[row0] = m[0] + logf(l[0]);
    if (row0 + 8 < a.nq) lrow[row0 + 8] = m[1] + logf(l[1]);
  }
}

template <int D, int kBias>
__global__ void __launch_bounds__(kThreads) attention_hm_dq_kernel(const HmArgs a) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 sq[Dm::kTileElems];
  __shared__ __align__(16) bf16 sdo[Dm::kTileElems];
  __shared__ __align__(16) bf16 sk[Dm::kTileElems];
  __shared__ __align__(16) bf16 sv[Dm::kTileElems];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  load_tile_d<D>(sq, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
  load_tile_d<D>(sdo, at(a.dout, a.sdo, b, h, q0), a.sdo.n, a.nq - q0, tid);
  __syncthreads();
  uint32_t qa[Dm::kChunks][4];
  uint32_t da[Dm::kChunks][4];
  load_a_rows_d<D>(qa, sq, warp, g, t);
  load_a_rows_d<D>(da, sdo, warp, g, t);

  // lse and delta of rows row0 and row0 + 8; padded rows have zero Q and dO
  // and are never stored, so any finite value serves them.
  const int row0 = q0 + warp * 16 + g;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const float* lrow = a.lse + bh * a.nq;
  const float* drow = a.delta + bh * a.nq;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < a.nq ? lrow[row] : 0.f;
    dl[r] = row < a.nq ? drow[row] : 0.f;
  }
  float* dbias = kBias != kNoBias ? a.dbias + bh * a.nq * a.nk : nullptr;

  float acc[Dm::kTiles][4];
#pragma unroll
  for (int i = 0; i < Dm::kTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < a.nk; k0 += kBlock) {
    __syncthreads();
    load_tile_d<D>(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
    load_tile_d<D>(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    float dp[kNTiles][4];
    mma_scores<D>(s, qa, sk, g, t);   // S = Q.K^T
    mma_scores<D>(dp, da, sv, g, t);  // dP = dO.V^T
    const int valid = a.nk - k0;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        float ds = 0.f;
        if (col < valid) {
          float x = s[nt][e] * a.scale;
          if constexpr (kBias != kNoBias) {
            if (row < a.nq) x += bias_at<kBias>(a, b, h, row, k0 + col);
          }
          ds = __expf(x - lse[e >> 1]) * (dp[nt][e] - dl[e >> 1]);  // dbias
          if constexpr (kBias != kNoBias) {
            if (row < a.nq) dbias[static_cast<int64_t>(row) * a.nk + k0 + col] = ds;
          }
        }
        s[nt][e] = ds * a.scale;  // dS
      }
    }
    mma_pv<D>(acc, s, sk, g, t);  // dq += dS.K
  }

  store_rows_d<D>(at(a.out, a.so, b, h, 0), a.so.n, row0, a.nq, acc, 1.f, 1.f, t);
}

template <int D, int kBias>
__global__ void __launch_bounds__(kThreads) attention_hm_dkv_kernel(const HmArgs a) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 sk[Dm::kTileElems];
  __shared__ __align__(16) bf16 sv[Dm::kTileElems];
  __shared__ __align__(16) bf16 sq[Dm::kTileElems];
  __shared__ __align__(16) bf16 sdo[Dm::kTileElems];
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
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float* lrow = a.lse + (static_cast<int64_t>(b) * a.heads + h) * a.nq;
  const float* drow = a.delta + (static_cast<int64_t>(b) * a.heads + h) * a.nq;

  load_tile_d<D>(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
  load_tile_d<D>(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
  __syncthreads();
  uint32_t ka[Dm::kChunks][4];
  uint32_t va[Dm::kChunks][4];
  load_a_rows_d<D>(ka, sk, warp, g, t);
  load_a_rows_d<D>(va, sv, warp, g, t);

  float dk_acc[Dm::kTiles][4];
  float dv_acc[Dm::kTiles][4];
#pragma unroll
  for (int i = 0; i < Dm::kTiles; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < a.nq; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile_d<D>(sq, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
    load_tile_d<D>(sdo, at(a.dout, a.sdo, b, h, q0), a.sdo.n, a.nq - q0, tid);
    if (tid < kBlock) {
      const int row = q0 + tid;
      slse[tid] = row < a.nq ? lrow[row] : 0.f;
      sdelta[tid] = row < a.nq ? drow[row] : 0.f;
    }
    __syncthreads();

    float s[kNTiles][4];   // S^T: rows are keys, columns queries
    float dp[kNTiles][4];  // dP^T
    mma_scores<D>(s, ka, sq, g, t);    // S^T = K.Q^T
    mma_scores<D>(dp, va, sdo, g, t);  // dP^T = V.dO^T
    const int valid = a.nq - q0;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        float p = 0.f;
        float ds = 0.f;
        if (col < valid) {
          float x = s[nt][e] * a.scale;
          if constexpr (kBias != kNoBias) {
            if (key < a.nk) x += bias_at<kBias>(a, b, h, q0 + col, key);
          }
          p = __expf(x - slse[col]);
          ds = p * (dp[nt][e] - sdelta[col]) * a.scale;
        }
        s[nt][e] = p;
        dp[nt][e] = ds;
      }
    }
    mma_pv<D>(dv_acc, s, sdo, g, t);  // dv += P^T.dO
    mma_pv<D>(dk_acc, dp, sq, g, t);  // dk += dS^T.Q
  }

  store_rows_d<D>(at(a.out, a.so, b, h, 0), a.so.n, key0, a.nk, dk_acc, 1.f, 1.f, t);
  store_rows_d<D>(at(a.out2, a.so2, b, h, 0), a.so2.n, key0, a.nk, dv_acc, 1.f, 1.f, t);
}

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

enum Which { kFwd, kDq, kDkv };

template <int D, int kBias>
void launch_kernel(Which which, const HmArgs& a, dim3 grid, cudaStream_t stream) {
  if (which == kFwd) attention_hm_fwd_kernel<D, kBias><<<grid, kThreads, 0, stream>>>(a);
  if (which == kDq) attention_hm_dq_kernel<D, kBias><<<grid, kThreads, 0, stream>>>(a);
  if (which == kDkv) attention_hm_dkv_kernel<D, kBias><<<grid, kThreads, 0, stream>>>(a);
}

template <int D>
void launch_d(Which which, int bias_kind, const HmArgs& a, dim3 grid, cudaStream_t stream) {
  if (bias_kind == kNoBias) launch_kernel<D, kNoBias>(which, a, grid, stream);
  if (bias_kind == kBiasBf16) launch_kernel<D, kBiasBf16>(which, a, grid, stream);
  if (bias_kind == kBiasF32) launch_kernel<D, kBiasF32>(which, a, grid, stream);
}

// Launch one kernel over a grid of (tiles of `rows`, heads, batch); returns a
// cudaError_t.
int launch(Which which, int head_dim, int bias_kind, const HmArgs& a, int rows, int batch,
           void* stream) {
  if (bias_kind < kNoBias || bias_kind > kBiasF32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kBlock - 1) / kBlock, a.heads, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    launch_d<64>(which, bias_kind, a, grid, s);
  } else if (head_dim == 80) {
    launch_d<80>(which, bias_kind, a, grid, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

HmArgs fwd_args(const void* q, const void* k, const void* v, void* out, void* lse,
                const long long* strides, int heads, int nq, int nk, float scale) {
  HmArgs a = args(q, k, v, strides, heads, nq, nk, scale);
  a.out = static_cast<bf16*>(out);
  a.so = view(strides, 3);
  a.lse = static_cast<float*>(lse);
  return a;
}

HmArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const long long* strides, int heads, int nq, int nk,
                float scale) {
  HmArgs a = args(q, k, v, strides, heads, nq, nk, scale);
  a.dout = static_cast<const bf16*>(dout);
  a.sdo = view(strides, 3);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  return a;
}

}  // namespace

// Forward. q [B, H, nq, D], k and v [B, H, nk, D], out [B, H, nq, D]: bf16
// views with unit stride along the head dim, 16-byte aligned rows; strides
// holds 12 int64: (batch, head, token) of q, k, v, out. lse: contiguous fp32
// [B, H, nq], written when non-null. head_dim: 64 or 80. Returns a
// cudaError_t.
extern "C" int vfmseg_attention_hm_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const long long* strides, int batch, int heads,
                                       int nq, int nk, int head_dim, float scale, void* stream) {
  const HmArgs a = fwd_args(q, k, v, out, lse, strides, heads, nq, nk, scale);
  return launch(kFwd, head_dim, kNoBias, a, nq, batch, stream);
}

// dq. q, k, v as the forward took them; dout [B, H, nq, D]; lse and delta
// contiguous fp32 [B, H, nq]; dq [B, H, nq, D]. strides: 15 int64 for q, k, v,
// dout, dq. Returns a cudaError_t.
extern "C" int vfmseg_attention_hm_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, const long long* strides, int batch, int heads,
                                      int nq, int nk, int head_dim, float scale, void* stream) {
  HmArgs a = bwd_args(q, k, v, dout, lse, delta, strides, heads, nq, nk, scale);
  a.out = static_cast<bf16*>(dq);
  a.so = view(strides, 4);
  return launch(kDq, head_dim, kNoBias, a, nq, batch, stream);
}

// dk and dv. Arguments as vfmseg_attention_hm_dq, writing dk and dv
// [B, H, nk, D]; strides: 18 int64 for q, k, v, dout, dk, dv.
extern "C" int vfmseg_attention_hm_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, const long long* strides, int batch,
                                       int heads, int nq, int nk, int head_dim, float scale,
                                       void* stream) {
  HmArgs a = bwd_args(q, k, v, dout, lse, delta, strides, heads, nq, nk, scale);
  a.out = static_cast<bf16*>(dk);
  a.so = view(strides, 4);
  a.out2 = static_cast<bf16*>(dv);
  a.so2 = view(strides, 5);
  return launch(kDkv, head_dim, kNoBias, a, nk, batch, stream);
}

// The forward with a bias: as vfmseg_attention_hm_fwd, plus bias, a
// [B, H, nq, nk] view with unit stride along nk, bf16 (bias_kind 1) or fp32
// (2); strides: 15 int64 for q, k, v, out, bias.
extern "C" int vfmseg_attention_hm_bias_fwd(const void* q, const void* k, const void* v,
                                            const void* bias, void* out, void* lse,
                                            const long long* strides, int bias_kind, int batch,
                                            int heads, int nq, int nk, int head_dim, float scale,
                                            void* stream) {
  if (bias_kind == kNoBias) return static_cast<int>(cudaErrorInvalidValue);
  HmArgs a = fwd_args(q, k, v, out, lse, strides, heads, nq, nk, scale);
  a.bias = bias;
  a.sb = view(strides, 4);
  return launch(kFwd, head_dim, bias_kind, a, nq, batch, stream);
}

// dq and dbias with a bias: as vfmseg_attention_hm_dq, plus the bias as the
// forward took it and dbias, contiguous fp32 [B, H, nq, nk] (padded rows and
// columns are not written; every real one is); strides: 18 int64 for q, k, v,
// dout, dq, bias.
extern "C" int vfmseg_attention_hm_bias_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* bias, void* dq, void* dbias,
                                           const long long* strides, int bias_kind, int batch,
                                           int heads, int nq, int nk, int head_dim, float scale,
                                           void* stream) {
  if (bias_kind == kNoBias) return static_cast<int>(cudaErrorInvalidValue);
  HmArgs a = bwd_args(q, k, v, dout, lse, delta, strides, heads, nq, nk, scale);
  a.out = static_cast<bf16*>(dq);
  a.so = view(strides, 4);
  a.bias = bias;
  a.sb = view(strides, 5);
  a.dbias = static_cast<float*>(dbias);
  return launch(kDq, head_dim, bias_kind, a, nq, batch, stream);
}

// dk and dv with a bias: as vfmseg_attention_hm_dkv, plus the bias; strides:
// 21 int64 for q, k, v, dout, dk, dv, bias.
extern "C" int vfmseg_attention_hm_bias_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* bias, void* dk, void* dv,
                                            const long long* strides, int bias_kind, int batch,
                                            int heads, int nq, int nk, int head_dim, float scale,
                                            void* stream) {
  if (bias_kind == kNoBias) return static_cast<int>(cudaErrorInvalidValue);
  HmArgs a = bwd_args(q, k, v, dout, lse, delta, strides, heads, nq, nk, scale);
  a.out = static_cast<bf16*>(dk);
  a.so = view(strides, 4);
  a.out2 = static_cast<bf16*>(dv);
  a.so2 = view(strides, 5);
  a.bias = bias;
  a.sb = view(strides, 6);
  return launch(kDkv, head_dim, bias_kind, a, nk, batch, stream);
}
