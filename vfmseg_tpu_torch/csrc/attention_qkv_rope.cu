// EVA02's inference attention with 2D RoPE, read from the q/k/v projections,
// for Hopper (sm_90a): B2-RoPE.
//
// Replaces _fwd_kernel_qkv_tav of vfmseg_tpu/ops/flash_attention.py with
// rope=True (launched by _flash_forward_qkv_tav_main, entry
// flash_attention_qkv_tm with rope_cs; tables :1254-1265). For every batch
// item b and head h:
//
//   out[b, :, h*64:(h+1)*64] = softmax(rope(q_h) rope(k_h)^T * scale) v_h
//
// with q_h, k_h, v_h the 64 columns of head h in three [B, N, H*64] bf16
// views (the thirds of EVA02's fused qkv, or any views with a stride pair
// each), in the evens|odds layout of vfmseg_tpu/ops/rope.py, and two fp32
// [N, 64] tables cos/sin: rope(x) = x * cos + half_swap(x) * sin, half_swap
// exchanging columns c and c + 32. The rotation is fp32 arithmetic from
// bf16, rounded once to bf16, as the port's plain twin
// (ops/attention.py attention_qkv_rope_plain) rotates; the TPU kernel folds
// scale * log2 e into q before rotating and rotates k in bf16 arithmetic.
// The output is contiguous token-major [B, N, H*64] bf16.
//
// One call launches two kernels:
//
// * The rotation pass (rope_rotate_kernel), bound by device memory: it reads
//   the q and k thirds and the tables and writes rotated q and k into a
//   workspace [B, N, 2*H*64] (q's heads, then k's), 8 bytes moved a rotated
//   element for 3 operations. Each element is rotated once: the kernel it
//   replaces rotated each K tile in shared memory once for every query block
//   that read it (17 times at N 1025, 33 at N 2049). A thread takes one
//   16-byte chunk of a head's low half row of q and of k (columns c..c+7,
//   c in {0, 8, 16, 24}) and the partner chunk of the high half (c + 32..), so
//   it reads both halves before it writes them; the 4 x H threads of a token
//   are neighbours and read that token's table rows (512 bytes) through L1
//   once for all heads and both of q and k. The cls row is the tables'
//   identity row (cos 1, sin 0). The arithmetic is the twin's,
//   lo' = xl * cl + xh * sl, hi' = xh * ch + xl * sh with each product
//   rounded to fp32 before the sum (no FMA contraction), so the rotated
//   values equal the twin's bit for bit. Contracted, as the earlier kernel
//   was, the sum of two nearly cancelling products kept bits the twin
//   rounds away: 2 bf16 units apart at EVA02's stage-1 shape.
// * B2's warp-specialised TMA + wgmma kernel (attention_qkv.cu) over the
//   rotated q and k (token stride 2*H*64) and v where it lies (its own
//   strides), through attention_qkv_views; bound by the tensor cores.
//
// The workspace comes from the caller (the wrapper takes it from PyTorch's
// caching allocator).

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

constexpr int kRotThreads = 256;
constexpr int kHalf = kHeadDim / 2;   // partner columns lie kHalf apart
constexpr int kChunks = kHalf / 8;    // 16-byte chunks of a half row: 4

struct RotArgs {
  const bf16* q;
  const bf16* k;
  TokenStrides sq, sk;
  const float* cos;
  const float* sin;
  bf16* rot;
  int n, heads, units;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Eight consecutive fp32 table entries (32-byte aligned), read-only path.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Thread u: chunk u % 4 of head (u / 4) % H of token u / (4 H) (b * n + t),
// for q and for k.
__global__ void __launch_bounds__(kRotThreads) rope_rotate_kernel(const RotArgs a) {
  const int u = blockIdx.x * kRotThreads + threadIdx.x;
  if (u >= a.units) return;
  const int c = (u % kChunks) * 8;
  const int h = (u / kChunks) % a.heads;
  const int tok = u / (kChunks * a.heads);
  const int t = tok % a.n;
  const int b = tok / a.n;
  const bf16* src[2] = {a.q + b * a.sq.b + t * a.sq.n + h * kHeadDim + c,
                        a.k + b * a.sk.b + t * a.sk.n + h * kHeadDim + c};
  uint4 raw[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    raw[i][0] = *reinterpret_cast<const uint4*>(src[i]);
    raw[i][1] = *reinterpret_cast<const uint4*>(src[i] + kHalf);
  }
  float cl[8], ch[8], sl[8], sh[8];
  const int row = t * kHeadDim + c;
  load8(a.cos + row, cl);
  load8(a.cos + row + kHalf, ch);
  load8(a.sin + row, sl);
  load8(a.sin + row + kHalf, sh);

  const int64_t width = static_cast<int64_t>(a.heads) * kHeadDim;
  bf16* const dst = a.rot + static_cast<int64_t>(tok) * 2 * width + h * kHeadDim + c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float xl[8], xh[8], yl[8], yh[8];
    unpack8(raw[i][0], xl);
    unpack8(raw[i][1], xh);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      yl[e] = __fadd_rn(__fmul_rn(xl[e], cl[e]), __fmul_rn(xh[e], sl[e]));
      yh[e] = __fadd_rn(__fmul_rn(xh[e], ch[e]), __fmul_rn(xl[e], sh[e]));
    }
    *reinterpret_cast<uint4*>(dst + i * width) = pack8(yl);
    *reinterpret_cast<uint4*>(dst + i * width + kHalf) = pack8(yh);
  }
}

}  // namespace

// q, k, v: bf16 [batch, n, heads * 64] views in the evens|odds layout, unit
// stride along features, 16-byte aligned; strides: int64 (batch, token)
// element strides of q, k and v in turn (multiples of 8, the batch stride
// free when batch is 1). cos and sin: contiguous fp32 [n, 64] tables (identity
// rows for the cls token), 16-byte aligned, shared by every batch item and
// head. rot: a contiguous bf16 [batch, n, 2 * heads * 64] workspace. out:
// contiguous bf16 [batch, n, heads * 64]. Launches the rotation pass and B2's
// kernel on the stream; returns a cudaError_t, or a tensor-map encode failure
// (see vfmseg_error_string).
extern "C" int vfmseg_attention_qkv_rope(const void* q, const void* k, const void* v, void* out,
                                         const void* cos, const void* sin, void* rot,
                                         const long long* strides, int batch, int n, int heads,
                                         float scale, void* stream) {
  const int64_t units = static_cast<int64_t>(batch) * n * heads * kChunks;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RotArgs args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     TokenStrides{strides[0], strides[1]}, TokenStrides{strides[2], strides[3]},
                     static_cast<const float*>(cos), static_cast<const float*>(sin),
                     static_cast<bf16*>(rot), n, heads, static_cast<int>(units)};
  const int blocks = static_cast<int>((units + kRotThreads - 1) / kRotThreads);
  rope_rotate_kernel<<<blocks, kRotThreads, 0, s>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t width = static_cast<int64_t>(heads) * kHeadDim;
  const TokenStrides rotated{static_cast<int64_t>(n) * 2 * width, 2 * width};
  const TokenStrides views[3] = {rotated, rotated, TokenStrides{strides[4], strides[5]}};
  return attention_qkv_views(rot, static_cast<const bf16*>(rot) + width, v, out, batch, n, heads,
                             views, scale, stream);
}
