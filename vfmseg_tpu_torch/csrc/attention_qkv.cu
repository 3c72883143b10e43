// Inference attention read straight from q/k/v projections, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel vfmseg_tpu/ops/flash_attention.py::
// _fwd_kernel_qkv_tav (launched by _flash_forward_qkv_tav_main, entry
// flash_attention_qkv_tm), without its RoPE variant. For every batch item b
// and head h:
//
//   out[b, :, h*64:(h+1)*64] = softmax(q_h k_h^T * scale) v_h
//
// where q_h, k_h, v_h are the 64 columns of head h in three [B, N, H*64] bf16
// views that share one (batch, token) stride pair. The three thirds of one
// fused qkv tensor (token stride 3*H*64) and three separate tensors (token
// stride H*64) both qualify, so neither caller concatenates. The output is
// token-major [B, N, H*64] bf16, the layout the proj matmul reads.
//
// Numerics follow xla_attention (vfmseg_tpu/ops/attention.py:31-57): fp32
// logits, an exact softmax with a running max (online softmax), probabilities
// cast to bf16 before the P.V product with fp32 accumulation, and the division
// by the row sum at the end. None of the TPU kernel's schedule (no-max exp2
// softmax, transposed AV, head pairs, batch packing, the aligned-tail cls
// side-chain) is carried over: each answered a TPU lane or VMEM limit.
//
// What bounds it: the tensor cores. Per head it does 4*N^2*64 flops on
// 4*N*64*2 bytes, ~N/2 flops per byte (N = 1025 or 2049 on the main path),
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;             // queries per block, 16 per warp
constexpr int kBlockK = 64;             // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kHeadDim + 8;      // padded shared-memory row, in elements
constexpr int kNTiles = kBlockK / 8;    // n=8 column tiles of S per key tile
constexpr int kDTiles = kHeadDim / 8;   // n=8 column tiles of O
constexpr int kDChunks = kHeadDim / 16; // k=16 chunks of the q.k contraction
constexpr int kKChunks = kBlockK / 16;  // k=16 chunks of the P.V contraction

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
  for (int i = tid; i < 64 * (kHeadDim / 8); i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = (i % (kHeadDim / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kRow + c) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_qkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int n,
                     int heads, int stride_b, int stride_n, float scale_log2) {
  __shared__ __align__(16) bf16 sq[kBlockQ * kRow];
  __shared__ __align__(16) bf16 sk[kBlockK * kRow];
  __shared__ __align__(16) bf16 sv[kBlockK * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t head = static_cast<int64_t>(b) * stride_b + static_cast<int64_t>(h) * kHeadDim;

  load_tile(sq, q + head + static_cast<int64_t>(q0) * stride_n, stride_n, n - q0, tid);
  __syncthreads();

  // A fragments of this warp's 16 query rows, one per 16-wide d chunk.
  const int r0 = warp * 16 + g;
  uint32_t qa[kDChunks][4];
#pragma unroll
  for (int kc = 0; kc < kDChunks; ++kc) {
    const bf16* p = sq + kc * 16 + 2 * t;
    qa[kc][0] = load_u32(p + r0 * kRow);
    qa[kc][1] = load_u32(p + (r0 + 8) * kRow);
    qa[kc][2] = load_u32(p + r0 * kRow + 8);
    qa[kc][3] = load_u32(p + (r0 + 8) * kRow + 8);
  }

  // Each thread holds rows r0 (index 0) and r0 + 8 (index 1).
  float o[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sk, k + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
    load_tile(sv, v + head + static_cast<int64_t>(k0) * stride_n, stride_n, n - k0, tid);
    __syncthreads();

    // S = Q.K^T for 16 rows x 64 keys.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = sk + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
      for (int kc = 0; kc < kDChunks; ++kc) {
        mma_m16n8k16(s[nt], qa[kc], load_u32(kr + kc * 16), load_u32(kr + kc * 16 + 8));
      }
    }

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
#pragma unroll
    for (int kc = 0; kc < kKChunks; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const bf16* vr = sv + (kc * 16 + 2 * t) * kRow + g;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const bf16* p = vr + dt * 8;
        mma_m16n8k16(o[dt], pa, pack_pair(p, p + kRow),
                     pack_pair(p + 8 * kRow, p + 9 * kRow));
      }
    }
  }

  // The row sums so far are per thread; the quad of a row holds the rest.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0];
  const float inv1 = 1.f / l[1];
  const int row0 = q0 + r0;
  const int64_t out_row = static_cast<int64_t>(heads) * kHeadDim;
  bf16* base = out + static_cast<int64_t>(b) * n * out_row + h * kHeadDim + 2 * t;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    if (row0 < n) {
      *reinterpret_cast<uint32_t*>(base + row0 * out_row + dt * 8) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    }
    if (row0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(base + (row0 + 8) * out_row + dt * 8) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
}

}  // namespace

// q, k, v: bf16 [batch, n, heads * 64] views sharing the element strides
// (stride_b, stride_n), unit stride along features, 16-byte aligned.
// out: contiguous bf16 [batch, n, heads * 64]. Returns a cudaError_t.
extern "C" int vfmseg_attention_qkv(const void* q, const void* k, const void* v, void* out,
                                    int batch, int n, int heads, int stride_b, int stride_n,
                                    float scale, void* stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_qkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), n, heads, stride_b, stride_n,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Text of a status code returned by any entry of this library.
extern "C" const char* vfmseg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
