// Last-axis LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernels vfmseg_tpu/ops/norm.py::_ln_kernel (launched by
// _ln_forward) and ::_ln_kernel_3d (launched by _ln_forward_3d). Their numerics,
// defined by _ln_reference, are kept: fp32 statistics, the mean first and
// then the mean of the centred squares (not E[x^2] - mean^2),
// rsqrt(var + eps), an fp32 affine from fp32 weight and bias, and the store
// in the input's dtype. The TPU needed two launch paths to keep unaligned token
// counts off a re-tiling copy; here a row is a row, so the kernels take any
// [rows, C] with C >= 1.
//
// What bounds it: device memory. Each element is read once and written once
// (4 bytes per element in bf16) against ~8 flops, far below the card's
// ~295 flop/byte ridge.
//
// What the design does about it, in two paths picked per launch:
//
// * C a multiple of 8, at most 2048 (bf16) or 1024 (fp32), 16-byte aligned
//   rows (the ViT's 1024 and the decoder's 256): one warp per row, each lane
//   issuing 16-byte loads and stores on neighbouring addresses; the row stays
//   in registers between the two statistics passes and the affine, so x
//   crosses the bus exactly once each way. Four rows per 128-thread block.
// * Any other C (EVA02's SwiGLU sub-LN is 2730 wide, so its rows are only
//   4-byte aligned): one block per row, up to 256 threads striding the row
//   with bf16x2 loads where the row is 4-byte aligned and scalar loads
//   otherwise; block reductions through shared memory. The row is read three
//   times (sum, centred squares, affine); the second and third reads hit L1,
//   which holds the block's row (5.5 KB at 2730 bf16), so device memory still
//   sees each element once each way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T <-> kVec floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float (&out)[4]) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&in)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&out)[8]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&in)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// VPT: 16-byte vectors per lane, so one row holds at most 32 * VPT * kVec
// elements.
template <typename T, int VPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ y, int rows,
                  int c, float eps) {
  constexpr int kVec = Vec<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<int64_t>(row) * c;
  T* yr = y + static_cast<int64_t>(row) * c;

  float v[VPT][kVec];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = (lane + 32 * j) * kVec;
    if (col < c) {
      Vec<T>::load(xr + col, v[j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += v[j][e];
    }
  }
  const float inv_c = 1.f / static_cast<float>(c);
  const float mean = warp_sum(sum) * inv_c;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = (lane + 32 * j) * kVec;
    if (col < c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[j][e] -= mean;
        sq += v[j][e] * v[j][e];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);

#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = (lane + 32 * j) * kVec;
    if (col < c) {
      float w[kVec], b[kVec], out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        Vec<float>::load(weight + col + e, *reinterpret_cast<float(*)[4]>(w + e));
        Vec<float>::load(bias + col + e, *reinterpret_cast<float(*)[4]>(b + e));
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = v[j][e] * rstd * w[e] + b[e];
      Vec<T>::store(yr + col, out);
    }
  }
}

// Sum of v over the block; `red` holds one float per warp. Every thread gets
// the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` is free: every thread has read the previous sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += red[w];
  return total;
}

// Two or one elements of T at p <-> floats.
template <typename T, int kPair>
struct Units;

template <typename T>
struct Units<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float (&out)[1]) {
    out[0] = static_cast<float>(*p);
  }
  __device__ __forceinline__ static void store(T* p, const float (&in)[1]) {
    *p = static_cast<T>(in[0]);
  }
};

template <>
struct Units<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&out)[1]) {
    out[0] = __bfloat162float(*p);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&in)[1]) {
    *p = __float2bfloat16_rn(in[0]);
  }
};

template <>
struct Units<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&out)[2]) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&in)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(in[0], in[1]);
  }
};

// One block per row of any width c; kPair elements per load (2 only for bf16
// rows that are 4-byte aligned, i.e. c even and x, y 4-byte aligned).
template <typename T, int kPair>
__global__ void __launch_bounds__(256)
layer_norm_row_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y, int c, float eps) {
  __shared__ float red[8];
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * c;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * c;
  const int units = c / kPair;  // c % kPair == 0 on this path
  const float inv_c = 1.f / static_cast<float>(c);

  float sum = 0.f;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float v[kPair];
    Units<T, kPair>::load(xr + u * kPair, v);
#pragma unroll
    for (int e = 0; e < kPair; ++e) sum += v[e];
  }
  const float mean = block_sum(sum, red) * inv_c;

  float sq = 0.f;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float v[kPair];
    Units<T, kPair>::load(xr + u * kPair, v);
#pragma unroll
    for (int e = 0; e < kPair; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) * inv_c + eps);

  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float v[kPair];
    Units<T, kPair>::load(xr + u * kPair, v);
#pragma unroll
    for (int e = 0; e < kPair; ++e) {
      const int col = u * kPair + e;
      v[e] = (v[e] - mean) * rstd * weight[col] + bias[col];
    }
    Units<T, kPair>::store(yr + u * kPair, v);
  }
}

template <typename T, int kPair>
int launch_rows(const T* x, const float* w, const float* b, T* y, int rows, int c, float eps,
                cudaStream_t stream) {
  const int units = c / kPair;
  const int threads = units >= 256 ? 256 : ((units + 31) / 32) * 32;
  layer_norm_row_kernel<T, kPair><<<rows, threads, 0, stream>>>(x, w, b, y, c, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* weight, const void* bias, void* y, int rows,
           int c, float eps, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::kVec;
  const int vectors = (c + kVec - 1) / kVec;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(weight);
  const float* bp = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  const bool aligned16 = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (c % 8 == 0 && aligned16 && vectors <= 256) {
    if (vectors <= 32) {
      layer_norm_kernel<T, 1><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, c, eps);
    } else if (vectors <= 64) {
      layer_norm_kernel<T, 2><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, c, eps);
    } else if (vectors <= 128) {
      layer_norm_kernel<T, 4><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, c, eps);
    } else {
      layer_norm_kernel<T, 8><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, c, eps);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned4 = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 4 == 0;
  if constexpr (sizeof(T) == 2) {
    if (c % 2 == 0 && aligned4) return launch_rows<T, 2>(xp, wp, bp, yp, rows, c, eps, stream);
  }
  return launch_rows<T, 1>(xp, wp, bp, yp, rows, c, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, c], any
// c >= 1 and any element alignment;
// weight and bias are contiguous float32 [c]. Returns a cudaError_t.
extern "C" int vfmseg_layer_norm(const void* x, const void* weight, const void* bias,
                                 void* y, int rows, int c, float eps, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, weight, bias, y, rows, c, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, weight, bias, y, rows, c, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
