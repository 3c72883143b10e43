// Pieces shared by the row-normalising kernels, B1 (layer_norm.cu) and the
// SwiGLU gate with its sub-LN (swiglu_gate_ln.cu): fp32 warp and block sums,
// 16-byte vectors of bf16 or fp32 unpacked to floats and packed back, and
// the grid of a persistent kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vfmseg_norm {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// A 16-byte vector of T <-> kVec floats, and one element <-> a float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&out)[4]) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&in)[4]) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                      __float_as_uint(in[3]));
  }
  __device__ __forceinline__ static float to_float(float v) { return v; }
  __device__ __forceinline__ static float from_float(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&out)[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&in)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Blocks of a persistent kernel over `rows` rows, `rows_per_block` at a time:
// as many as the rows need, at most the resident blocks of all SMs.
// `per_sm` is the kernel's resident blocks a SM. Returns a cudaError_t, the
// grid in *grid.
inline int persistent_grid(int64_t rows, int rows_per_block, int per_sm, int* grid) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (rows + rows_per_block - 1) / rows_per_block;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<int>(needed < resident ? needed : resident);
  return 0;
}

}  // namespace vfmseg_norm
