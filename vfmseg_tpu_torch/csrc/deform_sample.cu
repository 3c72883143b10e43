// Zero-padded bilinear sampling of one feature level at normalised points, for
// Hopper (sm_90a): the sampling step of multi-scale deformable attention.
//
// Replaces the TPU kernel `kernel` of _sample_pallas_xy
// (vfmseg_tpu/ops/deform_attn.py:107-189), reached through the VJP
// _sample_pallas and ms_deform_attn_core: once per level of each layer of
// Mask2Former's pixel decoder, with the heads folded into the batch.
//
// For every batch row b (a crop's head) and sample n, with value_b [H, W, C]:
//
//   x = xn[b, n] * W - 0.5,  y = yn[b, n] * H - 0.5   (fp32)
//   x0 = floor(x), y0 = floor(y),  fx = x - x0, fy = y - y0
//   out[b, n] = (v(y0, x0) (1 - fx) + v(y0, x0 + 1) fx) (1 - fy)
//             + (v(y0 + 1, x0) (1 - fx) + v(y0 + 1, x0 + 1) fx) fy
//
// with v(i, j) = value_b[i, j] inside the plane and 0 outside (grid_sample's
// align_corners=False with zero padding). Weights and sums are fp32, rounded
// once to the value's dtype (bf16 or fp32) at the end, as the Pallas kernel
// keeps its products in fp32.
//
// Layout: value contiguous [B, H, W, C]; xn, yn contiguous fp32 [B, N]; out
// contiguous [B, N, C].
//
// What bounds it: the bytes. Each sample does ~7 flops a channel on 4 taps
// read from a plane that sits in L2 (one pixel-decoder level at a 512 crop is
// 32 x 32 x 32 channels, 64 KB a head), and writes C values: the output and
// the coordinates dominate the traffic to device memory.
//
// What the design does about it: a gather, which the TPU lacked (its kernel
// built one-hot interpolation matrices for the MXU instead, :212-228). One warp
// takes one sample, its lanes the channels: at C = 32 (8 heads of 32) each tap
// is one contiguous 64-byte row read by the whole warp, and the output row is
// one 64-byte store. Out-of-range taps are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // samples per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_kernel(const T* __restrict__ value, const float* __restrict__ xn,
                         const float* __restrict__ yn, T* __restrict__ out, int64_t samples,
                         int n, int h, int w, int c) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= samples) return;
  const int lane = threadIdx.x & 31;
  const int64_t b = s / n;

  const float x = xn[s] * static_cast<float>(w) - 0.5f;
  const float y = yn[s] * static_cast<float>(h) - 0.5f;
  const float xf = floorf(x);
  const float yf = floorf(y);
  const float fx = x - xf;
  const float fy = y - yf;
  // which taps lie inside the plane, decided in fp32 so that coordinates far
  // outside never reach an integer conversion
  const bool in_x0 = xf >= 0.f && xf <= static_cast<float>(w - 1);
  const bool in_x1 = xf >= -1.f && xf <= static_cast<float>(w - 2);
  const bool in_y0 = yf >= 0.f && yf <= static_cast<float>(h - 1);
  const bool in_y1 = yf >= -1.f && yf <= static_cast<float>(h - 2);
  const int x0 = (in_x0 || in_x1) ? static_cast<int>(xf) : 0;
  const int y0 = (in_y0 || in_y1) ? static_cast<int>(yf) : 0;

  const T* plane = value + b * h * w * c;
  const T* r00 = plane + (static_cast<int64_t>(y0) * w + x0) * c;
  const T* r10 = r00 + static_cast<int64_t>(w) * c;
  T* dst = out + s * c;
  for (int ch = lane; ch < c; ch += 32) {
    const float v00 = in_y0 && in_x0 ? to_float(r00[ch]) : 0.f;
    const float v01 = in_y0 && in_x1 ? to_float(r00[c + ch]) : 0.f;
    const float v10 = in_y1 && in_x0 ? to_float(r10[ch]) : 0.f;
    const float v11 = in_y1 && in_x1 ? to_float(r10[c + ch]) : 0.f;
    const float top = v00 * (1.f - fx) + v01 * fx;
    const float bot = v10 * (1.f - fx) + v11 * fx;
    dst[ch] = from_float<T>(top * (1.f - fy) + bot * fy);
  }
}

}  // namespace

// value: contiguous [batch, h, w, c], fp32 (dtype 0) or bf16 (dtype 1); xn, yn:
// contiguous fp32 [batch, n] normalised coordinates; out: contiguous
// [batch, n, c] in value's dtype. Returns a cudaError_t.
extern "C" int vfmseg_deform_sample(const void* value, const void* xn, const void* yn, void* out,
                                    int batch, int n, int h, int w, int c, int dtype,
                                    void* stream) {
  const int64_t samples = static_cast<int64_t>(batch) * n;
  if (samples == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (samples + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float* x = static_cast<const float*>(xn);
  const float* y = static_cast<const float*>(yn);
  if (dtype == 0) {
    deform_sample_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(value), x, y, static_cast<float*>(out), samples, n, h, w, c);
  } else if (dtype == 1) {
    deform_sample_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value), x, y, static_cast<__nv_bfloat16*>(out), samples,
        n, h, w, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
