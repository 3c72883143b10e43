// Pieces shared by the deformable-attention kernels, B8 (deform_sample.cu)
// and its fused successor (deform_attn.cu): raw accesses of 2 to 16 bytes,
// bf16 and fp32 elements as floats, the four taps of a bilinear sample with
// their in-plane predicates, and the access-width rule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vfmseg_deform {

// A raw access of kBytes.
template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  using U = uint4;
};
template <>
struct Raw<8> {
  using U = uint2;
};
template <>
struct Raw<4> {
  using U = unsigned int;
};
template <>
struct Raw<2> {
  using U = unsigned short;
};

// An element's bits: fp32 as itself, bf16 as its 16 bits.
template <typename T>
struct Bits {
  using E = float;
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};
template <>
struct Bits<__nv_bfloat16> {
  using E = unsigned short;
  static __device__ __forceinline__ float to_float(unsigned short v) {
    return __uint_as_float(static_cast<unsigned int>(v) << 16);
  }
  static __device__ __forceinline__ unsigned short from_float(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
};

// kBytes of T as raw bits and as elements.
template <typename T, int kBytes>
union Vec {
  static constexpr int kElems = kBytes / static_cast<int>(sizeof(T));
  typename Raw<kBytes>::U raw;
  typename Bits<T>::E e[kElems];
};

template <typename T, int kBytes>
__device__ __forceinline__ Vec<T, kBytes> load_tap(const T* p, bool inside) {
  Vec<T, kBytes> v;
  v.raw = typename Raw<kBytes>::U();
  if (inside) v.raw = __ldg(reinterpret_cast<const typename Raw<kBytes>::U*>(p));
  return v;
}

// One sample's geometry: the top-left tap's first element, the lerp weights
// and which taps lie inside the plane.
template <typename T>
struct Taps {
  const T* r00;
  float fx, fy;
  bool i00, i01, i10, i11;
};

// The taps of the sample at normalised (xn, yn) of the h x w plane whose
// pixel (i, j) starts at plane + (i w + j) stride.
template <typename T>
__device__ __forceinline__ Taps<T> taps(const T* plane, float xn, float yn, int h, int w,
                                        int64_t stride) {
  Taps<T> tp;
  const float x = xn * static_cast<float>(w) - 0.5f;
  const float y = yn * static_cast<float>(h) - 0.5f;
  const float xf = floorf(x);
  const float yf = floorf(y);
  tp.fx = x - xf;
  tp.fy = y - yf;
  // which taps lie inside the plane, decided in fp32 so that coordinates far
  // outside never reach an integer conversion
  const bool in_x0 = xf >= 0.f && xf <= static_cast<float>(w - 1);
  const bool in_x1 = xf >= -1.f && xf <= static_cast<float>(w - 2);
  const bool in_y0 = yf >= 0.f && yf <= static_cast<float>(h - 1);
  const bool in_y1 = yf >= -1.f && yf <= static_cast<float>(h - 2);
  const int x0 = (in_x0 || in_x1) ? static_cast<int>(xf) : 0;
  const int y0 = (in_y0 || in_y1) ? static_cast<int>(yf) : 0;
  tp.r00 = plane + (static_cast<int64_t>(y0) * w + x0) * stride;
  tp.i00 = in_y0 && in_x0;
  tp.i01 = in_y0 && in_x1;
  tp.i10 = in_y1 && in_x0;
  tp.i11 = in_y1 && in_x1;
  return tp;
}

// The bilinear sample of four taps' element e, in B8's order and fp32.
template <typename T, int kBytes>
__device__ __forceinline__ float lerp(const Vec<T, kBytes>& v00, const Vec<T, kBytes>& v01,
                                      const Vec<T, kBytes>& v10, const Vec<T, kBytes>& v11,
                                      float fx, float fy, int e) {
  using B = Bits<T>;
  const float top = B::to_float(v00.e[e]) * (1.f - fx) + B::to_float(v01.e[e]) * fx;
  const float bot = B::to_float(v10.e[e]) * (1.f - fx) + B::to_float(v11.e[e]) * fx;
  return top * (1.f - fy) + bot * fy;
}

// The widest access (16, 8, 4 bytes, or one element) that divides a row of
// `elems` elements and both pointers' alignment.
inline int vec_bytes(const void* a, const void* b, int elems, int item) {
  const int64_t row = static_cast<int64_t>(elems) * item;
  for (int vb = 16; vb > item; vb /= 2) {
    if (row % vb == 0 && reinterpret_cast<uintptr_t>(a) % vb == 0 &&
        reinterpret_cast<uintptr_t>(b) % vb == 0) {
      return vb;
    }
  }
  return item;
}

}  // namespace vfmseg_deform
