// EVA02's SwiGLU gate and its sub-LN in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves silu(w1 x) * (w2 x) to XLA
// and runs the sub-LN on its LayerNorm kernel (vfmseg_tpu/ops/norm.py
// _ln_forward). On the card those were three passes over the [M, H] hidden
// (PyTorch's silu, its multiply, then B1) at EVA02-L's H = 2730, whose rows
// of 5460 bytes kept the GEMMs around them off cuBLAS's Hopper kernels.
//
// The eval route (models/backbones/vit.py SwiGLUEva) pads the hidden to Hp,
// a multiple of 8 elements (16 bytes of bf16), with zero weight rows and
// columns, and runs w1 and w2 as one GEMM whose output g is [M, 2 Hp]:
// a = g[:, :H], b = g[:, Hp:Hp + H]. This kernel reads g and writes the
// [M, Hp] input of the padded w3:
//
//   h = silu(a) * b in fp32, over the H true columns;
//   mean, then the mean of the centred squares, over those H columns only
//   (_ln_reference's order, as B1), rstd = rsqrt(var + eps);
//   y = (h - mean) * rstd * w + bias in fp32, rounded to g's dtype;
//   y = 0 exactly in the Hp - H pad columns, so w3's zero columns add
//   exact zeros whatever their weights.
//
// What bounds it: device memory. 2 Hp elements read and Hp written a row
// (6 bytes an element of Hp in bf16) against ~20 flops and one exp, far
// below the card's ~295 flop/byte ridge. The three passes it replaces moved
// 14 bytes an element of H.
//
// The design, for the bus to stay busy: B1's (layer_norm.cu) row in
// registers, with a block to a row instead of a warp. A warp to a row held
// 12 vectors of a and b and 96 fp32 products a lane at Hp 2736: 168
// registers with spills, 3 blocks a SM, and 0.256 ms at the refine batch
// against a 0.090 ms bound (H100, 700 W).
//
// * Rows all start 16-byte aligned (Hp a multiple of a vector, g and y
//   aligned). One block of 128 threads takes a row; thread t takes the
//   16-byte vectors t, t + 128, ... of a and of b, all loads issued before
//   the first use, and keeps their gate products in fp32 registers (24 at
//   Hp 2736) from its loads to its store. Both statistics are warp-shuffle
//   sums joined through shared memory.
// * Persistent blocks walk the rows with the grid as stride; weight and
//   bias are staged once a block in shared memory as (w, b) pairs,
//   element-major, ws[k][m] = (w, b)[kVec m + k], so a warp's threads,
//   which hold consecutive vectors, read consecutive pairs: one
//   conflict-free 8-byte load an element. The pad columns stage (0, 0).
// * The gate is F.silu's a / (1 + exp(-a)) times b, with the accurate exp
//   and division, as the twin computes it. The fast ones (__expf,
//   __fdividef) took 0.118 ms at the refine batch against 0.139 (H100,
//   700 W), and moved bf16 roundings off the twin's.
// * Rows too wide for a block's registers (more than 8 vectors a thread:
//   bf16 Hp > 8192, fp32 Hp > 4096) take one 256-thread block a row,
//   striding the row three times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "norm_common.cuh"

namespace {

using vfmseg_norm::block_sum;
using vfmseg_norm::Vec;

constexpr int kThreads = 128;  // a row's threads
constexpr int kMaxVpt = 8;     // 16-byte vectors of a and of b a thread, at most

// silu(a) * b as F.silu computes silu: a / (1 + exp(-a)), exp and the
// division to IEEE accuracy (0 for a below ~-88, silu's limit).
__device__ __forceinline__ float gate(float a, float b) { return a / (1.f + expf(-a)) * b; }

// VPT: 16-byte vectors a thread of each half row (Hp up to 128 * VPT
// vectors). Resident blocks a SM the registers allow: 6 (80 registers a
// thread: 77 at VPT 3 in bf16, EVA02-L's), or 3 (168) past 3 vectors a
// thread, which spilled at 80.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads, VPT <= 3 ? 6 : 3)
swiglu_gate_ln_kernel(const T* __restrict__ g, const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y, int rows, int h, int hp,
                      float eps) {
  constexpr int kVec = Vec<T>::kVec;
  extern __shared__ float2 staged[];
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x;
  const int nvec = hp / kVec;

  for (int col = t; col < hp; col += kThreads) {
    staged[(col % kVec) * nvec + col / kVec] =
        col < h ? make_float2(weight[col], bias[col]) : make_float2(0.f, 0.f);
  }
  __syncthreads();

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint4* a4 = reinterpret_cast<const uint4*>(g + static_cast<int64_t>(row) * 2 * hp);
    const uint4* b4 = a4 + nvec;
    uint4 ra[VPT], rb[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (t + kThreads * i < nvec) {
        ra[i] = a4[t + kThreads * i];
        rb[i] = b4[t + kThreads * i];
      }
    }

    float v[VPT][kVec];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + kThreads * i;
      if (j < nvec) {
        float fa[kVec], fb[kVec];
        Vec<T>::unpack(ra[i], fa);
        Vec<T>::unpack(rb[i], fb);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[i][e] = kVec * j + e < h ? gate(fa[e], fb[e]) : 0.f;
          sum += v[i][e];
        }
      }
    }
    const float mean = block_sum(sum, red) / static_cast<float>(h);

    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + kThreads * i;
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (kVec * j + e < h) {
            const float d = v[i][e] - mean;
            sq += d * d;
          }
        }
      }
    }
    const float rstd = rsqrtf(block_sum(sq, red) / static_cast<float>(h) + eps);

    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<int64_t>(row) * hp);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + kThreads * i;
      if (j < nvec) {
        float out[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float2 wb = staged[e * nvec + j];
          out[e] = kVec * j + e < h ? (v[i][e] - mean) * rstd * wb.x + wb.y : 0.f;
        }
        yr[j] = Vec<T>::pack(out);
      }
    }
  }
}

// One block a row of any width, one element a thread a step: rows too wide
// for the row-in-registers kernel. The gate is recomputed in each pass.
template <typename T>
__global__ void __launch_bounds__(256)
swiglu_gate_ln_row_kernel(const T* __restrict__ g, const float* __restrict__ weight,
                          const float* __restrict__ bias, T* __restrict__ y, int h, int hp,
                          float eps) {
  __shared__ float red[8];
  const T* ar = g + static_cast<int64_t>(blockIdx.x) * 2 * hp;
  const T* br = ar + hp;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * hp;
  float sum = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    sum += gate(Vec<T>::to_float(ar[i]), Vec<T>::to_float(br[i]));
  }
  const float mean = block_sum(sum, red) / static_cast<float>(h);
  float sq = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float d = gate(Vec<T>::to_float(ar[i]), Vec<T>::to_float(br[i])) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / static_cast<float>(h) + eps);
  for (int i = threadIdx.x; i < hp; i += blockDim.x) {
    const float v = i < h ? (gate(Vec<T>::to_float(ar[i]), Vec<T>::to_float(br[i])) - mean) *
                                    rstd * weight[i] + bias[i]
                          : 0.f;
    yr[i] = Vec<T>::from_float(v);
  }
}

template <typename T, int VPT>
int launch_rows(const T* g, const float* w, const float* b, T* y, int rows, int h, int hp,
                float eps, cudaStream_t stream) {
  auto kernel = swiglu_gate_ln_kernel<T, VPT>;
  const int smem = hp * static_cast<int>(sizeof(float2));
  // Resident blocks a SM, at the largest staging this instantiation takes
  // (above 48 KB only once the kernel is allowed it).
  static const int per_sm = [&] {
    int n = 0;
    const int most = Vec<T>::kVec * kThreads * VPT * static_cast<int>(sizeof(float2));
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, most) != cudaSuccess) {
      n = 1;
    }
    return n > 0 ? n : 1;
  }();
  int grid = 0;
  const int err = vfmseg_norm::persistent_grid(rows, 1, per_sm, &grid);
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, stream>>>(g, w, b, y, rows, h, hp, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const void* weight, const void* bias, void* y, int rows, int h, int hp,
           float eps, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::kVec;
  if (h < 1 || h > hp || hp % kVec != 0 || ((reinterpret_cast<uintptr_t>(g) |
                                             reinterpret_cast<uintptr_t>(y)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* gp = static_cast<const T*>(g);
  const float* wp = static_cast<const float*>(weight);
  const float* bp = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  const int vpt = (hp / kVec + kThreads - 1) / kThreads;  // vectors a thread of each half
  if (vpt > kMaxVpt) {
    swiglu_gate_ln_row_kernel<T><<<rows, 256, 0, stream>>>(gp, wp, bp, yp, h, hp, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (vpt <= 1) return launch_rows<T, 1>(gp, wp, bp, yp, rows, h, hp, eps, stream);
  if (vpt <= 2) return launch_rows<T, 2>(gp, wp, bp, yp, rows, h, hp, eps, stream);
  if (vpt <= 3) return launch_rows<T, 3>(gp, wp, bp, yp, rows, h, hp, eps, stream);
  if (vpt <= 4) return launch_rows<T, 4>(gp, wp, bp, yp, rows, h, hp, eps, stream);
  return launch_rows<T, kMaxVpt>(gp, wp, bp, yp, rows, h, hp, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g is a contiguous [rows, 2 hp] (a in
// columns [0, h), b in [hp, hp + h)) and y a contiguous [rows, hp], both
// 16-byte aligned, hp a multiple of 16 bytes' elements, 1 <= h <= hp; weight
// and bias are contiguous float32 [h]. Returns a cudaError_t.
extern "C" int vfmseg_swiglu_gate_ln(const void* g, const void* weight, const void* bias,
                                     void* y, int rows, int h, int hp, float eps, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (dtype == 0) return launch<float>(g, weight, bias, y, rows, h, hp, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, weight, bias, y, rows, h, hp, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
