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
// The design, for the bus to stay busy:
//
// * One warp per row, the row held in registers from its load to its store,
//   so x crosses the bus once each way; both statistics are warp-shuffle
//   reductions, with no shared memory and no __syncthreads in the row loop.
// * 16-byte loads and stores. A row whose start is not 16-byte aligned (EVA02's
//   SwiGLU sub-LN is 2730 wide: its rows start 0, 4, 8 or 12 bytes past a
//   16-byte boundary, in turn; odd widths at any even byte) is cut into a
//   peeled head of h0 < 16 / sizeof(T) elements that brings it to the
//   boundary (lane i < h0 takes element i), a body of 16-byte vectors (lane l
//   takes vectors l, l + 32, ...) and a tail of fewer than one vector's
//   elements (lane i takes one). y has x's address modulo 16 (the wrapper
//   allocates it so), so the same cut serves the store.
// * Persistent blocks: min(rows / 4, SMs x resident blocks) blocks of four
//   warps walk the rows with a stride of the grid's warps. Four blocks a SM
//   keep 16 rows in flight. Loading a warp's next row before its current
//   row's reductions (two rows in flight a warp) held the registers of a
//   fourth block and, in development builds, ran no faster at the refine
//   batch and slower at EVA02's stage 1.
// * Weight and bias are read once a block, not once a row. Where every row
//   starts 16-byte aligned and a lane holds at most 4 vectors (the ViT's
//   1024 and the decoder's 256 in bf16), each lane keeps its columns' weight
//   and bias in registers. Elsewhere the block stages them in shared memory
//   as (w, b) pairs (21.8 KB at 2730) in an element-major layout,
//   ws[k][m] = (w, b)[kVec * m + k], so that the lanes of a warp, which hold
//   consecutive vectors of one row, read consecutive pairs whatever the
//   row's head: one conflict-free 8-byte load an element.
// * Rows too wide for a warp's registers (more than 12 vectors a lane: bf16
//   C > 3079, fp32 C > 1539) take one 256-thread block per row, striding the
//   row three times (the second and third reads hit L1), with block
//   reductions through shared memory; so do x and y at different addresses
//   modulo 16, which the wrapper never passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "norm_common.cuh"

namespace {

using vfmseg_norm::block_sum;
using vfmseg_norm::Vec;
using vfmseg_norm::warp_sum;

constexpr int kWarps = 4;                  // rows in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVpt = 12;                // 16-byte vectors a lane, at most
constexpr int kMaxRegVpt = 4;              // ... with weight and bias in registers
constexpr int kMinBlocks = 4;              // resident blocks a SM the registers allow

// How one row is cut: h0 head elements up to the first 16-byte boundary,
// nvec 16-byte vectors, tl tail elements.
struct Cut {
  int h0, nvec, tl;
};

template <typename T, bool kAligned>
__device__ __forceinline__ Cut cut_row(const T* row, int c) {
  constexpr int kVec = Vec<T>::kVec;
  if constexpr (kAligned) return Cut{0, c / kVec, 0};
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15) / static_cast<int>(sizeof(T));
  const int h0 = min((kVec - mis) & (kVec - 1), c);
  const int nvec = (c - h0) / kVec;
  return Cut{h0, nvec, c - h0 - nvec * kVec};
}

// One lane's share of a row, as loaded: VPT vectors, one head and one tail
// element.
template <typename T, int VPT>
struct Share {
  uint4 v[VPT];
  T head, tail;
};

template <typename T, int VPT>
__device__ __forceinline__ void load_share(Share<T, VPT>& s, const T* row, const Cut& cut,
                                           int lane) {
  constexpr int kVec = Vec<T>::kVec;
  if (lane < cut.h0) s.head = row[lane];
  const uint4* body = reinterpret_cast<const uint4*>(row + cut.h0);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + 32 * i < cut.nvec) s.v[i] = body[lane + 32 * i];
  }
  if (lane < cut.tl) s.tail = row[cut.h0 + kVec * cut.nvec + lane];
}

// Weight and bias of the columns a lane holds: kRegW keeps them in
// registers; otherwise they come in (w, b) pairs from the element-major
// staging in shared memory, ws[k * stride + m] = (w, b)[kVec * m + k].
template <typename T, int VPT, bool kRegW>
struct Affine {
  static constexpr int kVec = Vec<T>::kVec;
  static constexpr int kShift = kVec == 8 ? 3 : 2;
  float w[kRegW ? VPT : 1][kVec], b[kRegW ? VPT : 1][kVec];
  const float2* ws;
  int stride;

  __device__ __forceinline__ float2 staged(int col) const {
    return ws[(col & (kVec - 1)) * stride + (col >> kShift)];
  }
  // Element e of this lane's vector i (vector j of the row past its head).
  __device__ __forceinline__ float2 body(int i, int j, int e, int h0) const {
    if constexpr (kRegW) {
      return make_float2(w[i][e], b[i][e]);
    } else {
      // column h0 + kVec * j + e: k = (h0 + e) mod kVec, m = j + carry
      const int q = h0 + e;
      return ws[(q & (kVec - 1)) * stride + j + (q >> kShift)];
    }
  }
};

// VPT: 16-byte vectors a lane (rows up to 32 * VPT vectors past the head);
// kRegW: weight and bias in registers, for rows that all start 16-byte
// aligned and have no tail (C a multiple of kVec, x 16-byte aligned).
template <typename T, int VPT, bool kRegW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ y, int rows, int c, float eps) {
  constexpr int kVec = Vec<T>::kVec;
  extern __shared__ float2 staged[];
  const int lane = threadIdx.x & 31;

  Affine<T, VPT, kRegW> af;
  af.ws = staged;
  af.stride = (c + kVec - 1) / kVec + 1;
  if constexpr (kRegW) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = kVec * (lane + 32 * i);
      if (col < c) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(weight + col + e);
          const float4 b4 = *reinterpret_cast<const float4*>(bias + col + e);
          af.w[i][e] = w4.x; af.w[i][e + 1] = w4.y; af.w[i][e + 2] = w4.z; af.w[i][e + 3] = w4.w;
          af.b[i][e] = b4.x; af.b[i][e + 1] = b4.y; af.b[i][e + 2] = b4.z; af.b[i][e + 3] = b4.w;
        }
      }
    }
  } else {
    // The rows' columns all lie below c: nothing past it is read.
    for (int col = threadIdx.x; col < c; col += kThreads) {
      staged[(col & (kVec - 1)) * af.stride + col / kVec] = make_float2(weight[col], bias[col]);
    }
    __syncthreads();
  }

  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const T* xr = x + static_cast<int64_t>(row) * c;
    const Cut cut = cut_row<T, kRegW>(xr, c);
    Share<T, VPT> s;
    load_share(s, xr, cut, lane);

    const bool has_head = lane < cut.h0;
    const bool has_tail = lane < cut.tl;
    float sum = 0.f;
    if (has_head) sum += Vec<T>::to_float(s.head);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (lane + 32 * i < cut.nvec) {
        float v[kVec];
        Vec<T>::unpack(s.v[i], v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += v[e];
      }
    }
    if (has_tail) sum += Vec<T>::to_float(s.tail);
    const float mean = warp_sum(sum) / static_cast<float>(c);

    float sq = 0.f;
    if (has_head) {
      const float d = Vec<T>::to_float(s.head) - mean;
      sq += d * d;
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (lane + 32 * i < cut.nvec) {
        float v[kVec];
        Vec<T>::unpack(s.v[i], v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = v[e] - mean;
          sq += d * d;
        }
      }
    }
    if (has_tail) {
      const float d = Vec<T>::to_float(s.tail) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(c) + eps);

    T* yr = y + static_cast<int64_t>(row) * c;
    if (has_head) {
      const float2 wb = af.staged(lane);
      yr[lane] = Vec<T>::from_float((Vec<T>::to_float(s.head) - mean) * rstd * wb.x + wb.y);
    }
    uint4* body = reinterpret_cast<uint4*>(yr + cut.h0);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = lane + 32 * i;
      if (j < cut.nvec) {
        float v[kVec];
        Vec<T>::unpack(s.v[i], v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float2 wb = af.body(i, j, e, cut.h0);
          v[e] = (v[e] - mean) * rstd * wb.x + wb.y;
        }
        body[j] = Vec<T>::pack(v);
      }
    }
    if (has_tail) {
      const int col = cut.h0 + kVec * cut.nvec + lane;
      const float2 wb = af.staged(col);
      yr[col] = Vec<T>::from_float((Vec<T>::to_float(s.tail) - mean) * rstd * wb.x + wb.y);
    }
  }
}

// One block per row of any width c, one element a thread a step: rows too
// wide for the warp kernel's registers.
template <typename T>
__global__ void __launch_bounds__(256)
layer_norm_row_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y, int c, float eps) {
  __shared__ float red[8];
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * c;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * c;
  float sum = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) sum += Vec<T>::to_float(xr[i]);
  const float mean = block_sum(sum, red) / static_cast<float>(c);
  float sq = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const float d = Vec<T>::to_float(xr[i]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / static_cast<float>(c) + eps);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    yr[i] = Vec<T>::from_float((Vec<T>::to_float(xr[i]) - mean) * rstd * weight[i] + bias[i]);
  }
}

// Shared memory of the staged (weight, bias) pairs at width c.
template <typename T>
int staged_bytes(int c) {
  constexpr int kVec = Vec<T>::kVec;
  return kVec * ((c + kVec - 1) / kVec + 1) * static_cast<int>(sizeof(float2));
}

template <typename T, int VPT, bool kRegW>
int launch_warps(const T* x, const float* w, const float* b, T* y, int rows, int c, float eps,
                 cudaStream_t stream) {
  auto kernel = layer_norm_kernel<T, VPT, kRegW>;
  const int smem = kRegW ? 0 : staged_bytes<T>(c);
  // Resident blocks a SM, at the largest staging this instantiation takes.
  static const int per_sm = [&] {
    int n = 0;
    const int most = kRegW ? 0 : staged_bytes<T>(Vec<T>::kVec * 32 * VPT + Vec<T>::kVec - 1);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, most) != cudaSuccess) {
      n = 1;
    }
    return n > 0 ? n : 1;
  }();
  int grid = 0;
  const int err = vfmseg_norm::persistent_grid(rows, kWarps, per_sm, &grid);
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, w, b, y, rows, c, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* weight, const void* bias, void* y, int rows, int c,
           float eps, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::kVec;
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(weight);
  const float* bp = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const int vpt = (c / kVec + 31) / 32;  // vectors a lane, past any head
  if (((xa ^ ya) & 15) != 0 || vpt > kMaxVpt) {
    layer_norm_row_kernel<T><<<rows, 256, 0, stream>>>(xp, wp, bp, yp, c, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = (xa & 15) == 0 && c % kVec == 0 &&
                       (reinterpret_cast<uintptr_t>(weight) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(bias) & 15) == 0;
  if (aligned && vpt <= kMaxRegVpt) {
    if (vpt <= 1) return launch_warps<T, 1, true>(xp, wp, bp, yp, rows, c, eps, stream);
    if (vpt <= 2) return launch_warps<T, 2, true>(xp, wp, bp, yp, rows, c, eps, stream);
    return launch_warps<T, 4, true>(xp, wp, bp, yp, rows, c, eps, stream);
  }
  if (vpt <= 1) return launch_warps<T, 1, false>(xp, wp, bp, yp, rows, c, eps, stream);
  if (vpt <= 2) return launch_warps<T, 2, false>(xp, wp, bp, yp, rows, c, eps, stream);
  if (vpt <= 4) return launch_warps<T, 4, false>(xp, wp, bp, yp, rows, c, eps, stream);
  if (vpt <= 8) return launch_warps<T, 8, false>(xp, wp, bp, yp, rows, c, eps, stream);
  return launch_warps<T, kMaxVpt, false>(xp, wp, bp, yp, rows, c, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, c], any
// c >= 1 and any element alignment (the warp kernel when x and y lie at one
// address modulo 16); weight and bias are contiguous float32 [c]. Returns a
// cudaError_t.
extern "C" int vfmseg_layer_norm(const void* x, const void* weight, const void* bias,
                                 void* y, int rows, int c, float eps, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, weight, bias, y, rows, c, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, weight, bias, y, rows, c, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
