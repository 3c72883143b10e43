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
// read from a plane that sits in L1 and L2 (one pixel-decoder level at a 512
// crop is 32 x 32 x 32 channels, 64 KB a head), and writes C values: the
// output and the coordinates are the traffic to device memory (at the eval
// level, 12288 samples of 64 bytes a row: 113 MB of output against 9 MB of
// value).
//
// What the design does about it: a gather, which the TPU lacked (its kernel
// built one-hot interpolation matrices for the MXU instead, :212-228), with
// every access as wide as the channels allow. A thread takes kVec bytes of a
// sample's channels (16 bytes: 8 bf16 or 4 fp32; 8, 4 or one element where
// C * itemsize or the data's alignment is less, chosen by the entry), so at
// C = 32 bf16 four threads cover a sample and a warp eight samples, whose
// stores are 512 contiguous bytes. The four taps go through the read-only
// cache. Blocks are persistent, each over one contiguous run of samples, so
// a block's samples share a plane, and five blocks a SM keep enough loads in
// flight; each thread loads its next sample's coordinates before this one's
// taps. The in-plane predicates stay in fp32, so coordinates far outside
// never reach an integer conversion, and taps outside the plane are never
// read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_common.cuh"

namespace {

using vfmseg_deform::Bits;
using vfmseg_deform::lerp;
using vfmseg_deform::load_tap;
using vfmseg_deform::Raw;
using vfmseg_deform::Taps;
using vfmseg_deform::taps;
using vfmseg_deform::Vec;

constexpr int kThreads = 256;
// Blocks a SM: a thread holds one sample's four taps, and occupancy, not
// more samples a thread, hides the loads' latency (four samples a thread at
// two blocks a SM ran slower at the eval level)
constexpr int kMinBlocks = 5;

// Persistent blocks: block k takes the k-th of gridDim.x contiguous runs of
// block rows (`rows` samples each), so a block's samples share a plane
// (12288 a row at the eval level) and its taps stay in the SM's L1 (a plane
// is 64 KB there). Each thread loads the next row's coordinates before this
// row's taps, so its two dependent loads overlap across rows.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    deform_sample_kernel(const T* __restrict__ value, const float* __restrict__ xn,
                         const float* __restrict__ yn, T* __restrict__ out, int samples, int n,
                         int h, int w, int c, int tps, int lanes, int block_rows) {
  constexpr int kElems = Vec<T, kVec>::kElems;
  // `lanes` threads a sample (tps, or kThreads where a sample has more
  // vectors than that), `rows` samples a block row.
  const int rows = kThreads / lanes;
  const int slot = threadIdx.x / lanes;
  const int slice = threadIdx.x - slot * lanes;
  if (slot >= rows) return;
  const int g0 = static_cast<int>(static_cast<int64_t>(block_rows) * blockIdx.x / gridDim.x);
  const int g1 = static_cast<int>(static_cast<int64_t>(block_rows) * (blockIdx.x + 1) / gridDim.x);
  const int64_t row_elems = static_cast<int64_t>(w) * c;
  int64_t s = static_cast<int64_t>(g0) * rows + slot;
  float nx = 0.f;
  float ny = 0.f;
  if (g0 < g1 && s < samples) {
    nx = xn[s];
    ny = yn[s];
  }
  for (int g = g0; g < g1; ++g, s += rows) {
    const float x = nx;
    const float y = ny;
    if (g + 1 < g1 && s + rows < samples) {
      nx = xn[s + rows];
      ny = yn[s + rows];
    }
    if (s >= samples) continue;
    const Taps<T> tp = taps(value + s / n * h * row_elems, x, y, h, w, c);
    for (int vi = slice; vi < tps; vi += lanes) {
      const int ch = vi * kElems;
      const T* r0 = tp.r00 + ch;
      const Vec<T, kVec> v00 = load_tap<T, kVec>(r0, tp.i00);
      const Vec<T, kVec> v01 = load_tap<T, kVec>(r0 + c, tp.i01);
      const Vec<T, kVec> v10 = load_tap<T, kVec>(r0 + row_elems, tp.i10);
      const Vec<T, kVec> v11 = load_tap<T, kVec>(r0 + row_elems + c, tp.i11);
      Vec<T, kVec> o;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        o.e[e] = Bits<T>::from_float(lerp(v00, v01, v10, v11, tp.fx, tp.fy, e));
      }
      *reinterpret_cast<typename Raw<kVec>::U*>(out + s * c + ch) = o.raw;
    }
  }
}

template <typename T, int kVec>
int launch(const void* value, const float* x, const float* y, void* out, int64_t samples, int n,
           int h, int w, int c, cudaStream_t stream) {
  constexpr int kElems = Vec<T, kVec>::kElems;
  const int tps = c / kElems;
  const int lanes = tps < kThreads ? tps : kThreads;
  const int64_t rows = kThreads / lanes;
  const int64_t block_rows = (samples + rows - 1) / rows;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deform_sample_kernel<T, kVec>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(block_rows < slots ? block_rows : slots);
  deform_sample_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), x, y, static_cast<T*>(out), static_cast<int>(samples), n, h,
      w, c, tps, lanes, static_cast<int>(block_rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value: contiguous [batch, h, w, c], fp32 (dtype 0) or bf16 (dtype 1); xn, yn:
// contiguous fp32 [batch, n] normalised coordinates; out: contiguous
// [batch, n, c] in value's dtype; batch * n below 2^31. Returns a cudaError_t.
extern "C" int vfmseg_deform_sample(const void* value, const void* xn, const void* yn, void* out,
                                    int batch, int n, int h, int w, int c, int dtype,
                                    void* stream) {
  const int64_t samples = static_cast<int64_t>(batch) * n;
  if (samples == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (samples > 0x7fffffff || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xn);
  const float* y = static_cast<const float*>(yn);
  if (dtype == 0) {
    switch (vfmseg_deform::vec_bytes(value, out, c, 4)) {
      case 16: return launch<float, 16>(value, x, y, out, samples, n, h, w, c, st);
      case 8: return launch<float, 8>(value, x, y, out, samples, n, h, w, c, st);
      default: return launch<float, 4>(value, x, y, out, samples, n, h, w, c, st);
    }
  }
  if (dtype == 1) {
    switch (vfmseg_deform::vec_bytes(value, out, c, 2)) {
      case 16: return launch<__nv_bfloat16, 16>(value, x, y, out, samples, n, h, w, c, st);
      case 8: return launch<__nv_bfloat16, 8>(value, x, y, out, samples, n, h, w, c, st);
      case 4: return launch<__nv_bfloat16, 4>(value, x, y, out, samples, n, h, w, c, st);
      default: return launch<__nv_bfloat16, 2>(value, x, y, out, samples, n, h, w, c, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
