// Ordered window blend for Hopper (sm_90a): base[img_i[i], y:y+ch, x:x+cw, :]
// += delta[i], for i in ascending order, in place.
//
// Replaces the TPU kernel vfmseg_tpu/ops/window_blend.py::_blend_kernel
// (launched by blend_windows). The compact gated engine adds the refine
// deltas of its k selected windows (pre-scaled by the inverse coverage) back
// over the stage-1 logit map. Windows overlap, so a pixel may take several
// adds; the TPU ran one grid cell per window in order. Here the result is the
// same chain: each add is rounded to the base's dtype, in ascending window
// order, so kernel and plain version (`blend_windows_plain`, a Python loop of
// slice adds) are bit-identical in fp32 and in bf16.
//
// What bounds it: device memory. The deltas are read once and every covered
// base element is read and written once, against one add per delta element.
//
// What the design does about it: no atomics, one launch, a fixed order. The
// grid tiles every image of the base into kTileH rows x kTileW pixels; each
// block first collects, in ascending order, the windows of its image that
// meet its tile (a ballot compaction over all k windows into shared memory),
// and leaves at once when there are none, so only covered tiles cost more
// than the scan. Then each thread owns elements of the tile's (x, C) runs:
// in [B, H, W, C] a tile row is one contiguous run of kTileW * C elements, and
// a window row one contiguous run of cw * C, so a window covers an element iff
// its row is in [y, y + ch) and its run offset x * C + c is in [x * C,
// (x + cw) * C): no division by C. Neighbouring threads read and write
// neighbouring elements of the base and of each delta row. The thread reads
// the base element once, adds every covering window's delta in list order
// with the dtype's rounding after each add, and writes it once; elements no
// window covers are never touched. Pad rows (the engine's zero deltas at a
// duplicated origin) are windows like any other and add +0. Windows of
// another image never enter a block's list.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 8;
constexpr int kTileW = 64;
constexpr int kMaxWindows = 1024;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
  __device__ __forceinline__ static float add(float acc, float d) { return __fadd_rn(acc, d); }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // the sum of two bf16 values in fp32, rounded back to bf16 (PyTorch's and
  // XLA's bf16 add)
  __device__ __forceinline__ static float add(float acc, float d) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, d)));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_blend_kernel(T* __restrict__ base, const T* __restrict__ delta,
                    const int* __restrict__ img_i, const int* __restrict__ ys,
                    const int* __restrict__ xs, int h, int w, int c, int k, int ch,
                    int cw) {
  __shared__ int s_slot[kMaxWindows];
  __shared__ int s_y[kMaxWindows];
  __shared__ int s_xc[kMaxWindows];
  __shared__ int s_warp[kWarps];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  if (tid == 0) s_count = 0;
  __syncthreads();
  // the windows of image b that meet this tile, in ascending order
  for (int first = 0; first < k; first += kThreads) {
    const int j = first + tid;
    bool hit = false;
    int wy = 0, wx = 0;
    if (j < k) {
      wy = ys[j];
      wx = xs[j];
      hit = img_i[j] == b && wy < y0 + kTileH && wy + ch > y0 && wx < x0 + kTileW &&
            wx + cw > x0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int pos = s_count + __popc(ballot & ((1u << lane) - 1u));
    for (int v = 0; v < warp; ++v) pos += s_warp[v];
    if (hit) {
      s_slot[pos] = j;
      s_y[pos] = wy;
      s_xc[pos] = wx * c;
    }
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int v = 0; v < kWarps; ++v) total += s_warp[v];
      s_count += total;
    }
    __syncthreads();
  }
  const int n = s_count;
  if (n == 0) return;

  const int run = min(kTileW, w - x0) * c;  // elements of one tile row
  const int xc0 = x0 * c;
  const int wrow = cw * c;                  // elements of one window row
  const long long win = static_cast<long long>(ch) * wrow;
  for (int r = 0; r < kTileH; ++r) {
    const int y = y0 + r;
    if (y >= h) break;
    T* row = base + (static_cast<long long>(b) * h + y) * static_cast<long long>(w) * c;
    for (int e = tid; e < run; e += kThreads) {
      const int gc = xc0 + e;
      bool touched = false;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        const int wy = s_y[i];
        const int wxc = s_xc[i];
        if (y < wy || y >= wy + ch || gc < wxc || gc >= wxc + wrow) continue;
        if (!touched) {
          acc = Elem<T>::load(row + gc);
          touched = true;
        }
        const T* d = delta + s_slot[i] * win + static_cast<long long>(y - wy) * wrow + (gc - wxc);
        acc = Elem<T>::add(acc, Elem<T>::load(d));
      }
      if (touched) Elem<T>::store(row + gc, acc);
    }
  }
}

template <typename T>
int launch(void* base, const void* delta, const int* img_i, const int* ys, const int* xs,
           int batch, int h, int w, int c, int k, int ch, int cw, cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  window_blend_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(base), static_cast<const T*>(delta), img_i, ys, xs, h, w, c, k, ch, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// base: contiguous [batch, h, w, c]; delta: contiguous [k, ch, cw, c] of the
// same dtype (0 = float32, 1 = bfloat16); img_i, ys, xs: int32 [k] on the
// device, each window inside the base. 1 <= k <= 1024, batch <= 65535.
// Returns a cudaError_t.
extern "C" int vfmseg_window_blend(void* base, const void* delta, const void* img_i,
                                   const void* ys, const void* xs, int batch, int h, int w,
                                   int c, int k, int ch, int cw, int dtype, void* stream) {
  if (k < 1 || k > kMaxWindows || batch < 1 || batch > 65535 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(img_i);
  const int* yp = static_cast<const int*>(ys);
  const int* xp = static_cast<const int*>(xs);
  if (dtype == 0) return launch<float>(base, delta, ip, yp, xp, batch, h, w, c, k, ch, cw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(base, delta, ip, yp, xp, batch, h, w, c, k, ch, cw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
