// Attention with SAM's decomposed relative-position bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel_relpos of vfmseg_tpu/ops/flash_attention.py,
// as launched by _flash_forward_relpos_hm (entry flash_attention_relpos_hm, the
// primal and the training forward of _flash_relpos_hm), which every block of
// SAM's ViT takes: the 28 windowed blocks (N = 14 x 14) and the 4 global ones
// (N = the whole grid). The JAX rule's backward recomputes through the plain
// formulation, and so does the port's (ops/attention.py); there is no backward
// kernel.
//
// For every batch item (or window) b and head h, with q_h, k_h, v_h [N, D] and
// N = kh * kw tokens on a kh x kw grid:
//
//   S[r, c] = (q_h[r] . k_h[c]) * scale + rel_h[r, c / kw] + rel_w[r, c % kw]
//   out_h   = softmax(S) v_h
//
// in fp32, with an exact online softmax over a running max, P rounded to bf16
// for P.V with fp32 accumulation, and the output in bf16: the numerics of
// xla_attention_decomposed_hm (attention_decomposed_plain in the port), not
// the TPU kernel's no-max exp2 softmax and its one-hot bias matmuls. The
// softmax runs in log2 units: the rel terms are staged pre-multiplied by
// log2 e, a score is one FADD (rel_h + rel_w) and one FFMA (s * scale * log2 e
// + that), and p = 2^(score - max) by ex2.
//
// Layout: q, k, v and out are [B, H, N, D] bf16 views with their own element
// strides (batch, head, token) and unit stride along the head dim, so SAM's
// attention reads q, k and v straight out of its fused qkv output [B, N, 3, H,
// D] and writes a token-major output for the proj product. rel_h [B, H, N, kh]
// and rel_w [B, H, N, kw] are contiguous bf16. D is 64 or 80 (SAM ViT-H), a
// template parameter.
//
// What bounds it, in two regimes. The global blocks (N = 1024 at the refine
// crops and in training, 2048 at stage 1) are bound by the tensor cores: 4 *
// N^2 * D operations per head on ~(4D + kh + kw) * 2 bytes a token, N/2
// operations a byte. The windowed blocks (N = 196) are bound by the bytes:
// ~100 operations a byte, under the card's ~295 ridge, with q, k, v and out
// the bulk of them. They carry most of B7's launches and time.
//
// The design, one warp-specialised kernel template for both regimes: the same
// pipeline keeps the tensor cores fed at the global blocks and the loads in
// flight across the windows' short rows, so two kernels would share all but
// their unit of work.
//
// * A block is three warpgroups (384 threads, one block a SM, persistent:
//   min(units, SMs) blocks walk the units, query tile fastest, then head,
//   then batch item). Warpgroup 0 is the producer, lowered by setmaxnreg to
//   kProducerRegs: one thread issues every TMA load, and its three other
//   warps stage the rel terms. Warpgroups 1 and 2 are the consumers, raised
//   to kConsumerRegs, each owning 64 rows of a 128-row query tile.
// * Units. Where a row's key steps leave a ring stage free (the 14 x 14
//   windows: 196 keys in two steps), a unit is a whole (window, head): its
//   two query tiles (128 rows, then 64 + 4) are two passes over one load of
//   K and V, and the second pass releases the stages. Elsewhere a unit is
//   one query tile.
// * TMA over the views with no copy on the host: at D = 80 a row is 160
//   bytes, more than one 128-byte swizzle span, so each tile is two TMA
//   boxes: the first 64 columns 128-byte swizzled (as B2 reads them) and the
//   last 16 columns 32-byte swizzled (rows of 32 bytes). S = Q.K^T takes four
//   k16 steps from the first and one from the second; O += P.V is m64n64 from
//   the first and m64n16 from the second, with P in registers. TMA issues a
//   request per box row, so two boxes a tile row, where boxes of one 16-byte
//   column (the no-swizzle core-matrix layout B5 fills by cp.async) would
//   take ten. Rows past N load as zeros.
// * A ring of K/V stages (three, or two where the rel staging leaves no room)
//   of 128 keys each, with full barriers (the producer's expect_tx, TMA's
//   complete_tx) and empty barriers that each consumer warp arrives at once
//   its P.V on that stage has retired; the Q tile is double-buffered where it
//   fits (the windows' two-step passes would wait for every Q load
//   otherwise).
// * The rel terms. The staging warps copy each query tile's rows of rel_h
//   and rel_w (one contiguous run of bf16 each, read 16 bytes a load with
//   several loads in flight: the run is a few KB, and its latency, not its
//   bytes, would stall the consumers) into shared memory as fp32
//   pre-multiplied by log2 e, double-buffered with their own barriers, a
//   tile ahead. Where kw is 32 or 64 (every global block on the path) the
//   columns a thread holds in the m64n128 accumulator (8j + 2t + e) fall on
//   a fixed set of c % kw on every key step: the thread keeps those rel_w
//   values in registers for the whole tile (kw / 2 of them) and reads rel_h
//   once per kw keys. Other grids (the 14 x 14 windows) look both up with a
//   (row, column) index advanced by 8 keys at a time, with no division per
//   score; with kw even the two columns of a pair never wrap, so one 8-byte
//   read gives both rel_w values.
// * The key steps: 128 keys, then a last step sized to the keys that remain
//   (16, 64 or 80 columns of S and 1, 4 or 5 k16 chunks of P.V; a remainder
//   above 80 takes a whole masked step): a window's 196 keys are 128 + 80,
//   not 256. Keys past N are masked to -inf; the first step always holds a
//   real key, so the running max is finite after it.
// * Overlap inside a consumer: S of step j + 1 is issued, then O is rescaled
//   and P.V of step j issued, and the softmax of step j + 1 runs while that
//   P.V is in flight; two named barriers ping-pong the tensor cores between
//   the consumers. No wgmma sits on a run-time branch (ptxas serialises them
//   there), so the first step of a pass is its own instantiation. A consumer
//   whose 64 rows all lie past N takes its turns and releases every buffer
//   without computing.
// * The output leaves from registers, 4-byte stores of bf16 pairs of rows
//   below N. (A TMA store through the consumer's dead Q rows ran slower on
//   the card: its addressing pushed the consumers past their registers.)
// * setmaxnreg's budget: the launch gives every thread 168 registers (65536
//   / 384), so kProducerRegs + 2 kConsumerRegs may not exceed 3 x 168 = 504,
//   or the consumers' raise never completes.
//
// Grids whose rel rows do not fit the shared memory beside the pipeline
// (kh + kw above ~110; none on SAM's paths) take the mma.sync kernel below,
// one 64-query block of 4 warps per (query tile, head, batch item), which
// stages its 64 rows of rel terms as fp32 and takes kh + kw up to 512.

#include <cuda.h>
#include <math.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vfmseg_attn;
using namespace vfmseg_hopper;

// ---------------------------------------------------------------------------
// The warp-specialised kernel.

constexpr int kQueries = 128;          // rows of a query tile
constexpr int kWgRows = 64;            // rows of a consumer warpgroup
constexpr int kKeys = 128;             // keys of a K/V ring stage
constexpr int kWsThreads = 384;        // producer + two consumers
constexpr int kConsumerWarps = 8;      // each arrives once at an empty barrier
constexpr int kRelThreads = 96;        // the producer's staging warps
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168, "setmaxnreg budget");
constexpr int kSw128Group = 8 * 128;   // 8 rows of 128 bytes
constexpr int kSw32Group = 8 * 32;     // 8 rows of 32 bytes
constexpr int kMaxQStages = 2;
constexpr int kMaxKvStages = 3;
constexpr int kRelStages = 2;
// Barriers: Q full / empty, rel full / empty (one per stage each), K full,
// V full and stage empty per ring stage.
constexpr int kBarQFull = 0;
constexpr int kBarQEmpty = kBarQFull + kMaxQStages;
constexpr int kBarRelFull = kBarQEmpty + kMaxQStages;
constexpr int kBarRelEmpty = kBarRelFull + kRelStages;
constexpr int kBarKFull = kBarRelEmpty + kRelStages;
constexpr int kBarVFull = kBarKFull + kMaxKvStages;
constexpr int kBarEmpty = kBarVFull + kMaxKvStages;
constexpr int kNumBars = kBarEmpty + kMaxKvStages;
constexpr int kBarBytes = 256;
static_assert(kNumBars * 8 <= kBarBytes, "barrier space");
constexpr int kSmemLimit = 232448;     // a block's shared memory on an H100
// Named barriers 1 and 2 order the consumers' products (ping-pong).
constexpr int kSchedBar = 1;

// A Q, K or V tile of 128 rows: the first 64 columns as 128-byte rows (16 KB,
// 128-byte swizzle), then at D = 80 the last 16 as 32-byte rows (4 KB, 32-byte
// swizzle).
template <int D>
struct Tile {
  static constexpr bool kRest = D == 80;
  static constexpr int kBytesA = kQueries * 128;
  static constexpr int kBytes = kQueries * D * 2;
};

// Row strides of the staged fp32 rel rows, in floats. rel_h: odd, so the 8
// rows of a warp read at one column fall in 8 banks. rel_w: an odd multiple
// of 8 (8 or 24 mod 32), so the 8-byte pairs of 4 rows fill 32 banks, and
// pairs stay 8-byte aligned.
__host__ __device__ __forceinline__ int rel_h_stride(int kh) { return kh | 1; }
__host__ __device__ __forceinline__ int rel_w_stride(int kw) {
  const int s = (kw + 7) & ~7;
  return (s / 8) % 2 == 1 ? s : s + 8;
}

// The key steps of a row of N keys: `full` steps of 128 (the last one masked
// where the remainder is above 80), then a `tail` step of 16, 64 or 80 keys
// (0: none).
struct Steps {
  int full;
  int tail;
};

__host__ __device__ __forceinline__ Steps key_steps(int n) {
  const int rem = n % kKeys;
  if (rem == 0) return {n / kKeys, 0};
  if (rem > 80) return {n / kKeys + 1, 0};
  return {n / kKeys, rem <= 16 ? 16 : (rem <= 64 ? 64 : 80)};
}

// Everything the kernel reads besides the tensor maps.
struct WsArgs {
  const bf16* rel_h;
  const bf16* rel_w;
  bf16* out;
  View so;
  int n, heads, kh, kw, sh, sw;
  int total_units;  // (query tiles / passes) x heads x batch items
  int passes;       // query tiles a unit takes over one load of K and V
  float scale_log2;
  int q_stages, kv_stages;
  int ring_off, rel_off, rel_stage_bytes, bar_off;
  int head_inner;  // the maps' dims are (d, head, token, batch), else (d, token, head, batch)
  int rel_vec;     // every (batch, head)'s rel rows start 16-byte aligned
};

// A unit's first query tile, head and batch item: query tiles fastest.
__device__ __forceinline__ void unit_coords(int unit, int q_units, int passes, int heads, int& qt0,
                                            int& h, int& b) {
  qt0 = (unit % q_units) * passes;
  const int bh = unit / q_units;
  h = bh % heads;
  b = bh / heads;
}

// Load the 128-row tile of a view at `row` (rows past N read as zeros) into
// `dst`: the 64-column box, then at D = 80 the 16-column box.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map_a,
                                          const CUtensorMap* map_b, uint64_t* bar, int row, int h,
                                          int b, int head_inner) {
  const int c1 = head_inner ? h : row;
  const int c2 = head_inner ? row : h;
  tma_load_4d(dst, map_a, bar, 0, c1, c2, b);
  if constexpr (Tile<D>::kRest) tma_load_4d(dst + Tile<D>::kBytesA, map_b, bar, 64, c1, c2, b);
}

// Stage 128 rows of a contiguous [*, c] bf16 rel term, of which the first
// `valid` exist, as fp32 rows `stride` floats apart, times log2 e; rows past
// `valid` are zero. The row of flat element e is (e + 0.5) / c by a float
// reciprocal: exact for e < 2^16 (128 rows of c <= 512), since (e + 0.5) / c
// lies at least 0.5 / c from an integer. With kVec the run starts 16-byte
// aligned and each thread reads chunks of 8 elements, kUnroll of them in
// flight at once (the run is a few KB, so its latency, not its bytes, is
// the cost); else one element a load.
__device__ __forceinline__ void put_rel(float* dst, int e, float v, int c, int stride,
                                        float inv_c) {
  const int r = __float2int_rz((static_cast<float>(e) + 0.5f) * inv_c);
  dst[r * stride + (e - r * c)] = v * kLog2e;
}

template <bool kVec>
__device__ __forceinline__ void stage_rel(float* dst, const bf16* __restrict__ src, int c,
                                          int stride, int valid, int ptid) {
  constexpr int kUnroll = 4;
  const int total = kQueries * c;
  const int live = valid * c;
  const float inv_c = 1.f / static_cast<float>(c);
  if constexpr (kVec) {
    const int chunks = total / 8;  // 128 c is a multiple of 8
    for (int k0 = ptid; k0 < chunks; k0 += kRelThreads * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = 8 * (k0 + u * kRelThreads);
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e + 8 <= live) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(src + e));
        } else if (e < live) {  // the chunk that ends the last tile's rows
          const uint16_t* bits = reinterpret_cast<const uint16_t*>(src) + e;
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (e + i < live) w[i / 2] |= static_cast<uint32_t>(bits[i]) << (16 * (i % 2));
          }
          v[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = 8 * (k0 + u * kRelThreads);
        if (e < total) {
          const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            put_rel(dst, e + 2 * i, __uint_as_float(w[i] << 16), c, stride, inv_c);
            put_rel(dst, e + 2 * i + 1, __uint_as_float(w[i] & 0xffff0000u), c, stride, inv_c);
          }
        }
      }
    }
  } else {
    for (int e0 = ptid; e0 < total; e0 += kRelThreads * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kRelThreads;
        v[u] = e < live ? __bfloat162float(src[e]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kRelThreads;
        if (e < total) put_rel(dst, e, v[u], c, stride, inv_c);
      }
    }
  }
}

// A consumer warpgroup's state and steps. Each thread holds rows g and g + 8
// of its warp's 16 and, for every 8 columns j of an accumulator, columns
// 8j + 2t and 8j + 2t + 1 (element 4j + 2r + e is row g + 8r, column
// 8j + 2t + e).
template <int D, int kRegK>
struct Consumer {
  static constexpr int kRegW = kRegK > 0 ? kRegK : 1;

  unsigned char* smem;
  uint64_t* bar;
  int n, kw, kv_stages, ring_off;
  float scale_log2;
  int t, lane, cw;
  int d8i, d8w;      // lookup: 8 keys are d8i grid rows and d8w columns
  bool kw_even;

  // this tile
  const unsigned char* qa;
  const unsigned char* qb;
  const float* rh[2];
  const float* rw[2];
  float rwr[2][kRegW][2];  // kw = 8 kRegK: rel_w of this thread's columns
  int qs, rs;
  uint32_t rel_ph;
  bool release;  // the unit's last pass: release the K/V stages

  // the ring: the current step's stage and phase, and the previous step's
  int st;
  uint32_t ph;
  int prev;
  uint32_t prev_ph;

  float o[32];
  float o16[Tile<D>::kRest ? 8 : 1];
  float m[2], l[2], alpha[2];
  uint32_t p[kKeys / 16][4];

  __device__ __forceinline__ unsigned char* ring(int stage) const {
    return smem + ring_off + stage * 2 * Tile<D>::kBytes;
  }

  __device__ __forceinline__ void advance() {
    prev = st;
    prev_ph = ph;
    if (++st == kv_stages) {
      st = 0;
      ph ^= 1u;
    }
  }

  // S = Q.K^T over kCols keys of stage `stage`, both operands K-major.
  template <int kCols>
  __device__ __forceinline__ void issue_s(float (&s)[kCols / 2], int stage) {
    const unsigned char* k = ring(stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<0, 0>(s, smem_desc_sw128(qa + kk * 32, 0, kSw128Group),
                     smem_desc_sw128(k + kk * 32, 0, kSw128Group), kk);
    }
    if constexpr (Tile<D>::kRest) {
      wgmma_ss<0, 0>(s, smem_desc_sw32(qb, 0, kSw32Group),
                     smem_desc_sw32(k + Tile<D>::kBytesA, 0, kSw32Group), 1);
    }
    wgmma_commit();
  }

  // O += P.V over kChunks x 16 keys of stage `stage`: P from registers, V an
  // MN-major B (keys the contraction): 16 keys are two 8-row groups.
  template <int kChunks>
  __device__ __forceinline__ void issue_pv(const uint32_t (&pp)[kChunks][4], int stage) {
    const unsigned char* v = ring(stage) + Tile<D>::kBytes;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      wgmma_rs<1>(o, pp[c], smem_desc_sw128(v + c * 2 * kSw128Group, kSw128Group, kSw128Group), 1);
      if constexpr (Tile<D>::kRest) {
        wgmma_rs<1>(o16, pp[c],
                    smem_desc_sw32(v + Tile<D>::kBytesA + c * 2 * kSw32Group, kSw32Group,
                                   kSw32Group),
                    1);
      }
    }
    wgmma_commit();
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    if constexpr (Tile<D>::kRest) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        o16[4 * j] *= alpha[0];
        o16[4 * j + 1] *= alpha[0];
        o16[4 * j + 2] *= alpha[1];
        o16[4 * j + 3] *= alpha[1];
      }
    }
  }

  __device__ __forceinline__ void fence_o() {
    fence_regs(o);
    if constexpr (Tile<D>::kRest) fence_regs(o16);
  }

  // The rel_w values of this thread's columns, for the whole tile (kw = 8
  // kRegK divides the 128-key step).
  __device__ __forceinline__ void load_rel_w_regs() {
    if constexpr (kRegK > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int jj = 0; jj < kRegK; ++jj) {
          const float2 w = *reinterpret_cast<const float2*>(rw[r] + 8 * jj + 2 * t);
          rwr[r][jj][0] = w.x;
          rwr[r][jj][1] = w.y;
        }
      }
    }
  }

  // Raw scores of kCols keys from k0 -> scores in log2 units with the bias,
  // keys >= valid at -inf.
  template <int kCols>
  __device__ __forceinline__ void add_bias(float (&s)[kCols / 2], int k0, int valid) const {
    const float sl2 = scale_log2;
    if constexpr (kRegK > 0) {
      // kw = 8 kRegK: column 8j + 2t + e is grid row k0 / kw + j / kRegK and
      // grid column 8 (j % kRegK) + 2t + e.
      const int ib = k0 / (8 * kRegK);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float hv = rh[r][ib + j / kRegK];
          s[4 * j + 2 * r] = fmaf(s[4 * j + 2 * r], sl2, hv + rwr[r][j % kRegK][0]);
          s[4 * j + 2 * r + 1] = fmaf(s[4 * j + 2 * r + 1], sl2, hv + rwr[r][j % kRegK][1]);
        }
      }
    } else {
      // The grid (row, column) of column 2t, advanced by 8 keys a j.
      const int key = k0 + 2 * t;
      int i = key / kw;
      int w = key - i * kw;
      if (kw_even) {
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float hv = rh[r][i];
            const float2 wv = *reinterpret_cast<const float2*>(rw[r] + w);
            s[4 * j + 2 * r] = fmaf(s[4 * j + 2 * r], sl2, hv + wv.x);
            s[4 * j + 2 * r + 1] = fmaf(s[4 * j + 2 * r + 1], sl2, hv + wv.y);
          }
          w += d8w;
          i += d8i;
          if (w >= kw) {
            w -= kw;
            ++i;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          int w1 = w + 1;
          int i1 = i;
          if (w1 == kw) {
            w1 = 0;
            ++i1;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            s[4 * j + 2 * r] = fmaf(s[4 * j + 2 * r], sl2, rh[r][i] + rw[r][w]);
            s[4 * j + 2 * r + 1] = fmaf(s[4 * j + 2 * r + 1], sl2, rh[r][i1] + rw[r][w1]);
          }
          w += d8w;
          i += d8i;
          if (w >= kw) {
            w -= kw;
            ++i;
          }
        }
      }
    }
    if (valid < kCols) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (col >= valid) s[4 * j + 2 * r] = -INFINITY;
          if (col + 1 >= valid) s[4 * j + 2 * r + 1] = -INFINITY;
        }
      }
    }
  }

  // One step of the online softmax on scores in log2 units: the running max
  // m, this thread's part of the row sums l and O's rescale factor alpha are
  // updated, and s becomes P = 2^(s - m).
  template <int kCols>
  __device__ __forceinline__ void softmax(float (&s)[kCols / 2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2_approx(s[4 * j + e] - m[e >> 1]);
        s[4 * j + e] = pe;
        l[e >> 1] += pe;
      }
    }
  }

  // One key step of kCols keys from k0: S of this step with P.V of the
  // previous one (none on the tile's first step) in flight, then this step's
  // softmax; P of this step lands in pn. `last`: the tile's last step.
  // kFirst is a template parameter so that no wgmma sits on a run-time
  // branch, which would make ptxas serialise them.
  template <int kCols, bool kFirst>
  __device__ __forceinline__ void step(float (&s)[kCols / 2], uint32_t (&pn)[kCols / 16][4],
                                       int k0, bool last) {
    mbar_wait(&bar[kBarKFull + st], ph);
    named_bar_sync(kSchedBar + cw, 2 * 128);
    issue_s<kCols>(s, st);
    if constexpr (!kFirst) {
      rescale();
      mbar_wait(&bar[kBarVFull + prev], prev_ph);
      issue_pv<kKeys / 16>(p, prev);
    }
    named_bar_arrive(kSchedBar + (cw ^ 1), 2 * 128);
    if constexpr (kFirst) {
      wgmma_wait<0>();
    } else {
      wgmma_wait<1>();
    }
    fence_regs(s);
    if (last && lane == 0) mbar_arrive(&bar[kBarQEmpty + qs]);
    if constexpr (kFirst) {
      mbar_wait(&bar[kBarRelFull + rs], rel_ph);
      load_rel_w_regs();
    }
    add_bias<kCols>(s, k0, n - k0);
    softmax<kCols>(s);
    if (last && lane == 0) mbar_arrive(&bar[kBarRelEmpty + rs]);
    if constexpr (!kFirst) {
      wgmma_wait<0>();
      fence_o();
#pragma unroll
      for (int c = 0; c < kKeys / 16; ++c) fence_regs(p[c]);
      if (release && lane == 0) mbar_arrive(&bar[kBarEmpty + prev]);
    }
#pragma unroll
    for (int c = 0; c < kCols / 16; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pn[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
    }
    advance();
  }

  // The last P.V of a tile, on the stage of the step just taken.
  template <int kChunks>
  __device__ __forceinline__ void finish(uint32_t (&pp)[kChunks][4]) {
    rescale();
    mbar_wait(&bar[kBarVFull + prev], prev_ph);
    issue_pv<kChunks>(pp, prev);
    wgmma_wait<0>();
    fence_o();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(pp[c]);
    if (release && lane == 0) mbar_arrive(&bar[kBarEmpty + prev]);
  }

  // The tail step of kCols keys, then the tile's last P.V.
  template <int kCols, bool kFirst>
  __device__ __forceinline__ void tail(int k0) {
    float s[kCols / 2];
    uint32_t pt[kCols / 16][4];
    step<kCols, kFirst>(s, pt, k0, true);
    finish<kCols / 16>(pt);
  }

  // The tail step of kCols keys after `full` whole steps.
  template <int kCols>
  __device__ __forceinline__ void tail_after(int full) {
    if (full == 0) {
      tail<kCols, true>(0);
    } else {
      tail<kCols, false>(full * kKeys);
    }
  }
};

template <int D, int kRegK>
__global__ void __launch_bounds__(kWsThreads, 1)
    attention_relpos_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_q16,
                            const __grid_constant__ CUtensorMap tm_k16,
                            const __grid_constant__ CUtensorMap tm_v16, const WsArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q_units = (a.n + kQueries - 1) / kQueries / a.passes;
  const Steps steps = key_steps(a.n);
  const int n_steps = steps.full + (steps.tail ? 1 : 0);

  if (tid == 0) {
    for (int s = 0; s < kMaxQStages; ++s) {
      mbar_init(&bar[kBarQFull + s], 1);
      mbar_init(&bar[kBarQEmpty + s], kConsumerWarps);
    }
    for (int s = 0; s < kRelStages; ++s) {
      mbar_init(&bar[kBarRelFull + s], kRelThreads);
      mbar_init(&bar[kBarRelEmpty + s], kConsumerWarps);
    }
    for (int s = 0; s < kMaxKvStages; ++s) {
      mbar_init(&bar[kBarKFull + s], 1);
      mbar_init(&bar[kBarVFull + s], 1);
      mbar_init(&bar[kBarEmpty + s], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      // TMA: each unit's Q tiles, and its key steps' K and V tiles once.
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      if constexpr (Tile<D>::kRest) {
        prefetch_tensormap(&tm_q16);
        prefetch_tensormap(&tm_k16);
        prefetch_tensormap(&tm_v16);
      }
      int st = 0;
      uint32_t ph = 0;
      int qi = 0;  // query tiles taken so far
      for (int unit = blockIdx.x; unit < a.total_units; unit += gridDim.x) {
        int qt0, h, b;
        unit_coords(unit, q_units, a.passes, a.heads, qt0, h, b);
        for (int pass = 0; pass < a.passes; ++pass, ++qi) {
          const int qs = qi % a.q_stages;
          mbar_wait(&bar[kBarQEmpty + qs], ((qi / a.q_stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&bar[kBarQFull + qs], Tile<D>::kBytes);
          load_tile<D>(smem + qs * Tile<D>::kBytes, &tm_q, &tm_q16, &bar[kBarQFull + qs],
                       (qt0 + pass) * kQueries, h, b, a.head_inner);
          if (pass > 0) continue;
          for (int j = 0; j < n_steps; ++j) {
            unsigned char* const ring = smem + a.ring_off + st * 2 * Tile<D>::kBytes;
            mbar_wait(&bar[kBarEmpty + st], ph ^ 1);
            mbar_arrive_expect_tx(&bar[kBarKFull + st], Tile<D>::kBytes);
            load_tile<D>(ring, &tm_k, &tm_k16, &bar[kBarKFull + st], j * kKeys, h, b,
                         a.head_inner);
            mbar_arrive_expect_tx(&bar[kBarVFull + st], Tile<D>::kBytes);
            load_tile<D>(ring + Tile<D>::kBytes, &tm_v, &tm_v16, &bar[kBarVFull + st], j * kKeys,
                         h, b, a.head_inner);
            if (++st == a.kv_stages) {
              st = 0;
              ph ^= 1u;
            }
          }
        }
      }
    } else if (tid >= 32) {
      // The rel terms of each query tile, a tile ahead of the consumers.
      const int ptid = tid - 32;
      int qi = 0;
      for (int unit = blockIdx.x; unit < a.total_units; unit += gridDim.x) {
        int qt0, h, b;
        unit_coords(unit, q_units, a.passes, a.heads, qt0, h, b);
        for (int pass = 0; pass < a.passes; ++pass, ++qi) {
          const int rs = qi & 1;
          mbar_wait(&bar[kBarRelEmpty + rs], ((qi >> 1) & 1) ^ 1);
          float* const dh = reinterpret_cast<float*>(smem + a.rel_off + rs * a.rel_stage_bytes);
          const int row0 = (qt0 + pass) * kQueries;
          const int valid = min(kQueries, a.n - row0);
          const int64_t base = (static_cast<int64_t>(b) * a.heads + h) * a.n + row0;
          if (a.rel_vec) {
            stage_rel<true>(dh, a.rel_h + base * a.kh, a.kh, a.sh, valid, ptid);
            stage_rel<true>(dh + kQueries * a.sh, a.rel_w + base * a.kw, a.kw, a.sw, valid, ptid);
          } else {
            stage_rel<false>(dh, a.rel_h + base * a.kh, a.kh, a.sh, valid, ptid);
            stage_rel<false>(dh + kQueries * a.sh, a.rel_w + base * a.kw, a.kw, a.sw, valid,
                             ptid);
          }
          mbar_arrive(&bar[kBarRelFull + rs]);
        }
      }
    }
    return;
  }

  // The consumers.
  setmaxnreg_inc<kConsumerRegs>();
  Consumer<D, kRegK> c;
  c.smem = smem;
  c.bar = bar;
  c.n = a.n;
  c.kw = a.kw;
  c.kv_stages = a.kv_stages;
  c.ring_off = a.ring_off;
  c.scale_log2 = a.scale_log2;
  c.cw = wg - 1;
  c.lane = tid & 31;
  c.t = c.lane & 3;
  const int warp = (tid >> 5) & 3;
  const int g = c.lane >> 2;
  c.d8i = 8 / a.kw;
  c.d8w = 8 % a.kw;
  c.kw_even = (a.kw & 1) == 0;
  c.st = 0;
  c.ph = 0;
  c.prev = 0;
  c.prev_ph = 0;
  // Consumer 0 takes the tensor cores first.
  if (c.cw == 1) named_bar_arrive(kSchedBar, 2 * 128);

  int qi = 0;
  for (int unit = blockIdx.x; unit < a.total_units; unit += gridDim.x) {
    int qt0, h, b;
    unit_coords(unit, q_units, a.passes, a.heads, qt0, h, b);
    // Every pass takes the unit's K/V stages from the same point of the
    // ring; the last one releases them.
    const int st0 = c.st;
    const uint32_t ph0 = c.ph;
    for (int pass = 0; pass < a.passes; ++pass, ++qi) {
      c.st = st0;
      c.ph = ph0;
      c.release = pass == a.passes - 1;
      const int row0 = (qt0 + pass) * kQueries + c.cw * kWgRows;
      c.qs = qi % a.q_stages;
      c.rs = qi & 1;
      c.rel_ph = (qi >> 1) & 1;

      if (row0 >= a.n) {
        // Every row of this consumer lies past N: it takes its turns and
        // releases what the other consumer reads, and computes nothing.
        for (int j = 0; j < n_steps; ++j) {
          named_bar_sync(kSchedBar + c.cw, 2 * 128);
          named_bar_arrive(kSchedBar + (c.cw ^ 1), 2 * 128);
          if (c.lane == 0) {
            if (j == n_steps - 1) {
              mbar_arrive(&bar[kBarQEmpty + c.qs]);
              mbar_arrive(&bar[kBarRelEmpty + c.rs]);
            }
            if (j > 0 && c.release) mbar_arrive(&bar[kBarEmpty + c.prev]);
          }
          c.advance();
        }
        if (c.release && c.lane == 0) mbar_arrive(&bar[kBarEmpty + c.prev]);
        continue;
      }

      unsigned char* const q = smem + c.qs * Tile<D>::kBytes;
      c.qa = q + c.cw * kWgRows * 128;
      c.qb = q + Tile<D>::kBytesA + c.cw * kWgRows * 32;
      const float* const rel = reinterpret_cast<const float*>(smem + a.rel_off +
                                                              c.rs * a.rel_stage_bytes);
      const int lr = c.cw * kWgRows + warp * 16 + g;  // the tile row of r = 0
      c.rh[0] = rel + lr * a.sh;
      c.rh[1] = c.rh[0] + 8 * a.sh;
      c.rw[0] = rel + kQueries * a.sh + lr * a.sw;
      c.rw[1] = c.rw[0] + 8 * a.sw;
#pragma unroll
      for (int i = 0; i < 32; ++i) c.o[i] = 0.f;
      if constexpr (Tile<D>::kRest) {
#pragma unroll
        for (int i = 0; i < 8; ++i) c.o16[i] = 0.f;
      }
      c.m[0] = c.m[1] = -INFINITY;
      c.l[0] = c.l[1] = 0.f;

      mbar_wait(&bar[kBarQFull + c.qs], (qi / a.q_stages) & 1);
      if (steps.full > 0) {
        float s[kKeys / 2];
        c.template step<kKeys, true>(s, c.p, 0, n_steps == 1);
      }
      for (int j = 1; j < steps.full; ++j) {
        float s[kKeys / 2];
        c.template step<kKeys, false>(s, c.p, j * kKeys, j == n_steps - 1);
      }
      if (steps.tail == 16) {
        c.template tail_after<16>(steps.full);
      } else if (steps.tail == 64) {
        c.template tail_after<64>(steps.full);
      } else if (steps.tail == 80) {
        c.template tail_after<80>(steps.full);
      } else {
        c.template finish<kKeys / 16>(c.p);
      }

      // out = O / rowsum in bf16, rows below N.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr_sum = c.l[r];
        lr_sum += __shfl_xor_sync(0xffffffffu, lr_sum, 1);
        lr_sum += __shfl_xor_sync(0xffffffffu, lr_sum, 2);
        const float inv = 1.f / lr_sum;
        const int row = row0 + warp * 16 + g + 8 * r;
        if (row >= a.n) continue;
        bf16* const orow = at(a.out, a.so, b, h, row) + 2 * c.t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(c.o[4 * j + 2 * r] * inv, c.o[4 * j + 2 * r + 1] * inv);
        }
        if constexpr (Tile<D>::kRest) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            *reinterpret_cast<uint32_t*>(orow + 64 + 8 * j) =
                pack_bf16(c.o16[4 * j + 2 * r] * inv, c.o16[4 * j + 2 * r + 1] * inv);
          }
        }
      }
    }
  }
}

// A failed cuTensorMapEncodeTiled returns kEncodeError + its CUresult; the
// function missing from libcuda, kEncodeError - 1.
constexpr int kEncodeError = 1 << 20;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime already loaded;
// looked up once.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a [B, H, N, D] bf16 view with element strides `s` (dims d, then
// head and token in the order of their strides, then batch), boxes of
// `cols` columns from column 0 or 64 and 128 rows of one head and batch item,
// swizzled to `cols` * 2 bytes (128 or 32), zero fill past N. Strides of
// dims of size 1 are never stepped: they become a row's bytes (head, token)
// or the largest other stride (batch), which keeps the strides ascending.
int encode_view(CUtensorMap* map, const void* base, const View& s, int batch, int heads, int n,
                int d, int cols, bool head_inner) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError - 1;
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t sh = heads > 1 ? static_cast<cuuint64_t>(s.h) * 2 : row;
  const cuuint64_t sn = n > 1 ? static_cast<cuuint64_t>(s.n) * 2 : row;
  const cuuint64_t sb = batch > 1 ? static_cast<cuuint64_t>(s.b) * 2 : (sh > sn ? sh : sn);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(head_inner ? heads : n),
                              static_cast<cuuint64_t>(head_inner ? n : heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {head_inner ? sh : sn, head_inner ? sn : sh, sb};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(head_inner ? 1 : kQueries),
                             static_cast<cuuint32_t>(head_inner ? kQueries : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// The shared memory of the warp-specialised kernel at head dim D and a grid
// with rel strides (sh, sw), with the Q and ring stages chosen: two Q stages
// and three ring stages where they fit, then one Q stage, then two ring
// stages. False where not even one Q and two ring stages fit.
template <int D>
bool ws_layout(WsArgs& a, int& bytes) {
  const int rel_stage = kQueries * (a.sh + a.sw) * 4;
  const int pick[4][2] = {{2, 3}, {1, 3}, {2, 2}, {1, 2}};
  for (const auto& qk : pick) {
    const int ring_off = qk[0] * Tile<D>::kBytes;
    const int rel_off = ring_off + qk[1] * 2 * Tile<D>::kBytes;
    const int bar_off = rel_off + kRelStages * rel_stage;
    const int total = bar_off + kBarBytes + 1024;  // + alignment slack
    if (total <= kSmemLimit) {
      a.q_stages = qk[0];
      a.kv_stages = qk[1];
      a.ring_off = ring_off;
      a.rel_off = rel_off;
      a.rel_stage_bytes = rel_stage;
      a.bar_off = bar_off;
      bytes = total;
      return true;
    }
  }
  return false;
}

template <int D, int kRegK>
int launch_ws_kernel(const CUtensorMap (&maps)[6], const WsArgs& a, int bytes, int grid,
                     cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_relpos_kernel<D, kRegK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_relpos_kernel<D, kRegK><<<grid, kWsThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The mma.sync kernel, for grids whose rel rows the warp-specialised kernel
// cannot stage: one block of 4 warps per (64 query rows, head, batch item),
// 16 rows a warp, bf16 mma.sync.m16n8k16 with fp32 accumulators, K and V
// tiles of 64 keys staged with 8 elements of row padding, the block's 64 rows
// of rel_h and rel_w staged once as fp32 (row strides made odd), a natural
// exp.

struct RelposArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* rel_h;
  const bf16* rel_w;
  bf16* out;
  View sq, sk, sv, so;
  int heads, n, kh, kw;
  float scale;
};

// Odd row stride of a staged fp32 rel-term row of c entries.
__host__ __device__ __forceinline__ int odd_stride(int c) { return c | 1; }

template <int D>
size_t mma_smem_bytes(int kh, int kw) {
  return 3 * sizeof(bf16) * Dims<D>::kTileElems +
         sizeof(float) * kBlock * (odd_stride(kh) + odd_stride(kw));
}

// Stage rows [0, valid) of a contiguous [*, c] bf16 rel term as fp32 rows of
// stride `stride`; rows past `valid` are zero.
__device__ __forceinline__ void stage_rel_mma(float* dst, const bf16* src, int c, int stride,
                                              int valid, int tid) {
  for (int i = tid; i < kBlock * c; i += kThreads) {
    const int r = i / c;
    dst[r * stride + (i - r * c)] = r < valid ? __bfloat162float(src[i]) : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_relpos_mma_kernel(const RelposArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + Dims<D>::kTileElems;
  bf16* sv = sk + Dims<D>::kTileElems;
  const int sh = odd_stride(a.kh);
  const int sw = odd_stride(a.kw);
  float* srh = reinterpret_cast<float*>(sv + Dims<D>::kTileElems);
  float* srw = srh + kBlock * sh;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int valid_q = a.n - q0;

  load_tile_d<D>(sq, at(a.q, a.sq, b, h, q0), a.sq.n, valid_q, tid);
  const int64_t rel_row0 = (static_cast<int64_t>(b) * a.heads + h) * a.n + q0;
  stage_rel_mma(srh, a.rel_h + rel_row0 * a.kh, a.kh, sh, valid_q, tid);
  stage_rel_mma(srw, a.rel_w + rel_row0 * a.kw, a.kw, sw, valid_q, tid);
  __syncthreads();
  uint32_t qa[Dims<D>::kChunks][4];
  load_a_rows_d<D>(qa, sq, warp, g, t);

  // this thread's two rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + g;
  const float* rh[2] = {srh + r0 * sh, srh + (r0 + 8) * sh};
  const float* rw[2] = {srw + r0 * sw, srw + (r0 + 8) * sw};
  // key / kw by a float reciprocal: exact while N < 2^16, since (key + 0.5)
  // / kw lies at least 0.5 / kw from an integer
  const float inv_kw = 1.f / static_cast<float>(a.kw);

  float o[Dims<D>::kTiles][4];
#pragma unroll
  for (int i = 0; i < Dims<D>::kTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.n; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_d<D>(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.n - k0, tid);
    load_tile_d<D>(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.n - k0, tid);
    __syncthreads();

    float s[kNTiles][4];
    mma_scores<D>(s, qa, sk, g, t);  // S = Q.K^T, 16 rows x 64 keys

    // Scale, add the bias of (row, key) and mask keys past N at -inf; the
    // first tile always holds a real key, so m is finite after it.
    const int valid = a.n - k0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        float x0 = -INFINITY;
        float x1 = -INFINITY;
        if (col < valid) {
          const int key = k0 + col;
          const int i = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_kw);
          const int w = key - i * a.kw;
          x0 = s[nt][j] * a.scale + rh[0][i] + rw[0][w];
          x1 = s[nt][2 + j] * a.scale + rh[1][i] + rw[1][w];
        }
        s[nt][j] = x0;
        s[nt][2 + j] = x1;
        mx[0] = fmaxf(mx[0], x0);
        mx[1] = fmaxf(mx[1], x1);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < Dims<D>::kTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    mma_pv<D>(o, s, sv, g, t);  // O += P.V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows_d<D>(at(a.out, a.so, b, h, 0), a.so.n, q0 + r0, a.n, o, 1.f / l[0], 1.f / l[1], t);
}

template <int D>
int launch_mma(const RelposArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>(a.kh, a.kw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_relpos_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.n + kBlock - 1) / kBlock, a.heads, batch);
  attention_relpos_mma_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The entry's choice between the two kernels.

template <int D>
int launch(const RelposArgs& r, int batch, cudaStream_t stream) {
  WsArgs a{};
  a.rel_h = r.rel_h;
  a.rel_w = r.rel_w;
  a.out = r.out;
  a.so = r.so;
  a.n = r.n;
  a.heads = r.heads;
  a.kh = r.kh;
  a.kw = r.kw;
  a.sh = rel_h_stride(r.kh);
  a.sw = rel_w_stride(r.kw);
  a.scale_log2 = r.scale * kLog2e;
  a.rel_vec = reinterpret_cast<uintptr_t>(r.rel_h) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(r.rel_w) % 16 == 0 &&
              (static_cast<int64_t>(r.n) * r.kh * 2) % 16 == 0 &&
              (static_cast<int64_t>(r.n) * r.kw * 2) % 16 == 0;
  int bytes = 0;
  if (!ws_layout<D>(a, bytes)) return launch_mma<D>(r, batch, stream);

  // Where a row's key steps leave a ring stage free, one unit takes every
  // query tile of a (head, batch item) over one load of K and V (the 14 x 14
  // windows: two tiles, two steps); else a unit is one query tile.
  const int q_tiles = (r.n + kQueries - 1) / kQueries;
  const Steps steps = key_steps(r.n);
  a.passes = steps.full + (steps.tail ? 1 : 0) < a.kv_stages ? q_tiles : 1;
  const int64_t total = static_cast<int64_t>(q_tiles / a.passes) * r.heads * batch;
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  a.total_units = static_cast<int>(total);
  // The maps' middle dims in the order of their strides (SAM's fused qkv
  // views: head, then token).
  a.head_inner = (r.heads == 1 || (r.n > 1 && r.sq.h <= r.sq.n)) ? 1 : 0;
  const bool hi = a.head_inner != 0;
  CUtensorMap maps[6];
  const void* bases[3] = {r.q, r.k, r.v};
  const View views[3] = {r.sq, r.sk, r.sv};
  int status = 0;
  for (int i = 0; i < 3 && status == 0; ++i) {
    status = encode_view(&maps[i], bases[i], views[i], batch, r.heads, r.n, D, 64, hi);
    if (status == 0) {
      if (D == 80) {
        status = encode_view(&maps[3 + i], bases[i], views[i], batch, r.heads, r.n, D, 16, hi);
      } else {
        maps[3 + i] = maps[i];
      }
    }
  }
  if (status != 0) return status;

  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(total < sms ? total : sms);
  if constexpr (D == 80) {
    if (r.kw == 32) return launch_ws_kernel<80, 4>(maps, a, bytes, grid, stream);
    if (r.kw == 64) return launch_ws_kernel<80, 8>(maps, a, bytes, grid, stream);
  }
  return launch_ws_kernel<D, 0>(maps, a, bytes, grid, stream);
}

}  // namespace

// q, k, v, out: [B, H, n, head_dim] bf16 views with unit stride along the head
// dim, other strides multiples of 8 and 16-byte aligned data; strides holds 12
// int64: (batch, head, token) of q, k, v, out. rel_h [B, H, n, kh] and rel_w
// [B, H, n, kw]: contiguous bf16, n = kh * kw < 65536, kh + kw <= 512.
// head_dim: 64 or 80. Returns a cudaError_t, or a tensor-map encode failure
// (>= 2^20; see vfmseg_error_string).
extern "C" int vfmseg_attention_relpos(const void* q, const void* k, const void* v,
                                       const void* rel_h, const void* rel_w, void* out,
                                       const long long* strides, int batch, int heads, int n,
                                       int kh, int kw, int head_dim, float scale, void* stream) {
  RelposArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.rel_h = static_cast<const bf16*>(rel_h);
  a.rel_w = static_cast<const bf16*>(rel_w);
  a.out = static_cast<bf16*>(out);
  a.sq = view(strides, 0);
  a.sk = view(strides, 1);
  a.sv = view(strides, 2);
  a.so = view(strides, 3);
  a.heads = heads;
  a.n = n;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  if (kh * kw != n || n >= 65536 || kh + kw > 512) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(a, batch, s);
  if (head_dim == 80) return launch<80>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
