// Attention read straight from q/k/v projections, for Hopper (sm_90a): the
// inference forward and the training forward with its log-sum-exp, one
// warp-specialised TMA + wgmma kernel template with two instantiations.
//
// Replaces two TPU kernels of vfmseg_tpu/ops/flash_attention.py:
//
// * vfmseg_attention_qkv (B2): _fwd_kernel_qkv_tav (launched by
//   _flash_forward_qkv_tav_main, entry flash_attention_qkv_tm), the inference
//   primal of DINOv2's blocks and of VFMHead's decoder attention;
// * vfmseg_attention_qkv_fwd_lse (B3): _fwd_kernel_qkv (launched by
//   _flash_forward_qkv with with_lse=True, reached through
//   _flash_qkv_tm_fwd_rule), the training forward. It also writes, per batch
//   item, head and query row, lse = log(sum_k exp(q.k * scale)) in fp32 and
//   natural log, which the fused backward (attention_hm.cu) reads.
//
// B2-RoPE, EVA02's inference attention (attention_qkv_rope.cu), rotates q
// and k into a workspace and runs B2's kernel through attention_qkv_views,
// with v read where it lies. For every batch item b and head h:
//
//   out[b, :, h*64:(h+1)*64] = softmax(q_h k_h^T * scale) v_h
//
// where q_h, k_h, v_h are the 64 columns of head h in three [B, N, H*64] bf16
// views, each with its own (batch, token) stride pair (B2's and B3's entries
// pass one pair for all three). The three thirds of one fused qkv tensor
// (token stride 3*H*64), three separate tensors (token stride H*64) and
// B2-RoPE's rotated q and k (2*H*64) beside v in the qkv (3*H*64) all
// qualify, so no caller concatenates. The output is
// contiguous token-major [B, N, H*64] bf16, the layout the proj matmul
// reads; the LSE is contiguous [B, H, N] fp32.
//
// Numerics follow xla_attention (vfmseg_tpu/ops/attention.py:31-57): fp32
// logits, an exact softmax with a running max (online softmax) in log2 units
// (x = logit * scale * log2 e, scale, log2 e and the max folded into one FFMA
// before ex2), probabilities rounded to bf16 before the P.V product with fp32
// accumulation, and one division by the row sum at the end; lse = (m +
// log2 l) * ln 2. None of the TPU kernels' schedule (no-max exp2 softmax,
// transposed AV, head pairs, batch packing, the aligned-tail cls side-chain)
// is carried over: each answered a TPU lane or VMEM limit.
//
// What bounds it: the tensor cores. Per head it does 4*N^2*64 operations on
// 4*N*64*2 bytes, ~N/2 operations a byte (N = 1025 or 2049 on the main paths),
// well above the card's ~295 operations-a-byte ridge, while the N x N scores
// and probabilities never leave the SM.
//
// The design, for the tensor cores to be fed without stalls:
//
// * Warp specialisation. A block is three warpgroups (384 threads, one block
//   a SM). Warpgroup 0 is the producer: setmaxnreg lowers it to
//   kProducerRegs registers, and one of its threads issues every TMA load.
//   Warpgroups 1 and 2 are consumers raised to kConsumerRegs; each owns 64
//   of a query tile's 128 rows.
// * TMA over the token-major views, with no transpose or copy on the host:
//   a CUtensorMap per view (q, k, v, out) over dims {64 (d), H, N, B} with
//   byte strides {128, 2 * stride_n, 2 * stride_b}, boxes of {64, 1, 128, 1}
//   (64 rows for out) and the 128-byte swizzle; the maps are encoded on each
//   call and passed as __grid_constant__ parameters. Rows past N load as
//   zeros and are never stored, which covers N = 1025 and 2049.
// * A ring of three stages of (K tile, V tile), 128 keys each, with full
//   barriers for K and for V (the producer's expect_tx, TMA's complete_tx)
//   and an empty barrier that each consumer warp arrives at once its P.V
//   product on that stage has retired. The Q tile has its own full and empty
//   barriers; the consumers release it after their last S product, so the
//   next tile's Q lands during this tile's last P.V and epilogue.
// * wgmma from the swizzled tiles: S = Q.K^T as m64n128k16 with both
//   operands K-major; O += P.V as m64n64k16 with P in registers (the S
//   accumulator rounded to bf16 and re-packed as A fragments) and V an
//   MN-major B operand.
// * Overlap inside a warpgroup: S of key step j + 1 is issued, then O is
//   rescaled and P.V of step j issued, and the softmax of step j + 1 runs
//   while that P.V is in flight.
// * Ping-pong between the two consumers: two named barriers hand the tensor
//   cores from one warpgroup to the other after each pair of products, so
//   one warpgroup's softmax runs while the other's products do.
// * Persistent blocks with a static scheduler: min(tiles, SMs) blocks walk
//   the tiles (query tile fastest, then head, then batch item) with a
//   stride of the grid, so the blocks of one (head, batch item) read its K
//   and V from L2 at about the same time (B3's (4, 1025, 16) is 576 tiles,
//   4.4 waves of 132; stage 1's (1, 2049, 16) 272 tiles).
// * Epilogue: O / rowsum is written as bf16 into a 64-row swizzled staging
//   tile per consumer and leaves with one TMA store, which clips the rows
//   past N; the LSE of valid rows goes straight to device memory.
// * Ragged tails. At N = 1025 and 2049 the last key tile would hold one real
//   key: where N mod 128 is in (0, 16] the last key step reads a 16-key box
//   through two more maps (k, v with boxes of 16 rows) and multiplies
//   m64n16k16 and one k16 chunk of P.V, not a whole tile. Keys past N inside
//   a step are masked to -inf (the first step always holds a real key, so the
//   running max is finite after it). Where all 64 rows of consumer 1 lie past
//   N (the last query tile when N mod 128 is in (0, 64]), it only takes its
//   turns and releases the buffers, and consumer 0 runs alone.

#include <cuda.h>
#include <math.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vfmseg_attn;
using namespace vfmseg_hopper;

constexpr int kQueries = 128;                  // rows of a query tile
constexpr int kWgRows = 64;                    // rows of a consumer warpgroup
constexpr int kKeys = 128;                     // keys of a K/V tile
constexpr int kTail = 16;                      // keys of the tail step
constexpr int kStages = 3;                     // K/V ring stages
constexpr int kWsThreads = 384;                // producer + two consumers
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = kHeadDim * 2;        // 128: one swizzle span
constexpr int kTileBytes = kQueries * kRowBytes;  // a Q, K or V tile: 16 KB
constexpr int kTailBytes = kTail * kRowBytes;     // a 16-key K or V tail
constexpr int kWgTileBytes = kWgRows * kRowBytes; // a consumer's Q or O rows
constexpr int kSwizzleGroup = 8 * kRowBytes;      // 8 rows: 1024 bytes

// Shared memory, in bytes from a 1024-byte aligned base: Q tile, the two
// consumers' O staging tiles, the ring, then the barriers.
constexpr int kSmQ = 0;
constexpr int kSmO = kSmQ + kTileBytes;
constexpr int kSmRing = kSmO + 2 * kWgTileBytes;
constexpr int kStageBytes = 2 * kTileBytes;    // K then V
constexpr int kSmBar = kSmRing + kStages * kStageBytes;
// Barriers: Q full, Q empty, K full [kStages], V full [kStages], stage
// empty [kStages].
constexpr int kBarQFull = 0;
constexpr int kBarQEmpty = 1;
constexpr int kBarKFull = 2;
constexpr int kBarVFull = kBarKFull + kStages;
constexpr int kBarEmpty = kBarVFull + kStages;
constexpr int kNumBars = kBarEmpty + kStages;
constexpr int kSmemBytes = kSmBar + kNumBars * 8 + 1024;  // + alignment slack
// Consumer warps: each arrives once at an empty barrier.
constexpr int kConsumerWarps = kConsumerThreads / 32;
// Named barriers: 1 and 2 order the consumers' products (ping-pong), 3 and
// 4 are each consumer's epilogue.
constexpr int kSchedBar = 1;
constexpr int kEpiBar = 3;

static_assert(kSmO % 1024 == 0 && kSmRing % 1024 == 0 && kStageBytes % 1024 == 0,
              "swizzled tiles must stay 1024-byte aligned");

// S = Q.K^T for this warpgroup's 64 rows and kCols keys (a whole tile, or
// the 16-key tail), both K-major, 128-byte swizzled: the K (d) step of 16
// adds 32 bytes.
template <int kCols>
__device__ __forceinline__ void issue_s(float (&s)[kCols / 2], const unsigned char* sq,
                                        const unsigned char* sk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    wgmma_ss<0, 0>(s, smem_desc_sw128(sq + kk * 32, 0, kSwizzleGroup),
                   smem_desc_sw128(sk + kk * 32, 0, kSwizzleGroup), kk);
  }
  wgmma_commit();
}

// O += P.V over kChunks x 16 keys: P from registers (one A fragment per 16
// keys), V MN-major (keys are the contraction, d the 64 columns: one swizzle
// span, 8-key groups 1024 bytes apart; 16 keys are 2048 bytes).
template <int kChunks>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[kChunks][4],
                                         const unsigned char* sv) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    wgmma_rs<1>(o, p[c], smem_desc_sw128(sv + c * 2 * kSwizzleGroup, kSwizzleGroup, kSwizzleGroup),
                1);
  }
  wgmma_commit();
}

// One key step of the online softmax on the raw scores s of kCols keys: each
// thread holds rows g and g + 8 of its warp's 16 and, for every 8 keys j,
// columns 8j + 2t and 8j + 2t + 1 (s[4j + 2r], s[4j + 2r + 1] for row r).
// Keys >= valid are masked to -inf; the running max m (log2 units), this
// thread's part of the row sums l and O's rescale factor alpha are updated,
// and s becomes P = 2^(s * scale_log2 - m) in fp32.
template <int kCols>
__device__ __forceinline__ void softmax_step(float (&s)[kCols / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int valid,
                                             int t) {
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
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, neg_m[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// P in bf16 as the A fragments of P.V: 16 keys (two 8-key blocks) a fragment.
template <int kCols>
__device__ __forceinline__ void pack_p(uint32_t (&p)[kCols / 16][4], const float (&s)[kCols / 2]) {
#pragma unroll
  for (int c = 0; c < kCols / 16; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
  }
}

template <int kChunks>
__device__ __forceinline__ void fence_p(uint32_t (&p)[kChunks][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) fence_regs(p[c]);
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// The static tile order: query tile fastest, then head, then batch item, so
// the blocks of one (head, batch item) read its K and V from L2 at about the
// same time.
__device__ __forceinline__ void tile_coords(int tile, int q_tiles, int heads, int& qt, int& h,
                                            int& b) {
  qt = tile % q_tiles;
  const int bh = tile / q_tiles;
  h = bh % heads;
  b = bh / heads;
}

// Whether the last key step is a 16-key tail (read through the 16-row maps)
// rather than a whole tile: N = 1025 and 2049 end on one real key.
__host__ __device__ __forceinline__ bool has_tail(int n) {
  return n > kKeys && n % kKeys != 0 && n % kKeys <= kTail;
}

template <bool kWithLse>
__global__ void __launch_bounds__(kWsThreads, 1)
    attention_qkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_k_tail,
                         const __grid_constant__ CUtensorMap tm_v_tail,
                         const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int n,
                         int heads, int total_tiles, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + kSmBar);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n_steps = (n + kKeys - 1) / kKeys;
  const int q_tiles = (n + kQueries - 1) / kQueries;
  const bool tail = has_tail(n);

  if (tid == 0) {
    mbar_init(&bar[kBarQFull], 1);
    mbar_init(&bar[kBarQEmpty], kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar[kBarKFull + s], 1);
      mbar_init(&bar[kBarVFull + s], 1);
      mbar_init(&bar[kBarEmpty + s], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread walks the same tiles as the consumers and
    // keeps the Q buffer and the K/V ring filled.
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_k_tail);
      prefetch_tensormap(&tm_v_tail);
      prefetch_tensormap(&tm_o);
      int it = 0;
      int tile_iter = 0;
      for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x, ++tile_iter) {
        int qt, h, b;
        tile_coords(tile, q_tiles, heads, qt, h, b);
        mbar_wait(&bar[kBarQEmpty], (tile_iter & 1) ^ 1);
        mbar_arrive_expect_tx(&bar[kBarQFull], kTileBytes);
        tma_load_4d(smem + kSmQ, &tm_q, &bar[kBarQFull], 0, h, qt * kQueries, b);
        for (int j = 0; j < n_steps; ++j, ++it) {
          const int st = it % kStages;
          const bool last_tail = tail && j == n_steps - 1;
          const uint32_t bytes = last_tail ? kTailBytes : kTileBytes;
          unsigned char* const ring = smem + kSmRing + st * kStageBytes;
          mbar_wait(&bar[kBarEmpty + st], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&bar[kBarKFull + st], bytes);
          tma_load_4d(ring, last_tail ? &tm_k_tail : &tm_k, &bar[kBarKFull + st], 0, h, j * kKeys,
                      b);
          mbar_arrive_expect_tx(&bar[kBarVFull + st], bytes);
          tma_load_4d(ring + kTileBytes, last_tail ? &tm_v_tail : &tm_v, &bar[kBarVFull + st], 0,
                      h, j * kKeys, b);
        }
      }
    }
    return;
  }

  // The consumers.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool leader = (tid & 127) == 0;
  const unsigned char* const sq = smem + kSmQ + cw * kWgTileBytes;
  unsigned char* const so = smem + kSmO + cw * kWgTileBytes;
  const int n_full = n_steps - (tail ? 1 : 0);  // whole 128-key steps
  // Consumer 0 takes the tensor cores first.
  if (cw == 1) named_bar_arrive(kSchedBar, 2 * 128);

  int it = 0;
  int tile_iter = 0;
  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x, ++tile_iter) {
    int qt, h, b;
    tile_coords(tile, q_tiles, heads, qt, h, b);
    const int row0 = qt * kQueries + cw * kWgRows;

    if (row0 >= n) {
      // Every row of this consumer lies past N (consumer 1 on the last query
      // tile when N mod 128 is in (0, 64]): it takes its turns and releases
      // what the other consumer reads, at the same points, and computes
      // nothing, so the other one has the tensor cores to itself.
      for (int j = 0; j < n_steps; ++j) {
        named_bar_sync(kSchedBar + cw, 2 * 128);
        named_bar_arrive(kSchedBar + (cw ^ 1), 2 * 128);
        if (lane == 0) {
          if (j == n_steps - 1) mbar_arrive(&bar[kBarQEmpty]);
          if (j > 0) mbar_arrive(&bar[kBarEmpty + (it + j - 1) % kStages]);
        }
      }
      it += n_steps;
      if (lane == 0) mbar_arrive(&bar[kBarEmpty + (it - 1) % kStages]);
      continue;
    }

    float o[kHeadDim / 2];
#pragma unroll
    for (int i = 0; i < kHeadDim / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float s[kKeys / 2];
    uint32_t p[kKeys / 16][4];

    mbar_wait(&bar[kBarQFull], tile_iter & 1);
    int st = it % kStages;
    uint32_t ph = (it / kStages) & 1;
    mbar_wait(&bar[kBarKFull + st], ph);
    named_bar_sync(kSchedBar + cw, 2 * 128);
    issue_s<kKeys>(s, sq, smem + kSmRing + st * kStageBytes);
    named_bar_arrive(kSchedBar + (cw ^ 1), 2 * 128);
    wgmma_wait<0>();
    fence_regs(s);
    if (n_steps == 1 && lane == 0) mbar_arrive(&bar[kBarQEmpty]);
    softmax_step<kKeys>(s, m, l, alpha, scale_log2, n, t);
    pack_p<kKeys>(p, s);

    // Step j: S of step j, then P.V of step j - 1 while its softmax runs.
    for (int j = 1; j < n_full; ++j) {
      const int prev = st;
      const uint32_t prev_ph = ph;
      ++it;
      st = it % kStages;
      ph = (it / kStages) & 1;
      mbar_wait(&bar[kBarKFull + st], ph);
      named_bar_sync(kSchedBar + cw, 2 * 128);
      issue_s<kKeys>(s, sq, smem + kSmRing + st * kStageBytes);
      rescale(o, alpha);
      mbar_wait(&bar[kBarVFull + prev], prev_ph);
      issue_pv<kKeys / 16>(o, p, smem + kSmRing + prev * kStageBytes + kTileBytes);
      named_bar_arrive(kSchedBar + (cw ^ 1), 2 * 128);
      wgmma_wait<1>();
      fence_regs(s);
      if (j == n_steps - 1 && lane == 0) mbar_arrive(&bar[kBarQEmpty]);
      softmax_step<kKeys>(s, m, l, alpha, scale_log2, n - j * kKeys, t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_p(p);
      if (lane == 0) mbar_arrive(&bar[kBarEmpty + prev]);
      pack_p<kKeys>(p, s);
    }
    if (tail) {
      // The 16-key tail: S over 16 keys with P.V of the last whole step in
      // flight, then one k16 chunk of P.V.
      float s16[kTail / 2];
      uint32_t p16[kTail / 16][4];
      const int prev = st;
      const uint32_t prev_ph = ph;
      ++it;
      st = it % kStages;
      ph = (it / kStages) & 1;
      mbar_wait(&bar[kBarKFull + st], ph);
      named_bar_sync(kSchedBar + cw, 2 * 128);
      issue_s<kTail>(s16, sq, smem + kSmRing + st * kStageBytes);
      rescale(o, alpha);
      mbar_wait(&bar[kBarVFull + prev], prev_ph);
      issue_pv<kKeys / 16>(o, p, smem + kSmRing + prev * kStageBytes + kTileBytes);
      named_bar_arrive(kSchedBar + (cw ^ 1), 2 * 128);
      wgmma_wait<1>();
      fence_regs(s16);
      if (lane == 0) mbar_arrive(&bar[kBarQEmpty]);
      softmax_step<kTail>(s16, m, l, alpha, scale_log2, n - n_full * kKeys, t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_p(p);
      if (lane == 0) mbar_arrive(&bar[kBarEmpty + prev]);
      pack_p<kTail>(p16, s16);
      rescale(o, alpha);
      mbar_wait(&bar[kBarVFull + st], ph);
      issue_pv<kTail / 16>(o, p16, smem + kSmRing + st * kStageBytes + kTileBytes);
      wgmma_wait<0>();
      fence_regs(o);
      fence_p(p16);
    } else {
      rescale(o, alpha);
      mbar_wait(&bar[kBarVFull + st], ph);
      issue_pv<kKeys / 16>(o, p, smem + kSmRing + st * kStageBytes + kTileBytes);
      wgmma_wait<0>();
      fence_regs(o);
      fence_p(p);
    }
    if (lane == 0) mbar_arrive(&bar[kBarEmpty + st]);
    ++it;

    // out = O / rowsum in bf16 through the swizzled staging tile, one TMA
    // store a consumer; lse = (m + log2(rowsum)) * ln 2.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    if (leader) bulk_wait_read<0>();  // the last store has left the tile
    named_bar_sync(kEpiBar + cw, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;  // row & 7 == g
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        *reinterpret_cast<uint32_t*>(so + row * kRowBytes + ((j ^ g) << 4) + 4 * t) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    fence_proxy_async();
    named_bar_sync(kEpiBar + cw, 128);
    if (leader) {
      tma_store_4d(&tm_o, so, 0, h, row0, b);
      bulk_commit();
    }
    if constexpr (kWithLse) {
      if (t == 0) {
        float* const lrow = lse + (static_cast<int64_t>(b) * heads + h) * n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + warp * 16 + g + 8 * r;
          if (row < n) lrow[row] = (m[r] + log2f(l[r])) * kLn2;
        }
      }
    }
  }
  if (leader) bulk_wait<0>();
}

// A failed cuTensorMapEncodeTiled returns kEncodeError + its CUresult; the
// function missing from libcuda, kEncodeError - 1.
constexpr int kEncodeError = 1 << 20;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime already loaded
// (this library links none of its own); looked up once.
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

// A map over the [batch, n, heads * 64] bf16 view at `base` with element
// strides (stride_b, stride_n): dims {64, heads, n, batch}, boxes of
// {64, 1, box_rows, 1}, 128-byte swizzle, zero fill past the edges.
int encode_view(CUtensorMap* map, const void* base, int batch, int n, int heads, int64_t stride_b,
                int64_t stride_n, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError - 1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kRowBytes),
                                 static_cast<cuuint64_t>(stride_n) * 2,
                                 static_cast<cuuint64_t>(stride_b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kHeadDim), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <bool kWithLse>
int launch_forward(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
                   int n, int heads, const TokenStrides (&views)[3], float scale, void* stream) {
  // With one batch item the batch stride is never stepped; any legal one
  // serves.
  int64_t sb[3];
  for (int i = 0; i < 3; ++i) {
    sb[i] = batch > 1 ? views[i].b : static_cast<int64_t>(n) * views[i].n;
  }
  const int64_t out_n = static_cast<int64_t>(heads) * kHeadDim;
  CUtensorMap mq, mk, mv, mk_tail, mv_tail, mo;
  int status = encode_view(&mq, q, batch, n, heads, sb[0], views[0].n, kQueries);
  if (status == 0) status = encode_view(&mk, k, batch, n, heads, sb[1], views[1].n, kKeys);
  if (status == 0) status = encode_view(&mv, v, batch, n, heads, sb[2], views[2].n, kKeys);
  if (status == 0) status = encode_view(&mo, out, batch, n, heads, out_n * n, out_n, kWgRows);
  mk_tail = mk;
  mv_tail = mv;
  if (has_tail(n)) {
    if (status == 0) status = encode_view(&mk_tail, k, batch, n, heads, sb[1], views[1].n, kTail);
    if (status == 0) status = encode_view(&mv_tail, v, batch, n, heads, sb[2], views[2].n, kTail);
  }
  if (status != 0) return status;

  const int q_tiles = (n + kQueries - 1) / kQueries;
  const int64_t total = static_cast<int64_t>(q_tiles) * heads * batch;
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attention_qkv_kernel<kWithLse>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(total < sms ? total : sms);
  attention_qkv_kernel<kWithLse><<<grid, kWsThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mk_tail, mv_tail, mo, lse, n, heads, static_cast<int>(total), scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int vfmseg_attn::attention_qkv_views(const void* q, const void* k, const void* v, void* out,
                                     int batch, int n, int heads,
                                     const TokenStrides (&views)[3], float scale, void* stream) {
  return launch_forward<false>(q, k, v, out, nullptr, batch, n, heads, views, scale, stream);
}

// q, k, v: bf16 [batch, n, heads * 64] views sharing the element strides
// (stride_b, stride_n; multiples of 8, stride_b free when batch is 1), unit
// stride along features, 16-byte aligned. out: contiguous bf16
// [batch, n, heads * 64]. Returns a cudaError_t, or a tensor-map encode
// failure (see vfmseg_error_string).
extern "C" int vfmseg_attention_qkv(const void* q, const void* k, const void* v, void* out,
                                    int batch, int n, int heads, int stride_b, int stride_n,
                                    float scale, void* stream) {
  const TokenStrides views[3] = {{stride_b, stride_n}, {stride_b, stride_n}, {stride_b, stride_n}};
  return launch_forward<false>(q, k, v, out, nullptr, batch, n, heads, views, scale, stream);
}

// As vfmseg_attention_qkv, and lse: contiguous fp32 [batch, heads, n], the
// natural-log log-sum-exp of each row of scaled logits.
extern "C" int vfmseg_attention_qkv_fwd_lse(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int batch, int n, int heads,
                                            int stride_b, int stride_n, float scale,
                                            void* stream) {
  const TokenStrides views[3] = {{stride_b, stride_n}, {stride_b, stride_n}, {stride_b, stride_n}};
  return launch_forward<true>(q, k, v, out, static_cast<float*>(lse), batch, n, heads, views,
                              scale, stream);
}

// Text of a status code returned by any entry of this library.
extern "C" const char* vfmseg_error_string(int status) {
  if (status == kEncodeError - 1) {
    return "cuTensorMapEncodeTiled not found in libcuda";
  }
  if (status >= kEncodeError) {
    return "cuTensorMapEncodeTiled refused a tensor map (status - 2^20 is its CUresult)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
