// General flash attention over per-head views with their own strides, for
// Hopper (sm_90a): a forward that may write the log-sum-exp, and one fused
// backward that writes dq, dk and dv, each with an optional additive bias
// (then the backward also writes dbias).
//
// Replaces the TPU kernels _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel of
// vfmseg_tpu/ops/flash_attention.py, as launched by _flash_forward_hm and
// _flash_backward_hm (the custom VJP of flash_attention_headmajor, EVA02's
// training attention), by _flash_forward / _flash_backward (the [B, N, H, D]
// entry, cross-attention at unmatched lengths) and, with has_bias, by the VJP
// _flash_bias of flash_attention(bias=) (impl="pallas_bias": SAM's blocks with
// the materialised rel-pos bias, inference and training). The TPU's two
// backward kernels become one kernel here. The forward with the LSE off
// computes the function of _fwd_kernel_hm_tav (_flash_forward_hm_tav), and
// the backward without a bias that of _bwd_dq_kernel_qkv and
// _bwd_dkv_kernel_qkv (_flash_backward_qkv_tm, the VJP of
// flash_attention_qkv_tm), whose token-major q, k, v and d(qkv) thirds it
// reads as [B, H, N, 64] views.
//
// For every batch item b and head h, with q_h [Nq, D], k_h and v_h [Nk, D]
// and bias_h [Nq, Nk] (zero without a bias):
//
//   forward:  S = q_h k_h^T * scale + bias_h (fp32),  out_h = softmax(S) v_h,
//             lse_h = log(sum_k exp(S))     (natural log, fp32, optional)
//   backward: P = exp(S - lse_h),  dP = dO_h v_h^T,  delta_h = rowsum(dO_h * out_h)
//             dbias_h = P * (dP - delta_h)  (rounded once to the bias's dtype)
//             dS = dbias_h * scale,  dq_h = dS k_h,  dk_h = dS^T q_h,  dv_h = P^T dO_h
//
// Numerics are the TPU kernels' B5 numerics, not B3's: the scale multiplies the
// fp32 logits and the bias is added after it (flash_attention.py:316-318,
// :385-388), the softmax is the exact one of xla_attention with a running max
// (not the TPU primal's no-max exp2 one), and the backward recomputes P from
// the natural-log LSE with no pre-scaled q. Both kernels evaluate exp(x) as
// 2^(x log2 e), with x's terms folded into fp32 multiply-adds. P and dS round
// to bf16 before their products, which accumulate in fp32.
//
// Layout: q, k, v, dO and the outputs are [B, H, N, D] bf16 views with their
// own element strides (batch, head, token) and unit stride along the head dim,
// so the training route hands in the token-major outputs of its projections as
// [B, N, H, D] views with no transpose, and SAM's route its q, k, v as views of
// one fused qkv tensor. D is 64 or 80 (SAM ViT-H), a template parameter. Nq and
// Nk are separate. lse and delta are contiguous fp32 [B, H, Nq]. The bias is a
// [B, H, Nq, Nk] bf16 or fp32 view with unit stride along Nk and any other
// strides (0 for a dimension it is broadcast over); dbias is contiguous
// [B, H, Nq, Nk] in the bias's dtype.
//
// Both kernels run blocks of two consumer warpgroups (256 threads), multiply
// with wgmma.m64nNk16 (bf16 in, fp32 accumulators; no product is left on
// mma.sync), and feed it from shared-memory tiles filled by cp.async.
//
// The forward, and what bounds it. It needs two products of 2*Nq*Nk*D
// operations per head on q, k, v and out: at N = 1025 and D = 64 ~N/2
// operations a byte, above the card's ~295 operations-a-byte ridge, so without
// a bias the tensor cores bound it. With a bias each score reads 2 (bf16) or 4
// bias bytes against 4*D operations, ~160 or ~80 operations a byte at D = 80:
// the bias's bytes bound it. The design:
//
// * A block owns 128 queries of one (head, batch item), 64 per warpgroup, and
//   loops over the key tiles of 64. Each warpgroup's Q slab is loaded once.
//   The K tile, the V tile and the 128 x 64 bias tile of a key step go
//   through a ring of two stages: the next step's cp.async copies are in
//   flight while the current one is multiplied. Every stream is read once
//   from device memory per block, the bias once in all. Shared memory is
//   dynamic (48-132 KB by head dim and bias), so the launch sets the kernel's
//   limit. The launch bounds hold a thread to 128 registers so that two
//   blocks share a SM (with a bf16 bias or none; an fp32 bias tile leaves
//   room for one): on an H100 one block a SM ran slower at every path
//   shape, and deeper rings (a third K/V stage, or a third bias stage in
//   unpadded, swizzled tiles) gained nothing or spilled; keeping the
//   previous step's P.V in flight during the softmax at D = 64 ran slower.
// * S = Q.K^T is wgmma from shared memory with both operands K-major. The
//   softmax runs in registers on the m64n64 accumulator (each thread holds two
//   rows, 16w + g and 16w + g + 8, of warp w in its warpgroup, and columns
//   2t, 2t + 1 of each 8 keys; a row's max and sum reduce over the 4 threads
//   of a quad). P is rounded to bf16 and re-packed as the register A operand
//   of O += P.V (a 64 x 16 slab of the accumulator is the A fragment of one
//   k16 step), with V an MN-major B operand of the same tile.
// * The online softmax is exact, in fp32, in log2 units: the scores are
//   y = s * scale * log2 e (+ bias * log2 e), the running max m is taken over
//   y, and p = 2^(y - m) by ex2 with scale, log2 e and the max folded into one
//   FFMA when there is no bias; O and the row sums rescale by 2^(m_old -
//   m_new). O is divided by the row sum once at the end, and lse = (m +
//   log2(sum)) * ln 2 is written in natural log, as the backward reads it.
// * The bias tile is copied once into the ring in copies of 16 bytes (8, 4 or
//   2 where the view's rows are less aligned, as SAM's window bias of 196-
//   element rows), and each thread reads its scores' pairs from shared memory
//   in fragment order. Its rows are kFwdBiasPitch = 72 elements apart, which
//   keeps those reads free of bank conflicts in bf16 (4-byte pairs, rows 36
//   words = 4 banks apart) and in fp32 (8-byte pairs, rows 72 words = 8 banks
//   apart within each half warp).
// * Ragged tiles. Rows past Nq or Nk are zero-filled on load; keys >= Nk are
//   masked to -inf (the first key tile always holds a real key, so the running
//   max is finite after it); query rows >= Nq are never stored, lse included.
//   A warpgroup whose 64 rows all lie past Nq only helps with the copies.
//
// The backward, and what bounds it. It needs five products of 2*Nq*Nk*D
// operations per head (S, dP, dV, dK, dQ) on a few N*D vectors of bytes: ~N/2
// operations a byte at N = 1025, above the card's ~295 operations-a-byte ridge,
// so without a bias the tensor cores bound it. With a bias each score reads 2
// (bf16) bias bytes and writes 2 dbias bytes against 10*D operations: 200
// operations a byte at D = 80, under the ridge, so the bias's bytes bound it.
// The design, one kernel per bias kind and head dim:
//
// * One pass over the scores. A block is two warpgroups that own 128 keys of
//   one (head, batch item), 64 each, and loop over the query tiles of 64. Per
//   tile each warpgroup computes S^T = K.Q^T and dP^T = V.dO^T once for its
//   keys; P and dS stay in registers, dV += P^T.dO and dK += dS^T.Q
//   accumulate in registers and are written once at the end. dS^T is staged in
//   shared memory as bf16 and is the operand of dQ_part = dS.K over all 128
//   keys, each warpgroup computing half of dQ's columns; each thread adds its
//   share into a zeroed fp32 [B, H, Nq, D] workspace with float2 atomics
//   (red.global.add), and a short epilogue kernel rounds the workspace once to
//   bf16 into the dq view. Every stream (q, k, v, dO, lse, delta, the bias) is
//   read once from device memory. dq's sum over the key blocks runs in fp32 in
//   an order that changes from run to run, before its one bf16 rounding; dk,
//   dv and dbias are deterministic. On the card the atomics were the largest
//   single cost of a one-warpgroup block of 64 keys; 128 keys a block halve
//   them. The blocks of one head start their query loop at different tiles,
//   so their atomics fall on different dq rows at a time.
// * Asynchronous copies. A ring of two stages holds the Q tile, the dO tile,
//   lse, delta and, with a bias, the 64 x 128 bias tile; the next query tile's
//   cp.async copies (16 bytes a copy for the tiles, zero-filled past Nq or Nk)
//   are in flight while the current one is multiplied. Shared memory is dynamic
//   (81-163 KB by head dim and bias, above the 48 KB default), so the launch
//   sets the kernel's limit.
// * wgmma. S^T and dP^T with K, V (A) and Q, dO (B) K-major from shared
//   memory; dV and dK with P^T and dS^T as register A operands and dO, Q as
//   MN-major (transposed) B operands; dQ with the staged dS^T as a transposed
//   shared-memory A operand and K as a transposed B. Inside a warpgroup the
//   products overlap the elementwise work: P is computed while dP^T is in
//   flight, and dS while dV's product is.
// * The bias. Each bias tile is read once, into the ring, by cp.async copies
//   as in the forward. Each thread rounds its dbias scores to the bias's dtype
//   and writes them in place over the bias values it read; the tile then
//   leaves with vector stores of up to 16 bytes while the dK and dQ products
//   run. The row pitch (136 bf16 or 132 fp32) keeps the fragment-ordered reads
//   and writes free of bank conflicts.
// * Ragged tiles. Rows past Nq or Nk are zero-filled on load; query rows >= Nq
//   and keys >= Nk get P = dS = 0, so they add nothing to dq, dk or dv; padded
//   rows and key columns are never stored, dbias's included (Nk = 196 in SAM's
//   windows is ragged).
//
// Shared-memory layout of both kernels. Tiles are stored without swizzle as
// the canonical "interleaved" wgmma layout: 8 x 8 core matrices of 8 rows of
// 16 bytes, 128 contiguous bytes each. So a D = 80 row (160 bytes) is 10 core
// matrices along the head dim and needs no split box, and one layout of a Q,
// dO, K or V tile serves both as a K-major operand (contraction over d) and as
// an MN-major one (contraction over the rows): only the descriptor's leading-
// and stride-byte offsets trade places. A quarter warp's cp.async fills one
// core matrix (8 rows x 16 bytes), so the copies are free of bank conflicts.

#include <math.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace vfmseg_attn;

// The bias operand: none, bf16 or fp32.
enum BiasKind { kNoBias = 0, kBiasBf16 = 1, kBiasF32 = 2 };

template <int kBias>
using BiasT = typename std::conditional<kBias == kBiasF32, float, bf16>::type;

// Both kernels run blocks of kGroups consumer warpgroups.
constexpr int kGroups = 2;
constexpr int kBlockThreads = 128 * kGroups;

// Asynchronous copy of `bytes` (4, 8 or 16) from global to shared memory;
// only the first `valid` bytes are read and the rest is zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(valid)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x by the special-function unit (flushing denormals to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Make this thread's generic-proxy writes to shared memory (plain stores and
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup's products are
// in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor of the no-swizzle ("interleaved") layout:
// 8 x 16-byte core matrices, `lbo` bytes apart along the contraction (K)
// dimension and `sbo` bytes apart along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// wgmma.m64nNk16, bf16 in, fp32 accumulators: d (+)= A.B, N = 32, 40 or 64
// with both operands in shared memory (the dQ halves, S^T and dP^T, the
// forward's S), 64 or 80 with A from registers (dV and dK, the forward's O).
// SS: A and B from shared memory (kTransA / kTransB: 0 K-major, 1 MN-major);
// RS: A from registers (the mma.m16n8k16 A fragment of each warp's 16 rows).
// `accumulate` 0 ignores d's old value.
// d[64 x 32] (+)= A . B, both operands in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x 40] (+)= A . B, both operands in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[20], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, %23, %24;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x 64] (+)= A . B, both operands in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x 64] (+)= A . B, A from registers, B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTransB));
}

// d[64 x 80] (+)= A . B, A from registers, B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTransB));
}

// The byte offset of (row, 16-byte column chunk) in a tile of kRows rows
// stored as core matrices: chunk-major, then 8-row group, then row within
// the group.
template <int kRows>
__device__ __forceinline__ int core_off(int row, int chunk) {
  return ((chunk * (kRows / 8) + (row >> 3)) << 7) + ((row & 7) << 4);
}

// Between core matrices of a tile: 128 bytes to the next 8 rows, and
// kColBytes<kRows> to the next 8 columns in a tile of kRows rows.
constexpr uint32_t kRowGroupBytes = 128;
template <int kRows>
constexpr uint32_t kColBytes = kRows * 16;

// Queue rows [0, valid) of a kRows x D tile of a view (rows `row_stride`
// elements apart) into its core-matrix layout; later rows are zero-filled.
// Eight consecutive threads fill one core matrix.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_async(unsigned char* tile, const bf16* src,
                                                int64_t row_stride, int valid, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kCopies = kRows * kChunks;
#pragma unroll
  for (int it = 0; it < (kCopies + kBlockThreads - 1) / kBlockThreads; ++it) {
    const int i = it * kBlockThreads + tid;
    if (kCopies % kBlockThreads != 0 && i >= kCopies) break;
    const int chunk = (i >> 3) % kChunks;
    const int row = ((i >> 3) / kChunks) * 8 + (i & 7);
    const bool ok = row < valid;
    cp_async<16>(tile + core_off<kRows>(row, chunk),
                 ok ? src + row * row_stride + chunk * 8 : src, ok ? 16 : 0);
  }
}

// Queue a kRows x kCols bias tile, whose first element is `src` and whose
// rows are `row_stride` elements apart, into rows kPitch elements apart, in
// copies of kVec bytes; rows >= rows_valid and columns >= cols_valid are
// zero-filled.
template <typename T, int kRows, int kCols, int kPitch, int kVec>
__device__ __forceinline__ void load_bias_vec(unsigned char* tile, const T* src, int64_t row_stride,
                                              int rows_valid, int cols_valid, int tid) {
  constexpr int kPer = kVec / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kPerRow = kCols / kPer;
#pragma unroll 4
  for (int i = tid; i < kRows * kPerRow; i += kBlockThreads) {
    const int row = i / kPerRow;
    const int col = (i % kPerRow) * kPer;
    const bool ok = row < rows_valid && col < cols_valid;
    T* dst = reinterpret_cast<T*>(tile) + row * kPitch + col;
    const T* s = ok ? src + row * row_stride + col : src;
    if constexpr (kVec >= 4) {
      cp_async<kVec>(dst, s, ok ? kVec : 0);
    } else {
      *dst = ok ? *s : T(0.f);
    }
  }
}

// The same with the copy width `vec` (16, 8, 4 or 2 bytes) chosen at run time.
template <typename T, int kRows, int kCols, int kPitch>
__device__ __forceinline__ void load_bias_async(unsigned char* tile, const T* src,
                                                int64_t row_stride, int rows_valid,
                                                int cols_valid, int vec, int tid) {
  if (vec == 16) {
    load_bias_vec<T, kRows, kCols, kPitch, 16>(tile, src, row_stride, rows_valid, cols_valid, tid);
  } else if (vec == 8) {
    load_bias_vec<T, kRows, kCols, kPitch, 8>(tile, src, row_stride, rows_valid, cols_valid, tid);
  } else if (vec == 4) {
    load_bias_vec<T, kRows, kCols, kPitch, 4>(tile, src, row_stride, rows_valid, cols_valid, tid);
  } else if constexpr (sizeof(T) == 2) {
    load_bias_vec<T, kRows, kCols, kPitch, 2>(tile, src, row_stride, rows_valid, cols_valid, tid);
  }
}

// The widest copy (16, 8, 4 or 2 bytes, at least one element) that keeps
// every row chunk of a [B, H, Nq, Nk] view with unit stride along Nk aligned:
// it divides the data pointer, each stride and the row length in bytes.
int vec_bytes(const void* p, int elem, const View& s, int nk) {
  int w = 16;
  while (w > elem) {
    const int64_t e = elem;
    if (reinterpret_cast<uintptr_t>(p) % w == 0 && (s.b * e) % w == 0 && (s.h * e) % w == 0 &&
        (s.n * e) % w == 0 && (nk * e) % w == 0) {
      break;
    }
    w /= 2;
  }
  return w;
}

// ---------------------------------------------------------------------------
// The forward.

// A forward block: kFwdQueries queries, kBlock of them per warpgroup.
constexpr int kFwdQueries = kBlock * kGroups;
// Row pitch of the forward's bias tile (kFwdQueries x kBlock keys), in
// elements: conflict-free fragment-ordered reads in bf16 and fp32.
constexpr int kFwdBiasPitch = kBlock + 8;
// Blocks a SM should hold: at most 128 registers a thread.
constexpr int kFwdMinBlocks = 2;

// The arguments of the forward kernel. Unused pointers are null; bias_vec:
// the bytes of one bias copy (16, 8, 4 or 2), the widest that the view's
// alignment allows.
struct HmArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;   // [B, H, Nq, Nk] view, unit stride along Nk
  bf16* out;
  float* lse;         // written when non-null
  View sq, sk, sv, so, sb;
  int heads, nq, nk;
  float scale;
  int bias_vec;
};

// Shared memory of the forward, in bytes: the block's Q tile, then two ring
// stages of (K tile, V tile, bias tile).
template <int D, int kBias>
struct FwdSmem {
  static constexpr int kKTile = kBlock * D * 2;
  static constexpr int kBiasBytes =
      kBias == kNoBias ? 0
                       : kFwdQueries * kFwdBiasPitch * static_cast<int>(sizeof(BiasT<kBias>));
  static constexpr int kQ = 0;
  static constexpr int kRing = kFwdQueries * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  static constexpr int kBiasOff = 2 * kKTile;
  static constexpr int kStage = kBiasOff + kBiasBytes;
  static constexpr int kStages = 2;
  static constexpr int kBytes = kRing + kStages * kStage;
  static_assert(kKTile % 128 == 0 && kBiasBytes % 128 == 0, "tiles must stay 128-byte aligned");
};

// Queue one ring stage of the forward: the K and V tiles and the bias tile
// at key k0 for the block's queries from q0.
template <int D, int kBias>
__device__ __forceinline__ void load_fwd_stage(unsigned char* st, const HmArgs& a, int b, int h,
                                               int q0, int k0, int tid) {
  using L = FwdSmem<D, kBias>;
  load_tile_async<D, kBlock>(st + L::kK, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
  load_tile_async<D, kBlock>(st + L::kV, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
  if constexpr (kBias != kNoBias) {
    using T = BiasT<kBias>;
    const T* src = static_cast<const T*>(a.bias) + b * a.sb.b + h * a.sb.h +
                   static_cast<int64_t>(q0) * a.sb.n + k0;
    load_bias_async<T, kFwdQueries, kBlock, kFwdBiasPitch>(st + L::kBiasOff, src, a.sb.n,
                                                           a.nq - q0, a.nk - k0, a.bias_vec, tid);
  }
}

template <int D, int kBias>
__global__ void __launch_bounds__(kBlockThreads, kFwdMinBlocks)
    attention_hm_fwd_kernel(const HmArgs a) {
  using L = FwdSmem<D, kBias>;
  using T = BiasT<kBias>;
  constexpr int kAcc = D / 2;  // registers of a 64 x D accumulator
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int q0 = blockIdx.x * kFwdQueries;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // This thread's query rows in the block's tile: ql0 and ql0 + 8.
  const int ql0 = wg * kBlock + warp * 16 + g;
  const int n_tiles = (a.nk + kBlock - 1) / kBlock;
  const float scale_log2 = a.scale * kLog2e;
  const bool active = q0 + wg * kBlock < a.nq;
  const uint32_t q_rows = wg * (kBlock / 8) * kRowGroupBytes;

  load_tile_async<D, kFwdQueries>(smem + L::kQ, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
  load_fwd_stage<D, kBias>(smem + L::kRing, a, b, h, q0, 0, tid);
  cp_async_commit();

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  // Running max (log2 units) and this thread's part of the row sums.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlock;
    unsigned char* st = smem + L::kRing + (it & 1) * L::kStage;
    // This key tile has landed, and every thread is done with the other stage.
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_fwd_stage<D, kBias>(smem + L::kRing + ((it + 1) & 1) * L::kStage, a, b, h, q0,
                               k0 + kBlock, tid);
      cp_async_commit();
    }
    if (!active) continue;

    // S = Q.K^T: rows are this warpgroup's 64 queries, columns the tile's keys.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(s,
                     smem_desc(smem + L::kQ + q_rows + kk * 2 * kColBytes<kFwdQueries>,
                               kColBytes<kFwdQueries>, kRowGroupBytes),
                     smem_desc(st + L::kK + kk * 2 * kColBytes<kBlock>, kColBytes<kBlock>,
                               kRowGroupBytes),
                     1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // The scores in log2 units (with a bias: y = s * scale_log2 + bias * log2 e;
    // without: s itself, scaled below), keys >= Nk at -inf, and the row max.
    const int valid = a.nk - k0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x0 = s[4 * j + 2 * r];
        float x1 = s[4 * j + 2 * r + 1];
        if constexpr (kBias != kNoBias) {
          const T* bp = reinterpret_cast<const T*>(st + L::kBiasOff) +
                        (ql0 + 8 * r) * kFwdBiasPitch + col;
          float2 bv;
          if constexpr (kBias == kBiasBf16) {
            bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp));
          } else {
            bv = *reinterpret_cast<const float2*>(bp);
          }
          x0 = fmaf(x0, scale_log2, bv.x * kLog2e);
          x1 = fmaf(x1, scale_log2, bv.y * kLog2e);
        }
        if (valid < kBlock) {
          if (col >= valid) x0 = -INFINITY;
          if (col + 1 >= valid) x1 = -INFINITY;
        }
        s[4 * j + 2 * r] = x0;
        s[4 * j + 2 * r + 1] = x1;
        mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
      }
    }
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], kBias != kNoBias ? mx[r] : mx[r] * scale_log2);
      const float alpha = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * r] *= alpha;
        o[4 * j + 2 * r + 1] *= alpha;
      }
    }
    // P = 2^(y - m), one FFMA and one ex2 a score, re-packed as bf16 A
    // fragments (one per 16 keys).
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = kBias != kNoBias ? exp2_approx(s[4 * j + e] + neg_m[r])
                                         : exp2_approx(fmaf(s[4 * j + e], scale_log2, neg_m[r]));
        s[4 * j + e] = p;
        l[r] += p;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
    }

    // O += P.V (register A, V an MN-major B).
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs<1>(o, pa[c],
                  smem_desc(st + L::kV + c * 2 * kRowGroupBytes, kRowGroupBytes, kColBytes<kBlock>),
                  1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  if (!active) return;

  // out = O / rowsum in bf16, and lse = (m + log2(rowsum)) * ln 2.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + ql0 + 8 * r;
    if (row >= a.nq) continue;
    const float inv = 1.f / l[r];
    bf16* orow = at(a.out, a.so, b, h, row) + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (a.lse != nullptr && t == 0) {
      a.lse[(static_cast<int64_t>(b) * a.heads + h) * a.nq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// The fused backward.

// A backward block: kBwdKeys keys, kBlock of them per warpgroup.
constexpr int kBwdKeys = kBlock * kGroups;

// The arguments of the backward kernel. dq_acc is the fp32 workspace
// [B, H, Nq, D], zeroed by the caller; bias and dbias are null without a
// bias. bias_vec / dbias_vec: the bytes of one bias copy / dbias store (16, 8,
// 4 or 2), the widest that the views' alignment allows.
struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  const void* bias;
  float* dq_acc;
  bf16* dk;
  bf16* dv;
  void* dbias;
  View sq, sk, sv, sdo, sdk, sdv, sb;
  int heads, nq, nk;
  float scale;
  int bias_vec, dbias_vec;
};

// The bias tile (64 queries x kBwdKeys keys): element type and row pitch in
// elements, which keeps the fragment-ordered accesses free of bank conflicts.
template <int kBias>
struct BiasTile {
  using T = BiasT<kBias>;
  static constexpr int kPitch = kBwdKeys + (kBias == kBiasF32 ? 4 : 8);
};

// Shared memory of the backward, in bytes: K, V and the staged dS^T, then two
// ring stages of (Q, dO, lse, delta, bias tile).
template <int D, int kBias>
struct BwdSmem {
  static constexpr int kQTile = kBlock * D * 2;
  static constexpr int kKTile = kBwdKeys * D * 2;
  static constexpr int kBiasBytes =
      kBias == kNoBias ? 0
                       : kBlock * BiasTile<kBias>::kPitch *
                             static_cast<int>(sizeof(typename BiasTile<kBias>::T));
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  static constexpr int kDs = 2 * kKTile;
  static constexpr int kRing = kDs + kBwdKeys * kBlock * 2;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQTile;
  static constexpr int kLse = 2 * kQTile;
  static constexpr int kDelta = kLse + kBlock * 4;
  static constexpr int kBiasOff = kDelta + kBlock * 4;
  static constexpr int kStage = kBiasOff + kBiasBytes;
  static constexpr int kStages = 2;
  static constexpr int kBytes = kRing + kStages * kStage;
  static_assert(kQTile % 128 == 0 && kBiasBytes % 128 == 0, "tiles must stay 128-byte aligned");
};

// Write the staged dbias tile (rows < Nq, keys < Nk) to dbias[b, h, q0:, k0:]
// in stores of kVec bytes.
template <int kBias, int kVec>
__device__ __forceinline__ void store_dbias_vec(const unsigned char* tile, const BwdArgs& a,
                                                int64_t bh, int q0, int k0, int tid) {
  using T = typename BiasTile<kBias>::T;
  constexpr int kPer = kVec / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kBwdKeys / kPer;
  using V = typename std::conditional<
      kVec == 16, uint4,
      typename std::conditional<kVec == 8, uint2,
                                typename std::conditional<kVec == 4, uint32_t,
                                                          uint16_t>::type>::type>::type;
  T* base = static_cast<T*>(a.dbias) + (bh * a.nq + q0) * a.nk + k0;
#pragma unroll 4
  for (int i = tid; i < kBlock * kPerRow; i += kBlockThreads) {
    const int row = i / kPerRow;
    const int col = (i % kPerRow) * kPer;
    if (q0 + row < a.nq && k0 + col < a.nk) {
      *reinterpret_cast<V*>(base + static_cast<int64_t>(row) * a.nk + col) =
          *reinterpret_cast<const V*>(reinterpret_cast<const T*>(tile) +
                                      row * BiasTile<kBias>::kPitch + col);
    }
  }
}

template <int kBias>
__device__ __forceinline__ void store_dbias(const unsigned char* tile, const BwdArgs& a,
                                            int64_t bh, int q0, int k0, int tid) {
  if (a.dbias_vec == 16) {
    store_dbias_vec<kBias, 16>(tile, a, bh, q0, k0, tid);
  } else if (a.dbias_vec == 8) {
    store_dbias_vec<kBias, 8>(tile, a, bh, q0, k0, tid);
  } else if (a.dbias_vec == 4) {
    store_dbias_vec<kBias, 4>(tile, a, bh, q0, k0, tid);
  } else if constexpr (kBias == kBiasBf16) {
    store_dbias_vec<kBias, 2>(tile, a, bh, q0, k0, tid);
  }
}

// Queue one ring stage: the Q and dO tiles, lse and delta (4-byte copies:
// a row of [B, H, Nq] is only 4-byte aligned) and the bias tile at query q0.
template <int D, int kBias>
__device__ __forceinline__ void load_stage(unsigned char* st, const BwdArgs& a, int b, int h,
                                           int q0, int k0, int tid) {
  using L = BwdSmem<D, kBias>;
  load_tile_async<D, kBlock>(st + L::kQ, at(a.q, a.sq, b, h, q0), a.sq.n, a.nq - q0, tid);
  load_tile_async<D, kBlock>(st + L::kDo, at(a.dout, a.sdo, b, h, q0), a.sdo.n, a.nq - q0, tid);
  if (tid < 2 * kBlock) {
    const int r = tid & (kBlock - 1);
    const float* rows = (tid < kBlock ? a.lse : a.delta) +
                        (static_cast<int64_t>(b) * a.heads + h) * a.nq + q0;
    const bool ok = q0 + r < a.nq;
    cp_async<4>(st + (tid < kBlock ? L::kLse : L::kDelta) + r * 4, ok ? rows + r : rows,
                ok ? 4 : 0);
  }
  if constexpr (kBias != kNoBias) {
    using T = BiasT<kBias>;
    const T* src = static_cast<const T*>(a.bias) + b * a.sb.b + h * a.sb.h +
                   static_cast<int64_t>(q0) * a.sb.n + k0;
    load_bias_async<T, kBlock, kBwdKeys, BiasTile<kBias>::kPitch>(st + L::kBiasOff, src, a.sb.n,
                                                                  a.nq - q0, a.nk - k0,
                                                                  a.bias_vec, tid);
  }
}

template <int D, int kBias>
__global__ void __launch_bounds__(kBlockThreads) attention_hm_bwd_kernel(const BwdArgs a) {
  using L = BwdSmem<D, kBias>;
  using T = typename BiasTile<kBias>::T;
  constexpr int kP = BiasTile<kBias>::kPitch;
  constexpr int kAcc = D / 2;               // registers of a 64 x D accumulator
  constexpr int kDqN = D / kGroups;      // the dQ columns of a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int k0 = blockIdx.x * kBwdKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  unsigned char* sk = smem + L::kK;
  unsigned char* sv = smem + L::kV;
  unsigned char* sds = smem + L::kDs;
  // This thread's keys in the block's tile (kl0, kl0 + 8: accumulator rows
  // of S^T, dP^T, dK and dV) and query rows of the tile (ql0, ql0 + 8: rows
  // of dQ_part).
  const int ql0 = warp * 16 + g;
  const int kl0 = wg * kBlock + ql0;
  const int n_tiles = (a.nq + kBlock - 1) / kBlock;
  const float scale_log2 = a.scale * kLog2e;

  load_tile_async<D, kBwdKeys>(sk, at(a.k, a.sk, b, h, k0), a.sk.n, a.nk - k0, tid);
  load_tile_async<D, kBwdKeys>(sv, at(a.v, a.sv, b, h, k0), a.sv.n, a.nk - k0, tid);
  // Blocks of one head start at different query tiles, so the atomic adds
  // into dq of the head's key tiles fall on different rows at a time.
  const int first = blockIdx.x % n_tiles;
  load_stage<D, kBias>(smem + L::kRing, a, b, h, first * kBlock, k0, tid);
  cp_async_commit();

  float dk[kAcc], dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
  const bool key_ok[2] = {k0 + kl0 < a.nk, k0 + kl0 + 8 < a.nk};

  for (int it = 0; it < n_tiles; ++it) {
    int qt = it + first;
    if (qt >= n_tiles) qt -= n_tiles;
    const int q0 = qt * kBlock;
    unsigned char* st = smem + L::kRing + (it & 1) * L::kStage;
    // This tile has landed, and every thread is done with the other stage.
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = qt + 1 < n_tiles ? qt + 1 : 0;
      load_stage<D, kBias>(smem + L::kRing + ((it + 1) & 1) * L::kStage, a, b, h, nxt * kBlock,
                           k0, tid);
      cp_async_commit();
    }

    // S^T = K.Q^T and dP^T = V.dO^T, committed as two groups: rows are this
    // warpgroup's 64 keys, columns the tile's queries.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    const int key_rows = wg * (kBlock / 8) * kRowGroupBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(s,
                     smem_desc(sk + key_rows + kk * 2 * kColBytes<kBwdKeys>, kColBytes<kBwdKeys>, kRowGroupBytes),
                     smem_desc(st + L::kQ + kk * 2 * kColBytes<kBlock>, kColBytes<kBlock>, kRowGroupBytes), 1);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(dp,
                     smem_desc(sv + key_rows + kk * 2 * kColBytes<kBwdKeys>, kColBytes<kBwdKeys>, kRowGroupBytes),
                     smem_desc(st + L::kDo + kk * 2 * kColBytes<kBlock>, kColBytes<kBlock>, kRowGroupBytes),
                     1);
    }
    wgmma_commit();
    const float* slse = reinterpret_cast<const float*>(st + L::kLse);
    const float* sdelta = reinterpret_cast<const float*>(st + L::kDelta);
    T* sbias = reinterpret_cast<T*>(st + L::kBiasOff);

    // P^T in place of S^T while dP^T is still in flight.
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 lse = *reinterpret_cast<const float2*>(slse + col);
      const float neg_lse2[2] = {-lse.x * kLog2e, -lse.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = col + (e & 1);
        const int kl = kl0 + 8 * (e >> 1);
        // P = exp(s * scale + bias - lse) = 2^(s * scale_log2 + (bias - lse) * log2 e)
        float c = neg_lse2[e & 1];
        if constexpr (kBias != kNoBias) {
          c = fmaf(static_cast<float>(sbias[qc * kP + kl]), kLog2e, c);
        }
        const float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, c));
        s[4 * j + e] = (q0 + qc < a.nq && key_ok[e >> 1]) ? p : 0.f;
      }
    }

    // dV += P^T.dO (register A: one fragment per 16 queries; MN-major B),
    // in flight while dS^T is computed.
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
    }
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs<1>(dv, pa[c],
                  smem_desc(st + L::kDo + c * 2 * kRowGroupBytes, kRowGroupBytes, kColBytes<kBlock>), 1);
    }
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) * scale in place of dP^T; dbias over the
    // bias tile, in place of the bias values this thread read.
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 dl = *reinterpret_cast<const float2*>(sdelta + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = col + (e & 1);
        const int kl = kl0 + 8 * (e >> 1);
        const float ds = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        if constexpr (kBias != kNoBias) sbias[qc * kP + kl] = T(ds);
        dp[4 * j + e] = ds * a.scale;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) da[c][r] = pack_bf16(dp[8 * c + 2 * r], dp[8 * c + 2 * r + 1]);
    }
    // dS^T to shared memory as the MN-major A operand of dQ: core matrices
    // of 8 keys x 8 queries, the 8 query groups of a key group adjacent.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned char* p = sds + (((kl0 >> 3) * 8 + j) << 7) + (g << 4) + (t << 2);
      *reinterpret_cast<uint32_t*>(p) = da[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(p + (8 << 7)) = da[j >> 1][(j & 1) * 2 + 1];
    }
    fence_proxy_async();
    __syncthreads();  // dS^T of every warpgroup and the dbias tile are complete

    // dK += dS^T.Q (register A, MN-major B), and this warpgroup's kDqN
    // columns of dQ_part = dS.K over all kBwdKeys keys (both operands
    // MN-major in shared memory); the dbias tile leaves meanwhile.
    float dq[kDqN / 2];
#pragma unroll
    for (int i = 0; i < kDqN / 2; ++i) dq[i] = 0.f;
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs<1>(dk, da[c],
                  smem_desc(st + L::kQ + c * 2 * kRowGroupBytes, kRowGroupBytes, kColBytes<kBlock>), 1);
    }
    const int dq_cols = wg * (kDqN / 8) * kColBytes<kBwdKeys>;
#pragma unroll
    for (int c = 0; c < kBwdKeys / 16; ++c) {
      wgmma_ss<1, 1>(dq, smem_desc(sds + c * 2 * kColBytes<kBlock>, kColBytes<kBlock>, kRowGroupBytes),
                     smem_desc(sk + dq_cols + c * 2 * kRowGroupBytes, kRowGroupBytes, kColBytes<kBwdKeys>),
                     1);
    }
    wgmma_commit();
    if constexpr (kBias != kNoBias) store_dbias<kBias>(st + L::kBiasOff, a, bh, q0, k0, tid);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(dq);

    // dq_acc[q0 + row] += dQ_part: this thread's rows ql0 and ql0 + 8 of the
    // tile's queries, two columns per 8 of its warpgroup's kDqN.
    float* dq_row = a.dq_acc + (bh * a.nq + q0 + ql0) * D + wg * kDqN + 2 * t;
#pragma unroll
    for (int j = 0; j < kDqN / 8; ++j) {
      if (q0 + ql0 < a.nq) {
        atomicAdd(reinterpret_cast<float2*>(dq_row + 8 * j), make_float2(dq[4 * j], dq[4 * j + 1]));
      }
      if (q0 + ql0 + 8 < a.nq) {
        atomicAdd(reinterpret_cast<float2*>(dq_row + 8 * D + 8 * j),
                  make_float2(dq[4 * j + 2], dq[4 * j + 3]));
      }
    }
  }

  // dk and dv rows of this thread's keys, bf16.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kl0 + 8 * r;
    if (key >= a.nk) continue;
    bf16* dkr = at(a.dk, a.sdk, b, h, key) + 2 * t;
    bf16* dvr = at(a.dv, a.sdv, b, h, key) + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * j) = pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j) = pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dq = bf16(dq_acc): 8 elements a thread, from the fp32 [B, H, Nq, D]
// workspace into the strided dq view.
template <int D>
__global__ void attention_hm_dq_round_kernel(const float* __restrict__ acc, bf16* dq, View sdq,
                                             int heads, int nq, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / (D / 8);
  const int c = static_cast<int>(i - row * (D / 8)) * 8;
  const int q = static_cast<int>(row % nq);
  const int64_t bh = row / nq;
  const int h = static_cast<int>(bh % heads);
  const int b = static_cast<int>(bh / heads);
  const float4 x = *reinterpret_cast<const float4*>(acc + row * D + c);
  const float4 y = *reinterpret_cast<const float4*>(acc + row * D + c + 4);
  uint4 o;
  o.x = pack_bf16(x.x, x.y);
  o.y = pack_bf16(x.z, x.w);
  o.z = pack_bf16(y.x, y.y);
  o.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(at(dq, sdq, b, h, q) + c) = o;
}


HmArgs fwd_args(const void* q, const void* k, const void* v, void* out, void* lse,
                const long long* strides, int heads, int nq, int nk, float scale) {
  HmArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.sq = view(strides, 0);
  a.sk = view(strides, 1);
  a.sv = view(strides, 2);
  a.so = view(strides, 3);
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.scale = scale;
  return a;
}

// The forward over a grid of (query blocks, heads, batch); returns a
// cudaError_t.
template <int D, int kBias>
int launch_fwd_kernel(const HmArgs& a, int batch, cudaStream_t stream) {
  constexpr int kBytes = FwdSmem<D, kBias>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(attention_hm_fwd_kernel<D, kBias>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.nq + kFwdQueries - 1) / kFwdQueries, a.heads, batch);
  attention_hm_fwd_kernel<D, kBias><<<grid, kBlockThreads, kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_d(int bias_kind, const HmArgs& a, int batch, cudaStream_t stream) {
  if (bias_kind == kNoBias) return launch_fwd_kernel<D, kNoBias>(a, batch, stream);
  if (bias_kind == kBiasBf16) return launch_fwd_kernel<D, kBiasBf16>(a, batch, stream);
  return launch_fwd_kernel<D, kBiasF32>(a, batch, stream);
}

int launch_fwd(int head_dim, int bias_kind, const HmArgs& a, int batch, void* stream) {
  if (bias_kind < kNoBias || bias_kind > kBiasF32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_fwd_d<64>(bias_kind, a, batch, s);
  if (head_dim == 80) return launch_fwd_d<80>(bias_kind, a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused backward, then the dq rounding; returns a cudaError_t.
template <int D, int kBias>
int launch_bwd_kernel(const BwdArgs& a, bf16* dq, const View& sdq, int batch,
                      cudaStream_t stream) {
  constexpr int kBytes = BwdSmem<D, kBias>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attention_hm_bwd_kernel<D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.nk + kBwdKeys - 1) / kBwdKeys, a.heads, batch);
  attention_hm_bwd_kernel<D, kBias><<<grid, kBlockThreads, kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * a.heads * a.nq * (D / 8);
  constexpr int kRoundThreads = 256;
  attention_hm_dq_round_kernel<D>
      <<<static_cast<unsigned>((total + kRoundThreads - 1) / kRoundThreads), kRoundThreads, 0,
         stream>>>(a.dq_acc, dq, sdq, a.heads, a.nq, total);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_d(int bias_kind, const BwdArgs& a, bf16* dq, const View& sdq, int batch,
                 cudaStream_t stream) {
  if (bias_kind == kNoBias) return launch_bwd_kernel<D, kNoBias>(a, dq, sdq, batch, stream);
  if (bias_kind == kBiasBf16) return launch_bwd_kernel<D, kBiasBf16>(a, dq, sdq, batch, stream);
  return launch_bwd_kernel<D, kBiasF32>(a, dq, sdq, batch, stream);
}

// Arguments of the backward from the entries' pointers and their (batch,
// head, token) strides of q, k, v, dout, dq, dk, dv (and bias).
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* bias, void* dq_acc, void* dq, void* dk, void* dv,
               void* dbias, const long long* strides, int bias_kind, int batch, int heads,
               int nq, int nk, int head_dim, float scale, void* stream) {
  if (bias_kind < kNoBias || bias_kind > kBiasF32) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = view(strides, 0);
  a.sk = view(strides, 1);
  a.sv = view(strides, 2);
  a.sdo = view(strides, 3);
  const View sdq = view(strides, 4);
  a.sdk = view(strides, 5);
  a.sdv = view(strides, 6);
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.scale = scale;
  if (bias_kind != kNoBias) {
    const int elem = bias_kind == kBiasF32 ? 4 : 2;
    a.bias = bias;
    a.dbias = dbias;
    a.sb = view(strides, 7);
    a.bias_vec = vec_bytes(bias, elem, a.sb, nk);
    const View contiguous{static_cast<int64_t>(heads) * nq * nk, static_cast<int64_t>(nq) * nk, nk};
    a.dbias_vec = vec_bytes(dbias, elem, contiguous, nk);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* dqp = static_cast<bf16*>(dq);
  if (head_dim == 64) return launch_bwd_d<64>(bias_kind, a, dqp, sdq, batch, s);
  if (head_dim == 80) return launch_bwd_d<80>(bias_kind, a, dqp, sdq, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Forward. q [B, H, nq, D], k and v [B, H, nk, D], out [B, H, nq, D]: bf16
// views with unit stride along the head dim, 16-byte aligned rows; strides
// holds 12 int64: (batch, head, token) of q, k, v, out. lse: contiguous fp32
// [B, H, nq], written when non-null. head_dim: 64 or 80. Returns a
// cudaError_t.
extern "C" int vfmseg_attention_hm_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const long long* strides, int batch, int heads,
                                       int nq, int nk, int head_dim, float scale, void* stream) {
  const HmArgs a = fwd_args(q, k, v, out, lse, strides, heads, nq, nk, scale);
  return launch_fwd(head_dim, kNoBias, a, batch, stream);
}

// The forward with a bias: as vfmseg_attention_hm_fwd, plus bias, a
// [B, H, nq, nk] view with unit stride along nk, bf16 (bias_kind 1) or fp32
// (2); strides: 15 int64 for q, k, v, out, bias.
extern "C" int vfmseg_attention_hm_bias_fwd(const void* q, const void* k, const void* v,
                                            const void* bias, void* out, void* lse,
                                            const long long* strides, int bias_kind, int batch,
                                            int heads, int nq, int nk, int head_dim, float scale,
                                            void* stream) {
  if (bias_kind == kNoBias) return static_cast<int>(cudaErrorInvalidValue);
  HmArgs a = fwd_args(q, k, v, out, lse, strides, heads, nq, nk, scale);
  a.bias = bias;
  a.sb = view(strides, 4);
  a.bias_vec = vec_bytes(bias, bias_kind == kBiasF32 ? 4 : 2, a.sb, nk);
  return launch_fwd(head_dim, bias_kind, a, batch, stream);
}

// The fused backward: dq, dk and dv. q, k, v as the forward took them; dout
// [B, H, nq, D]; lse and delta contiguous fp32 [B, H, nq]; dq_acc a zeroed
// contiguous fp32 [B, H, nq, D] workspace; dq [B, H, nq, D], dk and dv
// [B, H, nk, D] views as q's. strides: 21 int64 for q, k, v, dout, dq, dk,
// dv. Two launches: the backward, then dq rounded from dq_acc. Returns a
// cudaError_t.
extern "C" int vfmseg_attention_hm_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq_acc, void* dq, void* dk, void* dv,
                                       const long long* strides, int batch, int heads, int nq,
                                       int nk, int head_dim, float scale, void* stream) {
  return launch_bwd(q, k, v, dout, lse, delta, nullptr, dq_acc, dq, dk, dv, nullptr, strides,
                    kNoBias, batch, heads, nq, nk, head_dim, scale, stream);
}

// The fused backward with a bias: as vfmseg_attention_hm_bwd, plus the bias
// as the forward took it and dbias, contiguous [B, H, nq, nk] in the bias's
// dtype (bias_kind 1 bf16, 2 fp32; padded rows and columns are not written,
// every real one is); strides: 24 int64 for q, k, v, dout, dq, dk, dv, bias.
extern "C" int vfmseg_attention_hm_bias_bwd(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* bias, void* dq_acc, void* dq, void* dk,
                                            void* dv, void* dbias, const long long* strides,
                                            int bias_kind, int batch, int heads, int nq, int nk,
                                            int head_dim, float scale, void* stream) {
  if (bias_kind == kNoBias) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(q, k, v, dout, lse, delta, bias, dq_acc, dq, dk, dv, dbias, strides,
                    bias_kind, batch, heads, nq, nk, head_dim, scale, stream);
}
