"""Multi-head attention on hand-written CUDA kernels: inference, and training
with its backward.

Port of vfmseg_tpu/ops/attention.py:31-57 (``xla_attention``), :101-158
(``xla_attention_decomposed_hm``, ``multi_head_attention_decomposed_hm``),
:194-235 (``multi_head_attention_qkv_tm``, with its ``rope_cs``), :238-269
(``multi_head_attention_headmajor``, its bias branch included) and :272-314
(``multi_head_attention``), whose TPU kernels are ``flash_attention_qkv_tm``
with its custom VJP ``_flash_qkv_tm``, ``flash_attention_headmajor`` with
``_flash_hm``, ``flash_attention(bias=)`` with ``_flash_bias`` and
``flash_attention_relpos_hm`` with ``_flash_relpos_hm``
(vfmseg_tpu/ops/flash_attention.py:1579-1663, 1775-1814, 2002-2042,
1940-1977).

* :func:`attention_plain` is the plain PyTorch version: fp32 logits and
  softmax, probabilities cast to v's dtype before the product with v.
  :func:`attention_fwd_lse_plain` adds the log-sum-exp of the scaled logits,
  and :func:`attention_bwd_plain` is the backward that recomputes the
  probabilities from it, on whole tensors; each takes an optional additive
  ``[B, H, Nq, Nk]`` bias, whose gradient the backward then returns too.
  :func:`attention_qkv_rope_plain` rotates q and k by RoPE first.
  :func:`attention_decomposed_plain` adds SAM's decomposed rel-pos bias from
  its two k-separable terms.
* Kernels, on bf16 views with head dim 64 (B5: 32, 64 or 80, with a bias
  64 or 80; B7: 64 or 80):

  - :func:`attention_qkv_tm` (``csrc/attention_qkv.cu``, B2) and
    :func:`attention_fwd_lse_tm` (same kernel template, B3), the inference
    forward and the training forward with the LSE, over ``[B, N, H*64]``
    views of one stride pair: a warp-specialised kernel whose producer warp
    TMA-loads the views as they are, with no transpose or copy;
  - :func:`attention_qkv_rope_tm` (``csrc/attention_qkv_rope.cu``),
    B2-RoPE (EVA02 inference): a rotation pass into a workspace, then B2's
    kernel over the rotated q and k and v, each view with its own strides;
  - :func:`attention_hm_fwd` and :func:`attention_hm_bwd`
    (``csrc/attention_hm.cu``, B5: a forward and one fused backward, both on
    wgmma), general attention over ``[B, H, N, D]`` views with their own
    strides and Nq != Nk, with an optional additive bias (then the backward
    also writes dbias in the bias's dtype). The backward also computes B4's
    function, B3's backward, on ``[B, H, N, 64]`` views of the token-major
    tensors (:func:`attention_bwd_tm`);
  - :func:`attention_relpos_hm` (``csrc/attention_relpos.cu``, B7), SAM's
    attention with the rel-pos bias rebuilt in the kernel from its terms.
* :func:`multi_head_attention_qkv_tm`, :func:`multi_head_attention_headmajor`,
  :func:`multi_head_attention_decomposed_hm` and :func:`multi_head_attention`
  pick: when grad is enabled and an input requires it, the autograd
  Functions :class:`FusedQKVAttention` / :class:`QKVAttention` (B3 forward,
  B5's fused backward on CUDA), :class:`HeadMajorAttention` (B5, with or
  without a bias) or
  :class:`DecomposedRelPosAttention` (B7 forward, plain recomputed
  backward), with the plain twins on the CPU, as the JAX package takes its
  forward rules under differentiation; otherwise the inference kernels on
  CUDA and the plain versions on the CPU. Nothing falls back from a kernel
  to a plain version.

Layouts are the JAX package's: ``[B, N, H, D]`` per head, ``[B, H, N, D]``
head-major, ``[B, N, 3*H*D]`` for a fused qkv projection (q|k|v thirds,
head-contiguous), and token-major ``[B, N, H*D]`` output. The LSE is
``[B, H, N]`` fp32, natural log.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vfmseg_tpu_torch.kernels import (
    ATTENTION_FWD_LSE,
    ATTENTION_HM_BIAS_BWD,
    ATTENTION_HM_BIAS_FWD,
    ATTENTION_HM_BWD,
    ATTENTION_HM_BWD_D32,
    ATTENTION_HM_FWD,
    ATTENTION_HM_FWD_D32,
    ATTENTION_QKV,
    ATTENTION_QKV_ROPE,
    ATTENTION_RELPOS,
)
from vfmseg_tpu_torch.ops.rope import apply_rope_permuted

HEAD_DIM = 64  # the only head dim B2 and B3 take
HM_HEAD_DIMS = (32, 64, 80)  # the head dims B5 is built for
BIAS_HEAD_DIMS = (64, 80)  # B5 with a bias, and B7
_INT_MAX = 2**31 - 1


def _logits(q, k, scale, bias):
    """fp32 ``[B, H, Nq, Nk]`` logits: q k^T * scale, plus the bias in
    fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return logits if bias is None else logits + bias.float()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per head (``xla_attention``). q:
    [B, Nq, H, D]; k/v: [B, Nk, H, D]; bias: optional, broadcastable to
    [B, H, Nq, Nk]. Returns [B, Nq, H, D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _logits(q, k, scale, bias)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_qkv_rope_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """:func:`attention_plain` after rotating q and k by RoPE in the
    evens|odds layout (``apply_rope_permuted``) in fp32 and rounding them
    back to their dtype. q, k, v: [B, N, H, D]; cos, sin: [N, D]."""
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    qr = apply_rope_permuted(q.float(), c, s).to(q.dtype)
    kr = apply_rope_permuted(k.float(), c, s).to(k.dtype)
    return attention_plain(qr, kr, v, scale=scale)


def attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: Optional[float] = None,
                            bias: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_plain` and the natural-log LSE of the fp32 scaled
    (and biased) logits. Returns (out [B, Nq, H, D] in q's dtype, lse
    [B, H, Nq] fp32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _logits(q, k, scale, bias)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype), lse


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, scale: Optional[float] = None,
                        bias: Optional[torch.Tensor] = None) -> tuple:
    """The backward of :func:`attention_fwd_lse_plain` by the LSE/delta
    recurrence of the kernels, in fp32 on whole tensors: P = exp(S*scale +
    bias - lse), delta = rowsum(dO*O), dbias = P*(dP - delta), dS =
    dbias*scale, dq = dS.K, dk = dS^T.Q, dv = P^T.dO. Returns dq, dk, dv in
    q's dtype, and with a bias also dbias, fp32 ``[B, H, Nq, Nk]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    p = torch.exp(_logits(qf, kf, scale, bias) - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).transpose(1, 2)          # [B, H, Nq]
    dbias = p * (dp - delta[..., None])
    ds = dbias * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    grads = (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))
    return grads if bias is None else grads + (dbias,)


def _cuda_views(fn: str, *views: torch.Tensor) -> None:
    """Raise unless every view is a CUDA tensor on one device."""
    for t in views:
        if not t.is_cuda:
            raise ValueError(f"{fn} needs CUDA tensors, got one on {t.device}")
        if t.device != views[0].device:
            raise ValueError(f"{fn} needs its tensors on one device")


def _strided_views(fn: str, num_heads: int, *views: torch.Tensor
                   ) -> Tuple[int, int, int, int]:
    """Check bf16 CUDA ``[B, N, H*64]`` views of one shape and one stride
    pair on one device (:func:`qkv_view_geometry`); return (B, N, stride_b,
    stride_n)."""
    _cuda_views(fn, *views)
    return qkv_view_geometry(fn, num_heads, *views)


def qkv_view_strides(fn: str, num_heads: int, *views: torch.Tensor
                     ) -> Tuple[int, int, Tuple[Tuple[int, int], ...]]:
    """The geometry B2's kernel reads ``[B, N, H*64]`` bf16 views with, each
    view with a stride pair of its own: (B, N, ((stride_b, stride_n) of each
    view)) in elements, after checking what a TMA tensor map needs of each
    view: unit stride along features, a 16-byte aligned start (the k and v
    thirds of a fused qkv start H*128 bytes after q) and row strides of
    whole 16 bytes (the batch stride only when B > 1). The kernel's maps run
    over dims (64, H, N, B) with element strides (1, 64, stride_n, stride_b)
    from each view's start."""
    first = views[0]
    for t in views:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn} takes bf16, got {t.dtype}")
        if t.dim() != 3 or t.shape != first.shape:
            raise ValueError(f"{fn} needs views of one [B, N, F] shape")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn} needs 16-byte aligned tensors")
    b, n, f = first.shape
    if f != num_heads * HEAD_DIM:
        raise ValueError(f"{fn} takes head_dim {HEAD_DIM} only: features {f} "
                         f"!= {num_heads} heads x {HEAD_DIM}")
    strides = []
    for t in views:
        stride_b, stride_n, stride_f = t.stride()
        if stride_f != 1 or stride_n % 8 or (b > 1 and stride_b % 8):
            raise ValueError(f"{fn} needs unit feature stride and row strides "
                             f"that are multiples of 8, got {t.stride()}")
        if (max(stride_b, stride_n) > _INT_MAX or b > 65535
                or num_heads > 65535 or t.numel() > _INT_MAX):
            raise ValueError(f"{fn}: shape {tuple(t.shape)} with strides "
                             f"{t.stride()} exceeds the launch limits")
        strides.append((stride_b, stride_n))
    return b, n, tuple(strides)


def qkv_view_geometry(fn: str, num_heads: int, *views: torch.Tensor
                      ) -> Tuple[int, int, int, int]:
    """:func:`qkv_view_strides` for B2's and B3's own entries, which take
    one stride pair for every view: (B, N, stride_b, stride_n)."""
    b, n, strides = qkv_view_strides(fn, num_heads, *views)
    if len(set(strides)) > 1:
        raise ValueError(f"{fn} needs views of one [B, N, F] shape and one "
                         f"stride, got {strides}")
    return (b, n) + strides[0]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_qkv_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float) -> torch.Tensor:
    """Launch the inference kernel (B2). q, k, v: bf16 CUDA ``[B, N, H*64]``
    views with equal shapes and strides, unit stride along features, and
    16-byte aligned rows (the thirds of one fused qkv tensor qualify). The
    kernel reads each view through a TMA tensor map over (64, H, N, B) with
    byte strides (128, 2*stride_n, 2*stride_b), encoded on each call; a map
    that ``cuTensorMapEncodeTiled`` refuses raises :class:`KernelLaunchError`.
    Returns a new contiguous ``[B, N, H*64]`` bf16 tensor."""
    b, n, stride_b, stride_n = _strided_views("attention_qkv_tm", num_heads,
                                              q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ATTENTION_QKV(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, n, num_heads, stride_b, stride_n, float(scale),
                  _stream(q))
    return out


def attention_qkv_rope_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          num_heads: int, scale: float,
                          rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B2-RoPE (``csrc/attention_qkv_rope.cu``): q, k, v as
    :func:`attention_qkv_tm` takes them, in the evens|odds layout, but each
    with a stride pair of its own (:func:`qkv_view_strides`); cos, sin:
    contiguous 16-byte aligned fp32 ``[N, 64]`` tables on the same card. One
    call rotates q and k into a ``[B, N, 2*H*64]`` bf16 workspace (``rot``,
    contiguous, where the caller wants to read the rotated q | k back; else
    taken here) and runs B2's kernel over it and v."""
    fn = "attention_qkv_rope_tm"
    _cuda_views(fn, q, k, v)
    b, n, strides = qkv_view_strides(fn, num_heads, q, k, v)
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, HEAD_DIM)
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(f"{fn} needs a contiguous 16-byte aligned fp32 "
                             f"{name} of shape {(n, HEAD_DIM)} on {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rot_shape = (b, n, 2 * num_heads * HEAD_DIM)
    if rot is None:
        rot = torch.empty(rot_shape, dtype=q.dtype, device=q.device)
    elif (rot.dtype != q.dtype or tuple(rot.shape) != rot_shape
          or not rot.is_contiguous() or rot.device != q.device):
        raise ValueError(f"{fn} needs a contiguous bf16 rot of shape "
                         f"{rot_shape} on {q.device}")
    pairs = (ctypes.c_longlong * 6)(*(x for pair in strides for x in pair))
    ATTENTION_QKV_ROPE(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                       rot.data_ptr(), ctypes.addressof(pairs), b, n,
                       num_heads, float(scale), _stream(q))
    return out


def attention_fwd_lse_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the training forward (B3), B2's kernel writing the LSE too,
    on views as :func:`attention_qkv_tm` takes them. Returns (out:
    contiguous bf16 ``[B, N, H*64]``, lse: contiguous fp32 ``[B, H, N]``,
    natural log)."""
    b, n, stride_b, stride_n = _strided_views("attention_fwd_lse_tm",
                                              num_heads, q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out, lse
    ATTENTION_FWD_LSE(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), b, n, num_heads,
                      stride_b, stride_n, float(scale), _stream(q))
    return out, lse


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per (batch, head, token), fp32 ``[B, H, N]``,
    computed outside the kernels as the JAX package computes it
    (flash_attention.py:1516-1518). out, dout: ``[B, N, H*D]``."""
    b, n, f = out.shape
    return (dout.float() * out.float()).reshape(
        b, n, num_heads, f // num_heads).sum(-1).transpose(1, 2).contiguous()


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, f = t.shape
    return t.reshape(b, n, num_heads, f // num_heads)


def _heads_hm(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The ``[B, H, N, D]`` view of a ``[B, N, H*D]`` view with unit feature
    stride, with no copy: a third of a fused ``[B, N, 3*H*D]`` tensor gives
    strides (N*3*H*D, D, 3*H*D, 1)."""
    return _heads(t, num_heads).transpose(1, 2)


def _fwd_lse(q, k, v, num_heads, scale):
    """B3 on CUDA, :func:`attention_fwd_lse_plain` on the CPU, over
    ``[B, N, H*D]`` views; returns (out contiguous ``[B, N, H*D]``, lse)."""
    if q.is_cuda:
        return attention_fwd_lse_tm(q, k, v, num_heads, scale)
    out, lse = attention_fwd_lse_plain(*(_heads(t, num_heads)
                                         for t in (q, k, v)), scale=scale)
    return out.reshape(q.shape), lse


def attention_bwd_tm(q, k, v, out, lse, dout, num_heads: int, scale: float,
                     dq: torch.Tensor, dk: torch.Tensor,
                     dv: torch.Tensor) -> None:
    """B3's backward (B4's function) over ``[B, N, H*D]`` views: B5's fused
    backward on CUDA, :func:`attention_bwd_plain` on the CPU; writes dq, dk,
    dv (the thirds of d(qkv) qualify). On CUDA every view is read as the
    ``[B, H, N, D]`` view of itself that :func:`_heads_hm` makes, with no
    copy; one that B5 cannot read as it is raises."""
    dout = dout.contiguous()
    if q.is_cuda:
        delta = attention_delta(out, dout, num_heads)
        attention_hm_bwd(*(_heads_hm(t, num_heads)
                           for t in (q, k, v, dout)), lse, delta, scale,
                         *(_heads_hm(t, num_heads) for t in (dq, dk, dv)))
        return
    grads = attention_bwd_plain(*(_heads(t, num_heads)
                                  for t in (q, k, v, out)), lse,
                                _heads(dout, num_heads), scale=scale)
    for dst, src in zip((dq, dk, dv), grads):
        dst.copy_(src.reshape(dst.shape))


def _thirds(qkv: torch.Tensor):
    e = qkv.shape[-1] // 3
    return qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]


class FusedQKVAttention(torch.autograd.Function):
    """Training attention off a fused qkv ``[B, N, 3*H*D]``: B3 forward,
    B5's fused backward writing d(qkv)'s thirds in place (port of
    ``_flash_qkv_tm_fwd_rule`` / ``_flash_qkv_tm_bwd_rule``); the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        out, lse = _fwd_lse(*_thirds(qkv), num_heads, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        attention_bwd_tm(*_thirds(qkv), out, lse, dout, ctx.num_heads,
                         ctx.scale, *_thirds(dqkv))
        return dqkv, None, None


class QKVAttention(torch.autograd.Function):
    """Training attention over three ``[B, N, H*D]`` tensors of one shape
    and stride, with three separate gradients (the decoder's route)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        out, lse = _fwd_lse(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = torch.empty((3,) + tuple(q.shape), dtype=q.dtype,
                            device=q.device)
        attention_bwd_tm(q, k, v, out, lse, dout, ctx.num_heads, ctx.scale,
                         *grads)
        return grads[0], grads[1], grads[2], None, None


def _hm_strides_ok(t: torch.Tensor) -> bool:
    """B5 reads a view as it is: unit head-dim stride, other strides
    multiples of 8 (16-byte rows) and 16-byte aligned data."""
    return (t.stride(-1) == 1 and not any(st % 8 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _hm_views(fn: str, *views: torch.Tensor, bias=None,
              head_dims=HM_HEAD_DIMS):
    """Check bf16 CUDA ``[B, H, N, D]`` views (D in ``head_dims``, one D
    for all) on one device, unit stride along the head dim, other strides
    multiples of 8 and 16-byte aligned data; return their (batch, head,
    token) strides as the int64 array the B5 and B7 entries read, with the
    bias's last (``_hm_bias``)."""
    first = views[0]
    if bias is not None:
        head_dims = BIAS_HEAD_DIMS
    for t in views:
        if (t.dim() != 4 or t.shape[-1] not in head_dims
                or t.shape[-1] != first.shape[-1]):
            raise ValueError(f"{fn} takes [B, H, N, D] views with head dim D "
                             f"in {head_dims}, got {tuple(t.shape)}")
        if not t.is_cuda:
            raise ValueError(f"{fn} needs CUDA tensors, got one on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn} takes bf16, got {t.dtype}")
        if t.device != first.device or t.shape[:2] != first.shape[:2]:
            raise ValueError(f"{fn} needs views of one batch and head count "
                             f"on one device")
        if not _hm_strides_ok(t):
            raise ValueError(f"{fn} needs unit head-dim stride, strides that "
                             f"are multiples of 8 and 16-byte aligned data, "
                             f"got {t.stride()}")
    b, h, _, _ = first.shape
    if b > 65535 or h > 65535 or max(t.shape[2] for t in views) > _INT_MAX:
        raise ValueError(f"{fn}: shape {tuple(first.shape)} exceeds the "
                         f"launch limits")
    vals = [st for t in views for st in t.stride()[:3]]
    if bias is not None:
        vals += list(bias.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


_BIAS_KINDS = {torch.bfloat16: 1, torch.float32: 2}


def _hm_bias(fn: str, bias: torch.Tensor, q: torch.Tensor, nk: int) -> int:
    """Check a bias view for B5: ``[B, H, Nq, Nk]`` bf16 or fp32 on q's
    card with unit stride along Nk (any other strides, 0 where it is
    broadcast); return the entry's bias kind."""
    b, h, nq, _ = q.shape
    if (tuple(bias.shape) != (b, h, nq, nk) or bias.dtype not in _BIAS_KINDS
            or bias.device != q.device or (nk > 1 and bias.stride(-1) != 1)):
        raise ValueError(f"{fn} needs a bf16 or fp32 bias view of shape "
                         f"{(b, h, nq, nk)} on {q.device} with unit stride "
                         f"along Nk, got {bias.dtype} {tuple(bias.shape)} "
                         f"strides {bias.stride()}")
    return _BIAS_KINDS[bias.dtype]


def _hm_rows(fn: str, t: torch.Tensor, shape) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device.type != "cuda"):
        raise ValueError(f"{fn} needs contiguous fp32 rows of shape "
                         f"{tuple(shape)} on the card")


def _hm_out(like: torch.Tensor, n: int) -> torch.Tensor:
    """A ``[B, H, n, D]`` view of a new token-major ``[B, n, H, D]``
    tensor: the layout the proj matmul reads after a transpose."""
    b, h, _, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def attention_hm_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, with_lse: bool = True,
                     bias: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch B5's forward on bf16 CUDA ``[B, H, Nq, D]`` q and
    ``[B, H, Nk, D]`` k, v views (D 32, 64 or 80, each view with its own
    strides; D 32 through its own entry), with an optional bias as
    ``_hm_bias`` takes it (then through the bias entry, D 64 or 80).
    Returns (out: a ``[B, H, Nq, D]`` view of a token-major tensor, lse:
    contiguous fp32 ``[B, H, Nq]`` or None)."""
    fn = "attention_hm_fwd"
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != v.shape:
        raise ValueError(f"{fn} needs k and v of one shape")
    out = _hm_out(q, nq)
    strides = _hm_views(fn, q, k, v, out, bias=bias)
    kind = _hm_bias(fn, bias, q, nk) if bias is not None else 0
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or nk == 0:
        return out, lse
    lse_ptr = lse.data_ptr() if with_lse else None
    if bias is None:
        entry = ATTENTION_HM_FWD_D32 if d == 32 else ATTENTION_HM_FWD
        entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse_ptr, ctypes.addressof(strides), b, h, nq, nk, d,
              float(scale), _stream(q))
    else:
        ATTENTION_HM_BIAS_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), lse_ptr,
                              ctypes.addressof(strides), kind, b, h, nq, nk,
                              d, float(scale), _stream(q))
    return out, lse


def attention_hm_bwd(q, k, v, dout, lse, delta, scale: float,
                     dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     dbias: Optional[torch.Tensor] = None) -> None:
    """Launch B5's fused backward: q, k, v (and the bias) as the forward took
    them; dout and dq ``[B, H, Nq, D]`` views, dk and dv ``[B, H, Nk, D]``
    views; lse and delta contiguous fp32 ``[B, H, Nq]``. With a bias it also
    writes ``dbias``, a contiguous ``[B, H, Nq, Nk]`` tensor in the bias's
    dtype: dL/d(logits), before the scale. dq's fp32 sum over key tiles goes
    through a zeroed workspace allocated here."""
    fn = "attention_hm_bwd"
    b, h, nq, d = q.shape
    nk = k.shape[2]
    strides = _hm_views(fn, q, k, v, dout, dq, dk, dv, bias=bias)
    for t in (lse, delta):
        _hm_rows(fn, t, (b, h, nq))
    if bias is not None:
        kind = _hm_bias(fn, bias, q, nk)
        if (dbias is None or dbias.dtype != bias.dtype
                or tuple(dbias.shape) != (b, h, nq, nk)
                or not dbias.is_contiguous() or dbias.device != q.device):
            raise ValueError(f"{fn} needs a contiguous dbias of shape "
                             f"{(b, h, nq, nk)} in the bias's dtype "
                             f"{bias.dtype} on {q.device}")
    if q.numel() == 0 or nk == 0:
        return
    dq_acc = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    outs = (dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if bias is None:
        entry = ATTENTION_HM_BWD_D32 if d == 32 else ATTENTION_HM_BWD
        entry(*args, *outs, ctypes.addressof(strides), b, h, nq, nk, d,
              float(scale), _stream(q))
    else:
        ATTENTION_HM_BIAS_BWD(*args, bias.data_ptr(), *outs, dbias.data_ptr(),
                              ctypes.addressof(strides), kind, b, h, nq, nk,
                              d, float(scale), _stream(q))


def _hm_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` if B5 takes its strides as they are, else a contiguous copy."""
    return t if _hm_strides_ok(t) else t.contiguous()


def _tok(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)  # [B, H, N, D] <-> [B, N, H, D]


def _bias_layout(bias: torch.Tensor) -> torch.Tensor:
    """``bias`` if B5 reads it as it is (unit stride along Nk), else a
    contiguous copy."""
    return bias if bias.stride(-1) == 1 else bias.contiguous()


class HeadMajorAttention(torch.autograd.Function):
    """Training attention over head-major ``[B, H, N, D]`` views (port of
    ``_flash_hm_fwd_rule`` / ``_flash_hm_bwd_rule``, and with a
    ``[B, H, Nq, Nk]`` bias of ``_flash_bias_fwd_rule`` /
    ``_flash_bias_bwd_rule``): B5's forward with the LSE, then its fused
    backward (dq, dk, dv, and dbias in the bias's dtype), on CUDA; the LSE
    twins on the CPU.
    The gradients come back in the layout of q, k and v, and dbias in the
    bias's dtype, as the JAX rule casts it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        if q.is_cuda:
            if bias is not None:
                bias = _bias_layout(bias)
            out, lse = attention_hm_fwd(*map(_hm_layout, (q, k, v)), scale,
                                        bias=bias)
        else:
            out, lse = attention_fwd_lse_plain(_tok(q), _tok(k), _tok(v),
                                               scale=scale, bias=bias)
            out = _tok(out)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if not q.is_cuda:
            grads = attention_bwd_plain(_tok(q), _tok(k), _tok(v), _tok(out),
                                        lse, _tok(dout), scale=ctx.scale,
                                        bias=bias)
            dbias = None if bias is None else grads[3].to(bias.dtype)
            return tuple(_tok(g) for g in grads[:3]) + (dbias, None)
        q, k, v = map(_hm_layout, (q, k, v))
        dout = _hm_layout(dout)
        delta = (dout.float() * out.float()).sum(-1).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dbias = None
        if bias is not None:
            dbias = torch.empty(bias.shape, dtype=bias.dtype,
                                device=bias.device)
        attention_hm_bwd(q, k, v, dout, lse, delta, ctx.scale, dq, dk, dv,
                         bias=bias, dbias=dbias)
        return dq, dk, dv, dbias, None


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def multi_head_attention_headmajor(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *,
                                   scale: Optional[float] = None,
                                   bias: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """MHA over head-major ``[B, H, Nq, D]`` q and ``[B, H, Nk, D]`` k/v
    views, with an optional additive bias broadcastable to
    ``[B, H, Nq, Nk]`` (expanded to it as a view; autograd sums its
    gradient back over the broadcast dimensions); returns ``[B, H, Nq, D]``.
    Under differentiation :class:`HeadMajorAttention`; otherwise B5's
    forward without the LSE on CUDA and :func:`attention_plain` on the
    CPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"attention on {q.device}")
    if bias is not None:
        b, h, nq, _ = q.shape
        bias = bias.expand(b, h, nq, k.shape[2])
    if _wants_grad(q, k, v, *(() if bias is None else (bias,))):
        return HeadMajorAttention.apply(q, k, v, bias, scale)
    if q.is_cuda:
        return attention_hm_fwd(
            *map(_hm_layout, (q, k, v)), scale, with_lse=False,
            bias=None if bias is None else _bias_layout(bias))[0]
    return _tok(attention_plain(_tok(q), _tok(k), _tok(v), scale=scale,
                                bias=bias))


def attention_decomposed_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rel_h: torch.Tensor,
                               rel_w: torch.Tensor, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Attention with SAM's k-separable rel-pos bias (the twin of
    ``xla_attention_decomposed_hm``): fp32 logits scaled, plus
    ``rel_h[..., :, None] + rel_w[..., None, :]`` in fp32 on their
    ``[N, kh, kw]`` view, fp32 softmax, probabilities cast to v's dtype
    before the product. q, k, v: [B, H, N, D] with N = kh*kw; rel_h:
    [B, H, N, kh]; rel_w: [B, H, N, kw]. Returns [B, H, N, D] in q's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, n, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    logits = (logits.reshape(b, h, n, kh, kw) + rel_h.float()[..., :, None]
              + rel_w.float()[..., None, :])
    probs = torch.softmax(logits.reshape(b, h, n, kh * kw), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_relpos_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_h: torch.Tensor, rel_w: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Launch B7 (``csrc/attention_relpos.cu``) on bf16 CUDA ``[B, H, N, D]``
    q, k, v views (D 64 or 80, each view with its own strides) and
    contiguous bf16 rel_h ``[B, H, N, kh]``, rel_w ``[B, H, N, kw]`` with
    N = kh*kw below 65536 and kh + kw at most 512 (the rows the kernel
    stages in shared memory). The entry reads the views through TMA tensor
    maps encoded on each call (a map ``cuTensorMapEncodeTiled`` refuses
    raises :class:`KernelLaunchError`), and takes its mma.sync kernel where
    kh + kw leaves no room beside the warp-specialised kernel's pipeline.
    Returns a ``[B, H, N, D]`` view of a new token-major tensor."""
    fn = "attention_relpos_hm"
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{fn} needs q, k and v of one shape")
    out = _hm_out(q, q.shape[2])
    strides = _hm_views(fn, q, k, v, out, head_dims=BIAS_HEAD_DIMS)
    b, h, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    for name, t, c in (("rel_h", rel_h, kh), ("rel_w", rel_w, kw)):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (b, h, n, c)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{fn} needs a contiguous bf16 {name} of shape "
                             f"{(b, h, n, c)} on {q.device}")
    if kh * kw != n or n >= 2**16 or kh + kw > 512:
        raise ValueError(f"{fn} needs N = kh * kw < 65536 and kh + kw <= "
                         f"512, got N {n}, kh {kh}, kw {kw}")
    if out.numel() == 0:
        return out
    ATTENTION_RELPOS(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
                     ctypes.addressof(strides), b, h, n, kh, kw, d,
                     float(scale), _stream(q))
    return out


class DecomposedRelPosAttention(torch.autograd.Function):
    """Training attention with the decomposed rel-pos bias (port of
    ``_flash_relpos_fwd_rule`` / ``_flash_relpos_bwd_rule``): the forward is
    B7 on CUDA, :func:`attention_decomposed_plain` on the CPU; the backward
    recomputes through the plain version under autograd, for q, k, v, rel_h
    and rel_w, as the JAX rule recomputes through the XLA formulation (B7
    has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        if q.is_cuda:
            out = attention_relpos_hm(*map(_hm_layout, (q, k, v)),
                                      rel_h.contiguous(), rel_w.contiguous(),
                                      scale)
        else:
            out = attention_decomposed_plain(q, k, v, rel_h, rel_w,
                                             scale=scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_decomposed_plain(*inputs, scale=ctx.scale)
        return torch.autograd.grad(out, inputs, dout) + (None,)


def multi_head_attention_decomposed_hm(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, rel_h: torch.Tensor,
                                       rel_w: torch.Tensor, *,
                                       scale: Optional[float] = None
                                       ) -> torch.Tensor:
    """Attention over head-major ``[B, H, N, D]`` views with SAM's
    decomposed rel-pos bias from its two terms; returns ``[B, H, N, D]``.
    Under differentiation :class:`DecomposedRelPosAttention`; otherwise B7
    on CUDA and :func:`attention_decomposed_plain` on the CPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"attention on {q.device}")
    if _wants_grad(q, k, v, rel_h, rel_w):
        return DecomposedRelPosAttention.apply(q, k, v, rel_h, rel_w, scale)
    if q.is_cuda:
        return attention_relpos_hm(*map(_hm_layout, (q, k, v)),
                                   rel_h.contiguous(), rel_w.contiguous(),
                                   scale)
    return attention_decomposed_plain(q, k, v, rel_h, rel_w, scale=scale)


def multi_head_attention_qkv_tm(qkv: torch.Tensor, num_heads: int, *,
                                scale: Optional[float] = None,
                                rope_cs: Optional[Tuple[torch.Tensor,
                                                        torch.Tensor]] = None
                                ) -> torch.Tensor:
    """MHA off a fused qkv projection [B, N, 3*H*D], returning token-major
    [B, N, H*D].

    rope_cs: optional fp32 (cos, sin) ``[N, D]`` tables in the evens|odds
    layout (``ops/rope.py``); q and k then rotate inside the kernel (or in
    :func:`attention_qkv_rope_plain` on the CPU), and the caller must have
    permuted the q/k projection columns to match. Inference only, as in the
    JAX package: training takes the head-major route."""
    b, n, f = qkv.shape
    d = f // (3 * num_heads)
    if scale is None:
        scale = d ** -0.5
    if qkv.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"attention on {qkv.device}")
    if rope_cs is not None:
        if _wants_grad(qkv):
            raise NotImplementedError(
                "the RoPE fused-qkv attention is inference only; training "
                "takes the head-major route")
        cos, sin = rope_cs
        if qkv.device.type == "cuda":
            return attention_qkv_rope_tm(*_thirds(qkv), cos, sin, num_heads,
                                         scale)
        qkv_r = qkv.reshape(b, n, 3, num_heads, d)
        out = attention_qkv_rope_plain(qkv_r[:, :, 0], qkv_r[:, :, 1],
                                       qkv_r[:, :, 2], cos, sin, scale=scale)
        return out.reshape(b, n, num_heads * d)
    if _wants_grad(qkv):
        return FusedQKVAttention.apply(qkv, num_heads, scale)
    if qkv.device.type == "cuda":
        return attention_qkv_tm(*_thirds(qkv), num_heads, scale)
    qkv_r = qkv.reshape(b, n, 3, num_heads, d)
    out = attention_plain(qkv_r[:, :, 0], qkv_r[:, :, 1], qkv_r[:, :, 2],
                          scale=scale)
    return out.reshape(b, n, num_heads * d)


def takes_qkv_kernel(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> bool:
    """Whether :func:`multi_head_attention` reads [B, N, H, D] q, k, v
    with B2/B3's kernels: matched shapes at head dim 64, where the JAX
    package takes its fused-qkv kernel (vfmseg_tpu/ops/attention.py:292-293:
    matched shapes, an even head count, 2*D a multiple of 128). Every other
    case runs on B5, as JAX's ``flash_attention``: head dim 32 (DINOhead)
    with matched shapes among them. An odd head count at D 64 stays on B2,
    which computes the same function."""
    return q.shape == k.shape == v.shape and q.shape[-1] == HEAD_DIM


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """MHA over [B, N, H, D] q and [B, Nk, H, D] k/v; returns [B, N, H, D].

    Where :func:`takes_qkv_kernel` holds (the decoder's self- and
    cross-attention at equal lengths, head dim 64) the same kernels as the
    ViT run (B2, or under differentiation B3 and B5's fused backward), read
    from three separate tensors. Every other case runs on B5 through
    :func:`multi_head_attention_headmajor` on CUDA or under differentiation,
    as the JAX package takes ``flash_attention`` there; otherwise the plain
    version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"attention on {q.device}")
    matched = takes_qkv_kernel(q, k, v)
    if not matched and (q.device.type == "cuda" or _wants_grad(q, k, v)):
        return _tok(multi_head_attention_headmajor(_tok(q), _tok(k), _tok(v),
                                                   scale=scale))
    if matched and (q.device.type == "cuda" or _wants_grad(q, k, v)):
        b, n, h, d = q.shape
        q3, k3, v3 = (t.reshape(b, n, h * d) for t in (q, k, v))
        if _wants_grad(q, k, v):
            out = QKVAttention.apply(q3, k3, v3, h, scale)
        else:
            out = attention_qkv_tm(q3, k3, v3, h, scale)
        return out.reshape(b, n, h, d)
    return attention_plain(q, k, v, scale=scale)
