"""Multi-head attention on hand-written CUDA kernels: inference, and training
with its backward.

Port of vfmseg_tpu/ops/attention.py:31-57 (``xla_attention``), :194-235
(``multi_head_attention_qkv_tm``) and the same-shape route of :272-314
(``multi_head_attention``), whose TPU kernels are ``flash_attention_qkv_tm``
and its custom VJP ``_flash_qkv_tm`` (vfmseg_tpu/ops/flash_attention.py:
1579-1663).

* :func:`attention_plain` is the plain PyTorch version: fp32 logits and
  softmax, probabilities cast to v's dtype before the product with v.
  :func:`attention_fwd_lse_plain` adds the log-sum-exp of the scaled logits,
  and :func:`attention_bwd_plain` is the backward that recomputes the
  probabilities from it, on whole tensors.
* :func:`attention_qkv_tm` launches the inference kernel
  (``csrc/attention_qkv.cu``, B2), :func:`attention_fwd_lse_tm` the training
  forward that also writes the LSE (same file, B3), and
  :func:`attention_bwd_dq_tm` / :func:`attention_bwd_dkv_tm` the two
  backward kernels (``csrc/attention_qkv_bwd.cu``, B4), on bf16
  ``[B, N, H*64]`` views.
* :func:`multi_head_attention_qkv_tm` and :func:`multi_head_attention` pick:
  when grad is enabled and an input requires it, the autograd Functions
  :class:`FusedQKVAttention` / :class:`QKVAttention` (B3 forward, B4
  backward on CUDA; the LSE twins on the CPU), as the JAX package takes its
  forward rule under differentiation; otherwise the inference kernel on
  CUDA and :func:`attention_plain` on the CPU. Nothing falls back from a
  kernel to a plain version.

Layouts are the JAX package's: ``[B, N, H, D]`` per head, ``[B, N, 3*H*D]``
for a fused qkv projection (q|k|v thirds, head-contiguous), and token-major
``[B, N, H*D]`` output. The LSE is ``[B, H, N]`` fp32, natural log.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vfmseg_tpu_torch.kernels import (
    ATTENTION_BWD_DKV,
    ATTENTION_BWD_DQ,
    ATTENTION_FWD_LSE,
    ATTENTION_QKV,
)

HEAD_DIM = 64  # the only head dim the attention kernels take
_INT_MAX = 2**31 - 1


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per head. q: [B, Nq, H, D]; k/v:
    [B, Nk, H, D]. Returns [B, Nq, H, D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_plain` and the natural-log LSE of the fp32 scaled
    logits. Returns (out [B, Nq, H, D] in q's dtype, lse [B, H, Nq] fp32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype), lse


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`attention_fwd_lse_plain` by the LSE/delta
    recurrence of the kernels, in fp32 on whole tensors: P = exp(S*scale -
    lse), delta = rowsum(dO*O), dS = P*(dP - delta)*scale, dq = dS.K,
    dk = dS^T.Q, dv = P^T.dO. Returns dq, dk, dv in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
                  - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).transpose(1, 2)          # [B, H, Nq]
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _strided_views(fn: str, num_heads: int, *views: torch.Tensor
                   ) -> Tuple[int, int, int, int]:
    """Check bf16 CUDA ``[B, N, H*64]`` views of one shape and one stride
    pair, unit stride along features, 16-byte aligned rows; return
    (B, N, stride_b, stride_n)."""
    first = views[0]
    for t in views:
        if not t.is_cuda:
            raise ValueError(f"{fn} needs CUDA tensors, got one on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn} takes bf16, got {t.dtype}")
        if (t.dim() != 3 or t.shape != first.shape
                or t.stride() != first.stride()):
            raise ValueError(f"{fn} needs views of one [B, N, F] shape and "
                             f"one stride")
        if t.device != first.device:
            raise ValueError(f"{fn} needs its tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn} needs 16-byte aligned tensors")
    b, n, f = first.shape
    if f != num_heads * HEAD_DIM:
        raise ValueError(f"{fn} takes head_dim {HEAD_DIM} only: features {f} "
                         f"!= {num_heads} heads x {HEAD_DIM}")
    stride_b, stride_n, stride_f = first.stride()
    if stride_f != 1 or stride_n % 8 or (b > 1 and stride_b % 8):
        raise ValueError(f"{fn} needs unit feature stride and row strides "
                         f"that are multiples of 8, got {first.stride()}")
    if (max(stride_b, stride_n) > _INT_MAX or b > 65535 or num_heads > 65535
            or first.numel() > _INT_MAX):
        raise ValueError(f"{fn}: shape {tuple(first.shape)} with strides "
                         f"{first.stride()} exceeds the launch limits")
    return b, n, stride_b, stride_n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_qkv_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float) -> torch.Tensor:
    """Launch the inference kernel (B2). q, k, v: bf16 CUDA ``[B, N, H*64]``
    views with equal shapes and strides, unit stride along features, and
    16-byte aligned rows (the thirds of one fused qkv tensor qualify).
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


def attention_fwd_lse_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the training forward (B3) on views as :func:`attention_qkv_tm`
    takes them. Returns (out: contiguous bf16 ``[B, N, H*64]``, lse:
    contiguous fp32 ``[B, H, N]``)."""
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


def _check_bwd(fn: str, q, k, v, dout, lse, delta, num_heads, grads):
    b, n, stride_b, stride_n = _strided_views(fn, num_heads, q, k, v)
    _, _, gstride_b, gstride_n = _strided_views(fn, num_heads, *grads)
    _strided_views(fn, num_heads, dout)
    if grads[0].shape != q.shape:
        raise ValueError(f"{fn} needs gradients of q's shape")
    if not dout.is_contiguous():
        raise ValueError(f"{fn} needs a contiguous dout")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b, num_heads, n)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{fn} needs a contiguous fp32 {name} of shape "
                             f"{(b, num_heads, n)} on {q.device}")
    return b, n, stride_b, stride_n, gstride_b, gstride_n


def attention_bwd_dq_tm(q, k, v, dout, lse, delta, num_heads: int,
                        scale: float, dq: torch.Tensor) -> None:
    """Launch the dq kernel of B4. q, k, v as the forward took them; dout
    contiguous bf16 ``[B, N, H*64]``; lse and delta fp32 ``[B, H, N]``.
    Writes dq, a bf16 ``[B, N, H*64]`` view (a third of d(qkv) qualifies)."""
    b, n, sb, sn, gb, gn = _check_bwd("attention_bwd_dq_tm", q, k, v, dout,
                                      lse, delta, num_heads, (dq,))
    if q.numel() == 0:
        return
    ATTENTION_BWD_DQ(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), b, n, num_heads, sb, sn, gb, gn,
                     float(scale), _stream(q))


def attention_bwd_dkv_tm(q, k, v, dout, lse, delta, num_heads: int,
                         scale: float, dk: torch.Tensor,
                         dv: torch.Tensor) -> None:
    """Launch the dk/dv kernel of B4; arguments as
    :func:`attention_bwd_dq_tm`, writing dk and dv (two views of one
    stride pair)."""
    b, n, sb, sn, gb, gn = _check_bwd("attention_bwd_dkv_tm", q, k, v, dout,
                                      lse, delta, num_heads, (dk, dv))
    if q.numel() == 0:
        return
    ATTENTION_BWD_DKV(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), b, n, num_heads, sb, sn,
                      gb, gn, float(scale), _stream(q))


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, f = t.shape
    return t.reshape(b, n, num_heads, f // num_heads)


def _fwd_lse(q, k, v, num_heads, scale):
    """B3 on CUDA, :func:`attention_fwd_lse_plain` on the CPU, over
    ``[B, N, H*D]`` views; returns (out contiguous ``[B, N, H*D]``, lse)."""
    if q.is_cuda:
        return attention_fwd_lse_tm(q, k, v, num_heads, scale)
    out, lse = attention_fwd_lse_plain(*(_heads(t, num_heads)
                                         for t in (q, k, v)), scale=scale)
    return out.reshape(q.shape), lse


def _bwd(q, k, v, out, lse, dout, num_heads, scale, dq, dk, dv):
    """B4 on CUDA, :func:`attention_bwd_plain` on the CPU; writes dq, dk,
    dv (``[B, N, H*D]`` views)."""
    dout = dout.contiguous()
    if q.is_cuda:
        delta = attention_delta(out, dout, num_heads)
        attention_bwd_dq_tm(q, k, v, dout, lse, delta, num_heads, scale, dq)
        attention_bwd_dkv_tm(q, k, v, dout, lse, delta, num_heads, scale, dk,
                             dv)
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
    B4 backward writing d(qkv)'s thirds in place (port of
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
        _bwd(*_thirds(qkv), out, lse, dout, ctx.num_heads, ctx.scale,
             *_thirds(dqkv))
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
        _bwd(q, k, v, out, lse, dout, ctx.num_heads, ctx.scale, *grads)
        return grads[0], grads[1], grads[2], None, None


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def multi_head_attention_qkv_tm(qkv: torch.Tensor, num_heads: int, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """MHA off a fused qkv projection [B, N, 3*H*D], returning token-major
    [B, N, H*D]."""
    b, n, f = qkv.shape
    d = f // (3 * num_heads)
    if scale is None:
        scale = d ** -0.5
    if qkv.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"attention on {qkv.device}")
    if _wants_grad(qkv):
        return FusedQKVAttention.apply(qkv, num_heads, scale)
    if qkv.device.type == "cuda":
        return attention_qkv_tm(*_thirds(qkv), num_heads, scale)
    qkv_r = qkv.reshape(b, n, 3, num_heads, d)
    out = attention_plain(qkv_r[:, :, 0], qkv_r[:, :, 1], qkv_r[:, :, 2],
                          scale=scale)
    return out.reshape(b, n, num_heads * d)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """MHA over [B, N, H, D] q and [B, Nk, H, D] k/v; returns [B, N, H, D].

    On CUDA only the matched-shape case runs (the decoder's self- and
    cross-attention at equal lengths), on the same kernels as the ViT, read
    from three separate tensors. The general kernel for Nq != Nk is not
    ported yet, so that case raises there; on the CPU it takes the plain
    version, differentiated by autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"attention on {q.device}")
    matched = q.shape == k.shape == v.shape
    if q.device.type == "cuda" and not matched:
        raise NotImplementedError(
            "CUDA attention needs matched q/k/v shapes; the general flash "
            "kernel for Nq != Nk is not ported")
    if matched and (q.device.type == "cuda" or _wants_grad(q, k, v)):
        b, n, h, d = q.shape
        q3, k3, v3 = (t.reshape(b, n, h * d) for t in (q, k, v))
        if _wants_grad(q, k, v):
            out = QKVAttention.apply(q3, k3, v3, h, scale)
        else:
            out = attention_qkv_tm(q3, k3, v3, h, scale)
        return out.reshape(b, n, h, d)
    return attention_plain(q, k, v, scale=scale)
