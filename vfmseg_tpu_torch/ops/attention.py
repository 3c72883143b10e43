"""Multi-head attention, on a hand-written CUDA kernel for inference.

Port of vfmseg_tpu/ops/attention.py:31-57 (``xla_attention``), :194-235
(``multi_head_attention_qkv_tm``) and the same-shape route of :272-314
(``multi_head_attention``), whose TPU kernel is
``flash_attention_qkv_tm`` (vfmseg_tpu/ops/flash_attention.py:1637-1663).

* :func:`attention_plain` is the plain PyTorch version: fp32 logits and
  softmax, probabilities cast to v's dtype before the product with v.
* :func:`attention_qkv_tm` launches ``csrc/attention_qkv.cu`` on bf16
  ``[B, N, H*64]`` q/k/v views and returns token-major ``[B, N, H*64]``.
* :func:`multi_head_attention_qkv_tm` and :func:`multi_head_attention` pick
  by device: CPU tensors take the plain version, CUDA tensors the kernel,
  and nothing falls back from one to the other.

Layouts are the JAX package's: ``[B, N, H, D]`` per head, ``[B, N, 3*H*D]``
for a fused qkv projection (q|k|v thirds, head-contiguous), and token-major
``[B, N, H*D]`` output.
"""

from __future__ import annotations

from typing import Optional

import torch

from vfmseg_tpu_torch.kernels import ATTENTION_QKV

HEAD_DIM = 64  # the only head dim csrc/attention_qkv.cu takes
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


def attention_qkv_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float) -> torch.Tensor:
    """Launch the attention kernel. q, k, v: bf16 CUDA ``[B, N, H*64]`` views
    with equal shapes and strides, unit stride along features, and 16-byte
    aligned rows (the thirds of one fused qkv tensor qualify). Returns a new
    contiguous ``[B, N, H*64]`` bf16 tensor."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"attention_qkv_tm needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention_qkv_tm takes bf16, {name} is {t.dtype}")
        if t.dim() != 3 or t.shape != q.shape or t.stride() != q.stride():
            raise ValueError("attention_qkv_tm needs q, k, v of one [B, N, F] "
                             "shape and one stride")
        if t.device != q.device:
            raise ValueError("attention_qkv_tm needs q, k, v on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"attention_qkv_tm needs 16-byte aligned {name}")
    b, n, f = q.shape
    if f != num_heads * HEAD_DIM:
        raise ValueError(f"attention_qkv_tm takes head_dim {HEAD_DIM} only: "
                         f"features {f} != {num_heads} heads x {HEAD_DIM}")
    stride_b, stride_n, stride_f = q.stride()
    if stride_f != 1 or stride_n % 8 or (b > 1 and stride_b % 8):
        raise ValueError(f"attention_qkv_tm needs unit feature stride and "
                         f"row strides that are multiples of 8, got "
                         f"{q.stride()}")
    if max(stride_b, stride_n) > _INT_MAX or b > 65535 or num_heads > 65535:
        raise ValueError(f"attention_qkv_tm: shape {tuple(q.shape)} with "
                         f"strides {q.stride()} exceeds the launch limits")
    out = torch.empty((b, n, f), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ATTENTION_QKV(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, n, num_heads, stride_b, stride_n, float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def multi_head_attention_qkv_tm(qkv: torch.Tensor, num_heads: int, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """MHA off a fused qkv projection [B, N, 3*H*D], returning token-major
    [B, N, H*D]."""
    b, n, f = qkv.shape
    d = f // (3 * num_heads)
    if scale is None:
        scale = d ** -0.5
    if qkv.device.type == "cuda":
        e = num_heads * d
        return attention_qkv_tm(qkv[..., :e], qkv[..., e:2 * e],
                                qkv[..., 2 * e:], num_heads, scale)
    if qkv.device.type != "cpu":
        raise NotImplementedError(f"attention on {qkv.device}")
    qkv_r = qkv.reshape(b, n, 3, num_heads, d)
    out = attention_plain(qkv_r[:, :, 0], qkv_r[:, :, 1], qkv_r[:, :, 2],
                          scale=scale)
    return out.reshape(b, n, num_heads * d)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """MHA over [B, N, H, D] q and [B, Nk, H, D] k/v; returns [B, N, H, D].

    On CUDA only the matched-shape case runs (the decoder's self- and
    cross-attention at equal lengths), on the same kernel as the ViT, read
    from three separate tensors. The general kernel for Nq != Nk is not
    ported yet, so that case raises there."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        if not q.shape == k.shape == v.shape:
            raise NotImplementedError(
                "CUDA attention needs matched q/k/v shapes; the general "
                "flash kernel for Nq != Nk is not ported")
        b, n, h, d = q.shape
        out = attention_qkv_tm(q.reshape(b, n, h * d), k.reshape(b, n, h * d),
                               v.reshape(b, n, h * d), h, scale)
        return out.reshape(b, n, h, d)
    if q.device.type != "cpu":
        raise NotImplementedError(f"attention on {q.device}")
    return attention_plain(q, k, v, scale=scale)
