"""Resize of NHWC tensors with PyTorch ``F.interpolate`` semantics.

Port of vfmseg_tpu/ops/resize.py:127-155. The JAX package builds separable
interpolation matrices to reproduce ``F.interpolate``; here the semantics are
the function itself: bilinear or bicubic (Keys, a = -0.75), no antialias, and
with ``scale_factor`` the output size is ``floor(in * s)`` while source
coordinates use the given scale (``recompute_scale_factor=False``).

Under autograd a bf16 input is resized in fp32 and the result cast back.
The forward is the same (``F.interpolate`` computes bf16 in fp32 inside),
but its CUDA backward accumulates into a buffer of the input's dtype with
atomics, and in bf16 small contributions round away: on an H100, one train
step's gradients came out ~19% short of the fp32 CPU step's, at the 16x
upsampling of the refine logits. The JAX package's backward (two einsums
with fp32 accumulation) has no such loss.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size: Optional[Sequence[int]] = None,
           scale_factor: Optional[float] = None, method: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Resize [..., H, W, C]; exactly one of size / scale_factor."""
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unsupported method {method!r}")
    h, w = x.shape[-3], x.shape[-2]
    if size is not None:
        oh, ow = int(size[0]), int(size[1])
        kwargs = dict(size=(oh, ow))
    elif scale_factor is not None:
        oh, ow = int(h * scale_factor), int(w * scale_factor)
        kwargs = dict(scale_factor=(float(scale_factor),) * 2,
                      recompute_scale_factor=False)
    else:
        raise ValueError("resize needs size or scale_factor")
    if (oh, ow) == (h, w):
        return x
    lead = x.shape[:-3]
    xc = x
    if (x.dtype != torch.float32 and torch.is_grad_enabled()
            and x.requires_grad):
        xc = x.float()
    x4 = xc.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = F.interpolate(x4, mode=method, align_corners=align_corners, **kwargs)
    return y.permute(0, 2, 3, 1).reshape(
        tuple(lead) + (oh, ow, x.shape[-1])).to(x.dtype)


def nearest_downsample_2x(labels: torch.Tensor) -> torch.Tensor:
    """torch-nearest 0.5x downsample of [..., H, W] labels: the even rows and
    columns (vfmseg_tpu/ops/resize.py:168-174)."""
    return labels[..., ::2, ::2]
