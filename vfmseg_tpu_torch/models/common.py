"""Shared model helpers.

``gn_groups`` ports vfmseg_tpu/models/common.py. :func:`not_ported` is the
error the builders raise for a config type the port does not build yet,
naming the ROADMAP Queue A item that ports it. The layers below hold fp32
parameters and compute in a ``dtype`` given at construction, as the flax
layers of the JAX package do with ``dtype=``; the convolutions and GroupNorm
take and return NHWC tensors and go NCHW only inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# config type -> the ROADMAP Queue A item that ports it
QUEUE_ITEMS = {
    "CLIPVisionTransformer": "A7", "ReinsCLIPVisionTransformer": "A7",
    "MixVisionTransformer": "A9", "ResNetV1c": "A9", "ReinsResNetV1c": "A9",
    "SegformerHead": "A9", "DAFormerHead": "A9", "DINOhead": "A9",
    "AttentionHead": "A9", "HRDAHead": "A9", "HRDAEncoderDecoder": "A9",
    "FrozenHRDAEncoderDecoder": "A9", "MultiScaleEncoderDecoder": "A9",
    "DomainGeneral": "A10",
}


def not_ported(what: str, kind: str) -> NotImplementedError:
    """``NotImplementedError`` for the ``what`` type ``kind``, naming its
    queue item where it has one (MiT's ``mit_*`` types are A9's)."""
    item = QUEUE_ITEMS.get(kind, "A9" if kind.startswith("mit_") else None)
    where = f" yet (ROADMAP {item})" if item else ""
    return NotImplementedError(f"{what} type {kind!r} is not ported{where}")


def gn_groups(channels: int, preferred: int = 32) -> int:
    """GroupNorm group count: 32 where it divides the channels (all real
    configs); for small test widths the largest divisor <= preferred."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        _cast(self.bias, self.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors, computing in ``dtype``; ``padding``
    zero-pads every side (1 for flax's ``"SAME"`` at a 3x3 kernel)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), _cast(self.bias, self.dtype),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on NHWC tensors, computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype),
                               _cast(self.bias, self.dtype), self.stride)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` on NHWC tensors: statistics and affine in fp32, the
    result in ``dtype``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(self.dtype)
