"""DAFormerHead, context-aware multi-level fusion with ASPP.

Port of vfmseg_tpu/models/heads/daformer.py:19-84: the SegFormer embedding
of every level (``MLPEmbedHead``), then with ``fusion="aspp"`` an
:class:`ASPPModule` over the concatenation (a 1x1 branch at dilation 1 and
3x3 atrous branches, each GroupNorm + ReLU, concatenated), with
``fusion="conv1"`` nothing; then a 1x1 projection + GroupNorm + ReLU,
dropout in training mode and a 1x1 classifier. NHWC in and out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Conv2d, GroupNorm, gn_groups
from vfmseg_tpu_torch.models.heads.segformer import MLPEmbedHead


class ASPPModule(nn.Module):
    """Parallel atrous convolutions (aspp_head.py); the global pooling
    branch of the JAX module is off in every config and not ported."""

    def __init__(self, in_channels: int, channels: int,
                 dilations: Sequence[int] = (1, 6, 12, 18),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            k = 1 if d == 1 else 3
            self.add_module(f"branch{i}", Conv2d(
                in_channels, channels, k, padding="SAME", dilation=d,
                dtype=dtype))
            self.add_module(f"branch{i}_gn", GroupNorm(
                gn_groups(channels), channels, eps=1e-5, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i in range(len(self.dilations)):
            y = getattr(self, f"branch{i}")(x)
            outs.append(F.relu(getattr(self, f"branch{i}_gn")(y)))
        return torch.cat(outs, dim=-1)


class DAFormerHead(MLPEmbedHead):
    """``fusion="aspp"``: the context-aware DAFormer (the sepaspp base);
    ``fusion="conv1"``: the plain 1x1 fusion (the conv1 base)."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 channels: int = 256, num_classes: int = 19,
                 dilations: Sequence[int] = (1, 6, 12, 18),
                 fusion: str = "aspp", dropout_ratio: float = 0.1,
                 align_corners: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, channels, align_corners, dtype)
        if fusion not in ("aspp", "conv1"):
            raise ValueError(f"fusion {fusion!r} is not 'aspp' or 'conv1'")
        self.dropout_ratio = dropout_ratio
        width = len(in_channels) * channels
        self.fuse_aspp = None
        if fusion == "aspp":
            self.fuse_aspp = ASPPModule(width, channels, dilations,
                                        dtype=dtype)
            width = len(tuple(dilations)) * channels
        self.fuse_proj = Conv2d(width, channels, 1, dtype=dtype)
        self.fuse_gn = GroupNorm(gn_groups(channels), channels, eps=1e-5,
                                 dtype=dtype)
        self.conv_seg = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x = self.embed(feats)
        if self.fuse_aspp is not None:
            x = self.fuse_aspp(x)
        x = F.relu(self.fuse_gn(self.fuse_proj(x)))
        x = rng.dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)
