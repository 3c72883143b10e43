"""SegformerHead, the all-MLP decode head, and the MLP embedding that the
SegFormer-style heads share.

Port of vfmseg_tpu/models/heads/segformer.py:18-46: a Dense embedding per
level, each resized bilinearly to the finest level's grid, concatenated,
1x1 conv + GroupNorm + ReLU, dropout in training mode and a 1x1 classifier.
:class:`MLPEmbedHead` holds the first two steps, which the DAFormer and DINO
heads share (daformer.py:64-72, dino_head.py:37-45); its ``embed<i>``
layers sit on the head itself, as in the flax tree. NHWC in and out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Conv2d, Dense, GroupNorm, gn_groups
from vfmseg_tpu_torch.ops.resize import resize


class MLPEmbedHead(nn.Module):
    """A head with a Dense ``embed<i>`` to ``channels`` per level."""

    def __init__(self, in_channels: Sequence[int], channels: int,
                 align_corners: bool, dtype: torch.dtype):
        super().__init__()
        self.align_corners = align_corners
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"embed{i}", Dense(c, channels, dtype=dtype))

    def embed(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """The levels embedded, resized to the first level's grid and
        concatenated: ``[B, H0, W0, levels * channels]``."""
        target = tuple(feats[0].shape[1:3])
        outs = []
        for i, f in enumerate(feats):
            x = getattr(self, f"embed{i}")(f)
            if tuple(x.shape[1:3]) != target:
                x = resize(x, size=target, method="bilinear",
                           align_corners=self.align_corners)
            outs.append(x)
        return torch.cat(outs, dim=-1)


class SegformerHead(MLPEmbedHead):
    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 channels: int = 256, num_classes: int = 19,
                 dropout_ratio: float = 0.1, align_corners: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, channels, align_corners, dtype)
        self.dropout_ratio = dropout_ratio
        self.fusion_conv = Conv2d(len(in_channels) * channels, channels, 1,
                                  dtype=dtype)
        self.fusion_gn = GroupNorm(gn_groups(channels), channels, eps=1e-5,
                                   dtype=dtype)
        self.conv_seg = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x = F.relu(self.fusion_gn(self.fusion_conv(self.embed(feats))))
        x = rng.dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)
