"""LinearHead, the coarse decode head.

Port of vfmseg_tpu/models/heads/linear_head.py:35-56: concat the 4 backbone
maps, 1x1 conv + GroupNorm + ReLU down to C, two stride-2 transposed convs
(C -> C/2 -> C/4) with BatchNorm + GELU after the first and GELU after the
second, then dropout and a 1x1 classifier. NHWC in and out. The BatchNorm
is flax's (``common.BatchNorm``: momentum 0.9, the biased variance in the
running statistics).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    gn_groups,
)


class LinearHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 num_classes: int = 19, dropout_ratio: float = 0.1,
                 channels: int = 256, align_corners: bool = False,
                 dtype: torch.dtype = torch.float32):
        """``channels`` and ``align_corners``: config parity; the widths
        follow ``in_channels[0]`` and no resize happens here."""
        del channels, align_corners
        super().__init__()
        c = in_channels[0]
        self.dropout_ratio = dropout_ratio
        self.fusion_conv = Conv2d(sum(in_channels), c, 1, dtype=dtype)
        self.fusion_gn = GroupNorm(gn_groups(c), c, eps=1e-5, dtype=dtype)
        self.up1 = ConvTranspose2d(c, c // 2, 2, stride=2, dtype=dtype)
        self.up_bn = BatchNorm(c // 2, eps=1e-5, momentum=0.9, dtype=dtype)
        self.up2 = ConvTranspose2d(c // 2, c // 4, 2, stride=2, dtype=dtype)
        self.conv_seg = Conv2d(c // 4, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x = torch.cat(feats, dim=-1)
        x = F.relu(self.fusion_gn(self.fusion_conv(x)))
        x = F.gelu(self.up_bn(self.up1(x)))
        x = F.gelu(self.up2(x))
        x = rng.dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)
