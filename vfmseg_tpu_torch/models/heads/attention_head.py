"""AttentionHead, HRDA's scale-attention head.

Port of vfmseg_tpu/models/heads/attention_head.py:22-41: concat the 4
backbone maps, 1x1 conv + GroupNorm + ReLU, dropout in training mode and a
1x1 classifier; HRDA takes the sigmoid of its logits as the per-pixel weight
of the high-resolution branch. NHWC in and out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Conv2d, GroupNorm, gn_groups


class AttentionHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 channels: int = 256, num_classes: int = 19,
                 dropout_ratio: float = 0.1, align_corners: bool = False,
                 dtype: torch.dtype = torch.float32):
        """``align_corners``: config parity; no resize happens here."""
        del align_corners
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.fusion_conv = Conv2d(sum(in_channels), channels, 1, dtype=dtype)
        self.fusion_gn = GroupNorm(gn_groups(channels), channels, eps=1e-5,
                                   dtype=dtype)
        self.conv_seg = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x = F.relu(self.fusion_gn(self.fusion_conv(torch.cat(feats, dim=-1))))
        x = rng.dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)
