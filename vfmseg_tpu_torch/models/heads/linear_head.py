"""LinearHead, the coarse decode head, eval only.

Port of vfmseg_tpu/models/heads/linear_head.py: concat the 4 backbone maps,
1x1 conv + GroupNorm + ReLU down to C, two stride-2 transposed convs
(C -> C/2 -> C/4) with BatchNorm (running statistics) + GELU after the first
and GELU after the second, then a 1x1 classifier. NHWC in and out. Dropout is
an identity at inference and is left out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models.common import (
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    gn_groups,
)


class LinearHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 num_classes: int = 19, dtype: torch.dtype = torch.float32,
                 **_unused):
        super().__init__()
        c = in_channels[0]
        self.dtype = dtype
        self.fusion_conv = Conv2d(sum(in_channels), c, 1, dtype=dtype)
        self.fusion_gn = GroupNorm(gn_groups(c), c, eps=1e-5, dtype=dtype)
        self.up1 = ConvTranspose2d(c, c // 2, 2, stride=2, dtype=dtype)
        self.up_bn = nn.BatchNorm2d(c // 2, eps=1e-5)
        self.up2 = ConvTranspose2d(c // 2, c // 4, 2, stride=2, dtype=dtype)
        self.conv_seg = Conv2d(c // 4, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x = torch.cat(feats, dim=-1)
        x = F.relu(self.fusion_gn(self.fusion_conv(x)))
        x = self.up1(x)
        bn = self.up_bn
        x = F.batch_norm(x.float().permute(0, 3, 1, 2), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, False, 0.0,
                         bn.eps).permute(0, 2, 3, 1).to(self.dtype)
        x = F.gelu(x)
        x = F.gelu(self.up2(x))
        return self.conv_seg(x)
