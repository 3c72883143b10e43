"""LinearHead, the coarse decode head.

Port of vfmseg_tpu/models/heads/linear_head.py:35-56: concat the 4 backbone
maps, 1x1 conv + GroupNorm + ReLU down to C, two stride-2 transposed convs
(C -> C/2 -> C/4) with BatchNorm + GELU after the first and GELU after the
second, then dropout and a 1x1 classifier. NHWC in and out.

BatchNorm follows flax's ``nn.BatchNorm``: in training mode it normalises
with the fp32 batch mean and *biased* variance over (B, H, W) and moves the
running statistics by ``momentum`` 0.9 towards them, the biased variance
included (``F.batch_norm(training=True)`` would store the unbiased one);
in eval mode it uses the running statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import (
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    gn_groups,
)

BN_MOMENTUM = 0.9  # flax's convention; torch's momentum 0.1


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
        self.dtype = dtype
        self.dropout_ratio = dropout_ratio
        self.fusion_conv = Conv2d(sum(in_channels), c, 1, dtype=dtype)
        self.fusion_gn = GroupNorm(gn_groups(c), c, eps=1e-5, dtype=dtype)
        self.up1 = ConvTranspose2d(c, c // 2, 2, stride=2, dtype=dtype)
        self.up_bn = nn.BatchNorm2d(c // 2, eps=1e-5)
        self.up2 = ConvTranspose2d(c // 2, c // 4, 2, stride=2, dtype=dtype)
        self.conv_seg = Conv2d(c // 4, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        x = torch.cat(feats, dim=-1)
        x = F.relu(self.fusion_gn(self.fusion_conv(x)))
        x = F.gelu(self.batch_norm(self.up1(x)))
        x = F.gelu(self.up2(x))
        x = rng.dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)

    def batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """``up_bn`` on NHWC x, fp32 statistics, the result in ``dtype``."""
        bn = self.up_bn
        xf = x.float()
        if self.training:
            var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
            with torch.no_grad():
                m = BN_MOMENTUM
                bn.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                bn.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = bn.running_mean, bn.running_var
        y = (xf - mean) * (bn.weight * torch.rsqrt(var + bn.eps)) + bn.bias
        return y.to(self.dtype)
