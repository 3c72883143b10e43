"""DINOhead: the SegFormer head refined by cross-attention to coarse
segmentation logits.

Port of vfmseg_tpu/models/heads/dino_head.py:20-62, the context-aware head of
``MultiScaleEncoderDecoder``: the SegFormer embedding and fusion of the four
maps; with ``context_logits``, these resized bilinearly to the fused grid,
a 1x1 ``context_proj``, and the ported ``TransformerDecoder`` (``refine``,
its mask off) with the fused features as the query and the projected
context as cross-attention context, added to the features; dropout in
training mode and a 1x1 classifier. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Conv2d, GroupNorm, gn_groups
from vfmseg_tpu_torch.models.heads.segformer import MLPEmbedHead
from vfmseg_tpu_torch.models.heads.transformer import TransformerDecoder
from vfmseg_tpu_torch.ops.resize import resize


class DINOHead(MLPEmbedHead):
    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 channels: int = 256, num_classes: int = 19,
                 n_heads: int = 8, d_head: int = 32, depth: int = 1,
                 dropout_ratio: float = 0.1, align_corners: bool = False,
                 attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        """``attn_impl``: the decoder's attention has one route in the port
        (the kernels on CUDA tensors) whatever the value."""
        del attn_impl
        super().__init__(in_channels, channels, align_corners, dtype)
        self.dropout_ratio = dropout_ratio
        self.fusion_conv = Conv2d(len(in_channels) * channels, channels, 1,
                                  dtype=dtype)
        self.fusion_gn = GroupNorm(gn_groups(channels), channels, eps=1e-5,
                                   dtype=dtype)
        self.context_proj = Conv2d(num_classes, channels, 1, dtype=dtype)
        self.refine = TransformerDecoder(
            query_dim=channels, img_feat_dim=channels, n_heads=n_heads,
            d_head=d_head, depth=depth, dtype=dtype)
        self.conv_seg = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...],
                context_logits: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = F.relu(self.fusion_gn(self.fusion_conv(self.embed(feats))))
        if context_logits is not None:
            ctx = resize(context_logits, size=x.shape[1:3],
                         method="bilinear", align_corners=self.align_corners)
            x = x + self.refine(x, self.context_proj(ctx))
        x = rng.dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)
