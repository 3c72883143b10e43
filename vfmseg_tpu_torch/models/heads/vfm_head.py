"""VFMHead, the context-conditioned refinement head.

Port of vfmseg_tpu/models/heads/vfm_head.py: fuse the 4 backbone maps with a
1x1 conv + GroupNorm + GELU; resize the coarse context logits bilinearly to
4x the feature grid and embed them through a stride-2 conv stack back down to
the feature grid; run the TransformerDecoder with the image features as the
query and the embedded context as cross-attention context (its mask swap
under ``mask_enable``); dropout in training mode (vfm_head.py:75-76);
classify. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Conv2d, GroupNorm, gn_groups
from vfmseg_tpu_torch.models.heads.transformer import TransformerDecoder
from vfmseg_tpu_torch.ops.resize import resize


class VFMHead(nn.Module):
    def __init__(self, transformer: Optional[dict] = None,
                 in_channels: Sequence[int] = (1024,) * 4, channels: int = 256,
                 num_classes: int = 19, dropout_ratio: float = 0.1,
                 align_corners: bool = False, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        """``attn_impl``: the decoder's attention has one route in the port
        (the kernels on CUDA tensors) whatever the value."""
        del attn_impl
        super().__init__()
        ch = channels
        self.align_corners = align_corners
        self.dropout_ratio = dropout_ratio
        self.fuse_conv = Conv2d(sum(in_channels), ch, 1, dtype=dtype)
        self.fuse_gn = GroupNorm(gn_groups(ch), ch, eps=1e-5, dtype=dtype)
        self.embed_conv1 = Conv2d(num_classes, ch // 4, 2, stride=2,
                                  dtype=dtype)
        self.embed_gn1 = GroupNorm(gn_groups(ch // 4), ch // 4, eps=1e-5,
                                   dtype=dtype)
        self.embed_conv2 = Conv2d(ch // 4, ch // 2, 2, stride=2, dtype=dtype)
        self.embed_gn2 = GroupNorm(gn_groups(ch // 2), ch // 2, eps=1e-5,
                                   dtype=dtype)
        self.embed_conv3 = Conv2d(ch // 2, ch, 1, dtype=dtype)
        self.embed_gn3 = GroupNorm(gn_groups(ch), ch, eps=1e-5, dtype=dtype)
        tcfg = dict(transformer or {})
        tcfg.pop("type", None)
        tcfg.setdefault("query_dim", ch)
        tcfg["img_feat_dim"] = ch
        self.transformer_decoder = TransformerDecoder(dtype=dtype, **tcfg)
        self.conv_seg = Conv2d(ch, num_classes, 1, dtype=dtype)

    def forward(self, feats: Tuple[torch.Tensor, ...],
                context_logits: torch.Tensor,
                mask_enable: bool = False) -> torch.Tensor:
        gh, gw = feats[0].shape[1], feats[0].shape[2]
        context = resize(context_logits, size=(gh * 4, gw * 4),
                         method="bilinear", align_corners=self.align_corners)
        x = torch.cat(feats, dim=-1)
        img_feats = F.gelu(self.fuse_gn(self.fuse_conv(x)))
        e = F.gelu(self.embed_gn1(self.embed_conv1(context)))
        e = F.gelu(self.embed_gn2(self.embed_conv2(e)))
        e = self.embed_gn3(self.embed_conv3(e))
        out = self.transformer_decoder(img_feats, e, mask_enable)
        out = rng.dropout(out, self.dropout_ratio, self.training)
        return self.conv_seg(out)
