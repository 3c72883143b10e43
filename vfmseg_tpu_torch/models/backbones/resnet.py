"""ResNetV1c backbone and its Rein variant, ReinsResNetV1c.

Port of vfmseg_tpu/models/backbones/resnet.py:27-126 (mmseg's ResNetV1c,
which the reference wraps in reins_resnet.py; its configs sit among the
reference's unused model bases): a deep stem of three 3x3 convolutions,
a 3x3 stride-2 max-pool and four stages of bottlenecks, each convolution
bias-free and followed by flax's BatchNorm (``common.BatchNorm``, statistics
moving in training mode), with flax's ``"SAME"`` padding (the extra row and
column after the input at stride 2). One NHWC map per stage in
``out_indices``.

With ``reins_specs`` (one per stage, ``build_reins_resnet``) a Rein bank per
stage (``reins_<stage>``) refines the flattened map after every block of
the stage (reins_resnet.py:33-50), and the forward returns ``(maps, sum of
the queries of the stages in out_indices that link tokens to queries)``
(``returns_queries``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models.backbones.adapters import Reins, ReinsSpec
from vfmseg_tpu_torch.models.backbones.rein_backbones import (
    reins_spec_from_config,
)
from vfmseg_tpu_torch.models.common import BatchNorm, Conv2d, max_pool

STAGE_WIDTHS = (64, 128, 256, 512)


def _conv_bn(in_ch: int, out_ch: int, k: int, stride: int,
             dtype: torch.dtype) -> Tuple[Conv2d, BatchNorm]:
    return (Conv2d(in_ch, out_ch, k, stride=stride, bias=False,
                   padding="SAME", dtype=dtype),
            BatchNorm(out_ch, eps=1e-5, momentum=0.9, dtype=dtype))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to 4x ``channels``, each with BatchNorm,
    ReLU between; a 1x1 strided projection on the shortcut where the width
    or the stride changes."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = channels * 4
        self.conv1, self.bn1 = _conv_bn(in_channels, channels, 1, 1, dtype)
        self.conv2, self.bn2 = _conv_bn(channels, channels, 3, stride, dtype)
        self.conv3, self.bn3 = _conv_bn(channels, out, 1, 1, dtype)
        self.downsample_conv = self.downsample_bn = None
        if in_channels != out or stride != 1:
            self.downsample_conv, self.downsample_bn = _conv_bn(
                in_channels, out, 1, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNetV1c(nn.Module):
    def __init__(self, depth_blocks: Sequence[int] = (3, 4, 6, 3),
                 stem_channels: int = 64,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 reins_specs: Optional[Sequence[ReinsSpec]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth_blocks = tuple(depth_blocks)
        self.out_indices = tuple(out_indices)
        self.reins_specs = None if reins_specs is None else tuple(reins_specs)
        self.returns_queries = self.reins_specs is not None and any(
            self.reins_specs[s].link_token_to_query for s in self.out_indices)
        in_ch = 3
        for i, (ch, s) in enumerate([(stem_channels // 2, 2),
                                     (stem_channels // 2, 1),
                                     (stem_channels, 1)]):
            conv, bn = _conv_bn(in_ch, ch, 3, s, dtype)
            self.add_module(f"stem_conv{i}", conv)
            self.add_module(f"stem_bn{i}", bn)
            in_ch = ch
        for stage, blocks in enumerate(self.depth_blocks):
            width = STAGE_WIDTHS[stage]
            if self.reins_specs is not None:
                self.add_module(f"reins_{stage}", Reins(
                    self.reins_specs[stage], blocks, width * 4, 16,
                    dtype=dtype))
            for blk in range(blocks):
                stride = 2 if blk == 0 and stage > 0 else 1
                self.add_module(f"layer{stage + 1}_block{blk}", Bottleneck(
                    in_ch, width, stride, dtype))
                in_ch = width * 4

    def forward(self, x: torch.Tensor):
        for i in range(3):
            x = F.relu(getattr(self, f"stem_bn{i}")(
                getattr(self, f"stem_conv{i}")(x)))
        x = max_pool(x, 3, 2, same=True)
        outs, queries = [], []
        for stage, blocks in enumerate(self.depth_blocks):
            reins = getattr(self, f"reins_{stage}", None)
            for blk in range(blocks):
                x = getattr(self, f"layer{stage + 1}_block{blk}")(x)
                if reins is not None:
                    b, h, w, c = x.shape
                    x = reins.adapt(x.reshape(b, h * w, c), blk,
                                    num_prefix_tokens=0).reshape(b, h, w, c)
            if stage in self.out_indices:
                outs.append(x)
                if reins is not None and reins.spec.link_token_to_query:
                    queries.append(reins.queries())
        if self.returns_queries:
            return tuple(outs), sum(queries)
        return tuple(outs)


def build_resnet(depth_blocks: Sequence[int] = (3, 4, 6, 3),
                 stem_channels: int = 64,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 lora=None, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto") -> ResNetV1c:
    """The ``ResNetV1c`` type: the JAX module's fields. ``attn_impl``: a
    ResNet has no attention. ResNet takes no LoRA."""
    del attn_impl
    if lora is not None:
        raise NotImplementedError("LoRA on ResNetV1c is not ported")
    return ResNetV1c(depth_blocks, stem_channels, out_indices, dtype=dtype)


_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def build_reins_resnet(reins_config: Dict[str, Any],
                       distinct_cfgs: Optional[Sequence[Dict]] = None,
                       depth: int = 50, out_indices=(0, 1, 2, 3),
                       init_cfg=None, lora=None,
                       dtype: torch.dtype = torch.float32,
                       attn_impl: str = "auto") -> ResNetV1c:
    """resnet.py:110-126: one ReinsSpec per stage, ``reins_config`` updated
    by the stage's entry of ``distinct_cfgs``. ``init_cfg`` names the
    pretrained file (the weight tooling's); ``attn_impl``: no attention."""
    del init_cfg, attn_impl
    if lora is not None:
        raise NotImplementedError("LoRA on ReinsResNetV1c is not ported")
    per_stage = distinct_cfgs or [{}] * 4
    specs = tuple(reins_spec_from_config({**dict(reins_config or {}),
                                          **dict(c)}) for c in per_stage)
    return ResNetV1c(_DEPTHS[depth], out_indices=out_indices,
                     reins_specs=specs, dtype=dtype)
