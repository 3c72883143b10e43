"""MultiScaleEncoderDecoder, the earlier MsVFM variant with one shared
context-aware decode head.

Port of vfmseg_tpu/models/segmentors/multiscale.py:21-88. The LR branch
decodes the half-size image without context; the HR branch decodes a crop
with the detached LR logits of the crop as context, through the same head
(a ``DINOhead``). Training (``forward(img, labels)``) draws the crop's origin
from the ``crop`` stream as MsVFM does (y, then x) and returns
``decode_lr.*`` and ``decode_hr.*`` (the HR loss times ``detail_loss``).
Inference: ``lr_forward(img)`` and ``hr_forward(img, context_logits)``
(the context resized x0.25 first), logits at the input resolution, which a
context-conditioned slide takes (``eval/slide.py``
``ms_slide_inference``). NHWC in and out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.losses import cross_entropy_loss, seg_accuracy
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import (
    backbone_outputs,
)
from vfmseg_tpu_torch.ops.resize import nearest_downsample_2x, resize


class MultiScaleEncoderDecoder(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 hr_crop_size: Tuple[int, int] = (512, 512),
                 crop_coord_divisible: int = 32, detail_loss: float = 1.0,
                 align_corners: bool = False):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.hr_crop_size = tuple(hr_crop_size)
        self.crop_coord_divisible = crop_coord_divisible
        self.detail_loss = detail_loss
        self.align_corners = align_corners

    def _resize(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return resize(x, method="bilinear", align_corners=self.align_corners,
                      **kwargs)

    def _feats(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return backbone_outputs(self.backbone, img)[0]

    def lr_forward(self, img: torch.Tensor) -> torch.Tensor:
        logits = self.decode_head(self._feats(img), None)
        return self._resize(logits, size=img.shape[1:3])

    def hr_forward(self, img: torch.Tensor,
                   context_logits: torch.Tensor) -> torch.Tensor:
        """The crop decoded with ``context_logits`` (at the crop's size)
        resized x0.25 as context (multiscale.py:44-52)."""
        ctx = self._resize(context_logits, scale_factor=0.25)
        logits = self.decode_head(self._feats(img), ctx)
        return self._resize(logits, size=img.shape[1:3])

    def forward(self, img: torch.Tensor,
                labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        ch, cw = self.hr_crop_size
        div = self.crop_coord_divisible
        h, w = img.shape[1:3]
        lr_img = self._resize(img, scale_factor=0.5)
        lr_labels = nearest_downsample_2x(labels)
        lr_logits = self._resize(self.decode_head(self._feats(lr_img), None),
                                 size=lr_labels.shape[1:3])
        losses = {
            "decode_lr.loss_ce": cross_entropy_loss(lr_logits, lr_labels),
            "decode_lr.acc_seg": seg_accuracy(lr_logits, lr_labels)}
        y1 = rng.randint("crop", max((h - ch + 1) // div, 1)) * div
        x1 = rng.randint("crop", max((w - cw + 1) // div, 1)) * div
        hr_img = img[:, y1:y1 + ch, x1:x1 + cw]
        hr_labels = labels[:, y1:y1 + ch, x1:x1 + cw]
        context = lr_logits.detach()[:, y1 // 2:y1 // 2 + ch // 2,
                                     x1 // 2:x1 // 2 + cw // 2]
        ctx = self._resize(context, scale_factor=0.5)
        hr_logits = self._resize(self.decode_head(self._feats(hr_img), ctx),
                                 size=(ch, cw))
        losses["decode_hr.loss_ce"] = (
            cross_entropy_loss(hr_logits, hr_labels) * self.detail_loss)
        losses["decode_hr.acc_seg"] = seg_accuracy(hr_logits, hr_labels)
        return losses
