"""Segmentor for the Mask2Former set-prediction head, inference.

Port of vfmseg_tpu/models/segmentors/maskformer.py:24-53: an encoder-decoder
whose decode head is a Mask2FormerHead; ``forward(img)`` composes the last
stage's softmax(cls) x sigmoid(mask) into semantic logits at the mask
features' resolution (``semantic_inference``), and ``encode_decode`` resizes
them to the image. The set-prediction training loss (the JAX ``__call__``,
with the Hungarian matching of ``m2f_loss.py``) belongs to the training slice
and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from vfmseg_tpu_torch.models.heads.mask2former import semantic_inference
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import (
    TRAINING_SLICE,
    EncoderDecoder,
)


class MaskFormerSegmentor(EncoderDecoder):
    def __init__(self, backbone, decode_head, num_classes: int = 19,
                 align_corners: bool = False, frozen_backbone: bool = False):
        super().__init__(backbone, decode_head, align_corners=align_corners,
                         frozen_backbone=frozen_backbone)
        self.num_classes = num_classes

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Semantic logits [B, h, w, num_classes] in fp32 at the mask
        features' resolution (the first backbone map's); with ``labels``,
        the training losses, which raise."""
        if labels is not None:
            raise NotImplementedError(TRAINING_SLICE)
        cls_preds, mask_preds = self.decode_head(self.features(img))
        return semantic_inference(cls_preds[-1], mask_preds[-1],
                                  self.num_classes)
