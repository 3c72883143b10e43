"""Plain encoder-decoder segmentor (backbone + decode head).

Port of vfmseg_tpu/models/segmentors/encoder_decoder.py:21-42, inference:
``forward(img)`` gives the head's logits at its own stride (the JAX
``forward``), ``encode_decode(img)`` resizes them to the image (mmseg
``encode_decode``), which the ``whole`` and ``slide`` modes call. With
``frozen_backbone`` (FrozenBackboneEncoderDecoder) the features are detached,
as the JAX module stops their gradient. The training losses (the JAX
``__call__``) belong to the training slice and raise. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vfmseg_tpu_torch.ops.resize import resize

TRAINING_SLICE = ("the training losses of this segmentor are not ported "
                  "yet (ROADMAP A8, the Mask2Former training slice)")


class EncoderDecoder(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 align_corners: bool = False, frozen_backbone: bool = False):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.align_corners = align_corners
        self.frozen_backbone = frozen_backbone

    def features(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = self.backbone(img)
        if self.frozen_backbone:
            feats = tuple(f.detach() for f in feats)
        return feats

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Head logits at the head's stride for a [B, H, W, 3] image; with
        ``labels``, the training losses, which raise."""
        if labels is not None:
            raise NotImplementedError(TRAINING_SLICE)
        return self.decode_head(self.features(img))

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        """Logits resized bilinearly to the input resolution."""
        return resize(self.forward(img), size=img.shape[1:3],
                      method="bilinear", align_corners=self.align_corners)
