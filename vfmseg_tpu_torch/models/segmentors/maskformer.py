"""Segmentor for the Mask2Former set-prediction head.

Port of vfmseg_tpu/models/segmentors/maskformer.py:24-70: an encoder-decoder
whose decode head is a Mask2FormerHead, fed the Rein backbone's query
vector where there is one (rein_mask2former.py:26-30).

* ``forward(img)``: the last stage's softmax(cls) x sigmoid(mask) as
  semantic logits at the mask features' resolution (``semantic_inference``);
  ``encode_decode`` resizes them to the image.
* ``forward(img, labels)``: every stage's predictions through the
  set-prediction loss (``heads/m2f_loss.py``) with ``num_points`` points,
  scaled by the mean of an optional ``pixel_weight`` (maskformer.py:66-67),
  over the global batch under data parallelism; it draws from the ``mask``
  stream. A frozen backbone runs in the segmentor's
  mode (the JAX ``__call__`` runs it with ``train=True``) without a graph,
  its maps and queries detached.
"""

from __future__ import annotations

from typing import Optional

import torch

from vfmseg_tpu_torch.models.heads.m2f_loss import mask2former_loss
from vfmseg_tpu_torch.models.heads.mask2former import semantic_inference
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import EncoderDecoder
from vfmseg_tpu_torch.parallel import mesh


class MaskFormerSegmentor(EncoderDecoder):
    frozen_backbone_trains = True

    def __init__(self, backbone, decode_head, num_classes: int = 19,
                 num_points: int = 12544, align_corners: bool = False,
                 frozen_backbone: bool = False):
        super().__init__(backbone, decode_head, align_corners=align_corners,
                         frozen_backbone=frozen_backbone)
        self.num_classes = num_classes
        self.num_points = num_points

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                pixel_weight: Optional[torch.Tensor] = None):
        """Semantic logits [B, h, w, num_classes] in fp32 at the mask
        features' resolution (the first backbone map's); with ``labels``
        [B, H, W] (255 ignored), the multi-stage loss dict, every loss
        scaled by the mean of ``pixel_weight`` where given (a per-pixel
        weight has no direct analogue in set prediction)."""
        feats, queries = self.features(img)
        cls_preds, mask_preds = self.decode_head(feats, queries,
                                                 train=labels is not None)
        if labels is None:
            return semantic_inference(cls_preds[-1], mask_preds[-1],
                                      self.num_classes)
        losses = mask2former_loss(cls_preds, mask_preds, labels,
                                  num_classes=self.num_classes,
                                  num_points=self.num_points)
        if pixel_weight is not None:
            # the global batch's mean under data parallelism (equal local
            # batches), as under the JAX mesh: ClassMix makes each rank's
            # mean its own
            scale = mesh.all_reduce_mean(pixel_weight.float().mean())
            losses = {k: (v * scale if "loss" in k else v)
                      for k, v in losses.items()}
        return losses
