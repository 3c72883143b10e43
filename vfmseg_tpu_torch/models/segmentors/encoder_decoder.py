"""Plain encoder-decoder segmentor (backbone + decode head).

Port of vfmseg_tpu/models/segmentors/encoder_decoder.py:21-58.
``forward(img)`` gives the head's logits at its own stride (the JAX
``forward``), ``encode_decode(img)`` resizes them to the image (mmseg
``encode_decode``), which the ``whole`` and ``slide`` modes call, and
``forward(img, labels)`` the training losses (the JAX ``__call__``):
``decode.loss_ce`` (optionally weighted per pixel) and ``decode.acc_seg`` on
the logits resized bilinearly to the labels. With ``frozen_backbone`` (FrozenBackboneEncoderDecoder) the
backbone runs deterministic (in eval mode, also while the segmentor trains)
and without a graph, as the JAX module stops the features' gradient. NHWC
in and out.

:func:`backbone_outputs` unpacks what a backbone returns: a Rein backbone
with ``returns_queries`` gives (maps, queries).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from vfmseg_tpu_torch.models.losses import cross_entropy_loss, seg_accuracy
from vfmseg_tpu_torch.ops.resize import resize


def backbone_outputs(backbone: nn.Module, img: torch.Tensor
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Optional[torch.Tensor]]:
    """(feature maps, Rein queries or None) of ``backbone(img)``."""
    out = backbone(img)
    if getattr(backbone, "returns_queries", False):
        return out
    return out, None


class EncoderDecoder(nn.Module):
    # the JAX EncoderDecoder runs a frozen backbone deterministic in
    # training too (encoder_decoder.py:32); MaskFormerSegmentor does not
    frozen_backbone_trains = False

    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 align_corners: bool = False, frozen_backbone: bool = False):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.align_corners = align_corners
        self.frozen_backbone = frozen_backbone

    def train(self, mode: bool = True) -> "EncoderDecoder":
        super().train(mode)
        if self.frozen_backbone and not self.frozen_backbone_trains:
            self.backbone.eval()
        return self

    def features(self, img: torch.Tensor
                 ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
        """The backbone's maps and Rein queries (None without); a frozen
        backbone runs without a graph."""
        ctx = torch.no_grad() if self.frozen_backbone else (
            contextlib.nullcontext())
        with ctx:
            return backbone_outputs(self.backbone, img)

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                pixel_weight: Optional[torch.Tensor] = None):
        """Head logits at the head's stride for a [B, H, W, 3] image; with
        ``labels`` [B, H, W] (255 ignored), the training loss dict, the CE
        weighted per pixel by ``pixel_weight`` [B, H, W] where given (DACS's
        pseudo-label confidence)."""
        logits = self.decode_head(self.features(img)[0])
        if labels is None:
            return logits
        logits = resize(logits, size=labels.shape[1:3], method="bilinear",
                        align_corners=self.align_corners)
        return {"decode.loss_ce": cross_entropy_loss(
                    logits, labels, pixel_weight=pixel_weight),
                "decode.acc_seg": seg_accuracy(logits, labels)}

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        """Logits resized bilinearly to the input resolution."""
        return resize(self.forward(img), size=img.shape[1:3],
                      method="bilinear", align_corners=self.align_corners)
