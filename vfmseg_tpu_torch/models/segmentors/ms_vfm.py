"""MsVFM segmentor, inference methods.

Port of vfmseg_tpu/models/segmentors/ms_vfm.py:29-58: ``lr_forward`` (the
coarse backbone + LinearHead path) and ``hr_forward`` (backbone + VFMHead
conditioned on context logits), the building blocks that the two-stage slide
engine (``eval/slide.py``) drives. The two-scale training forward waits for
the training slice. NHWC images in, NHWC logits at the input size out.
"""

from __future__ import annotations

import torch
from torch import nn

from vfmseg_tpu_torch.ops.resize import resize


class MsVFMSegmentor(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 aux_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.aux_head = aux_head

    def _feats(self, img: torch.Tensor):
        if self.training:
            raise NotImplementedError(
                "the torch port runs inference only: call .eval() first")
        return self.backbone(img)

    def lr_forward(self, img: torch.Tensor) -> torch.Tensor:
        """Coarse path: backbone + LinearHead logits resized to the image
        size (whole-inference semantics)."""
        logits = self.decode_head(self._feats(img))
        return resize(logits, size=img.shape[1:3], method="bilinear")

    def hr_forward(self, img: torch.Tensor,
                   context_logits: torch.Tensor) -> torch.Tensor:
        """Refine path: backbone + VFMHead(context) logits resized to the
        image size, with the decoder's mask off."""
        logits = self.aux_head(self._feats(img), context_logits)
        return resize(logits, size=img.shape[1:3], method="bilinear")
