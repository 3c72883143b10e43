"""MsVFM segmentor: the two-scale training forward and the inference methods.

Port of vfmseg_tpu/models/segmentors/ms_vfm.py:29-136.

* ``forward(img, labels)`` (training, ms_vfm.py:60-136): the 0.5x full view
  (bilinear image, even-pixel labels) goes through the backbone and the
  LinearHead; an aligned random HR crop at full scale goes through the
  backbone and the VFMHead, conditioned on the *detached* LR logits cropped
  to the HR box at half resolution, with the decoder's mask on. When the two
  views have one shape (512x512 each at the headline 1024x1024 crops) the
  backbone sees both in one batch of 2B. Returns the loss dict:
  ``decode_lr.loss_ce``, ``decode_lr.acc_seg``, ``decode_hr.loss_ce`` (times
  ``detail_loss``) and ``decode_hr.acc_seg``. The crop box is drawn on the
  host from the ``crop`` stream (``models/rng.py``): two integers the slice
  needs on the host anyway, so no device sync follows.
* ``lr_forward`` / ``hr_forward``: the coarse and refine paths that the
  two-stage slide engine (``eval/slide.py``) drives, the decoder's mask off.

NHWC images in, NHWC logits at the input size out.
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


class MsVFMSegmentor(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 aux_head: nn.Module,
                 hr_crop_size: Tuple[int, int] = (512, 512),
                 crop_coord_divisible: int = 32, detail_loss: float = 1.0):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.aux_head = aux_head
        self.hr_crop_size = tuple(hr_crop_size)
        self.crop_coord_divisible = crop_coord_divisible
        self.detail_loss = detail_loss

    def _feats(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The backbone's maps; a Rein backbone's queries are not used
        (ms_vfm.py:38-42)."""
        return backbone_outputs(self.backbone, img)[0]

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

    def crop_origin(self, h: int, w: int) -> Tuple[int, int]:
        """Top-left corner of the HR crop (reference get_crop_bbox): each
        offset is randint(0, max((margin + 1) // div, 1)) * div."""
        ch, cw = self.hr_crop_size
        div = self.crop_coord_divisible
        y1 = rng.randint("crop", max((h - ch + 1) // div, 1)) * div
        x1 = rng.randint("crop", max((w - cw + 1) // div, 1)) * div
        return y1, x1

    def forward(self, img: torch.Tensor,
                labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Two-scale training losses. img: [B, H, W, 3] preprocessed;
        labels: [B, H, W] int with 255 ignored. Needs the ``crop``, ``mask``
        and ``dropout`` streams (``rng.streams``)."""
        ch, cw = self.hr_crop_size
        b, h, w = img.shape[:3]
        lr_img = resize(img, scale_factor=0.5, method="bilinear")
        lr_labels = nearest_downsample_2x(labels)
        y1, x1 = self.crop_origin(h, w)
        hr_img = img[:, y1:y1 + ch, x1:x1 + cw]
        hr_labels = labels[:, y1:y1 + ch, x1:x1 + cw]

        if tuple(lr_img.shape[1:3]) == (ch, cw):
            feats = self._feats(torch.cat([lr_img, hr_img], dim=0))
            lr_feats = tuple(f[:b] for f in feats)
            hr_feats = tuple(f[b:] for f in feats)
        else:
            lr_feats = self._feats(lr_img)
            hr_feats = self._feats(hr_img)

        lr_logits = resize(self.decode_head(lr_feats),
                           size=lr_labels.shape[1:3], method="bilinear")
        losses = {
            "decode_lr.loss_ce": cross_entropy_loss(lr_logits, lr_labels),
            "decode_lr.acc_seg": seg_accuracy(lr_logits, lr_labels),
        }
        context = lr_logits.detach()[:, y1 // 2:y1 // 2 + ch // 2,
                                     x1 // 2:x1 // 2 + cw // 2]
        hr_logits = resize(self.aux_head(hr_feats, context, mask_enable=True),
                           size=(ch, cw), method="bilinear")
        losses["decode_hr.loss_ce"] = (cross_entropy_loss(hr_logits, hr_labels)
                                       * self.detail_loss)
        losses["decode_hr.acc_seg"] = seg_accuracy(hr_logits, hr_labels)
        return losses
