"""HRDA's multi-resolution segmentor and head.

Port of vfmseg_tpu/models/segmentors/hrda.py:30-185. Two scales: a
low-resolution (LR) pass over the image at ``scales[0]`` (0.5) gives the
context logits and, through the scale-attention head, the per-pixel weight
``att = sigmoid(AttentionHead(lr_feats))``; high-resolution (HR) crops at
``scales[1]`` (1.0) give the detail logits, and the fusion is

    fused = up2(att) * hr_inserted + up2((1 - att) * lr_seg)

(hrda.py:149-210), at the segmentation head's stride ``os`` (4).

* Training (``forward(img, labels)``): one HR crop whose origin is drawn from
  the ``crop`` stream, two ``rng.randint`` calls (y, then x) of
  ``max((size - crop + 1) // div, 1)`` times ``crop_coord_divisible``
  (hrda.py:89-94). ``_fuse`` zeroes the attention outside the crop box at
  the LR-seg grid, pastes the HR logits into a zero canvas at the box and
  resizes x2. The losses are the fused ``loss_seg`` (weight 1 - lr - hr),
  ``lr.loss_seg`` where ``lr_loss_weight`` > 0 and ``hr.loss_seg`` /
  ``hr.acc_seg`` on the crop where ``hr_loss_weight`` > 0; an optional
  ``pixel_weight`` weights each CE, cut to the crop for the HR loss
  (hrda.py:107-124). The LR image
  and the crop go through the backbone in two calls, as in JAX.
* Inference (``encode_decode``, hrda.py:154-182): the LR pass, then every
  HR crop of the slide grid at stride crop / ``hr_slide_stride_divider``
  through the backbone as one batch (``eval/slide.py``), overlap-averaged
  at the ``/os`` grid, fused and resized to the input. ``forward(img)`` is
  ``encode_decode``.
* ``frozen_backbone`` (FrozenHRDAEncoderDecoder): the features carry no
  gradient (``torch.no_grad``, the JAX ``stop_gradient``); the backbone
  still runs in the segmentor's mode, as in JAX.

NHWC in and out; the ``whole`` and ``slide`` eval modes call
``encode_decode`` as for any encoder-decoder.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.eval.slide import (
    accumulate_crops,
    compute_slide_grid,
    extract_crops,
)
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.losses import cross_entropy_loss, seg_accuracy
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import (
    backbone_outputs,
)
from vfmseg_tpu_torch.ops.resize import resize


class HRDAHead(nn.Module):
    """The shared segmentation head and the scale-attention head."""

    def __init__(self, seg_head: nn.Module, scale_attention: nn.Module,
                 lr_loss_weight: float = 0.0, hr_loss_weight: float = 0.1):
        super().__init__()
        self.seg_head = seg_head
        self.scale_attention = scale_attention
        self.lr_loss_weight = lr_loss_weight
        self.hr_loss_weight = hr_loss_weight

    def seg(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return self.seg_head(feats)

    def attention(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return torch.sigmoid(self.scale_attention(feats))


class HRDAEncoderDecoder(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: HRDAHead,
                 scales: Sequence[float] = (0.5, 1.0),
                 hr_crop_size: Tuple[int, int] = (512, 512),
                 crop_coord_divisible: int = 8,
                 hr_slide_stride_divider: int = 2, os: int = 4,
                 frozen_backbone: bool = False, align_corners: bool = False):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.scales = tuple(scales)
        self.hr_crop_size = tuple(hr_crop_size)
        self.crop_coord_divisible = crop_coord_divisible
        self.hr_slide_stride_divider = hr_slide_stride_divider
        self.os = os
        self.frozen_backbone = frozen_backbone
        self.align_corners = align_corners

    def _resize(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return resize(x, method="bilinear", align_corners=self.align_corners,
                      **kwargs)

    def features(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The backbone's maps (a Rein backbone's queries are dropped,
        hrda.py:79-86); without a graph for a frozen backbone."""
        ctx = torch.no_grad() if self.frozen_backbone else (
            contextlib.nullcontext())
        with ctx:
            return backbone_outputs(self.backbone, img)[0]

    def _lr_branch(self, lr_feats) -> Tuple[torch.Tensor, torch.Tensor]:
        """(LR logits, attention resized to their grid)."""
        head = self.decode_head
        lr_seg = head.seg(lr_feats)
        att = self._resize(head.attention(lr_feats),
                           size=lr_seg.shape[1:3])
        return lr_seg, att

    def crop_origin(self, h: int, w: int) -> Tuple[int, int]:
        ch, cw = self.hr_crop_size
        div = self.crop_coord_divisible
        y1 = rng.randint("crop", max((h - ch + 1) // div, 1)) * div
        x1 = rng.randint("crop", max((w - cw + 1) // div, 1)) * div
        return y1, x1

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                pixel_weight: Optional[torch.Tensor] = None):
        """``encode_decode(img)``; with ``labels`` [B, H, W] (255 ignored),
        the training loss dict (needs the ``crop`` and ``dropout`` streams,
        ``rng.streams``), each CE weighted per pixel by ``pixel_weight``
        [B, H, W] where given (the HR loss by its crop)."""
        if labels is None:
            return self.encode_decode(img)
        h, w = img.shape[1:3]
        ch, cw = self.hr_crop_size
        head = self.decode_head
        lr_seg, att = self._lr_branch(self.features(
            self._resize(img, scale_factor=self.scales[0])))
        y1, x1 = self.crop_origin(h, w)
        hr_seg = head.seg(self.features(img[:, y1:y1 + ch, x1:x1 + cw]))
        fused = self._fuse(lr_seg, hr_seg, att, (y1, x1))

        main_w = 1.0 - head.lr_loss_weight - head.hr_loss_weight
        fused_up = self._resize(fused, size=(h, w))
        losses: Dict[str, torch.Tensor] = {
            "loss_seg": main_w * cross_entropy_loss(
                fused_up, labels, pixel_weight=pixel_weight),
            "acc_seg": seg_accuracy(fused_up, labels)}
        if head.lr_loss_weight > 0:
            lr_up = self._resize(lr_seg, size=(h, w))
            losses["lr.loss_seg"] = head.lr_loss_weight * cross_entropy_loss(
                lr_up, labels, pixel_weight=pixel_weight)
        if head.hr_loss_weight > 0:
            hr_labels = labels[:, y1:y1 + ch, x1:x1 + cw]
            hr_weight = (None if pixel_weight is None
                         else pixel_weight[:, y1:y1 + ch, x1:x1 + cw])
            hr_up = self._resize(hr_seg, size=(ch, cw))
            losses["hr.loss_seg"] = head.hr_loss_weight * cross_entropy_loss(
                hr_up, hr_labels, pixel_weight=hr_weight)
            losses["hr.acc_seg"] = seg_accuracy(hr_up, hr_labels)
        return losses

    def _fuse(self, lr_seg: torch.Tensor, hr_seg: torch.Tensor,
              att: torch.Tensor, crop_yx: Tuple[int, int]) -> torch.Tensor:
        """The fusion with one HR crop box at (y1, x1) (hrda.py:128-151)."""
        y1, x1 = crop_yx
        up = float(round(self.scales[1] / self.scales[0]))
        _, lh, lw, _ = lr_seg.shape
        sc = int(round(self.os / self.scales[0]))
        ch, cw = self.hr_crop_size
        rows = torch.arange(lh, device=att.device)
        cols = torch.arange(lw, device=att.device)
        mask = (((rows >= y1 // sc) & (rows < (y1 + ch) // sc))[:, None]
                & ((cols >= x1 // sc) & (cols < (x1 + cw) // sc))[None, :])
        att = att * mask[None, :, :, None].to(att.dtype)
        up_lr = self._resize((1.0 - att) * lr_seg, scale_factor=up)
        att_up = self._resize(att, scale_factor=up)
        top, left = y1 // self.os, x1 // self.os
        hh, hw = hr_seg.shape[1:3]
        inserted = F.pad(hr_seg.to(up_lr.dtype), (
            0, 0, left, up_lr.shape[2] - left - hw,
            top, up_lr.shape[1] - top - hh))
        return att_up * inserted + up_lr

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        """Two-scale fusion of a batch of windows, the HR branch an
        overlapping batched slide (hrda.py:154-182); logits at the input
        resolution."""
        h, w = img.shape[1:3]
        lr_seg, att = self._lr_branch(self.features(
            self._resize(img, scale_factor=self.scales[0])))
        ch, cw = self.hr_crop_size
        d = self.hr_slide_stride_divider
        boxes = compute_slide_grid((h, w), (ch, cw), (ch // d, cw // d))
        crop_seg = self.decode_head.seg(self.features(
            extract_crops(img, boxes, (ch, cw))))
        hr_seg = accumulate_crops(
            crop_seg, [(y // self.os, x // self.os) for (y, x) in boxes],
            (h // self.os, w // self.os))
        up_lr = self._resize((1.0 - att) * lr_seg, scale_factor=2.0)
        att_up = self._resize(att, scale_factor=2.0)
        fused = att_up * hr_seg.to(att_up.dtype) + up_lr
        return self._resize(fused, size=(h, w))
