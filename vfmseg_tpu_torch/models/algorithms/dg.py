"""DomainGeneral: the supervised source loss plus the optional
masked-image consistency branch.

Port of vfmseg_tpu/models/algorithms/dg.py:28-80 (reference
rein/models/dg/DG.py:33-56). The wrapped segmentor is ``self.model``, so
parameter names read ``model.<...>``, the flax ``model/`` scope.

* Training, ``forward(img, labels)``: the inner model's loss dict; with
  ``enable_mask_loss``, the batch is strong-transformed (jitter s 0.25 p
  0.2, blur with ``blur``), block-masked (``mask_ratio``,
  ``mask_block_size``) and run through the inner model again on the same
  labels. Every ``loss`` entry of that second call is scaled by
  ``acc / 100 * lamda_mask`` (acc: the first call's first ``acc_seg``,
  detached; 1 without one) and the entries are prefixed ``mask.``. The
  second call draws the next numbers of the ``crop``, ``mask`` and
  ``dropout`` streams, as flax's second ``make_rng`` gives new keys; the
  augmentation draws from ``augment``.
* Inference delegates ``forward(img)``, ``encode_decode``, ``lr_forward``
  and ``hr_forward`` to the inner model (reference Wrapper.py:24-45);
  ``eval/evaluator.unwrap_model`` gives the inner model itself.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vfmseg_tpu_torch.models.algorithms.augment import (
    block_mask,
    strong_transform,
)
from vfmseg_tpu_torch.models.presets import IMAGENET_MEAN, IMAGENET_STD
from vfmseg_tpu_torch.utils.misc import add_prefix


class DomainGeneral(nn.Module):
    """Wraps any segmentor whose ``forward(img, labels)`` returns a loss
    dict."""

    def __init__(self, model: nn.Module, enable_mask_loss: bool = False,
                 color_jitter_strength: float = 0.25,
                 color_jitter_probability: float = 0.2, blur: bool = True,
                 mask_ratio: float = 0.7, mask_block_size: int = 64,
                 lamda_mask: float = 0.5):
        super().__init__()
        self.model = model
        self.enable_mask_loss = enable_mask_loss
        self.color_jitter_strength = color_jitter_strength
        self.color_jitter_probability = color_jitter_probability
        self.blur = blur
        self.mask_ratio = mask_ratio
        self.mask_block_size = mask_block_size
        self.lamda_mask = lamda_mask

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        """The inner model's ``forward(img)``; with ``labels``, the training
        loss dict (needs ``rng.streams`` with ``augment`` when the mask
        branch is on)."""
        if labels is None:
            return self.model(img)
        losses: Dict[str, torch.Tensor] = dict(self.model(img, labels))
        if not self.enable_mask_loss:
            return losses
        mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
        std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
        aug = strong_transform(
            img, mean, std, self.color_jitter_strength,
            self.color_jitter_probability,
            blur_prob=1.0 if self.blur else 0.0)
        masked = block_mask(aug, self.mask_ratio, self.mask_block_size)
        mask_losses = self.model(masked, labels)
        acc_keys = [k for k in losses if "acc_seg" in k]
        acc = (losses[acc_keys[0]].detach() / 100.0 if acc_keys else 1.0)
        scale = acc * self.lamda_mask
        losses.update(add_prefix(
            {k: (v * scale if "loss" in k else v)
             for k, v in mask_losses.items()}, "mask"))
        return losses

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        return self.model.encode_decode(img)

    def lr_forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model.lr_forward(img)

    def hr_forward(self, img: torch.Tensor,
                   context_logits: torch.Tensor) -> torch.Tensor:
        return self.model.hr_forward(img, context_logits)
