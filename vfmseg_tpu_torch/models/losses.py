"""Segmentation loss and accuracy with mmseg semantics.

Port of vfmseg_tpu/models/losses.py:19-61. Cross-entropy zeroes ignored
pixels and, with the reference's default ``avg_non_ignore=False``, divides by
*all* pixels, so ignored pixels count in the denominator (which
``F.cross_entropy``'s mean would not do). Accuracy is top-1 over the pixels
that are not ignored, in percent. Logits are NHWC and taken in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255) -> torch.Tensor:
    """logits [B, H, W, C], labels [B, H, W] int -> scalar fp32."""
    nll_sum = F.cross_entropy(logits.float().permute(0, 3, 1, 2),
                              labels.long(), ignore_index=ignore_index,
                              reduction="sum")
    return nll_sum / labels.numel()


@torch.no_grad()
def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    """Top-1 pixel accuracy (%) over non-ignored pixels."""
    valid = labels != ignore_index
    correct = ((logits.argmax(dim=-1) == labels) & valid).sum()
    return 100.0 * correct.float() / valid.sum().clamp(min=1).float()
