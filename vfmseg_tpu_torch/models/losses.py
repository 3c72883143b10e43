"""Segmentation loss and accuracy with mmseg semantics.

Port of vfmseg_tpu/models/losses.py:19-61. Cross-entropy zeroes ignored
pixels, weights each pixel's term by ``pixel_weight`` where one is given
(DACS's pseudo-label confidence) and, with the reference's default
``avg_non_ignore=False``, divides by *all* pixels, so ignored pixels count in
the denominator (which ``F.cross_entropy``'s mean would not do), so each
rank's loss over equal local batches averages to the global batch's.
Accuracy is top-1 over the pixels that are not ignored, in percent. Logits
are NHWC and taken in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.parallel import mesh


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       pixel_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """logits [B, H, W, C], labels [B, H, W] int, optional pixel_weight
    [B, H, W] -> scalar fp32."""
    nll = F.cross_entropy(logits.float().permute(0, 3, 1, 2), labels.long(),
                          ignore_index=ignore_index, reduction="none")
    if pixel_weight is not None:
        nll = nll * pixel_weight.float()
    return nll.sum() / labels.numel()


@torch.no_grad()
def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    """Top-1 pixel accuracy (%) over non-ignored pixels; under data
    parallelism over the global batch's (the counts summed over the
    group)."""
    valid = labels != ignore_index
    correct = ((logits.argmax(dim=-1) == labels) & valid).sum()
    if mesh.world_size() > 1:
        correct, total = mesh.all_reduce_sum(
            torch.stack([correct, valid.sum()])).unbind()
        return 100.0 * correct.float() / total.clamp(min=1).float()
    return 100.0 * correct.float() / valid.sum().clamp(min=1).float()
