"""Test-time augmentation: horizontal-flip and multi-scale softmax averaging.

Port of vfmseg_tpu/eval/tta.py:20-55: wraps any logits-level function and
averages its softmax probabilities over {scales} x {identity, h-flip}, each
resized back to the input size.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from vfmseg_tpu_torch.ops.resize import resize


def tta_logits(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    img: torch.Tensor,
    *,
    flip: bool = True,
    scales: Sequence[float] = (1.0,),
    align_corners: bool = False,
) -> torch.Tensor:
    """img [B, H, W, 3]; ``logits_fn`` maps a view to input-sized logits.
    Returns fp32 probabilities [B, H, W, C] at the input size."""
    h, w = img.shape[1], img.shape[2]
    acc = None
    count = 0
    for s in scales:
        scaled = img if s == 1.0 else resize(
            img, size=(int(h * s), int(w * s)), method="bilinear",
            align_corners=align_corners)
        views = [scaled, scaled.flip(2)] if flip else [scaled]
        for i, view in enumerate(views):
            probs = torch.softmax(logits_fn(view).float(), dim=-1)
            if i == 1:
                probs = probs.flip(2)
            if tuple(probs.shape[1:3]) != (h, w):
                probs = resize(probs, size=(h, w), method="bilinear",
                               align_corners=align_corners)
            acc = probs if acc is None else acc + probs
            count += 1
    return acc / count
