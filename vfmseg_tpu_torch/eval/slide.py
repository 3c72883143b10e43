"""Batched sliding-window inference with the confidence gate.

Port of vfmseg_tpu/eval/slide.py:28-233. All crops of an image go through
the model as one batch; the overlap average sums crops in ascending window
order and then multiplies by the inverse coverage, as the JAX package does.
The gate is compute-all + select: every window is refined, and per window
the gate picks the refined logits or the stage-1 context. NHWC throughout.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from vfmseg_tpu_torch.ops.resize import resize


def compute_slide_grid(img_hw: Tuple[int, int], crop: Tuple[int, int],
                       stride: Tuple[int, int]) -> List[Tuple[int, int]]:
    """(y1, x1) crop origins of the mmseg slide grid, row-major."""
    h, w = img_hw
    ch, cw = crop
    sh, sw = stride
    h_grids = max(h - ch + sh - 1, 0) // sh + 1
    w_grids = max(w - cw + sw - 1, 0) // sw + 1
    boxes = []
    for hi in range(h_grids):
        for wi in range(w_grids):
            y2 = min(hi * sh + ch, h)
            x2 = min(wi * sw + cw, w)
            boxes.append((max(y2 - ch, 0), max(x2 - cw, 0)))
    return boxes


def extract_crops(x: torch.Tensor, boxes: Sequence[Tuple[int, int]],
                  crop: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [G*B, ch, cw, C], window-major."""
    ch, cw = crop
    return torch.cat([x[:, y1:y1 + ch, x1:x1 + cw] for (y1, x1) in boxes],
                     dim=0)


def accumulate_crops(crop_logits: torch.Tensor,
                     boxes: Sequence[Tuple[int, int]],
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Overlap-average [G*B, ch, cw, C] crop logits into fp32 [B, H, W, C]:
    sum in ascending window order, then times the inverse coverage
    (uncovered pixels stay 0)."""
    g = len(boxes)
    b = crop_logits.shape[0] // g
    ch, cw, c = crop_logits.shape[1:]
    dev = crop_logits.device
    preds = torch.zeros((b, out_hw[0], out_hw[1], c), dtype=torch.float32,
                        device=dev)
    count = torch.zeros((out_hw[0], out_hw[1], 1), dtype=torch.float32,
                        device=dev)
    for i, (y1, x1) in enumerate(boxes):
        preds[:, y1:y1 + ch, x1:x1 + cw] += crop_logits[i * b:(i + 1) * b].float()
        count[y1:y1 + ch, x1:x1 + cw] += 1.0
    inv = torch.where(count > 0, 1.0 / count.clamp(min=1.0),
                      torch.zeros_like(count))
    return preds * inv


def confident_mask(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """0/1 fp32 mask of pixels whose max softmax prob exceeds ``threshold``,
    as ``sum_j exp(x_j - x_max) < 1 / threshold`` (the JAX package's formula,
    so gate decisions match)."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    s = torch.exp(x - m).sum(dim=-1)
    return (s < 1.0 / threshold).float()


def ms_slide_inference(
    lr_logits_fn: Callable[[torch.Tensor], torch.Tensor],
    hr_logits_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    img: torch.Tensor,
    *,
    crop: Tuple[int, int] = (512, 512),
    stride: Tuple[int, int] = (320, 320),
    lr_size: Tuple[int, int] = (512, 1024),
    threshold: float = 0.968,
    conf: float = 0.8,
    align_corners: bool = False,
) -> torch.Tensor:
    """Two-stage coarse-to-fine inference (reference ms_inference).

    Stage 1: a whole-image pass at ``lr_size``, upsampled to full size.
    Stage 2: ``crop`` windows at ``stride``; a window whose fraction of
    pixels with max softmax above ``threshold`` is >= ``conf`` keeps the
    stage-1 context, the others take the refined logits. All windows are
    refined in one batched call."""
    h, w = img.shape[1], img.shape[2]
    lr_img = resize(img, size=lr_size, method="bilinear",
                    align_corners=align_corners)
    full_logits = resize(lr_logits_fn(lr_img), size=(h, w), method="bilinear",
                         align_corners=align_corners)

    boxes = compute_slide_grid((h, w), crop, stride)
    img_crops = extract_crops(img, boxes, crop)            # [G*B, ch, cw, 3]
    ctx_crops = extract_crops(full_logits, boxes, crop)    # [G*B, ch, cw, C]
    confidence = confident_mask(ctx_crops, threshold).mean(dim=(1, 2))
    needs_refine = confidence < conf

    refined = hr_logits_fn(img_crops, ctx_crops)
    sel = torch.where(needs_refine[:, None, None, None], refined, ctx_crops)
    return accumulate_crops(sel, boxes, (h, w))
