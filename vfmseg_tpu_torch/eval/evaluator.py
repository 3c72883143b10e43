"""Inference entry points: logits functions and the per-image predictor.

Port of vfmseg_tpu/eval/evaluator.py:50-90, 134-136 and 197-280 for the
headline's dense gated mode (``ms_slide_inference``). As in the JAX package,
the functions built here take the weights at call time: there the flax
``variables``, here the segmentor module that holds them, so one predictor
serves any copy of the model (CPU fp32 or CUDA bf16). The compact gated
engine (``test_cfg.gate == "compact"``), the other modes, TTA and shape
bucketing (``pad_multiple``) wait for later slices; the first two raise
``NotImplementedError``.

Typical use, as tools/test.py does per image::

    model = build_segmentor(cfg["model"], dtype=compute_dtype(cfg))
    predict = make_shape_aware_predict_fn(model, cfg["test_cfg"])
    labels = predict(model, img, out_hw)      # img: NHWC, preprocessed
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.eval.slide import ms_slide_inference
from vfmseg_tpu_torch.models.segmentors.ms_vfm import MsVFMSegmentor
from vfmseg_tpu_torch.ops.resize import resize


def make_logits_fn(model, test_cfg: Dict, mode: str) -> Callable:
    """(model, img) -> logits at the input resolution for ``mode``."""
    if mode != "ms_slide_inference" or not isinstance(model, MsVFMSegmentor):
        raise NotImplementedError(
            f"mode {mode!r} on {type(model).__name__} is not ported")
    test_cfg = test_cfg or {}

    def logits_fn(m: MsVFMSegmentor, img: torch.Tensor) -> torch.Tensor:
        return ms_slide_inference(
            m.lr_forward, m.hr_forward, img,
            crop=tuple(test_cfg.get("crop_size", (512, 512))),
            stride=tuple(test_cfg.get("stride", (320, 320))),
            lr_size=tuple(test_cfg.get("lr_img_size", (512, 1024))),
            threshold=test_cfg.get("threshold", 0.968),
            conf=test_cfg.get("conf", 0.8))

    return logits_fn


def _finish(logits: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    logits = resize(logits, size=out_hw, method="bilinear")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _pad_to_min(img: torch.Tensor, min_hw: Tuple[int, int]):
    """Bottom-right zero-pad NHWC images smaller than ``min_hw`` (the mean
    colour after normalisation). Returns (padded, valid_hw)."""
    h, w = int(img.shape[1]), int(img.shape[2])
    th, tw = max(min_hw[0], h), max(min_hw[1], w)
    if th > h or tw > w:
        img = F.pad(img, (0, 0, 0, tw - w, 0, th - h))
    return img, (h, w)


def make_shape_aware_predict_fn(model, test_cfg: Dict):
    """predict(model, img, out_hw) -> [B, out_h, out_w] int32 labels.

    ``img`` is a preprocessed NHWC float batch; it is padded up to one slide
    crop if smaller, the logits are cropped back to the valid region, resized
    bilinearly to ``out_hw`` and argmaxed."""
    test_cfg = test_cfg or {}
    mode = test_cfg.get("mode", "whole")
    if test_cfg.get("gate") == "compact":
        raise NotImplementedError("the compact gate is not ported")
    logits_fn = make_logits_fn(model, test_cfg, mode)
    min_hw = tuple(test_cfg.get("crop_size", (512, 512)))

    @torch.inference_mode()
    def predict(m: MsVFMSegmentor, img: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
        img, valid_hw = _pad_to_min(img, min_hw)
        logits = logits_fn(m, img)[:, :valid_hw[0], :valid_hw[1]]
        return _finish(logits, tuple(out_hw))

    return predict
