"""Inference entry points: logits functions, predictors, the gated stream and
the dataset evaluation loop.

Port of vfmseg_tpu/eval/evaluator.py:31-373 without the multi-card ``mesh``.
As in the JAX package, the functions built here take the weights at call
time: there the flax ``variables``, here the segmentor module that holds
them, so one predictor serves any copy of the model (CPU fp32 or CUDA bf16).

* ``unwrap_model`` gives DomainGeneral's inner segmentor, through which
  every function below predicts.
* ``make_logits_fn`` gives ``(model, img) -> input-sized logits`` for the
  MsVFM modes: ``ms_slide_inference`` (the dense gated two-stage slide),
  ``lr_slide_inference``, ``hr_slide_inference`` and
  ``msfull_slide_inference``; and for every other segmentor with an
  ``encode_decode`` (``EncoderDecoder``, Mask2Former's
  ``MaskFormerSegmentor``, ``HRDAEncoderDecoder``) ``whole`` and ``slide``
  (also taken for ``lr_``/``hr_slide_inference``, as in the JAX package),
  which call it. ``MsVFMSegmentor`` and ``MultiScaleEncoderDecoder`` have no
  ``encode_decode`` in either package, so ``whole`` and ``slide`` raise
  ``NotImplementedError`` for them.
* ``make_shape_aware_predict_fn`` gives ``predict(model, img, out_hw)``:
  labels at the label resolution, with optional flip/multi-scale TTA and
  shape bucketing (``pad_multiple``). With ``test_cfg.gate == "compact"``
  (and no TTA) it runs the compact gated engine (``compact.py``), which
  refines only the windows the gate sends on.
* ``stream_evaluate`` runs the compact engine's grouped, pipelined stream
  over a sequence of images, each with its own label resolution.
* ``make_predict_fn`` and the named constructors fix ``out_hw`` at build
  time; ``evaluate`` loops a predictor over a dataset into an
  ``IoUAccumulator``.

Typical use, as ``vfmseg_tpu_torch.tools.test`` does per image::

    model = build_segmentor(cfg["model"], dtype=compute_dtype(cfg),
                            attn_impl=compute_attn_impl(cfg))
    predict = make_shape_aware_predict_fn(model, cfg["test_cfg"])
    labels = predict(model, img, out_hw)      # img: NHWC, preprocessed
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.eval.compact import CompactMsSlide
from vfmseg_tpu_torch.eval.metrics import IoUAccumulator
from vfmseg_tpu_torch.eval.slide import (
    accumulate_crops,
    compute_slide_grid,
    extract_crops,
    ms_slide_inference,
    slide_inference,
)
from vfmseg_tpu_torch.eval.tta import tta_logits
from vfmseg_tpu_torch.models.algorithms.dg import DomainGeneral
from vfmseg_tpu_torch.models.segmentors.ms_vfm import MsVFMSegmentor
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.utils.profiling import span

MSVFM_MODES = ("ms_slide_inference", "lr_slide_inference",
               "hr_slide_inference", "msfull_slide_inference")


def unwrap_model(model):
    """The segmentor that predicts: DomainGeneral's inner model (reference
    Wrapper.py:24-45), any other model itself. The functions built here
    unwrap the model they are given at call time too."""
    return model.model if isinstance(model, DomainGeneral) else model


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_logits_fn(model, test_cfg: Dict, mode: str) -> Callable:
    """(model, img) -> logits at the input resolution for ``mode``
    (reference inference modes, Ms_VFM_encoder_decoder.py:278-332)."""
    model = unwrap_model(model)
    test_cfg = test_cfg or {}
    crop = tuple(test_cfg.get("crop_size", (512, 512)))
    if not isinstance(model, MsVFMSegmentor):
        if not hasattr(model, "encode_decode") or mode not in (
                "whole", "slide", "lr_slide_inference", "hr_slide_inference"):
            raise NotImplementedError(
                f"mode {mode!r} on {type(model).__name__} is not ported")
        if mode == "whole":
            return lambda m, img: unwrap_model(m).encode_decode(img)
        slide_stride = tuple(test_cfg.get("stride", (341, 341)))
        return lambda m, img: slide_inference(unwrap_model(m).encode_decode,
                                              img, crop, slide_stride)
    if mode not in MSVFM_MODES:
        raise NotImplementedError(
            f"mode {mode!r} on {type(model).__name__} is not ported")
    stride = tuple(test_cfg.get("stride", (320, 320)))
    lr_size = tuple(test_cfg.get("lr_img_size", (512, 1024)))

    def logits_fn(m: MsVFMSegmentor, img: torch.Tensor) -> torch.Tensor:
        m = unwrap_model(m)
        if mode == "ms_slide_inference":
            return ms_slide_inference(
                m.lr_forward, m.hr_forward, img, crop=crop, stride=stride,
                lr_size=lr_size, threshold=test_cfg.get("threshold", 0.968),
                conf=test_cfg.get("conf", 0.8))
        if mode == "lr_slide_inference":
            small = resize(img, scale_factor=0.5, method="bilinear")
            logits = slide_inference(m.lr_forward, small, crop, stride)
            return resize(logits, scale_factor=2.0, method="bilinear")
        if mode == "hr_slide_inference":
            return slide_inference(m.lr_forward, img, crop, stride)
        # msfull_slide_inference: stage 1 through the slide, then every
        # window refined against it
        small = resize(img, size=lr_size, method="bilinear")
        stage1 = slide_inference(m.lr_forward, small, crop, stride)
        full = resize(stage1, size=img.shape[1:3], method="bilinear")
        boxes = compute_slide_grid(tuple(img.shape[1:3]), crop, stride)
        refined = m.hr_forward(extract_crops(img, boxes, crop),
                               extract_crops(full, boxes, crop))
        return accumulate_crops(refined, boxes, tuple(img.shape[1:3]))

    return logits_fn


def _finish(logits: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    logits = resize(logits, size=out_hw, method="bilinear")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _pad_to_min(img: torch.Tensor, min_hw: Tuple[int, int],
                multiple: Optional[int] = None):
    """Bottom-right zero-pad NHWC images smaller than ``min_hw`` (the mean
    colour after normalisation); with ``multiple``, H and W also round up to
    it (shape bucketing: mixed keep-ratio sizes share a few shapes).
    Returns (padded, valid_hw)."""
    h, w = int(img.shape[1]), int(img.shape[2])
    th, tw = max(min_hw[0], h), max(min_hw[1], w)
    if multiple:
        th = -(-th // multiple) * multiple
        tw = -(-tw // multiple) * multiple
    if th > h or tw > w:
        img = F.pad(img, (0, 0, 0, tw - w, 0, th - h))
    return img, (h, w)


def _is_compact(test_cfg: Dict, tta: bool) -> bool:
    return (test_cfg.get("mode") == "ms_slide_inference"
            and test_cfg.get("gate") == "compact" and not tta)


def make_compact_ms_slide(model, test_cfg: Dict, **kwargs) -> CompactMsSlide:
    """The compact gated engine for ``model`` and ``test_cfg``; ``kwargs``
    go to ``CompactMsSlide`` (``buckets``, ``forced_bucket``)."""
    test_cfg = test_cfg or {}
    return CompactMsSlide(
        lambda m, x: unwrap_model(m).lr_forward(x),
        lambda m, c, t: unwrap_model(m).hr_forward(c, t),
        crop=tuple(test_cfg.get("crop_size", (512, 512))),
        stride=tuple(test_cfg.get("stride", (320, 320))),
        lr_size=tuple(test_cfg.get("lr_img_size", (512, 1024))),
        threshold=test_cfg.get("threshold", 0.968),
        conf=test_cfg.get("conf", 0.8), **kwargs)


def stream_evaluate(model, test_cfg: Dict, images: Iterable,
                    out_hw: Optional[Tuple[int, int]] = None, group: int = 8,
                    depth: int = 2, pad_multiple: Optional[int] = None,
                    engine: Optional[CompactMsSlide] = None
                    ) -> Iterator[torch.Tensor]:
    """Throughput evaluation: yield per-image [out_h, out_w] int32 labels for
    a stream of preprocessed [H, W, 3] images through the compact engine's
    ``stream``.

    Each item of ``images`` is an image, predicted at ``out_hw``, or an
    ``(image, out_hw)`` pair. The stream flushes a group when the image size
    changes, so per-dataset keep-ratio geometry works; ``pad_multiple``
    buckets the sizes (``_pad_to_min``). Each image's (valid size, label
    size) travels in this function's own queue, which the engine's output
    order pops, whenever the caller consumes. ``engine``: an engine from
    ``make_compact_ms_slide`` to run, whose counters the caller reads."""
    test_cfg = test_cfg or {}
    engine = engine or make_compact_ms_slide(model, test_cfg)
    min_hw = tuple(test_cfg.get("crop_size", (512, 512)))
    device = _model_device(model)
    geometry = deque()

    def padded():
        for item in images:
            img, hw = item if isinstance(item, tuple) else (item, out_hw)
            p, valid_hw = _pad_to_min(img[None].to(device), min_hw,
                                      multiple=pad_multiple)
            geometry.append((valid_hw, tuple(hw)))
            yield p[0]

    for logits in engine.stream(model, padded(), group=group, depth=depth):
        (vh, vw), hw = geometry.popleft()
        with torch.inference_mode():
            pred = _finish(logits[None, :vh, :vw], hw)[0]
        yield pred


def make_shape_aware_predict_fn(model, test_cfg: Dict, tta: bool = False,
                                pad_multiple: Optional[int] = None):
    """predict(model, img, out_hw) -> [B, out_h, out_w] int32 labels.

    ``img`` is a preprocessed NHWC float batch; it is padded up to one slide
    crop if smaller (and to ``pad_multiple``), the logits are cropped back
    to the valid region, resized bilinearly to ``out_hw`` and argmaxed.
    ``tta`` averages the softmax over flips and ``test_cfg.tta_scales``.
    Each call is the profiler range ``vfmseg.predict``."""
    test_cfg = test_cfg or {}
    mode = test_cfg.get("mode", "whole")
    min_hw = (tuple(test_cfg.get("crop_size", (512, 512)))
              if "slide" in mode else (1, 1))

    if _is_compact(test_cfg, tta):
        compact = make_compact_ms_slide(model, test_cfg)

        def logits_fn(m, img):
            return compact(m, img)[0]
    else:
        logits_fn = make_logits_fn(model, test_cfg, mode)
        if tta:
            inner = logits_fn
            scales = tuple(test_cfg.get("tta_scales", (1.0,)))

            def logits_fn(m, img):  # noqa: F811 (the TTA wrapper)
                return tta_logits(lambda view: inner(m, view), img,
                                  flip=True, scales=scales)

    @torch.inference_mode()
    def predict(m, img: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
        with span("vfmseg.predict"):
            img, (vh, vw) = _pad_to_min(img, min_hw, multiple=pad_multiple)
            return _finish(logits_fn(m, img)[:, :vh, :vw], tuple(out_hw))

    return predict


def make_predict_fn(model, test_cfg: Dict, out_hw: Tuple[int, int],
                    tta: bool = False):
    """predict(model, img) -> [B, out_h, out_w] int32 labels for a fixed
    label resolution ``out_hw`` (mmseg's postprocess resize)."""
    predict = make_shape_aware_predict_fn(model, test_cfg, tta=tta)
    return lambda m, img: predict(m, img, out_hw)


def make_ms_predict_fn(model, test_cfg: Dict, out_hw: Tuple[int, int]):
    return make_predict_fn(model, dict(test_cfg or {},
                                       mode="ms_slide_inference"), out_hw)


def make_whole_predict_fn(model, out_hw: Tuple[int, int]):
    return make_predict_fn(model, {"mode": "whole"}, out_hw)


def make_slide_predict_fn(model, test_cfg: Dict, out_hw: Tuple[int, int]):
    return make_predict_fn(model, dict(test_cfg or {}, mode="slide"), out_hw)


def evaluate(predict_fn, model, dataset, *, num_classes: int = 19,
             dataset_key: str = "default",
             accumulator: Optional[IoUAccumulator] = None, pipeline=None,
             max_images: Optional[int] = None, progress_every: int = 50,
             log=print) -> IoUAccumulator:
    """Run ``predict_fn(model, img)`` over ``dataset`` (items with ``img``,
    ``label`` and optionally ``seg_map_path``, which picks the key; with a
    ``pipeline``, its output ``{img, label}`` replaces the item and
    ``dataset_key`` is the key) into an accumulator."""
    acc = accumulator or IoUAccumulator(num_classes=num_classes,
                                        dataset_keys=[dataset_key])
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    device = _model_device(model)
    for i in range(n):
        raw = dataset[i]
        if pipeline is not None:
            raw = pipeline(raw["img"], raw.get("label"))
        img = torch.as_tensor(raw["img"])[None].to(device)
        pred = predict_fn(model, img)[0]
        acc.update(pred, raw["label"], raw.get("seg_map_path", dataset_key))
        if progress_every and (i + 1) % progress_every == 0:
            log(f"eval {i + 1}/{n}")
    return acc
