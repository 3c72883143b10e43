"""Evaluation CLI of the port.

Port of tools/test.py (the JAX package's), with the same flags but
``--data-parallel``, plus ``--device`` (the card unless asked otherwise)::

    python -m vfmseg_tpu_torch.tools.test <config> [checkpoint.trainable.npz]
        [--backbone converted.npz] [--max-images N] [--tta]
        [--show-dir DIR] [--out metrics.json] [--cfg-options k.path=value ...]
        [--device cuda|cpu]

``config`` names a ported config (``vfmseg_tpu_torch/models/presets.py``:
the DG configs and ``smoke_tiny_ms_masked``). The weights start at zero, as
the JAX CLI's do; then the trainable partition (``t/<flax path>``, as either
package's ``CheckpointManager`` saves it) and the converted backbone (flax
paths below ``backbone/``) are loaded through ``state_dict_from_flax``. The
JAX CLI never reads the BatchNorm statistics that training saves beside the
trainable file (``iter_N.batch_stats.npz``), so it evaluates with zero
running statistics; this CLI loads that file when it is there.

Each test set of ``data.test`` (else ``data.val``) goes through its own
``TestPipeline`` (``test_resize_wh``, ``keep_ratio``), and
:func:`evaluate_dataset`: the compact gate's stream when
``test_cfg.gate == "compact"`` (no TTA), else the per-image predictor. The
per-class IoU tables and the metrics JSON are printed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import deque
from typing import Callable, Optional

import torch

from vfmseg_tpu_torch.data.datasets import build_dataset
from vfmseg_tpu_torch.data.transforms import TestPipeline
from vfmseg_tpu_torch.eval.evaluator import (
    _is_compact,
    make_shape_aware_predict_fn,
    stream_evaluate,
)
from vfmseg_tpu_torch.eval.metrics import CITYSCAPES_CLASSES, IoUAccumulator
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.models.presets import (
    apply_cfg_options,
    config,
    get_path,
)
from vfmseg_tpu_torch.train.checkpoint import load_npz_tree
from vfmseg_tpu_torch.weights import state_dict_from_flax


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a vfmseg_tpu_torch segmentor")
    p.add_argument("config", help="name of a ported config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="trainable-partition checkpoint (.npz)")
    p.add_argument("--backbone", default=None,
                   help="converted backbone weights (.npz)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--tta", action="store_true",
                   help="flip (+multi-scale) test-time augmentation")
    p.add_argument("--show-dir", default=None,
                   help="save colourised prediction PNGs here")
    p.add_argument("--out", default=None, help="write metrics JSON here")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default: the card)")
    return p.parse_args(argv)


def _load(model: torch.nn.Module, variables: dict, what: str) -> None:
    unexpected = model.load_state_dict(state_dict_from_flax(variables),
                                       strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"{what} holds entries the model does not have: "
                         f"{sorted(unexpected)[:5]}")


@torch.no_grad()
def load_weights(model: torch.nn.Module, checkpoint: Optional[str],
                 backbone: Optional[str]) -> torch.nn.Module:
    """Zero every parameter and buffer, then load the trainable checkpoint
    (with the BatchNorm statistics saved beside it, if any) and the
    converted backbone over it, as the JAX CLI merges them."""
    for t in model.state_dict().values():
        t.zero_()
    if checkpoint:
        _load(model, {"params": load_npz_tree(checkpoint, "t")}, checkpoint)
        stats = checkpoint.replace(".trainable.npz", ".batch_stats.npz")
        if stats != checkpoint and os.path.exists(stats):
            _load(model, {"batch_stats": load_npz_tree(stats, "b")}, stats)
    if backbone:
        _load(model, {"params": {"backbone": load_npz_tree(backbone)}},
              backbone)
    return model


def _out_hw(proc: dict):
    """mIoU at the label's resolution; without a label, predict at the
    processed image's size."""
    if proc.get("label") is not None:
        return tuple(proc["label"].shape[:2])
    return tuple(proc["img"].shape[:2])


def evaluate_dataset(model, test_cfg: dict, dataset, pipeline, acc,
                     key: str, *, max_images: Optional[int] = None,
                     tta: bool = False, pad_multiple: Optional[int] = None,
                     on_pred: Optional[Callable] = None) -> int:
    """Evaluate up to ``max_images`` items of ``dataset`` into ``acc`` under
    ``key``. ``dataset``: anything with ``__len__`` and ``__getitem__``
    returning ``img`` (uint8 HWC), optionally ``label`` and ``img_path``;
    ``pipeline(img, label)`` preprocesses it. ``on_pred(pred, item, i)``
    sees each prediction. Returns the number of images."""
    n = min(max_images or len(dataset), len(dataset))
    device = next(model.parameters()).device
    if _is_compact(test_cfg, tta):
        meta = deque()

        def items():
            for i in range(n):
                raw = dataset[i]
                proc = pipeline(raw["img"], raw.get("label"))
                meta.append((raw, proc.get("label"), i))
                yield torch.from_numpy(proc["img"]), _out_hw(proc)

        preds = stream_evaluate(model, test_cfg, items(),
                                group=test_cfg.get("stream_group", 8),
                                pad_multiple=pad_multiple)
        for pred in preds:
            raw, label, i = meta.popleft()
            acc.update(pred, label, key)
            if on_pred:
                on_pred(pred, raw, i)
        return n
    predict = make_shape_aware_predict_fn(model, test_cfg, tta=tta,
                                          pad_multiple=pad_multiple)
    for i in range(n):
        raw = dataset[i]
        proc = pipeline(raw["img"], raw.get("label"))
        img = torch.from_numpy(proc["img"])[None].to(device)
        pred = predict(model, img, _out_hw(proc))[0]
        acc.update(pred, proc.get("label"), key)
        if on_pred:
            on_pred(pred, raw, i)
    return n


def _saver(show_dir: Optional[str], key: str):
    if not show_dir:
        return None

    def save(pred, raw, i):
        from PIL import Image

        from vfmseg_tpu_torch.utils.visualization import colorize_label

        os.makedirs(os.path.join(show_dir, key), exist_ok=True)
        name = os.path.basename(raw.get("img_path", f"{i}.png"))
        Image.fromarray(colorize_label(pred.cpu().numpy())).save(
            os.path.join(show_dir, key, name))

    return save


def main(argv=None) -> dict:
    args = parse_args(argv)
    name = os.path.splitext(os.path.basename(args.config))[0]
    cfg = apply_cfg_options(config(name), args.cfg_options)
    model = build_segmentor(cfg["model"], dtype=compute_dtype(cfg),
                            device=args.device,
                            attn_impl=compute_attn_impl(cfg))
    load_weights(model, args.checkpoint, args.backbone)

    test_sets = get_path(cfg, "data.test") or get_path(cfg, "data.val") or []
    keys = [d.get("key", f"set{i}") for i, d in enumerate(test_sets)]
    num_classes = cfg.get("num_classes", 19)
    # mean_used_keys = every key, as the JAX CLI has it (tools/test.py:91)
    acc = IoUAccumulator(
        num_classes=num_classes, dataset_keys=keys, mean_used_keys=keys,
        class_names=CITYSCAPES_CLASSES if num_classes == 19 else None)
    wh_default = tuple(get_path(cfg, "data.test_resize_wh", (2048, 1024)))
    kr_default = bool(get_path(cfg, "data.test_keep_ratio", True))
    test_cfg = cfg.get("test_cfg", {})
    pad_mult = get_path(cfg, "data.eval_pad_multiple")
    for dset_cfg, key in zip(test_sets, keys):
        wh = tuple(dset_cfg.get("test_resize_wh", wh_default))
        pipeline = TestPipeline(
            resize_scale_wh=wh,
            keep_ratio=bool(dset_cfg.get("keep_ratio", kr_default)))
        dataset = build_dataset({k: v for k, v in dset_cfg.items()
                                 if k not in ("key", "test_resize_wh",
                                              "keep_ratio")})
        print(f"evaluating {key}: {len(dataset)} images "
              f"(resize_wh={wh}, keep_ratio={pipeline.keep_ratio})")
        evaluate_dataset(model, test_cfg, dataset, pipeline, acc, key,
                         max_images=args.max_images, tta=args.tta,
                         pad_multiple=pad_mult,
                         on_pred=_saver(args.show_dir, key))

    results = acc.compute()
    for key in list(acc._acc):
        print(f"--- {key} per-class IoU ---")
        for cls, iou in acc.per_class_iou(key).items():
            print(f"  {cls:>15s}: {iou}")
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
