"""Evaluation CLI of the port.

Port of tools/test.py (the JAX package's), with the same flags, plus
``--device`` (the card unless asked otherwise)::

    python -m vfmseg_tpu_torch.tools.test <config> [checkpoint.trainable.npz]
        [--backbone converted.npz] [--max-images N] [--tta]
        [--show-dir DIR] [--out metrics.json] [--cfg-options k.path=value ...]
        [--data-parallel N] [--device cuda|cpu]

``--data-parallel N`` evaluates over N processes launched by torchrun
(``torchrun --nproc-per-node N -m vfmseg_tpu_torch.tools.test ...
--data-parallel N``; NCCL on the cards, gloo with ``--device cpu``); N must
equal the world size, and 1 needs no launcher. The JAX CLI shards one
image's crop batch over the devices of one process; PyTorch has no
single-process SPMD, so here the images are sharded: rank r evaluates
images i = r (mod N), the IoU areas and the compact gate's window counts
are summed over the ranks, each rank writes the ``--show-dir`` PNGs it
predicted, and rank 0 prints and writes ``--out``. The compact engine stays
whole on each rank, so it pads no windows to a shard size: its counts equal
the JAX engine's unsharded ones (the JAX mesh mode counts shard-pad windows
in its forced-bucket stats, vfmseg_tpu/eval/compact.py:481).

``config`` is a config file's bare name under ``configs/`` or its path,
read by the port's loader (``core/config.py``). The weights start at zero, as
the JAX CLI's do; then the trainable partition (``t/<flax path>``, as either
package's ``CheckpointManager`` saves it) and the converted backbone (flax
paths below ``backbone/``) are loaded through ``state_dict_from_flax``. The
JAX CLI never reads the BatchNorm statistics that training saves beside the
trainable file (``iter_N.batch_stats.npz``), so it evaluates with zero
running statistics; this CLI loads that file when it is there. A
DomainGeneral config evaluates its inner segmentor (``unwrap_model``), and a
checkpoint saved from the wrapper (paths under ``model/``) loads into it.

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
from vfmseg_tpu_torch.eval.compact import CompactMsSlide
from vfmseg_tpu_torch.eval.evaluator import (
    _is_compact,
    make_compact_ms_slide,
    make_shape_aware_predict_fn,
    stream_evaluate,
    unwrap_model,
)
from vfmseg_tpu_torch.eval.metrics import CITYSCAPES_CLASSES, IoUAccumulator
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.models.presets import config
from vfmseg_tpu_torch.parallel import mesh
from vfmseg_tpu_torch.train.checkpoint import load_npz_tree
from vfmseg_tpu_torch.weights import state_dict_from_flax

LAUNCH = ("torchrun --nproc-per-node N -m vfmseg_tpu_torch.tools.test "
          "<config> <checkpoint> --data-parallel N")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a vfmseg_tpu_torch segmentor")
    p.add_argument("config", help="config name or path")
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
    p.add_argument("--data-parallel", type=int, default=None,
                   help="evaluate over N torchrun processes (images "
                        "sharded over them)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default: the card)")
    return p.parse_args(argv)


def _unwrapped(tree: dict) -> dict:
    """A tree saved from the DomainGeneral wrapper (everything under
    ``model/``) as its inner segmentor's."""
    return tree["model"] if set(tree) == {"model"} else tree


def _load(model: torch.nn.Module, variables: dict, what: str) -> None:
    unexpected = model.load_state_dict(
        state_dict_from_flax(variables, model), strict=False).unexpected_keys
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
        _load(model, {"params": _unwrapped(load_npz_tree(checkpoint, "t"))},
              checkpoint)
        stats = checkpoint.replace(".trainable.npz", ".batch_stats.npz")
        if stats != checkpoint and os.path.exists(stats):
            _load(model, {"batch_stats": _unwrapped(
                load_npz_tree(stats, "b"))}, stats)
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
                     on_pred: Optional[Callable] = None, rank: int = 0,
                     world: int = 1,
                     engine: Optional[CompactMsSlide] = None) -> int:
    """Evaluate up to ``max_images`` items of ``dataset`` into ``acc`` under
    ``key``: of those, the images i = ``rank`` (mod ``world``).
    ``dataset``: anything with ``__len__`` and ``__getitem__`` returning
    ``img`` (uint8 HWC), optionally ``label`` and ``img_path``;
    ``pipeline(img, label)`` preprocesses it. ``on_pred(pred, item, i)``
    sees each prediction. ``engine``: the compact engine to stream through
    (whose counters the caller reads), else one made here. Returns the
    number of images this rank evaluated."""
    n = min(max_images or len(dataset), len(dataset))
    mine = range(rank, n, world)
    device = next(model.parameters()).device
    if _is_compact(test_cfg, tta):
        meta = deque()

        def items():
            for i in mine:
                raw = dataset[i]
                proc = pipeline(raw["img"], raw.get("label"))
                meta.append((raw, proc.get("label"), i))
                yield torch.from_numpy(proc["img"]), _out_hw(proc)

        preds = stream_evaluate(model, test_cfg, items(),
                                group=test_cfg.get("stream_group", 8),
                                pad_multiple=pad_multiple, engine=engine)
        for pred in preds:
            raw, label, i = meta.popleft()
            acc.update(pred, label, key)
            if on_pred:
                on_pred(pred, raw, i)
        return len(mine)
    predict = make_shape_aware_predict_fn(model, test_cfg, tta=tta,
                                          pad_multiple=pad_multiple)
    for i in mine:
        raw = dataset[i]
        proc = pipeline(raw["img"], raw.get("label"))
        img = torch.from_numpy(proc["img"])[None].to(device)
        pred = predict(model, img, _out_hw(proc))[0]
        acc.update(pred, proc.get("label"), key)
        if on_pred:
            on_pred(pred, raw, i)
    return len(mine)


def gate_counts(engine: CompactMsSlide, device: torch.device) -> dict:
    """The compact engine's windows seen and refined, summed over the data
    group."""
    counts = mesh.all_reduce_sum(torch.tensor(
        [engine.stat_windows, engine.stat_refined], device=device))
    return dict(windows=int(counts[0]), refined=int(counts[1]))


def _data_group(data_parallel: Optional[int], device: str) -> mesh.Mesh:
    """The data group ``--data-parallel`` asks for: an initialised process
    group as it is, else torchrun's (N > 1 needs it), else one process."""
    if data_parallel is None:
        return mesh.make_mesh(1, device=device)
    if (not torch.distributed.is_initialized()
            and (data_parallel > 1 or "WORLD_SIZE" in os.environ)):
        mesh.init_distributed(device, launch=LAUNCH)
    return mesh.make_mesh(data_parallel, device=device, launch=LAUNCH)


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
    cfg = config(args.config, args.cfg_options)
    group = _data_group(args.data_parallel, args.device)
    main_rank = group.rank == 0
    model = unwrap_model(build_segmentor(
        cfg["model"], dtype=compute_dtype(cfg), device=group.device,
        attn_impl=compute_attn_impl(cfg)))
    load_weights(model, args.checkpoint, args.backbone)

    test_sets = cfg.get_path("data.test") or cfg.get_path("data.val") or []
    keys = [d.get("key", f"set{i}") for i, d in enumerate(test_sets)]
    num_classes = cfg.get("num_classes", 19)
    # mean_used_keys = every key, as the JAX CLI has it (tools/test.py:91)
    acc = IoUAccumulator(
        num_classes=num_classes, dataset_keys=keys, mean_used_keys=keys,
        class_names=CITYSCAPES_CLASSES if num_classes == 19 else None)
    wh_default = tuple(cfg.get_path("data.test_resize_wh", (2048, 1024)))
    kr_default = bool(cfg.get_path("data.test_keep_ratio", True))
    test_cfg = cfg.get("test_cfg", {})
    pad_mult = cfg.get_path("data.eval_pad_multiple")
    engine = (make_compact_ms_slide(model, test_cfg)
              if _is_compact(test_cfg, args.tta) else None)
    for dset_cfg, key in zip(test_sets, keys):
        wh = tuple(dset_cfg.get("test_resize_wh", wh_default))
        pipeline = TestPipeline(
            resize_scale_wh=wh,
            keep_ratio=bool(dset_cfg.get("keep_ratio", kr_default)))
        dataset = build_dataset({k: v for k, v in dset_cfg.items()
                                 if k not in ("key", "test_resize_wh",
                                              "keep_ratio")})
        if main_rank:
            print(f"evaluating {key}: {len(dataset)} images "
                  f"(resize_wh={wh}, keep_ratio={pipeline.keep_ratio})")
        evaluate_dataset(model, test_cfg, dataset, pipeline, acc, key,
                         max_images=args.max_images, tta=args.tta,
                         pad_multiple=pad_mult,
                         on_pred=_saver(args.show_dir, key),
                         rank=group.rank, world=group.data, engine=engine)

    comm = next(model.parameters()).device
    acc.all_reduce(comm)
    results = acc.compute()
    gate = gate_counts(engine, comm) if engine is not None else None
    if main_rank:
        for key in list(acc._acc):
            print(f"--- {key} per-class IoU ---")
            for cls, iou in acc.per_class_iou(key).items():
                print(f"  {cls:>15s}: {iou}")
        if gate is not None:
            print(f"compact gate: refined {gate['refined']} of "
                  f"{gate['windows']} windows")
        print(json.dumps(results, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
