"""Training CLI of the port.

Port of tools/train.py (the JAX package's), with the same flags but
``--distributed``, plus ``--device`` (the card unless asked otherwise)::

    python -m vfmseg_tpu_torch.tools.train <config> [--work-dir D] [--resume]
        [--amp] [--cfg-options k.path=value ...] [--max-iters N]
        [--backbone-init converted.npz] [--list-params] [--device cuda|cpu]

``config`` is a config file's bare name under ``configs/`` or its path,
read by the port's loader. The model's weights come from
``schedule.seed`` (``weights.init_params``); ``--backbone-init`` loads a
converted backbone (``.npz`` in the JAX package's layout, from either
package's ``convert_*`` tool) under the backbone's prefix (``backbone``, or
``model.backbone`` under the DomainGeneral wrapper). The source dataset
(``data.source``) goes through ``data.train_pipeline`` with Rare-Class
Sampling (``data.rare_class_sampling``) into ``InfiniteLoader``;
``train_loop`` runs ``make_train_step`` with AdamW + PolyLR on the
trainable partition (``peft``), logs to ``<work_dir>/metrics.jsonl``,
checkpoints under ``<work_dir>/checkpoints`` and, every
``schedule.val_interval`` steps, evaluates ``data.val`` (at most
``data.val_max_images`` images each) with the dense predictor, keeping
``best.trainable.npz`` by ``schedule.save_best``. A config with a ``uda``
section trains DACS instead (``train/uda.py``): each item pairs the source
sample with a target sample from ``data.target`` (``UDADataset``), the
state carries the EMA copy of the head (``uda.head_key``), and the step is
``make_dacs_train_step`` with a ``DACSConfig`` from that section.

:func:`run` takes a loaded config, the parsed arguments and, optionally,
in-memory source and target datasets and validation sets in place of the
config's. Not ported yet, and raising: data parallelism over several cards
(ROADMAP A11) and the debug image grids (``schedule.debug_interval``,
``log_config.img_interval``; A11).
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping, Optional

import numpy as np
import torch

from vfmseg_tpu_torch.core.config import Config, load_config
from vfmseg_tpu_torch.data.datasets import (
    DGDataset,
    UDADataset,
    build_dataset,
)
from vfmseg_tpu_torch.data.loader import InfiniteLoader
from vfmseg_tpu_torch.data.transforms import TestPipeline, TrainPipeline
from vfmseg_tpu_torch.eval.evaluator import make_predict_fn
from vfmseg_tpu_torch.eval.metrics import IoUAccumulator
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.train.checkpoint import (
    load_pytree,
    trainable_state_dict,
)
from vfmseg_tpu_torch.train.loop import train_loop
from vfmseg_tpu_torch.train.optim import resolve_backbone_prefix
from vfmseg_tpu_torch.train.state import TrainState, create_train_state
from vfmseg_tpu_torch.train.step import make_train_step
from vfmseg_tpu_torch.train.uda import (
    DACSConfig,
    init_ema,
    make_dacs_train_step,
)
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    init_params,
    state_dict_from_flax,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a vfmseg_tpu_torch "
                                            "segmentor")
    p.add_argument("config", help="config name or path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute whatever compute.dtype says")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="dot-key overrides, e.g. optimizer.lr=3e-4")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--backbone-init", default=None,
                   help="converted backbone weights (.npz from convert_*)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--list-params", action="store_true",
                   help="print every trainable parameter path and shape")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p.parse_args(argv)


def build_model(cfg: Config, device: str, amp: bool) -> torch.nn.Module:
    """The config's segmentor on ``device``, its weights from
    ``schedule.seed``."""
    dtype = torch.bfloat16 if amp else compute_dtype(cfg)
    model = build_segmentor(cfg["model"], dtype=dtype, device=device,
                            attn_impl=compute_attn_impl(cfg))
    return init_params(model, cfg.get_path("schedule.seed", 0))


@torch.no_grad()
def load_backbone(model: torch.nn.Module, path: str) -> str:
    """Load a converted backbone tree (flax paths) under the backbone's
    prefix; returns the prefix."""
    tree = load_pytree(path)
    prefix = resolve_backbone_prefix(model)
    for seg in reversed(prefix):
        tree = {seg: tree}
    sd = state_dict_from_flax({"params": tree}, model)
    unexpected = model.load_state_dict(sd, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"{path} holds entries the model does not have: "
                         f"{sorted(unexpected)[:5]}")
    return "/".join(prefix)


def dacs_config(cfg: Config) -> DACSConfig:
    """The ``DACSConfig`` of a config's ``uda`` section (the keys of
    tools/train.py:182-194)."""
    uda = cfg["uda"]
    return DACSConfig(
        pseudo_threshold=uda.get("pseudo_threshold", 0.968),
        psweight_ignore_top=uda.get("pseudo_weight_ignore_top", 15),
        psweight_ignore_bottom=uda.get("pseudo_weight_ignore_bottom", 120),
        color_jitter_strength=uda.get("color_jitter_strength", 0.25),
        color_jitter_probability=uda.get("color_jitter_probability", 0.2),
        blur=uda.get("blur", True),
        num_classes=cfg.get("num_classes", 19),
        alpha=uda.get("alpha", 0.999),
        head_key=uda.get("head_key", "decode_head"))


def _check_ported(cfg: Config, args) -> None:
    if args.distributed or cfg.get_path("compute.data_parallel", 1) > 1:
        raise NotImplementedError("data-parallel training over several "
                                  "cards is not ported yet (ROADMAP A11)")
    if (cfg.get_path("log_config.img_interval", 0)
            or cfg.get_path("schedule.debug_interval", 0)):
        raise NotImplementedError("the debug image grids are not ported yet "
                                  "(ROADMAP A11)")


def make_val_fn(model: torch.nn.Module, cfg: Config,
                val_sets: Mapping[str, object]):
    """``val_fn(state) -> results``: each validation set's first
    ``data.val_max_images`` images through the dense predictor into one
    IoU accumulator, every key in the mean (tools/train.py:200-242)."""
    keys = list(val_sets)
    wh = tuple(cfg.get_path("data.test_resize_wh", (2048, 1024)))
    pipeline = TestPipeline(resize_scale_wh=wh)
    max_val = cfg.get_path("data.val_max_images", 50)
    test_cfg = cfg.get("test_cfg", {})
    device = next(model.parameters()).device
    predicts = {}

    def val_fn(state: TrainState) -> dict:
        state.model.eval()
        acc = IoUAccumulator(num_classes=cfg.get("num_classes", 19),
                             dataset_keys=keys, mean_used_keys=keys)
        for key, ds in val_sets.items():
            if key not in predicts:
                sample = ds[0]
                out_hw = (sample["label"].shape if "label" in sample
                          else (wh[1], wh[0]))
                predicts[key] = make_predict_fn(state.model, test_cfg,
                                                tuple(out_hw))
            for i in range(min(max_val, len(ds))):
                raw = ds[i]
                proc = pipeline(raw["img"], raw.get("label"))
                img = torch.from_numpy(proc["img"])[None].to(device)
                acc.update(predicts[key](state.model, img)[0],
                           proc["label"], key)
        return acc.compute()

    return val_fn


def run(cfg: Config, args, source=None,
        val_sets: Optional[Mapping[str, object]] = None,
        target=None) -> TrainState:
    """Train by ``cfg`` and ``args`` (``parse_args``'s namespace); the
    source dataset is ``source`` if given, else ``data.source``; with a
    ``uda`` section the target is ``target`` if given, else
    ``data.target``; the validation sets (key -> dataset) ``val_sets`` if
    given, else ``data.val``. Returns the final state."""
    _check_ported(cfg, args)
    work_dir = args.work_dir or os.path.join("work_dirs",
                                             cfg.get("name", "run"))
    os.makedirs(work_dir, exist_ok=True)
    model = build_model(cfg, args.device, args.amp)
    if args.backbone_init:
        prefix = load_backbone(model, args.backbone_init)
        print(f"loaded backbone weights from {args.backbone_init} "
              f"-> {prefix}")

    dcfg = cfg["data"]
    seed = cfg.get_path("schedule.seed", 0)
    if source is None:
        source = build_dataset(dcfg["source"])
    pipeline = TrainPipeline(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in dcfg["train_pipeline"].items()})
    rcs = dcfg.get("rare_class_sampling")
    if cfg.get("uda"):
        if target is None:
            target = build_dataset(dcfg["target"])
        dataset = UDADataset(source, target, pipeline,
                             rare_class_sampling=rcs, seed=seed)
    else:
        dataset = DGDataset(source, pipeline, rare_class_sampling=rcs,
                            seed=seed)

    max_iters = args.max_iters or cfg.get_path("schedule.max_iters", 40000)
    state = create_train_state(model, cfg, max_iters=max_iters)
    if cfg.get("uda"):
        dacs = dacs_config(cfg)
        state.ema = init_ema(model, dacs.head_key)  # a copy, not an alias
        state.ema_key = dacs.head_key
        step_fn = make_dacs_train_step(dacs)
    else:
        step_fn = make_train_step()
    trainable = trainable_state_dict(model)
    n_train = sum(p.numel() for p in trainable.values())
    n_total = sum(p.numel() for p in model.parameters())
    print(f"trainable params: {n_train:,} / {n_total:,} "
          f"({100.0 * n_train / n_total:.2f}%)")
    if args.list_params:
        _print_tree(flax_from_state_dict(trainable, model)["params"])

    sched = cfg.get("schedule", {})
    val_fn = None
    if val_sets is None:
        val_sets = {d.get("key", f"val{i}"): build_dataset(
                        {k: v for k, v in d.items() if k != "key"})
                    for i, d in enumerate(cfg.get_path("data.val") or [])}
    if val_sets and sched.get("val_interval", 0):
        val_fn = make_val_fn(model, cfg, val_sets)

    loader = InfiniteLoader(dataset, batch_size=dcfg.get("batch_size", 2),
                            num_workers=dcfg.get("num_workers", 4),
                            seed=seed)
    try:
        return train_loop(
            state, step_fn, loader, max_iters=max_iters,
            work_dir=work_dir, seed=seed,
            log_interval=sched.get("log_interval", 50),
            checkpoint_interval=sched.get("checkpoint_interval", 4000),
            max_keep_ckpts=sched.get("max_keep_ckpts", 3),
            val_interval=sched.get("val_interval", 0), val_fn=val_fn,
            save_best=sched.get("save_best"), resume=args.resume)
    finally:
        loader.close()


def _print_tree(tree: Mapping, prefix: str = "") -> None:
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            _print_tree(val, f"{prefix}{key}/")
        else:
            print(f"  [train] {prefix}{key}: {tuple(np.shape(val))}")


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    return run(load_config(args.config, args.cfg_options), args)


if __name__ == "__main__":
    main()
