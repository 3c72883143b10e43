"""Training CLI of the port.

Port of tools/train.py (the JAX package's), with the same flags, plus
``--device`` (the card unless asked otherwise)::

    python -m vfmseg_tpu_torch.tools.train <config> [--work-dir D] [--resume]
        [--amp] [--cfg-options k.path=value ...] [--max-iters N]
        [--backbone-init converted.npz] [--list-params] [--distributed]
        [--device cuda|cpu]

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

Data parallelism. ``--distributed`` joins the process group of a torchrun
launch (``torchrun --nproc-per-node N -m vfmseg_tpu_torch.tools.train
<config> --distributed``; NCCL with each rank on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``). Each rank builds its ``batch_size / N`` rows of
every global batch and the step reduces what the JAX mesh reduces over the
global batch (``parallel/mesh.py``); rank 0 logs and checkpoints, and
validation shards its images over the ranks. ``compute.data_parallel``
defaults to the world size, as the JAX CLI's to its device count; another
value, or a ``batch_size`` the world size does not divide, raises (the JAX
CLI shrinks the axis to a divisor, which would leave launched ranks idle).

Every ``log_config.img_interval`` (else ``schedule.debug_interval``) steps,
``debug_fn`` writes a grid of debug panels to ``<work_dir>/class_mix_debug``
on rank 0 (tools/train.py:244-321 of the JAX package): the image and its
labels; MsVFM's LR prediction and entropy and the refined centre crop; any
other segmentor's prediction and entropy; under DACS the target, the
pseudo-label, the mix mask, the mixed image and labels and the teacher's
entropy. Without matplotlib no file is written.

:func:`run` takes a loaded config, the parsed arguments and, optionally,
in-memory source and target datasets and validation sets in place of the
config's.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Callable, Mapping, Optional

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
from vfmseg_tpu_torch.eval.evaluator import make_predict_fn, unwrap_model
from vfmseg_tpu_torch.eval.metrics import IoUAccumulator
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.models.segmentors.ms_vfm import MsVFMSegmentor
from vfmseg_tpu_torch.parallel import mesh
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
    make_dacs_debug_fn,
    make_dacs_train_step,
)
from vfmseg_tpu_torch.utils.visualization import (
    denormalize_image,
    save_debug_grid,
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
                   help="join a torchrun launch's process group: data "
                        "parallelism over its ranks")
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


def check_data_parallel(cfg: Config, device: str = "cpu") -> mesh.Mesh:
    """The data axis of ``compute.data_parallel`` (default: the world
    size) over the process group; ``mesh.make_mesh`` raises unless it is
    the world size, and ``mesh.shard_rows`` unless the world splits
    ``data.batch_size``."""
    group = mesh.make_mesh(cfg.get_path("compute.data_parallel", -1),
                           device=device)
    mesh.shard_rows(cfg.get_path("data.batch_size", 2))
    return group


def make_val_fn(model: torch.nn.Module, cfg: Config,
                val_sets: Mapping[str, object]):
    """``val_fn(state) -> results``: each validation set's first
    ``data.val_max_images`` images through the dense predictor into one
    IoU accumulator, every key in the mean (tools/train.py:200-242). Under
    data parallelism rank r predicts images i = r (mod world) and the
    areas are summed over the ranks, so every rank gets the global
    results."""
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
            for i in range(mesh.rank(), min(max_val, len(ds)),
                           mesh.world_size()):
                raw = ds[i]
                proc = pipeline(raw["img"], raw.get("label"))
                img = torch.from_numpy(proc["img"])[None].to(device)
                acc.update(predicts[key](state.model, img)[0],
                           proc["label"], key)
        acc.all_reduce(device)
        return acc.compute()

    return val_fn


def _entropy(logits: torch.Tensor) -> torch.Tensor:
    """The normalised entropy of the softmax over the last axis, fp32."""
    p = torch.softmax(logits.float(), dim=-1)
    return -(p * torch.log(p + 1e-12)).sum(dim=-1) / math.log(p.shape[-1])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _argmax(logits: torch.Tensor) -> np.ndarray:
    return logits.argmax(dim=-1).cpu().numpy()


@torch.no_grad()
def debug_panels(state: TrainState, batch: Mapping, seed: int,
                 dacs_debug: Optional[Callable] = None) -> dict:
    """The debug grid's panels of ``batch``'s first image (the JAX CLI's
    ``debug_fn``, tools/train.py:267-310): image and labels; for MsVFM the
    LR prediction and entropy (``lr_forward``) and the centre crop refined
    with the LR logits as context (``hr_forward``); for any segmentor with
    ``encode_decode`` its prediction and entropy; under DACS
    (``dacs_debug``, ``make_dacs_debug_fn``'s function) the target, the
    pseudo-label, the mix mask, the mixed image and labels and the
    teacher's entropy. The model predicts in eval mode, its mode restored
    after."""
    model = state.model
    inner = unwrap_model(model)
    device = next(model.parameters()).device
    img = torch.as_tensor(batch["img"][:1]).to(device)
    panels = {"image": denormalize_image(np.asarray(batch["img"][0])),
              "gt": np.asarray(batch["label"][0])}
    was_training = model.training
    model.eval()
    try:
        if isinstance(inner, MsVFMSegmentor):
            lr_logits = inner.lr_forward(img)
            panels["lr_pred"] = _argmax(lr_logits)[0]
            panels["lr_entropy"] = _np(_entropy(lr_logits))[0]
            ch, cw = inner.hr_crop_size
            y0 = (img.shape[1] - ch) // 2
            x0 = (img.shape[2] - cw) // 2
            hr_logits = inner.hr_forward(
                img[:, y0:y0 + ch, x0:x0 + cw],
                lr_logits[:, y0:y0 + ch, x0:x0 + cw])
            panels["hr_refined"] = _argmax(hr_logits)[0]
        elif hasattr(type(inner), "encode_decode"):
            logits = inner.encode_decode(img)
            panels["pred"] = _argmax(logits)[0]
            panels["entropy"] = _np(_entropy(logits))[0]
    finally:
        model.train(was_training)
    if dacs_debug is not None and "target_img" in batch:
        d = dacs_debug(state, batch, seed)
        panels["target"] = denormalize_image(np.asarray(
            batch["target_img"][0]))
        panels["pseudo_label"] = d["pseudo_label"][0].cpu().numpy()
        panels["mix_mask"] = _np(d["mix_mask"])[0]
        panels["mixed_image"] = denormalize_image(_np(d["mixed_img"][0]))
        panels["mixed_label"] = d["mixed_lbl"][0].cpu().numpy()
        panels["teacher_entropy"] = _np(d["entropy"])[0]
    return panels


def make_debug_fn(cfg: Config, work_dir: str, seed: int,
                  write: bool) -> Callable:
    """``debug_fn(state, batch, step)`` for ``train_loop``: every rank
    computes the panels (the DACS ones reduce over the data group), the
    rank that ``write``s saves the grid under ``<work_dir>/class_mix_debug``
    (``save_debug_grid``)."""
    dacs_debug = (make_dacs_debug_fn(dacs_config(cfg)) if cfg.get("uda")
                  else None)
    out_dir = os.path.join(work_dir, "class_mix_debug")

    def debug_fn(state: TrainState, batch: Mapping, step: int):
        panels = debug_panels(state, batch, seed, dacs_debug)
        if write:
            return save_debug_grid(out_dir, step, panels, cols=4)
        return None

    return debug_fn


def run(cfg: Config, args, source=None,
        val_sets: Optional[Mapping[str, object]] = None,
        target=None) -> TrainState:
    """Train by ``cfg`` and ``args`` (``parse_args``'s namespace); the
    source dataset is ``source`` if given, else ``data.source``; with a
    ``uda`` section the target is ``target`` if given, else
    ``data.target``; the validation sets (key -> dataset) ``val_sets`` if
    given, else ``data.val``. Returns the final state."""
    if args.distributed:
        mesh.init_distributed(args.device)
    group = check_data_parallel(cfg, args.device)
    say = print if group.rank == 0 else (lambda *a, **k: None)
    work_dir = args.work_dir or os.path.join("work_dirs",
                                             cfg.get("name", "run"))
    os.makedirs(work_dir, exist_ok=True)
    model = build_model(cfg, str(group.device), args.amp)
    if args.backbone_init:
        prefix = load_backbone(model, args.backbone_init)
        say(f"loaded backbone weights from {args.backbone_init} -> {prefix}")
    mesh.replicate(model)  # rank 0's weights on every rank

    dcfg = cfg["data"]
    seed = cfg.get_path("schedule.seed", 0)
    # rank 0 draws the single process's samples; every other rank's
    # augmentations and rare-class picks come from a generator of its own
    data_seed = (seed if group.rank == 0 else int(np.random.SeedSequence(
        [seed, group.rank]).generate_state(1)[0]))
    if source is None:
        source = build_dataset(dcfg["source"])
    pipeline = TrainPipeline(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in dcfg["train_pipeline"].items()})
    rcs = dcfg.get("rare_class_sampling")
    if cfg.get("uda"):
        if target is None:
            target = build_dataset(dcfg["target"])
        dataset = UDADataset(source, target, pipeline,
                             rare_class_sampling=rcs, seed=data_seed)
    else:
        dataset = DGDataset(source, pipeline, rare_class_sampling=rcs,
                            seed=data_seed)

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
    say(f"trainable params: {n_train:,} / {n_total:,} "
        f"({100.0 * n_train / n_total:.2f}%)")
    if args.list_params and group.rank == 0:
        _print_tree(flax_from_state_dict(trainable, model)["params"])
    if group.data > 1:
        say(f"data-parallel training over {group.data} processes")

    sched = cfg.get("schedule", {})
    val_fn = None
    if val_sets is None:
        val_sets = {d.get("key", f"val{i}"): build_dataset(
                        {k: v for k, v in d.items() if k != "key"})
                    for i, d in enumerate(cfg.get_path("data.val") or [])}
    if val_sets and sched.get("val_interval", 0):
        val_fn = make_val_fn(model, cfg, val_sets)
    debug_interval = (cfg.get_path("log_config.img_interval", 0)
                      or sched.get("debug_interval", 0))
    debug_fn = (make_debug_fn(cfg, work_dir, seed, group.rank == 0)
                if debug_interval else None)

    loader = InfiniteLoader(dataset, batch_size=dcfg.get("batch_size", 2),
                            num_workers=dcfg.get("num_workers", 4),
                            seed=seed, rank=group.rank, world=group.data)
    try:
        return train_loop(
            state, step_fn, loader, max_iters=max_iters,
            work_dir=work_dir, seed=seed,
            log_interval=sched.get("log_interval", 50),
            checkpoint_interval=sched.get("checkpoint_interval", 4000),
            max_keep_ckpts=sched.get("max_keep_ckpts", 3),
            val_interval=sched.get("val_interval", 0), val_fn=val_fn,
            debug_interval=debug_interval, debug_fn=debug_fn,
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
