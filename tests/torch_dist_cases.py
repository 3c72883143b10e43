"""Cases of tests/test_torch_distributed.py, run by its gloo workers
(``torch_dist_worker.py``, one rank each) and by the test process itself
(one process, no process group) on the same global batch. Port only: no
jax import, so a worker starts in a few seconds.

Each step case builds a tiny config's segmentor on the CPU from a seed
(``init_params``: every rank builds the same weights), takes its rows of a
global batch of ``GLOBAL_BATCH`` (``mesh.shard_rows``) and runs one train
step with the randomness on; it returns the metrics, the reduced
gradients, the updated trainable parameters, the BatchNorm statistics and
(DACS) the EMA head as numpy arrays.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.heads import m2f_loss
from vfmseg_tpu_torch.models.build import build_segmentor, compute_attn_impl
from vfmseg_tpu_torch.models.presets import config
from vfmseg_tpu_torch.parallel import mesh
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step
from vfmseg_tpu_torch.train.uda import (
    DACSConfig,
    init_ema,
    make_dacs_train_step,
)
from vfmseg_tpu_torch.weights import init_params

GLOBAL_BATCH = 4
HW = (128, 128)
LR = 1e-4
# the tiny headline with drop-path on too, so that every per-sample stream
# draws: LoRA and head dropout, drop-path over the LR views and HR crops in
# one ViT call, the decoder's mask tokens
MSVFM = ("smoke_tiny_ms_masked",
         ["model.backbone.backbone.drop_path_rate=0.2"])
# the same with every draw off, the crop at (32, 0): the JAX comparison
MSVFM_FIXED = ("smoke_tiny_ms_masked",
               ["model.backbone.Lora_config.lora_dropout=0.0",
                "model.decode_head.dropout_ratio=0.0",
                "model.aux_head.dropout_ratio=0.0",
                "model.aux_head.transformer.dropout=0.0",
                "model.aux_head.transformer.mask_ratio=0.0"])
FIXED_CROPS = [1, 0]
M2F = ("smoke_tiny_rein_m2f", [])
# DACS's batched 2B student pass on an EncoderDecoder: the tiny UDA config
# (LinearHead, whose BatchNorm takes the moments of the 2B batch) and the
# same backbone under a SegFormer head; and the two passes of a
# MaskFormerSegmentor, the mixed one's set losses scaled by the mixed
# weight's mean
DACS = {"linear": ("smoke_tiny_uda", []),
        "segformer": ("smoke_tiny_uda", [
            "model.decode_head={'type': 'SegformerHead', "
            "'in_channels': [32, 32, 32, 32], 'channels': 8, "
            "'num_classes': 19, 'dropout_ratio': 0.1}"]),
        "m2f": M2F}


def global_batch(seed: int, target: bool = False) -> Dict[str, np.ndarray]:
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (GLOBAL_BATCH,) + HW).astype(np.int32)
    label[label == 7] = 8          # an absent class
    label[2] %= 6                  # images with unequal class sets
    label[3] = np.where(label[3] > 12, label[3], 255)
    label[:, :, :5] = 255
    label[1, 40:] = 255            # images with unequal ignored areas
    batch = {"img": rs.standard_normal((GLOBAL_BATCH,) + HW + (3,)).astype(
        np.float32), "label": label}
    if target:
        batch["target_img"] = rs.standard_normal(
            (GLOBAL_BATCH,) + HW + (3,)).astype(np.float32)
    return batch


def build(spec, seed: int):
    name, options = spec
    cfg = config(name, options)
    cfg["optimizer"]["lr"] = LR
    model = build_segmentor(cfg["model"], dtype=torch.float32, device="cpu",
                            attn_impl=compute_attn_impl(cfg))
    return cfg, init_params(model, seed)


def _arrays(model, state, metrics) -> Dict[str, np.ndarray]:
    out = {f"m/{k}": np.asarray(float(v)) for k, v in metrics.items()}
    for n, p in model.named_parameters():
        if p.requires_grad:
            out[f"p/{n}"] = p.detach().numpy().copy()
            out[f"g/{n}"] = p.grad.numpy().copy()
    for n, b in model.named_buffers():
        if "running" in n:
            out[f"s/{n}"] = b.numpy().copy()
    for n, e in (state.ema or {}).items():
        out[f"e/{n}"] = e.numpy().copy()
    return out


def _rows(batch):
    rows = mesh.shard_rows(GLOBAL_BATCH)
    return {k: v[rows] for k, v in batch.items()}


@contextlib.contextmanager
def _matchings(matching: Optional[np.ndarray], found: Dict):
    """The set loss's host matchings of every call, in call order, put in
    ``found["a/matching"]`` as [calls x stages, local images, K]; with
    ``matching`` ([calls x stages, images, K]) they are taken from it
    instead of solved."""
    solved: List[np.ndarray] = []
    solve = m2f_loss._hungarian_host
    images = GLOBAL_BATCH // mesh.world_size()

    def hungarian(cost):
        out = solve(cost)
        if matching is not None:
            start = sum(len(m) for m in solved)
            out = matching[start:start + len(out) // images].reshape(
                out.shape).astype(out.dtype)
        solved.append(out.reshape(-1, images, out.shape[-1]))
        return out

    with mock.patch.object(m2f_loss, "_hungarian_host", hungarian):
        yield
    if solved:
        found["a/matching"] = np.concatenate(solved)


def train_case(spec, seed: int, batch_seed: int,
               crops: Optional[list] = None,
               matching: Optional[np.ndarray] = None
               ) -> Dict[str, np.ndarray]:
    """One ``make_train_step`` step on this process's rows; ``crops``:
    the crop origins' ``randint`` draws, fixed; the set loss's matchings
    as ``_matchings`` takes and returns them."""
    cfg, model = build(spec, seed)
    state = create_train_state(model, cfg, max_iters=100)
    found: Dict[str, np.ndarray] = {}
    with mock.patch.object(rng, "randint",
                           side_effect=list(crops or []) or rng.randint), \
            _matchings(matching, found):
        state, metrics = make_train_step()(
            state, _rows(global_batch(batch_seed)), 0)
    return dict(_arrays(model, state, metrics), **found)


def dacs_case(spec, seed: int, batch_seed: int, threshold: float,
              matching: Optional[np.ndarray] = None
              ) -> Dict[str, np.ndarray]:
    """One DACS step on this process's rows at the pseudo-label
    ``threshold``; the set loss's matchings as ``_matchings`` takes and
    returns them."""
    cfg, model = build(spec, seed)
    state = create_train_state(model, cfg, max_iters=100)
    state.ema = init_ema(model)
    step = make_dacs_train_step(DACSConfig(
        pseudo_threshold=threshold, psweight_ignore_top=4,
        psweight_ignore_bottom=8))
    found: Dict[str, np.ndarray] = {}
    with _matchings(matching, found):
        state, metrics = step(state, _rows(global_batch(batch_seed, True)),
                              0)
    return dict(_arrays(model, state, metrics), **found)


def eval_case(task: dict, out_dir: str, world: int) -> Dict[str, np.ndarray]:
    """The eval CLI (``--data-parallel world`` when ``world`` > 1) through
    the per-image predictor and the compact stream, and the compact gate's
    counts summed over the ranks."""
    from vfmseg_tpu_torch.data import datasets, transforms
    from vfmseg_tpu_torch.eval import evaluator
    from vfmseg_tpu_torch.eval.metrics import IoUAccumulator
    from vfmseg_tpu_torch.tools import test as test_cli

    out = {}
    tag = "dp" if world > 1 else "single"
    for gate in ("dense", "compact"):
        options = list(task["options"])
        if gate == "compact":
            options.append("test_cfg.gate=compact")
        argv = ["smoke_tiny_ms_masked", task["ckpt"], "--device", "cpu",
                "--out", os.path.join(out_dir, f"{tag}_{gate}.json"),
                "--show-dir", os.path.join(out_dir, f"show_{tag}_{gate}"),
                "--cfg-options", *options]
        if world > 1:
            argv += ["--data-parallel", str(world)]
        test_cli.main(argv)
    cfg = config("smoke_tiny_ms_masked", task["options"]
                 + ["test_cfg.gate=compact"])
    model = build_segmentor(cfg["model"], device="cpu")
    test_cli.load_weights(model, task["ckpt"], None)
    engine = evaluator.make_compact_ms_slide(model, cfg["test_cfg"])
    acc = IoUAccumulator(dataset_keys=["synth"])
    test_cli.evaluate_dataset(
        model, cfg["test_cfg"], datasets.gta_dataset(task["data"]),
        transforms.TestPipeline((128, 128), True), acc, "synth",
        rank=mesh.rank(), world=mesh.world_size(), engine=engine)
    counts = test_cli.gate_counts(engine, torch.device("cpu"))
    out["gate"] = np.array([counts["windows"], counts["refined"]])
    return out


def run(name: str, task: dict, out_dir: str) -> Dict[str, np.ndarray]:
    """Case ``name`` in this process (a rank of the group, or alone)."""
    world = mesh.world_size()
    if name == "msvfm":
        return train_case(MSVFM, 3, 5)
    if name == "msvfm_fixed":
        return train_case(MSVFM_FIXED, 3, 5, FIXED_CROPS)
    if name == "m2f":
        return train_case(M2F, 4, 6, matching=task.get("matching"))
    if name.startswith("dacs_"):
        return dacs_case(DACS[name[5:]], 7, 8, task["threshold"][name],
                         task.get("matching"))
    if name == "eval":
        return eval_case(task, out_dir, world)
    raise KeyError(name)
