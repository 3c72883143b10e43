"""Checkpoints: periodic save, ``max_keep`` pruning and resume.

Port of vfmseg_tpu/train/checkpoint.py:26-165, in the JAX package's file
layout so that checkpoints cross both ways:

* ``iter_XXXXXXX.trainable.npz``: the trainable parameters (LoRA and heads)
  under ``t/<flax path>``, in the flax orientation (``weights.flax_name``);
  the JAX ``load_pytree`` reads it, and :meth:`CheckpointManager.restore`
  reads the JAX package's;
* ``iter_XXXXXXX.batch_stats.npz``: the BatchNorm statistics under
  ``b/<flax path>``;
* ``iter_XXXXXXX.torch_opt.pt``: the port's own AdamW state (moments and
  counts), beside them. The JAX package's ``.opt.npz`` holds optax leaves by
  position and is neither written nor read here.

Saves are synchronous: the light checkpoint is a few tens of MB.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vfmseg_tpu_torch.train.state import TrainState
from vfmseg_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax


def _flat(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(val, Mapping):
            out.update(_flat(val, path))
        else:
            out[path] = val
    return out


def load_npz_tree(path: str, prefix: Optional[str] = None) -> dict:
    """The nested tree under ``prefix`` of an npz written by either
    package's ``save_pytree``; with no prefix, the whole file's tree."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *mods, leaf = key.split("/")
            if prefix is not None:
                if not mods or mods[0] != prefix:
                    continue
                mods = mods[1:]
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return tree


def trainable_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def batch_stats_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


class CheckpointManager:
    """Iteration-numbered checkpoints with max_keep pruning and resume."""

    def __init__(self, work_dir: str, max_keep: int = 3):
        self.dir = os.path.join(work_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.max_keep = max_keep

    def _path(self, step: int, part: str, ext: str = "npz") -> str:
        return os.path.join(self.dir, f"iter_{step:07d}.{part}.{ext}")

    def save(self, state: TrainState) -> None:
        step = state.step
        tree = flax_from_state_dict(trainable_state_dict(state.model))
        np.savez(self._path(step, "trainable"), **_flat(tree["params"], "t"))
        stats = flax_from_state_dict(batch_stats_state_dict(state.model))
        if stats["batch_stats"]:
            np.savez(self._path(step, "batch_stats"),
                     **_flat(stats["batch_stats"], "b"))
        torch.save({"optimizer": state.optimizer.state_dict()},
                   self._path(step, "torch_opt", "pt"))
        self._prune()

    def latest_step(self) -> Optional[int]:
        steps = [int(m.group(1)) for f in os.listdir(self.dir)
                 if (m := re.match(r"iter_(\d+)\.trainable\.npz$", f))]
        return max(steps) if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the trainable parameters, BatchNorm statistics and optimizer
        state of ``step`` (default: the latest) into ``state``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        model = state.model
        variables = {"params": load_npz_tree(self._path(step, "trainable"),
                                             "t")}
        bs_path = self._path(step, "batch_stats")
        if os.path.exists(bs_path):
            variables["batch_stats"] = load_npz_tree(bs_path, "b")
        sd = {k: v for k, v in state_dict_from_flax(variables).items()
              if not k.endswith("num_batches_tracked")}
        missing = set(trainable_state_dict(model)) - set(sd)
        if missing:
            raise ValueError(f"checkpoint {step} lacks trainable parameters "
                             f"{sorted(missing)[:5]}")
        unexpected = model.load_state_dict(sd, strict=False).unexpected_keys
        if unexpected:
            raise ValueError(f"checkpoint {step} holds unknown entries "
                             f"{sorted(unexpected)[:5]}")
        opt_path = self._path(step, "torch_opt", "pt")
        if os.path.exists(opt_path):
            device = next(model.parameters()).device
            saved = torch.load(opt_path, map_location=device,
                               weights_only=True)
            state.optimizer.load_state_dict(saved["optimizer"])
        state.step = step
        return state

    def _prune(self) -> None:
        steps = sorted({int(m.group(1)) for f in os.listdir(self.dir)
                        if (m := re.match(r"iter_(\d+)\.", f))})
        for s in steps[:-self.max_keep] if self.max_keep else []:
            for f in os.listdir(self.dir):
                if f.startswith(f"iter_{s:07d}."):
                    os.remove(os.path.join(self.dir, f))
