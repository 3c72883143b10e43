"""Checkpoints: periodic save, ``max_keep`` pruning and resume.

Port of vfmseg_tpu/train/checkpoint.py:26-165, in the JAX package's file
layout so that checkpoints cross both ways:

* ``iter_XXXXXXX.trainable.npz``: the trainable parameters (LoRA and heads)
  under ``t/<flax path>``, in the flax orientation (``weights.flax_name``);
  the JAX ``load_pytree`` reads it, and :meth:`CheckpointManager.restore`
  reads the JAX package's;
* ``iter_XXXXXXX.batch_stats.npz``: the BatchNorm statistics under
  ``b/<flax path>``;
* ``iter_XXXXXXX.ema.npz``: DACS's EMA head (``TrainState.ema``) under
  ``e/<flax path below the head>``, the JAX ``TrainState.ema`` subtree
  (vfmseg_tpu/train/checkpoint.py:89-90,130-133);
* ``iter_XXXXXXX.torch_opt.pt``: the port's own AdamW state (moments and
  counts), beside them. The JAX package's ``.opt.npz`` holds optax leaves by
  position and is neither written nor read here.

Saves are asynchronous, as the JAX package's are in training: ``save``
copies the trainable tensors, the BatchNorm statistics and the AdamW state
to the host on the calling thread (the next step updates them in place), and
a thread writes the files; at most one save is in flight, and ``wait``,
``latest_step`` and ``restore`` first let it finish. ``save_pytree`` and
``load_pytree`` read and write any nested tree in the JAX package's ``.npz``
layout (``/``-joined paths): converted backbones (``--backbone-init``) and
``best.trainable.npz``.
"""

from __future__ import annotations

import os
import re
import threading
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


def save_pytree(path: str, tree: Mapping) -> None:
    """Save a nested tree of arrays as an ``.npz`` with ``/``-joined keys
    (vfmseg_tpu/train/checkpoint.py:30-34)."""
    flat = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flat(val, key))
        else:
            flat[key] = val
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str) -> dict:
    """The nested tree of an ``.npz`` written by either package's
    ``save_pytree``."""
    return load_npz_tree(path)


def _host_copy(obj):
    """A copy of every tensor of ``obj`` (nested dicts, lists, tuples) on
    the host, detached from what the next step updates in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


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
    """Iteration-numbered checkpoints with max_keep pruning and resume;
    with ``async_save``, a thread writes each snapshot."""

    def __init__(self, work_dir: str, max_keep: int = 3,
                 async_save: bool = False):
        self.dir = os.path.join(work_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.max_keep = max_keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _path(self, step: int, part: str, ext: str = "npz") -> str:
        return os.path.join(self.dir, f"iter_{step:07d}.{part}.{ext}")

    def wait(self) -> None:
        """Block until an in-flight save has finished; re-raise its
        error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, state: TrainState) -> None:
        self.wait()  # at most one save in flight
        snapshot = dict(
            step=state.step,
            trainable=_host_copy(trainable_state_dict(state.model)),
            stats=_host_copy(batch_stats_state_dict(state.model)),
            model=state.model,
            optimizer=_host_copy(state.optimizer.state_dict()),
            ema=_host_copy(state.ema), ema_key=state.ema_key)
        if not self.async_save:
            self._write(snapshot)
            return
        self._pending = threading.Thread(target=self._write_catching,
                                         args=(snapshot,), daemon=True)
        self._pending.start()

    def _write_catching(self, snapshot: dict) -> None:
        try:
            self._write(snapshot)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _write(self, snapshot: dict) -> None:
        step = snapshot["step"]
        model = snapshot["model"]
        tree = flax_from_state_dict(snapshot["trainable"], model)
        save_pytree(self._path(step, "trainable"), {"t": tree["params"]})
        stats = flax_from_state_dict(snapshot["stats"], model)
        if stats["batch_stats"]:
            save_pytree(self._path(step, "batch_stats"),
                        {"b": stats["batch_stats"]})
        if snapshot["ema"] is not None:
            ema = flax_from_state_dict(snapshot["ema"], model)["params"]
            save_pytree(self._path(step, "ema"),
                        {"e": ema[snapshot["ema_key"]]})
        torch.save({"optimizer": snapshot["optimizer"]},
                   self._path(step, "torch_opt", "pt"))
        self._prune()

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = [int(m.group(1)) for f in os.listdir(self.dir)
                 if (m := re.match(r"iter_(\d+)\.trainable\.npz$", f))]
        return max(steps) if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the trainable parameters, BatchNorm statistics, EMA head and
        optimizer state of ``step`` (default: the latest) into ``state``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        model = state.model
        variables = {"params": load_npz_tree(self._path(step, "trainable"),
                                             "t")}
        bs_path = self._path(step, "batch_stats")
        if os.path.exists(bs_path):
            variables["batch_stats"] = load_npz_tree(bs_path, "b")
        sd = {k: v for k, v in state_dict_from_flax(variables, model).items()
              if not k.endswith("num_batches_tracked")}
        missing = set(trainable_state_dict(model)) - set(sd)
        if missing:
            raise ValueError(f"checkpoint {step} lacks trainable parameters "
                             f"{sorted(missing)[:5]}")
        unexpected = model.load_state_dict(sd, strict=False).unexpected_keys
        if unexpected:
            raise ValueError(f"checkpoint {step} holds unknown entries "
                             f"{sorted(unexpected)[:5]}")
        device = next(model.parameters()).device
        ema_path = self._path(step, "ema")
        if os.path.exists(ema_path):
            ema = state_dict_from_flax(
                {"params": {state.ema_key: load_npz_tree(ema_path, "e")}},
                model)
            if state.ema is not None and ema.keys() != state.ema.keys():
                raise ValueError(f"checkpoint {step}'s EMA holds "
                                 f"{sorted(ema)[:5]}, the state's "
                                 f"{sorted(state.ema)[:5]}")
            state.ema = {k: v.to(device) for k, v in ema.items()}
        opt_path = self._path(step, "torch_opt", "pt")
        if os.path.exists(opt_path):
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
