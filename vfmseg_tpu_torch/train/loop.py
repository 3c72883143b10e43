"""Training loop: iteration-based, with logging, checkpoints and resume.

Port of vfmseg_tpu/train/loop.py:22-113: ``MetricLogger`` (``metrics.jsonl``
plus a console line) every ``log_interval`` steps, an asynchronous
checkpoint every ``checkpoint_interval`` (keep ``max_keep_ckpts``), the
``val_fn(state)`` results every ``val_interval``, logged under ``val``, with
``checkpoints/best.trainable.npz`` written whenever ``results[save_best]``
improves (the reference CheckpointHook's ``save_best``), an optional
``debug_fn(state, batch, step)`` every ``debug_interval``, and resume from
the latest checkpoint. The loop waits for the last save before it returns.

Reading the metrics at a log step waits for the device, so each logged
``steps_per_sec`` covers finished work; time spent saving checkpoints,
validating and in ``debug_fn`` is left out of it.

Under data parallelism every rank steps, validates (``val_fn`` shards its
images and returns the global results), calls ``debug_fn`` (which writes
on rank 0) and restores on ``resume``; rank 0 alone logs, checkpoints and
writes ``best.trainable.npz``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

from vfmseg_tpu_torch.parallel import mesh
from vfmseg_tpu_torch.train.checkpoint import (
    CheckpointManager,
    save_pytree,
    trainable_state_dict,
)
from vfmseg_tpu_torch.train.state import TrainState
from vfmseg_tpu_torch.weights import flax_from_state_dict


class MetricLogger:
    """JSONL + console logger."""

    def __init__(self, work_dir: str, log=print):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "metrics.jsonl")
        self.log = log

    def write(self, step: int, metrics: Dict, prefix: str = "train") -> None:
        rec = {"step": step, "prefix": prefix}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        pretty = " ".join(f"{k}={rec[k]:.4g}" if isinstance(rec[k], float)
                          else f"{k}={rec[k]}" for k in sorted(rec)
                          if k not in ("step", "prefix"))
        self.log(f"[{prefix}] iter {step}: {pretty}")


def train_loop(
    state: TrainState,
    step_fn: Callable,
    data_iter: Iterator,
    *,
    max_iters: int,
    work_dir: str,
    seed: int,
    log_interval: int = 50,
    checkpoint_interval: int = 4000,
    max_keep_ckpts: int = 3,
    val_interval: int = 0,
    val_fn: Optional[Callable] = None,
    debug_interval: int = 0,
    debug_fn: Optional[Callable] = None,
    save_best: Optional[str] = None,
    resume: bool = False,
) -> TrainState:
    ckpt = CheckpointManager(work_dir, max_keep=max_keep_ckpts,
                             async_save=True)
    main = mesh.rank() == 0
    logger = MetricLogger(work_dir) if main else None
    best_metric = float("-inf")
    if resume:
        state = ckpt.restore(state)

    window = max(log_interval, 1)
    t0 = time.perf_counter()
    for it in range(state.step, max_iters):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch, seed)
        if (it + 1) % window == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            metrics["steps_per_sec"] = window / max(now - t0, 1e-9)
            if main:
                logger.write(it + 1, metrics)
            t0 = time.perf_counter()
        paused = time.perf_counter()
        if (main and checkpoint_interval
                and (it + 1) % checkpoint_interval == 0):
            ckpt.save(state)
        if val_interval and val_fn is not None and (it + 1) % val_interval == 0:
            results = val_fn(state)
            if main:
                logger.write(it + 1, results, prefix="val")
            if main and save_best and results.get(
                    save_best, float("-inf")) > best_metric:
                best_metric = results[save_best]
                tree = flax_from_state_dict(
                    trainable_state_dict(state.model), state.model)
                save_pytree(os.path.join(ckpt.dir, "best.trainable.npz"),
                            {"t": tree["params"]})
                logger.log(f"[val] new best {save_best}={best_metric:.2f} "
                           f"-> checkpoints/best.trainable.npz")
        if (debug_interval and debug_fn is not None
                and (it + 1) % debug_interval == 0):
            debug_fn(state, batch, it + 1)
        t0 += time.perf_counter() - paused
    ckpt.wait()
    return state
