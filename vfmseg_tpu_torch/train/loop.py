"""Training loop: iteration-based, with logging, checkpoints and resume.

Port of vfmseg_tpu/train/loop.py:22-113: ``MetricLogger`` (``metrics.jsonl``
plus a console line) every ``log_interval`` steps, a checkpoint every
``checkpoint_interval`` (keep ``max_keep_ckpts``), an optional ``val_fn``
every ``val_interval`` whose results are logged, and resume from the latest
checkpoint. Validation itself (datasets, IoU) and ``save_best`` with it are
not ported yet, so ``val_fn`` stays a hook.

Reading the metrics at a log step waits for the device, so each logged
``steps_per_sec`` covers finished work; time spent saving checkpoints and
validating is left out of it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

from vfmseg_tpu_torch.train.checkpoint import CheckpointManager
from vfmseg_tpu_torch.train.state import TrainState


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
    resume: bool = False,
) -> TrainState:
    ckpt = CheckpointManager(work_dir, max_keep=max_keep_ckpts)
    logger = MetricLogger(work_dir)
    if resume:
        state = ckpt.restore(state)

    window = max(log_interval, 1)
    t0 = time.perf_counter()
    for it in range(state.step, max_iters):
        state, metrics = step_fn(state, next(data_iter), seed)
        if (it + 1) % window == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            metrics["steps_per_sec"] = window / max(now - t0, 1e-9)
            logger.write(it + 1, metrics)
            t0 = time.perf_counter()
        paused = time.perf_counter()
        if checkpoint_interval and (it + 1) % checkpoint_interval == 0:
            ckpt.save(state)
        if val_interval and val_fn is not None and (it + 1) % val_interval == 0:
            logger.write(it + 1, val_fn(state), prefix="val")
        t0 += time.perf_counter() - paused
    return state
