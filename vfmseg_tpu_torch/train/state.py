"""Train state: the model (which holds the trainable and frozen parameters
and the BatchNorm statistics), its optimizer, the learning-rate schedule and
the step count.

Port of vfmseg_tpu/train/state.py. The JAX ``TrainState`` splits the
parameters into trainable and frozen trees beside ``batch_stats`` and
``opt_state``; here the module holds them, ``requires_grad`` marks the
trainable ones (``train/optim.py``), and the optimizer holds the moments.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from vfmseg_tpu_torch.train.optim import (
    ADAPTER_KEYWORDS,
    make_optimizer,
    partition,
    trainable_predicate,
)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: nn.Module, cfg: dict,
                       max_iters: Optional[int] = None) -> TrainState:
    """Partition ``model`` by the config's ``peft`` section and build AdamW
    + PolyLR over the trainable part from its ``optimizer`` section and
    ``max_iters`` (default ``schedule.max_iters``), as tools/train.py:116-132
    does for the JAX package."""
    peft = cfg.get("peft", {})
    pred = trainable_predicate(
        peft=peft.get("enabled", True),
        adapter_keywords=tuple(peft.get("adapter_keywords",
                                        ADAPTER_KEYWORDS)))
    o = cfg.get("optimizer", {})
    optimizer, schedule = make_optimizer(
        partition(model, pred), base_lr=o.get("lr", 1e-4),
        weight_decay=o.get("weight_decay", 0.05),
        max_steps=max_iters or cfg.get("schedule", {}).get("max_iters",
                                                           40000),
        power=o.get("poly_power", 0.9),
        warmup_steps=o.get("warmup_steps", 0),
        betas=tuple(o.get("betas", (0.9, 0.999))), eps=o.get("eps", 1e-8))
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)
