"""Optimizer construction and PEFT parameter partitioning.

Port of vfmseg_tpu/train/optim.py:26-157.

* :func:`partition` freezes the parameters that ``trainable_predicate``
  rejects (``requires_grad=False``), so autograd runs no frozen dW GEMM: the
  counterpart of taking gradients only with respect to the JAX trainable
  partition. The predicate reads the port's dotted names, where the JAX one
  reads ``/``-joined flax paths; ``backbone`` is matched as a whole path
  segment and the keywords as substrings in both, so the two select the same
  set.
* :func:`decays` is ``decay_mask``'s rule, applied to the flax path of the
  parameter (``weights.flax_name``): rank >= 2 and no ``NO_DECAY_KEYWORDS``.
* :func:`make_optimizer` is ``torch.optim.AdamW`` over the trainable
  parameters in a decay and a no-decay group. Its decoupled decay
  ``p * (1 - lr * wd)`` followed by the Adam step equals optax's ``adamw``.
* :func:`poly_schedule` is PolyLR with the optional linear warmup; the train
  step reads it at the step count before the update, as optax does.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import torch
from torch import nn

from vfmseg_tpu_torch.weights import flax_name

NO_DECAY_KEYWORDS: Tuple[str, ...] = (
    "norm", "_gn", "_bn", "bn/", "learnable_tokens", "reins/scale",
    "query_embed", "level_embed", "pos_embed", "cls_token", "mask_token",
)
ADAPTER_KEYWORDS: Tuple[str, ...] = ("lora", "reins", "fpn")
WARMUP_START = 1e-6  # warmup's first learning-rate factor


def trainable_predicate(peft: bool = True,
                        adapter_keywords: Iterable[str] = ADAPTER_KEYWORDS
                        ) -> Callable[[str], bool]:
    """Name -> bool. With peft=True, backbone parameters train only if they
    are adapter parameters (``lora_a``/``lora_b``/...); the heads train."""
    adapter_keywords = tuple(adapter_keywords)

    def pred(name: str) -> bool:
        if peft and "backbone" in name.split("."):
            return any(k in name for k in adapter_keywords)
        return True

    return pred


def partition(model: nn.Module, pred: Callable[[str], bool]
              ) -> List[Tuple[str, nn.Parameter]]:
    """Set ``requires_grad`` by ``pred``; return the trainable (name,
    parameter) pairs in module order."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(pred(name))
        if p.requires_grad:
            trainable.append((name, p))
    return trainable


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays parameter ``name`` (``decay_mask``'s rule)."""
    path = flax_name(name, p.dim())
    return p.dim() >= 2 and not any(s in path for s in NO_DECAY_KEYWORDS)


def poly_schedule(base_lr: float, power: float = 0.9, max_steps: int = 40000,
                  warmup_steps: int = 0) -> Callable[[int], float]:
    """PolyLR (power 0.9 over max_steps, down to 0) with optional linear
    warmup from 1e-6 x (configs/_base_/schedules/schedule_40k.py:1-11)."""

    def sched(step: int) -> float:
        frac = min(max(step / max_steps, 0.0), 1.0)
        lr = base_lr * (1.0 - frac) ** power
        if warmup_steps > 0:
            wfrac = min(max(step / warmup_steps, 0.0), 1.0)
            lr *= WARMUP_START + (1.0 - WARMUP_START) * wfrac
        return lr

    return sched


def make_optimizer(
    trainable: List[Tuple[str, nn.Parameter]],
    base_lr: float = 1e-4,
    weight_decay: float = 0.05,
    max_steps: int = 40000,
    power: float = 0.9,
    warmup_steps: int = 0,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over the trainable (name, parameter) pairs, and its PolyLR."""
    decay = [p for n, p in trainable if decays(n, p)]
    no_decay = [p for n, p in trainable if not decays(n, p)]
    groups = [g for g in (dict(params=decay, weight_decay=weight_decay),
                          dict(params=no_decay, weight_decay=0.0))
              if g["params"]]
    optimizer = torch.optim.AdamW(groups, lr=base_lr, betas=betas, eps=eps)
    return optimizer, poly_schedule(base_lr, power, max_steps,
                                    warmup_steps=warmup_steps)
