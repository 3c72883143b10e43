"""The train step.

Port of vfmseg_tpu/train/step.py:21-72. One step ``(state, batch, seed) ->
(state, metrics)``: the two-scale forward in training mode, the total loss
(the sum of the entries whose key contains ``"loss"``, mmengine's
parse_losses), backward, the global L2 norm of the trainable gradients,
PolyLR read at the step count before the update, and the AdamW update. The
state is updated in place and returned.

Randomness: per step, one ``torch.Generator`` per stream name, seeded from
(seed, step, index of the name) as ``fold_in`` seeds the JAX step's keys, so
a resumed run draws what an unbroken one draws. ``crop`` lives on the CPU
(the box is needed on the host); ``mask`` and ``dropout`` live on the
model's device. Gradients stay in ``.grad`` until the next step clears them.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.train.state import TrainState

RNG_NAMES: Tuple[str, ...] = ("crop", "mask", "dropout")
HOST_STREAMS = ("crop",)


def sum_losses(losses: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return sum(v for k, v in losses.items() if "loss" in k)


def step_generators(seed: int, step: int,
                    device: torch.device) -> Dict[str, torch.Generator]:
    """One generator per stream, seeded from (seed, step, stream index)."""
    gens = {}
    for i, name in enumerate(RNG_NAMES):
        s = np.random.SeedSequence([seed, step, i]).generate_state(
            1, np.uint64)[0]
        dev = torch.device("cpu") if name in HOST_STREAMS else device
        gens[name] = torch.Generator(device=dev).manual_seed(int(s))
    return gens


def make_train_step() -> Callable:
    """Build the train step for a segmentor whose ``forward(img, labels)``
    returns a loss dict."""

    def train_step(state: TrainState, batch: Mapping, seed: int
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        img = torch.as_tensor(batch["img"]).to(device, non_blocking=True)
        label = torch.as_tensor(batch["label"]).to(device, non_blocking=True)
        model.train()
        opt.zero_grad(set_to_none=True)
        with rng.streams(step_generators(seed, state.step, device)):
            losses = model(img, label)
        loss = sum_losses(losses)
        loss.backward()
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
