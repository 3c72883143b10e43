"""The train step.

Port of vfmseg_tpu/train/step.py:21-72. One step ``(state, batch, seed) ->
(state, metrics)``: the two-scale forward in training mode, the total loss
(the sum of the entries whose key contains ``"loss"``, mmengine's
parse_losses), backward, the global L2 norm of the trainable gradients,
PolyLR read at the step count before the update, and the AdamW update. The
state is updated in place and returned.

Randomness: per step, one ``torch.Generator`` per stream name, seeded from
(seed, step, index of the name) as ``fold_in`` seeds the JAX step's keys, so
a resumed run draws what an unbroken one draws. ``crop`` and ``augment``
live on the CPU (the box is needed on the host; every augment draw is a
scalar or a tiny array, so the card and the CPU draw the same numbers from
one seed); ``mask`` and ``dropout`` live on the model's device. Gradients stay in ``.grad`` until the next step clears them.

Data parallelism (``parallel/mesh.py``): each rank runs the step on its
rows of the global batch with the streams seeded as one process seeds them
(``rng.streams`` takes the rank and the world size, and per-sample draws
keep the rank's rows of the global draw); the trainable gradients are then
averaged over the group before the norm is taken, so ``grad_norm`` and the
update are the global batch's, and the logged losses are averaged too.
With no process group nothing is reduced.

A trainable parameter that the loss does not reach (a Rein backbone's
query layers under a head that takes no queries: HRDA, SegFormer,
LinearHead) gets a zero gradient, as ``jax.grad`` gives one, so AdamW
decays it as optax's does instead of skipping it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.parallel import mesh
from vfmseg_tpu_torch.train.state import TrainState

RNG_NAMES: Tuple[str, ...] = ("crop", "mask", "dropout", "augment")
HOST_STREAMS = ("crop", "augment")


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


def reduced_gradients(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The optimizer's gradients, a zero one where the loss left none, each
    averaged over the data group; returned in the optimizer's order."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.average_gradients(params)
    return [p.grad for p in params]


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
        with rng.streams(step_generators(seed, state.step, device),
                         mesh.rank(), mesh.world_size()):
            losses = model(img, label)
        loss = sum_losses(losses)
        loss.backward()
        grads = reduced_gradients(opt)
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics = mesh.average_losses(metrics)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
