"""The plain reference's train step: the two-scale losses in float32,
autograd, and AdamW with PolyLR, written from their equations.

Each step draws from its own generators, one a stream, seeded from (seed,
step, the stream's index) through ``numpy.random.SeedSequence``: ``crop``
on the CPU, ``mask`` and ``dropout`` on the model's device, as the
configuration's training semantics state them. Only LoRA's factors and
the heads train. AdamW decays the trainable tensors of rank 2 and more but
the decoder's mask token, by ``lr * weight_decay`` before the Adam step,
with bias-corrected moments, at PolyLR's rate for the step count before
the update.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cardbench.reference import model as ref

STREAMS = ("crop", "mask", "dropout", "augment")
HOST_STREAMS = ("crop", "augment")
NO_DECAY = ("norm", "_gn", "_bn", "pos_embed", "cls_token", "mask_token")


def generators(seed: int, step: int, device) -> Dict[str, torch.Generator]:
    gens = {}
    for i, name in enumerate(STREAMS):
        s = np.random.SeedSequence([seed, step, i]).generate_state(
            1, np.uint64)[0]
        dev = torch.device("cpu") if name in HOST_STREAMS else device
        gens[name] = torch.Generator(device=dev).manual_seed(int(s))
    return gens


def trainable(name: str, adapter_keywords=("lora",)) -> bool:
    """PEFT: backbone tensors train only if they are adapters."""
    if "backbone" in name.split("."):
        return any(k in name for k in adapter_keywords)
    return True


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 and not any(k in name for k in NO_DECAY)


def poly_lr(cfg: Dict, step: int) -> float:
    o = cfg["optimizer"]
    frac = min(max(step / cfg["schedule"]["max_iters"], 0.0), 1.0)
    return o["lr"] * (1.0 - frac) ** o["poly_power"]


class Trainer:
    """The reference model in training, with its own AdamW state."""

    def __init__(self, cfg: Dict, state: Dict[str, torch.Tensor], device,
                 fp8: bool = False):
        self.cfg = cfg
        self.fp8 = fp8
        self.model = ref.build(cfg["model"], device)
        self.model.load_state_dict(state, strict=True)
        kw = tuple(cfg.get("peft", {}).get("adapter_keywords", ("lora",)))
        self.params = {n: p for n, p in self.model.named_parameters()
                       if trainable(n, kw)}
        for n, p in self.model.named_parameters():
            p.requires_grad_(n in self.params)
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    def step(self, batch: Dict, seed: int) -> Dict:
        """One step; returns its losses and each trainable tensor's
        gradient."""
        m = self.cfg["model"]
        dev = batch["img"].device
        pr = ref.Products(fp8=self.fp8,
                          gens=generators(seed, self.t, dev))
        losses = self.model.train_losses(
            batch["img"].float(), batch["label"], pr,
            m.get("hr_crop_size", (512, 512)),
            int(m.get("crop_coord_divisible", 32)),
            float(m.get("detail_loss", 1.0)))
        loss = sum(losses.values())
        grads = torch.autograd.grad(loss, list(self.params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(self.params.items(), grads)}
        self._adamw(grads, poly_lr(self.cfg, self.t))
        self.t += 1
        out = {k: float(v.detach()) for k, v in losses.items()}
        out["loss"] = float(loss.detach())
        return dict(losses=out, grads=grads)

    @torch.no_grad()
    def _adamw(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        o = self.cfg["optimizer"]
        b1, b2 = o["betas"]
        t = self.t + 1
        for n, p in self.params.items():
            g = grads[n]
            if decays(n, p):
                p.mul_(1.0 - lr * o["weight_decay"])
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[n] / (1 - b1 ** t)
            vhat = self.v[n] / (1 - b2 ** t)
            p.sub_(lr * mhat / (vhat.sqrt() + o["eps"]))


def run(cfg: Dict, state: Dict[str, torch.Tensor], batches: List[Dict],
        seed: int, steps: int, fp8: bool = False) -> Dict:
    """``steps`` reference steps from ``state`` on ``batches``: each step's
    losses, the first step's gradients, and each trainable tensor's change
    over the steps."""
    tr = Trainer(cfg, state, batches[0]["img"].device, fp8)
    start = {n: p.detach().clone() for n, p in tr.params.items()}
    losses, first = [], None
    for k in range(steps):
        got = tr.step(batches[k], seed)
        losses.append(got["losses"])
        if k == 0:
            first = {n: g.detach().clone() for n, g in got["grads"].items()}
    change = {n: (p.detach() - start[n]) for n, p in tr.params.items()}
    return dict(losses=losses, grads=first, change=change)
