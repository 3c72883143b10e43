"""Seeded weights, made on the device in a few large draws.

The tensors are named and shaped by the reference model's state dict,
which is the program's (``reference/model.py``), and drawn as the program's
own seeded initialisation draws them, so that no branch is trivially zero:
linear and convolution weights N(0, 1/fan_in), LoRA's A uniform in
+-1/sqrt(in) and B N(0, 0.1^2 * 3 / r), norm scales N(1, 0.1^2) and their
shifts N(0, 0.1^2), other biases N(0, 0.02^2), LayerScale N(0.1, 0.02^2),
the cls token and position embedding N(0, 0.02^2), the decoder's mask token
N(0, 1), BatchNorm's running mean N(0, 0.1^2) and variance U(0.5, 1.5).

Two draws on the card (one normal, one uniform) from one
``torch.Generator``, sliced per tensor: the same seed gives the same
tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from cardbench.reference import model as ref


def mix_seed(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size."""
    state = np.random.SeedSequence([int(p) & (2 ** 64 - 1) for p in parts])
    return int(state.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def _rules(model: nn.Module) -> List[Tuple[str, tuple, str, float, float]]:
    """(name, shape, "normal" / "uniform" / "zero", scale, shift) for every
    state-dict entry of the reference model."""
    out = []
    for mod_name, mod in model.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            shape = tuple(t.shape)
            full = pre + name
            if isinstance(mod, ref.Linear):
                if name == "weight":
                    rule = ("normal", shape[1] ** -0.5, 0.0)
                elif name == "lora_a":
                    rule = ("uniform", 2 * shape[1] ** -0.5,
                            -shape[1] ** -0.5)
                elif name == "lora_b":
                    rule = ("normal", 0.1 * (3.0 / shape[1]) ** 0.5, 0.0)
                else:
                    rule = ("normal", 0.02, 0.0)
            elif isinstance(mod, ref.Conv):
                rule = (("normal", float(np.prod(shape[1:])) ** -0.5, 0.0)
                        if name == "weight" else ("normal", 0.02, 0.0))
            elif isinstance(mod, ref.ConvT):
                rule = (("normal", shape[0] ** -0.5, 0.0)
                        if name == "weight" else ("normal", 0.02, 0.0))
            elif isinstance(mod, (ref.Norm, ref.GroupNorm, ref.BatchNorm)):
                rule = {"weight": ("normal", 0.1, 1.0),
                        "bias": ("normal", 0.1, 0.0),
                        "running_mean": ("normal", 0.1, 0.0),
                        "running_var": ("uniform", 1.0, 0.5),
                        "num_batches_tracked": ("zero", 0.0, 0.0)}[name]
            elif name == "gamma":
                rule = ("normal", 0.02, 0.1)
            elif name in ("cls_token", "pos_embed"):
                rule = ("normal", 0.02, 0.0)
            elif name == "mask_token":
                rule = ("normal", 1.0, 0.0)
            else:
                raise ValueError(f"no rule for {full}")
            out.append((full, shape) + rule)
    return out


def make(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (fp32; an int64 count for BatchNorm) of the
    configuration's model from ``seed``, on ``device``."""
    rules = _rules(ref.build(model_cfg, "meta"))
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(int(np.prod(s)) for _, s, k, _, _ in rules if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device)}
    at = {"normal": 0, "uniform": 0}
    sd = {}
    for name, shape, kind, scale, shift in rules:
        if kind == "zero":
            sd[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = int(np.prod(shape))
        t = pools[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        sd[name] = t * scale + shift
    return sd


def scale_classifier(sd: Dict[str, torch.Tensor], scale: float,
                     key: str = "decode_head.conv_seg") -> None:
    """Multiply the decode head's classifier (weight and bias) by
    ``scale``: its logits, and so the gate's confidence, scale with it."""
    for leaf in ("weight", "bias"):
        sd[f"{key}.{leaf}"] = sd[f"{key}.{leaf}"] * scale
