"""Seeded weights of ``rein_m2f``, made on the device in one draw.

The tensors are named and shaped by the reference model's state dict
(``reference/rein_m2f.py``), which is the program's, and drawn by the
scheme of ``weights.py`` (whose uniform draw no rule here needs): one
normal draw from one ``torch.Generator``, sliced per tensor, so the same
seed gives the same tensors. Every kind of layer ``weights.py`` covers
takes its rule there: linear and convolution weights N(0, 1/fan_in), norm
scales N(1, 0.1^2) and shifts N(0, 0.1^2), other biases N(0, 0.02^2),
LayerScale N(0.1, 0.02^2), the cls token and position embedding
N(0, 0.02^2). The rest:

* Rein's token factors: ``learnable_tokens_a`` [L, T, r] N(0, 1), an
  embedding table like the head's query embedding that the tokens stand
  in for (mmdet's ``nn.Embedding``), and ``learnable_tokens_b`` [L, r, E]
  N(0, 1/r), a linear map from rank r by the linear rule, so the tokens'
  entries are N(0, 1). The published LoRAReins init (uniform in
  +-sqrt(6 / (3 p^2 + sqrt(E r))) for both) gives entries near 0.009 and
  a hundred queries close to one another, whose masks' all-masked-row
  decisions then flip together under rounding: on an H100 the bf16
  program's scores read 6.7 and 12.9 times the bf16-rounded reference's
  distance from the float32 reference on 2 of 29 seeds (a float8 control
  reads at least 13.3), against at most 2.40 over 29 seeds with these
  factors (``check_slide.py``);
* Rein's ``scale``, a scalar on a residual branch as LayerScale is:
  LayerScale's N(0.1, 0.02^2) (the published 0.001 would leave the
  adapters' update a thousandth of the tokens');
* the multi-head attention's in-projection ``[C, 3C]``: N(0, 1/C), its bias
  N(0, 0.02^2);
* the level embeddings: N(0, 1), as mmdet's ``nn.Embedding`` and the
  pixel decoder's ``normal_init`` draw them.

The deformable layers' ``sampling_offsets`` and ``attention_weights`` are
linears, so their weights are drawn non-zero and every sample depends on
its query (the published init zeroes both weights).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from cardbench.reference import model as ref
from cardbench.reference import rein_m2f


def _rules(model: nn.Module) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, shift) of a normal draw for every state-dict
    entry of the reference model."""
    out = []
    for mod_name, mod in model.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        for name, t in mod.named_parameters(recurse=False):
            shape = tuple(t.shape)
            if isinstance(mod, ref.Linear):
                rule = ((shape[1] ** -0.5, 0.0) if name == "weight"
                        else (0.02, 0.0))
            elif isinstance(mod, (ref.Conv, rein_m2f.Conv)):
                rule = ((float(np.prod(shape[1:])) ** -0.5, 0.0)
                        if name == "weight" else (0.02, 0.0))
            elif isinstance(mod, (ref.Norm, ref.GroupNorm)):
                rule = {"weight": (0.1, 1.0), "bias": (0.1, 0.0)}[name]
            elif isinstance(mod, rein_m2f.Reins):
                rule = {"scale": (0.02, 0.1), "learnable_tokens_a": (1.0, 0.0),
                        "learnable_tokens_b": (mod.rank ** -0.5, 0.0)}[name]
            elif isinstance(mod, rein_m2f.MHA):
                rule = ((shape[0] ** -0.5, 0.0)
                        if name == "in_proj_kernel" else (0.02, 0.0))
            elif name == "gamma":
                rule = (0.02, 0.1)
            elif name in ("cls_token", "pos_embed"):
                rule = (0.02, 0.0)
            elif name == "level_embed":
                rule = (1.0, 0.0)
            else:
                raise ValueError(f"no rule for {pre + name}")
            out.append((pre + name, shape) + rule)
    return out


def make(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The fp32 state dict of the configuration's model from ``seed``, on
    ``device``."""
    rules = _rules(rein_m2f.build(model_cfg, "meta"))
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(sum(int(np.prod(s)) for _, s, _, _ in rules),
                       generator=gen, device=device)
    sd, at = {}, 0
    for name, shape, scale, shift in rules:
        n = int(np.prod(shape))
        sd[name] = pool[at:at + n].reshape(shape) * scale + shift
        at += n
    return sd
