"""LoRA linear layers.

Port of the LoRA half of vfmseg_tpu/models/backbones/adapters.py:30-120.
Two forms of ``y = x W + b + dropout(x) A B * (alpha / r)``:

* folded, for inference: the low-rank update is folded into the base weight
  in fp32 and cast once to the compute dtype, as the JAX ``LoRADense`` does
  on its dropout-free path (adapters.py:69-94);
* sequential, in training mode or whenever autograd may differentiate the
  LoRA factors (adapters.py:95-108): the fold is cached outside autograd, so
  trained through it ``lora_a``/``lora_b`` would get no gradient. LoRA
  dropout acts on x before A, in training mode only.

Parameters follow the torch (peft) orientation: ``weight`` [out, in],
``lora_a`` [r, in], ``lora_b`` [out, r].

The reference configs name LoRA targets in each family's own module names;
:func:`normalize_lora_targets` maps them onto the ViT's (the port's copy of
vfmseg_tpu/models/backbones/clip.py:25-38).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Dense


# reference target_modules name -> the ViT's linear name (CLIP uses
# out_proj/c_fc/c_proj, EVA02 attn.proj, SAM configs lin1/lin2)
LORA_TARGET_ALIASES = {
    "out_proj": "proj",
    "attn.proj": "proj",
    "mlp.c_fc": "fc1",
    "mlp.c_proj": "fc2",
    "lin1": "fc1",
    "lin2": "fc2",
}


def normalize_lora_targets(targets: Sequence[str]) -> Tuple[str, ...]:
    return tuple(LORA_TARGET_ALIASES.get(t, t) for t in targets)


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """Which linears get LoRA and with what shape (reference Lora_config)."""

    rank: int = 0
    alpha: float = 1.0
    dropout: float = 0.0
    targets: Tuple[str, ...] = ()  # linear module names, e.g. ("qkv",)

    def applies_to(self, name: str) -> bool:
        return self.rank > 0 and name in self.targets


class LoRALinear(Dense):
    """Dense layer plus a low-rank update, folded or sequential."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 rank: int = 1, alpha: float = 1.0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.rank = rank
        self.scaling = alpha / rank
        self.dropout = dropout
        self.lora_a = nn.Parameter(torch.zeros(rank, in_features))
        self.lora_b = nn.Parameter(torch.zeros(out_features, rank))
        self._folded: Optional[torch.Tensor] = None
        self._folded_key = None

    def folded_weight(self) -> torch.Tensor:
        """``W + (alpha / r) B A`` in fp32, cast once to the compute dtype.

        Cached until a parameter is written in place (loading a state dict),
        moved, or the compute dtype changes."""
        params = (self.weight, self.lora_a, self.lora_b)
        key = (self.dtype,) + tuple((p.device, p.data_ptr(), p._version)
                                    for p in params)
        if key != self._folded_key:
            with torch.no_grad():
                w = (self.weight.float()
                     + (self.lora_b.float() @ self.lora_a.float())
                     * self.scaling)
                self._folded = w.to(self.dtype)
            self._folded_key = key
        return self._folded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        lora_grad = torch.is_grad_enabled() and (self.lora_a.requires_grad
                                                 or self.lora_b.requires_grad)
        if not (self.training or lora_grad):
            bias = None if self.bias is None else self.bias.to(self.dtype)
            return F.linear(x, self.folded_weight(), bias)
        y = super().forward(x)
        xd = rng.dropout(x, self.dropout, self.training)
        low = F.linear(F.linear(xd, self.lora_a.to(self.dtype)),
                       self.lora_b.to(self.dtype))
        return y + low * self.scaling


def make_dense(in_features: int, out_features: int, bias: bool, name: str,
               lora: Optional[LoRASpec], dtype: torch.dtype) -> Dense:
    """A Dense, or a LoRALinear where ``lora`` targets ``name``."""
    if lora is not None and lora.applies_to(name):
        return LoRALinear(in_features, out_features, bias=bias,
                          rank=lora.rank, alpha=lora.alpha,
                          dropout=lora.dropout, dtype=dtype)
    return Dense(in_features, out_features, bias=bias, dtype=dtype)
