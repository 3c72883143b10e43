"""The backbones' adapters: LoRA linear layers and Rein token banks.

Port of vfmseg_tpu/models/backbones/adapters.py:30-120 (LoRA) and
:226-328 (Rein). LoRA has two forms of ``y = x W + b + dropout(x) A B *
(alpha / r)``:

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

:class:`Reins` is the Rein adapter (reference reins.py): a learnable token
bank per layer (``Reins``: ``learnable_tokens [L, T, E]``; ``LoRAReins``:
``learnable_tokens_a [L, T, r]`` times ``learnable_tokens_b [L, r, E]``)
that refines the patch tokens after a block, and with
``link_token_to_query`` the query vector a Mask2Former head takes as its
positional queries. Parameter names follow the flax tree, so
``weights.state_dict_from_flax`` maps them as they are.
"""

from __future__ import annotations

import dataclasses
import math
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


@dataclasses.dataclass(frozen=True)
class ReinsSpec:
    """Configuration of the Rein token adapter (reference reins.py:13-34).
    ``lora_dim`` > 0 factorises the token bank (LoRAReins);
    ``apply_indices``: the blocks that get the adapter (None: every block;
    SAM: its global-attention blocks)."""

    token_length: int = 100
    query_dims: int = 256
    use_softmax: bool = True
    link_token_to_query: bool = True
    scale_init: float = 0.001
    zero_mlp_delta_f: bool = False
    lora_dim: int = 0
    apply_indices: Optional[Tuple[int, ...]] = None

    def applies_at(self, layer: int) -> bool:
        return self.apply_indices is None or layer in self.apply_indices


class Reins(nn.Module):
    """Rein adapter bank over all layers (adapters.py:242-328). Per layer:
    ``attn = softmax(x tokens^T / sqrt(E))``, ``delta =
    mlp_delta_f(attn[:, :, 1:] mlp_token2feat(tokens[1:]) + x)``, ``x +=
    scale * delta``; the cls tokens bypass it. Parameters in fp32, compute
    in ``dtype``."""

    def __init__(self, spec: ReinsSpec, num_layers: int, embed_dims: int,
                 patch_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.embed_dims = embed_dims
        self.dtype = dtype
        t, e, r = spec.token_length, embed_dims, spec.lora_dim
        # the reference init: uniform(+-sqrt(6 / (3 p^2 + d))), d = E or
        # sqrt(E r) for the factorised bank (reins.py:44-52, 134-142)
        if r > 0:
            self.token_bound = math.sqrt(6.0 / (3 * patch_size ** 2
                                                + (e * r) ** 0.5))
            self.learnable_tokens_a = nn.Parameter(torch.zeros(num_layers, t,
                                                               r))
            self.learnable_tokens_b = nn.Parameter(torch.zeros(num_layers, r,
                                                               e))
        else:
            self.token_bound = math.sqrt(6.0 / (3 * patch_size ** 2 + e))
            self.learnable_tokens = nn.Parameter(torch.zeros(num_layers, t,
                                                             e))
        if not spec.zero_mlp_delta_f:
            self.scale = nn.Parameter(torch.tensor(float(spec.scale_init)))
        self.mlp_token2feat = Dense(e, e, dtype=dtype)
        self.mlp_delta_f = Dense(e, e, dtype=dtype)
        if spec.link_token_to_query:
            self.transform = Dense(e, spec.query_dims, dtype=dtype)
            self.merge = Dense(3 * spec.query_dims, spec.query_dims,
                               dtype=dtype)

    def tokens(self, layer: Optional[int] = None) -> torch.Tensor:
        """Layer ``layer``'s fp32 tokens ``[T, E]``, or every layer's
        ``[L, T, E]``."""
        if self.spec.lora_dim > 0:
            a, b = self.learnable_tokens_a, self.learnable_tokens_b
            if layer is None:
                return torch.einsum("ltr,lrd->ltd", a, b)
            return a[layer] @ b[layer]
        t = self.learnable_tokens
        return t if layer is None else t[layer]

    def adapt(self, feats: torch.Tensor, layer: int,
              num_prefix_tokens: int = 1) -> torch.Tensor:
        """feats: [B, N, E] with ``num_prefix_tokens`` leading cls tokens,
        which pass unchanged. As in JAX, ``scale * delta`` promotes to fp32:
        the result goes back to the prefix's dtype, and with no prefix (SAM)
        stays fp32."""
        p = num_prefix_tokens
        prefix = feats[:, :p]
        x = feats[:, p:].to(self.dtype)
        tokens = self.tokens(layer).to(self.dtype)
        attn = torch.einsum("bnc,mc->bnm", x, tokens)
        if self.spec.use_softmax:
            attn = torch.softmax(attn * self.embed_dims ** -0.5, dim=-1)
        delta = torch.einsum("bnm,mc->bnc", attn[:, :, 1:],
                             self.mlp_token2feat(tokens[1:]))
        delta = self.mlp_delta_f(delta + x)
        if self.spec.zero_mlp_delta_f:
            x = x + delta
        else:
            x = x.float() + self.scale * delta.float()
        if p:
            x = torch.cat([prefix, x.to(prefix.dtype)], dim=1)
        return x

    def queries(self) -> Optional[torch.Tensor]:
        """The ``[T, query_dims]`` query vector (reins.py:61-75): the
        transformed tokens' max, mean and last over the layers, merged; None
        without ``link_token_to_query``."""
        if not self.spec.link_token_to_query:
            return None
        tokens = self.transform(self.tokens().to(self.dtype))
        pooled = torch.cat([tokens.amax(dim=0), tokens.mean(dim=0),
                            tokens[-1]], dim=-1)
        return self.merge(pooled)
