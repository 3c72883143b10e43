"""Weights for the port: from a JAX parameter tree, or seeded.

* :func:`state_dict_from_flax` maps the JAX package's variables
  ``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy arrays) onto
  the port's ``state_dict``: Dense ``[in, out]`` -> ``[out, in]``, Conv HWIO
  -> OIHW, ConvTranspose ``[kh, kw, in, out]`` -> ``[in, out, kh, kw]`` with
  the kh/kw flip (PARITY.md, "Transcription note"), LayerNorm/GroupNorm/
  BatchNorm ``scale`` -> ``weight`` (Rein's scalar ``scale`` keeps its
  name), BatchNorm ``mean``/``var`` -> running
  statistics, LoRA ``lora_a [in, r]``/``lora_b [r, out]`` -> ``[r, in]``/
  ``[out, r]``, and ``blocks_<i>`` -> ``blocks.<i>``. It takes the training
  init's tree too (with the decoder's ``mask_token``).
* :func:`flax_from_state_dict` is its inverse for any subset of the
  parameters and BatchNorm statistics (checkpoints, gradients);
  :func:`flax_name` gives one port name's flax path.
* :func:`init_params` fills a model from a seed through ``torch.Generator``,
  with LoRA B, the BatchNorm statistics, SAM's rel-pos tables and the
  kernels of Mask2Former's ``sampling_offsets`` and ``attention_weights``
  (zero at the JAX init) non-zero and LayerScale well above its 1e-5 init,
  so that no branch is trivially zero and deformable samples depend on the
  query. Mask2Former's level embeddings and queries are drawn N(0, 1), its
  fused attention in-projection as a linear's. Rein's parameters take the
  reference's initialisers: the token banks uniform in +-``token_bound``,
  ``scale`` at ``scale_init``, ``mlp_token2feat`` and ``mlp_delta_f``
  kaiming-uniform (a = sqrt(5): +-1/sqrt(fan_in); zeros for
  ``mlp_delta_f`` with ``zero_mlp_delta_f``). The draws are made on the
  CPU and copied to the model's device, so a seed gives the same weights on
  any device.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from vfmseg_tpu_torch.models.backbones.adapters import LoRALinear, Reins
from vfmseg_tpu_torch.models.backbones.vit import (
    Attention,
    LayerScale,
    VisionTransformer,
)
from vfmseg_tpu_torch.models.heads.mask2former import (
    Mask2FormerHead,
    MSDeformAttnPixelDecoder,
    TorchMHA,
)
from vfmseg_tpu_torch.models.heads.transformer import TransformerDecoder
from vfmseg_tpu_torch.ops.norm import LayerNorm

# flax modules whose 4-D kernel is a ConvTranspose (LinearHead's upsamplers)
_CONV_TRANSPOSE = {"up1", "up2"}
_INDEXED = re.compile(r"^(blocks|block)_(\d+)$")
_PORT_INDEXED = re.compile(r"(^|\.)(blocks|block)\.(\d+)(?=\.)")
_STATS = {"running_mean": "mean", "running_var": "var"}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), np.asarray(val)


def _join(mods: Tuple[str, ...], name: str) -> str:
    return ".".join([_INDEXED.sub(r"\1.\2", p) for p in mods] + [name])


def _param(path: Tuple[str, ...], leaf: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, name = path
    if name == "kernel":
        if leaf.ndim == 2:
            return "weight", leaf.T
        if leaf.ndim == 4 and mods and mods[-1] in _CONV_TRANSPOSE:
            return "weight", leaf[::-1, ::-1].transpose(2, 3, 0, 1)
        if leaf.ndim == 4:
            return "weight", leaf.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {leaf.ndim} at {'/'.join(path)}")
    if name in ("lora_a", "lora_b"):
        return name, leaf.T
    if name == "scale" and leaf.ndim:
        return "weight", leaf
    return name, leaf


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX variables tree (see module doc)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree.get("params", {})):
        name, value = _param(path, leaf)
        out[_join(path[:-1], name)] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    for path, leaf in _leaves(tree.get("batch_stats", {})):
        stat = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        out[_join(path[:-1], stat)] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
        out[_join(path[:-1], "num_batches_tracked")] = torch.tensor(0)
    return out


def flax_name(name: str, ndim: int) -> str:
    """The flax path (``/``-joined) of the port parameter or BatchNorm
    buffer ``name`` of rank ``ndim``: ``backbone.blocks.0.attn.qkv.weight``
    -> ``backbone/blocks_0/attn/qkv/kernel``."""
    mods, _, leaf = _PORT_INDEXED.sub(r"\1\2_\3", name).rpartition(".")
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    leaf = _STATS.get(leaf, leaf)
    return "/".join(mods.split(".") + [leaf] if mods else [leaf])


def _flax_value(path: str, value: np.ndarray) -> np.ndarray:
    """Undo :func:`_param`'s re-orientation for the leaf at ``path``."""
    *mods, leaf = path.split("/")
    if leaf == "kernel" and value.ndim == 2:
        return value.T
    if (leaf == "kernel" and value.ndim == 4 and mods
            and mods[-1] in _CONV_TRANSPOSE):
        return value.transpose(2, 3, 0, 1)[::-1, ::-1]
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    if leaf in ("lora_a", "lora_b"):
        return value.T
    return value


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """``{"params": ..., "batch_stats": ...}`` nested dicts of fp32 numpy
    arrays in the flax layout, for the entries of ``sd`` (any subset of a
    port ``state_dict``; ``num_batches_tracked`` is dropped). The inverse of
    :func:`state_dict_from_flax`."""
    params, stats = {}, {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        value = t.detach().float().cpu().numpy()
        path = flax_name(name, value.ndim)
        dst = stats if name.rsplit(".", 1)[-1] in _STATS else params
        # order="C", not ascontiguousarray: that makes 0-d arrays (Rein's
        # scale) 1-d
        dst[path] = np.asarray(_flax_value(path, value), order="C")
    return {"params": _nest(params), "batch_stats": _nest(stats)}


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of ``model`` from
    ``seed``; the same seed gives the same weights on any device."""
    gen = torch.Generator().manual_seed(seed)
    done = set()

    def normal(p, std, mean=0.0):
        p.copy_(torch.randn(p.shape, generator=gen) * std + mean)
        done.add(id(p))

    def uniform(p, lo, hi):
        p.copy_(torch.rand(p.shape, generator=gen) * (hi - lo) + lo)
        done.add(id(p))

    kaiming = {}  # id(linear) -> bound of its uniform weight

    for mod in model.modules():
        if isinstance(mod, Reins):
            for name in ("learnable_tokens", "learnable_tokens_a",
                         "learnable_tokens_b"):
                if hasattr(mod, name):
                    uniform(getattr(mod, name), -mod.token_bound,
                            mod.token_bound)
            if hasattr(mod, "scale"):
                mod.scale.fill_(mod.spec.scale_init)
                done.add(id(mod.scale))
            kaiming[id(mod.mlp_token2feat)] = mod.embed_dims ** -0.5
            kaiming[id(mod.mlp_delta_f)] = (0.0 if mod.spec.zero_mlp_delta_f
                                            else mod.embed_dims ** -0.5)
        if id(mod) in kaiming:
            uniform(mod.weight, -kaiming[id(mod)], kaiming[id(mod)])
        elif isinstance(mod, nn.Linear):
            normal(mod.weight, mod.in_features ** -0.5)
        elif isinstance(mod, nn.Conv2d):
            normal(mod.weight, math.prod(mod.weight.shape[1:]) ** -0.5)
        elif isinstance(mod, nn.ConvTranspose2d):
            normal(mod.weight, mod.in_channels ** -0.5)
        elif isinstance(mod, (LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            normal(mod.weight, 0.1, mean=1.0)
        if isinstance(mod, LoRALinear):
            bound = mod.in_features ** -0.5
            uniform(mod.lora_a, -bound, bound)
            normal(mod.lora_b, 0.1 * math.sqrt(3.0 / mod.rank))
        if isinstance(mod, nn.BatchNorm2d):
            normal(mod.running_mean, 0.1)
            uniform(mod.running_var, 0.5, 1.5)
        if isinstance(mod, LayerScale):
            normal(mod.gamma, 0.02, mean=0.1)
        if isinstance(mod, VisionTransformer):
            if mod.cls_token is not None:
                normal(mod.cls_token, 0.02)
            normal(mod.pos_embed, 0.02)
        if isinstance(mod, Attention) and mod.rel_pos_h is not None:
            normal(mod.rel_pos_h, 0.1)
            normal(mod.rel_pos_w, 0.1)
        if isinstance(mod, TransformerDecoder) and hasattr(mod, "mask_token"):
            normal(mod.mask_token, 1.0)
        if isinstance(mod, TorchMHA):
            normal(mod.in_proj_kernel, mod.in_proj_kernel.shape[0] ** -0.5)
            normal(mod.in_proj_bias, 0.02)
        if isinstance(mod, (Mask2FormerHead, MSDeformAttnPixelDecoder)):
            for name in ("level_embed", "query_embed", "query_feat"):
                if hasattr(mod, name):
                    normal(getattr(mod, name), 1.0)
        bias = getattr(mod, "bias", None)
        if isinstance(bias, nn.Parameter):
            normal(bias, 0.1 if isinstance(
                mod, (LayerNorm, nn.GroupNorm, nn.BatchNorm2d)) else 0.02)
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise ValueError(f"init_params does not cover {missed}")
    return model
