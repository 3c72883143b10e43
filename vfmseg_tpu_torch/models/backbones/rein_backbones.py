"""Rein-adapter backbone builders (the reference's Reins* family).

Port of vfmseg_tpu/models/backbones/rein_backbones.py:33-103: the Rein
wrappers are the ViT core of ``vit.py`` with a :class:`ReinsSpec`.

* ``ReinsDinoVisionTransformer``: Rein after every block, returns (4 maps,
  query vector) (reins_dinov2.py:22-34); ``resize_feat`` off by default.
* ``ReinsEVA2``: the same, the x4/x2/x1/x0.5 pyramid on by default
  (reins_eva_02.py:36-55).
* ``ReinsSAMViT``: Rein only after the global-attention blocks
  (reins_sam_vit.py:27-37), the pyramid on by default.
* ``ReinsCLIPVisionTransformer``: Rein after every block of CLIP and the
  fpn1..4 pyramid (``ClipFPN``) on the four maps (reins_clip.py:53-60), as
  :class:`ReinsCLIPWithFPN`, whose ``vit`` and ``fpn`` follow the flax
  tree. Its configs train ``["reins", "fpn"]`` (reins_clip.py:87-90). As in
  JAX, a ``resize_feat`` in the config reaches the ViT too, which then
  resizes its maps before the pyramid does (the Rein-CLIP Mask2Former base
  asks for it).

``init_cfg`` names the reference's pretrained file, which the weight tooling
loads, not the builder. Adapter-only training falls out of the trainable
partition: the ``reins`` keyword selects exactly these parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from vfmseg_tpu_torch.models.backbones.adapters import ReinsSpec
from vfmseg_tpu_torch.models.backbones.clip import ClipFPN, build_clip
from vfmseg_tpu_torch.models.backbones.dinov2 import build_dinov2
from vfmseg_tpu_torch.models.backbones.eva02 import build_eva02
from vfmseg_tpu_torch.models.backbones.sam import build_sam
from vfmseg_tpu_torch.models.backbones.vit import VisionTransformer

_REINS_KEYS = {"type", "token_length", "query_dims", "use_softmax",
               "link_token_to_query", "scale_init", "zero_mlp_delta_f",
               "lora_dim"}


def reins_spec_from_config(reins_config: Optional[Dict[str, Any]],
                           apply_indices: Optional[Sequence[int]] = None
                           ) -> ReinsSpec:
    """A reference ``reins_config`` dict (``type`` Reins or LoRAReins) ->
    :class:`ReinsSpec`; ``lora_dim`` (default 16) counts for LoRAReins
    only, as in JAX. A key the JAX function does not read raises."""
    rc = dict(reins_config or {})
    unknown = set(rc) - _REINS_KEYS
    if unknown:
        raise TypeError(f"reins_config keys {sorted(unknown)} are not "
                        f"ported")
    kind = rc.pop("type", "Reins")
    if kind not in ("Reins", "LoRAReins"):
        raise NotImplementedError(f"reins type {kind!r} is not ported")
    return ReinsSpec(
        token_length=rc.get("token_length", 100),
        query_dims=rc.get("query_dims", 256),
        use_softmax=rc.get("use_softmax", True),
        link_token_to_query=rc.get("link_token_to_query", True),
        scale_init=rc.get("scale_init", 0.001),
        zero_mlp_delta_f=rc.get("zero_mlp_delta_f", False),
        lora_dim=rc.get("lora_dim", 16) if kind == "LoRAReins" else 0,
        apply_indices=(None if apply_indices is None
                       else tuple(apply_indices)),
    )


def build_reins_dinov2(reins_config: Dict[str, Any],
                       resize_feat: bool = False, init_cfg=None,
                       **backbone_kwargs) -> VisionTransformer:
    del init_cfg
    return build_dinov2(**backbone_kwargs,
                        reins=reins_spec_from_config(reins_config),
                        resize_feat=resize_feat)


def build_reins_eva02(reins_config: Dict[str, Any], resize_feat: bool = True,
                      init_cfg=None, **backbone_kwargs) -> VisionTransformer:
    del init_cfg
    return build_eva02(**backbone_kwargs,
                       reins=reins_spec_from_config(reins_config),
                       resize_feat=resize_feat)


def build_reins_sam(reins_config: Dict[str, Any], resize_feat: bool = True,
                    init_cfg=None, **backbone_kwargs) -> VisionTransformer:
    del init_cfg
    global_idx = tuple(backbone_kwargs.get("global_attn_indexes",
                                           (7, 15, 23, 31)))
    return build_sam(**backbone_kwargs,
                     reins=reins_spec_from_config(reins_config, global_idx),
                     resize_feat=resize_feat)


class ReinsCLIPWithFPN(nn.Module):
    """CLIP with Rein and the fpn1..4 pyramid on its four maps
    (rein_backbones.py:75-92): ``(maps, queries)`` when the ViT links its
    tokens to queries, else the maps. ``cfg`` and ``returns_queries`` are
    the ViT's."""

    def __init__(self, vit: VisionTransformer, fpn: ClipFPN):
        super().__init__()
        self.vit = vit
        self.fpn = fpn

    @property
    def cfg(self):
        return self.vit.cfg

    @property
    def returns_queries(self) -> bool:
        return self.vit.returns_queries

    def forward(self, x: torch.Tensor):
        out = self.vit(x)
        if self.returns_queries:
            feats, queries = out
            return self.fpn(feats), queries
        return self.fpn(out)


def build_reins_clip(reins_config: Dict[str, Any], init_cfg=None,
                     **backbone_kwargs) -> ReinsCLIPWithFPN:
    del init_cfg
    vit = build_clip(**backbone_kwargs,
                     reins=reins_spec_from_config(reins_config))
    return ReinsCLIPWithFPN(vit, ClipFPN(vit.cfg.embed_dim, vit.cfg.dtype))


REIN_BACKBONES = {"ReinsDinoVisionTransformer": build_reins_dinov2,
                  "ReinsEVA2": build_reins_eva02,
                  "ReinsSAMViT": build_reins_sam,
                  "ReinsCLIPVisionTransformer": build_reins_clip}
