"""DINOv2 ViT backbone factory, the backbone table and the LoRA wrapper.

Port of vfmseg_tpu/models/backbones/dinov2.py:23-93. They take the reference
config surface (configs/_base_/models/lora_*_ms_masked.py) and build the ViT
core of ``vit.py``; ``EVA2`` builds through ``eva02.py``, ``SAMViT``
through ``sam.py``, ``CLIPVisionTransformer`` through ``clip.py``, the
``Reins*`` ViTs through ``rein_backbones.py``, ``MixVisionTransformer``
and ``mit_b0``..``mit_b5`` through ``mit.py`` and ``ResNetV1c`` and
``ReinsResNetV1c`` through ``resnet.py``; any other type raises
(``common.not_ported``). A key that a builder neither uses nor names as
ignored raises ``TypeError``, and a value the port does not implement
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vfmseg_tpu_torch.models.backbones.adapters import (
    LoRASpec,
    ReinsSpec,
    normalize_lora_targets,
)
from vfmseg_tpu_torch.models.backbones.eva02 import build_eva02
from vfmseg_tpu_torch.models.common import not_ported
from vfmseg_tpu_torch.models.backbones.sam import build_sam
from vfmseg_tpu_torch.models.backbones.vit import (
    ViTConfig,
    VisionTransformer,
)

# the linears of the ported ViT that LoRA may target
LORA_LINEARS = {"qkv", "q_proj", "k_proj", "v_proj", "proj", "fc1", "fc2"}


def build_dinov2(
    patch_size: int = 16,
    embed_dim: int = 1024,
    depth: int = 24,
    num_heads: int = 16,
    mlp_ratio: float = 4.0,
    img_size: int = 512,
    ffn_layer: str = "mlp",
    init_values: Optional[float] = 1e-5,
    qkv_bias: bool = True,
    proj_bias: bool = True,
    ffn_bias: bool = True,
    out_indices: Sequence[int] = (7, 11, 15, 23),
    drop_path_rate: float = 0.0,
    block_chunks: int = 0,  # config parity: torch FSDP chunking, as in JAX
    lora: Optional[LoRASpec] = None,
    reins: Optional[ReinsSpec] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    remat: bool = False,
    resize_feat: bool = False,
) -> VisionTransformer:
    del block_chunks
    if ffn_layer != "mlp":
        raise NotImplementedError(f"ffn_layer={ffn_layer!r} is not ported")
    cfg = ViTConfig(
        patch_size=patch_size, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, img_size=img_size,
        out_indices=tuple(out_indices), qkv_bias=qkv_bias,
        proj_bias=proj_bias, ffn_bias=ffn_bias, init_values=init_values,
        drop_path_rate=drop_path_rate, ln_eps=1e-6, attn_impl=attn_impl,
        resize_feat=resize_feat, remat=remat, dtype=dtype)
    return VisionTransformer(cfg, lora=lora, reins=reins)


_BACKBONES = {"DinoVisionTransformer": build_dinov2, "EVA2": build_eva02,
              "SAMViT": build_sam}


def _backbones() -> dict:
    # the Rein builders call the three above
    from vfmseg_tpu_torch.models.backbones import clip, mit, rein_backbones
    from vfmseg_tpu_torch.models.backbones import resnet

    return dict(_BACKBONES, **rein_backbones.REIN_BACKBONES,
                **mit.MIT_BUILDERS, CLIPVisionTransformer=clip.build_clip,
                ResNetV1c=resnet.build_resnet,
                ReinsResNetV1c=resnet.build_reins_resnet)


def build_backbone(cfg: dict, lora: Optional[LoRASpec] = None,
                   dtype: torch.dtype = torch.float32,
                   attn_impl: str = "auto") -> torch.nn.Module:
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind == "LoRABackbone":
        if lora is not None:
            raise ValueError("nested LoRABackbone")
        return build_lora_backbone(dtype=dtype, attn_impl=attn_impl, **cfg)
    builders = _backbones()
    if kind not in builders:
        raise not_ported("backbone", kind)
    return builders[kind](lora=lora, dtype=dtype, attn_impl=attn_impl,
                          **cfg)


def build_lora_backbone(backbone: dict, Lora_config: dict, checkpoint: str = "",
                        dtype: torch.dtype = torch.float32,
                        attn_impl: str = "auto",
                        **extra) -> VisionTransformer:
    """Reference LoRABackbone (lora_backbone.py:12-24): the inner backbone
    with LoRA on its target linears. ``checkpoint`` is the converted
    backbone file, loaded by the weight tooling and not at build time. The
    reference target names are normalised to the ViT's linears."""
    del checkpoint
    lora = LoRASpec(
        rank=Lora_config.get("r", 0),
        alpha=Lora_config.get("lora_alpha", 1.0),
        dropout=Lora_config.get("lora_dropout", 0.0),
        targets=normalize_lora_targets(Lora_config.get("target_modules", ())),
    )
    unknown = set(lora.targets) - LORA_LINEARS
    if unknown:
        raise NotImplementedError(f"LoRA targets {sorted(unknown)} are not "
                                  "linears of the ported ViT")
    return build_backbone(dict(backbone, **extra), lora=lora, dtype=dtype,
                          attn_impl=attn_impl)
