"""SAM ViT-H image encoder factories.

Port of vfmseg_tpu/models/backbones/sam.py:23-90 (reference
rein/models/backbones/sam_vit.py and configs/_base_/models/
lora_sam_ms_masked.py): patch 16, embed 1280, depth 32, 16 heads of 80, no
cls token, a grid-shaped absolute pos-embed, windowed attention (window 14)
with global attention at ``global_attn_indexes`` (7, 15, 23, 31), the
decomposed relative positions (global tables sized for the 1024 / 16 = 64
pretraining grid and resized at run time), LN eps 1e-6, no LayerScale,
out_indices equal to the global blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vfmseg_tpu_torch.models.backbones.adapters import LoRASpec, ReinsSpec
from vfmseg_tpu_torch.models.backbones.vit import (
    ViTConfig,
    VisionTransformer,
)


def build_sam(
    img_size: int = 512,
    patch_size: int = 16,
    embed_dim: int = 1280,
    depth: int = 32,
    num_heads: int = 16,
    mlp_ratio: float = 4.0,
    qkv_bias: bool = True,
    out_indices: Sequence[int] = (7, 15, 23, 31),
    global_attn_indexes: Sequence[int] = (7, 15, 23, 31),
    window_size: int = 14,
    use_rel_pos: bool = True,
    use_abs_pos: bool = True,
    pretrain_img_size: int = 1024,
    lora: Optional[LoRASpec] = None,
    reins: Optional[ReinsSpec] = None,
    dtype: torch.dtype = torch.float32,
    drop_path_rate: float = 0.0,
    attn_impl: str = "auto",
    remat: bool = False,
    resize_feat: bool = False,
) -> VisionTransformer:
    """``attn_impl="pallas_bias"``: every block attends with the
    materialised rel-pos bias (B5's bias kernels) instead of B7.
    ``drop_path_rate``: the JAX SAM has no drop-path (its builder drops the
    key), so only 0 is taken."""
    if not use_abs_pos:
        raise NotImplementedError("SAM without the absolute pos-embed is not "
                                  "ported")
    if drop_path_rate:
        raise NotImplementedError("drop-path on SAM's blocks is not ported")
    cfg = ViTConfig(
        patch_size=patch_size, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, img_size=img_size,
        out_indices=tuple(out_indices), qkv_bias=qkv_bias, proj_bias=True,
        ffn_layer="mlp", init_values=None, ln_eps=1e-6, num_cls_tokens=0,
        pos_embed="learned_2d", window_size=window_size or None,
        global_attn_indexes=tuple(global_attn_indexes),
        use_rel_pos=use_rel_pos,
        rel_pos_pretrain_extent=pretrain_img_size // patch_size,
        attn_impl=attn_impl, resize_feat=resize_feat, remat=remat, dtype=dtype)
    return VisionTransformer(cfg, lora=lora, reins=reins)


def sam_vit_h(img_size: int = 512, lora: Optional[LoRASpec] = None,
              dtype: torch.dtype = torch.float32,
              attn_impl: str = "auto") -> VisionTransformer:
    return build_sam(img_size=img_size, lora=lora, dtype=dtype,
                     attn_impl=attn_impl)


def sam_tiny_for_tests(img_size: int = 64, depth: int = 4, embed_dim: int = 32,
                       num_heads: int = 2, window_size: int = 2,
                       global_attn_indexes: Sequence[int] = (1, 3),
                       out_indices: Sequence[int] = (0, 1, 2, 3),
                       lora: Optional[LoRASpec] = None,
                       dtype: torch.dtype = torch.float32,
                       attn_impl: str = "auto") -> VisionTransformer:
    return build_sam(
        img_size=img_size, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, window_size=window_size,
        global_attn_indexes=global_attn_indexes, out_indices=out_indices,
        pretrain_img_size=128, lora=lora, dtype=dtype, attn_impl=attn_impl)
