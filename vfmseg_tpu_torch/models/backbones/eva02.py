"""EVA02 ViT backbone factories.

Port of vfmseg_tpu/models/backbones/eva02.py:23-94 (reference
rein/models/backbones/eva_02.py and configs/_base_/models/
lora_eva02_ms_masked.py): patch 16, embed 1024, depth 24, 16 heads,
mlp_ratio 8/3 with the EVA SwiGLU and its sub-LN, split q/k/v projections
(k bias-free), 2D RoPE on the patch tokens (pt_hw_seq_len 16, interpolated
frequencies), a learned absolute pos-embed, out_indices (7, 11, 15, 23), LN
eps 1e-6, no LayerScale, drop-path 0.1 in training in the config.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vfmseg_tpu_torch.models.backbones.adapters import LoRASpec, ReinsSpec
from vfmseg_tpu_torch.models.backbones.vit import (
    ViTConfig,
    VisionTransformer,
)


def build_eva02(
    patch_size: int = 16,
    embed_dim: int = 1024,
    depth: int = 24,
    num_heads: int = 16,
    mlp_ratio: float = 4 * 2 / 3,
    img_size: int = 512,
    init_values: Optional[float] = None,
    qkv_bias: bool = True,
    out_indices: Sequence[int] = (7, 11, 15, 23),
    drop_path_rate: float = 0.0,
    rope: bool = True,
    pt_hw_seq_len: int = 16,
    intp_freq: bool = True,
    subln: bool = True,
    naiveswiglu: bool = True,
    use_abs_pos_emb: bool = True,
    lora: Optional[LoRASpec] = None,
    reins: Optional[ReinsSpec] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    remat: bool = False,
    resize_feat: bool = False,
) -> VisionTransformer:
    if not (subln and naiveswiglu and use_abs_pos_emb):
        raise NotImplementedError("EVA02 without the sub-LN attention, the "
                                  "SwiGLU or the absolute pos-embed is not "
                                  "ported")
    cfg = ViTConfig(
        patch_size=patch_size, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, img_size=img_size,
        out_indices=tuple(out_indices), qkv_bias=qkv_bias, proj_bias=True,
        ffn_layer="swiglu_eva", init_values=init_values,
        drop_path_rate=drop_path_rate, ln_eps=1e-6, attn_type="split_subln",
        use_rope=rope, rope_pt_seq_len=pt_hw_seq_len,
        rope_intp_freq=intp_freq, attn_impl=attn_impl,
        resize_feat=resize_feat, remat=remat, dtype=dtype)
    return VisionTransformer(cfg, lora=lora, reins=reins)


def eva02_large(img_size: int = 512, lora: Optional[LoRASpec] = None,
                dtype: torch.dtype = torch.float32,
                drop_path_rate: float = 0.0) -> VisionTransformer:
    return build_eva02(img_size=img_size, lora=lora, dtype=dtype,
                       drop_path_rate=drop_path_rate)


def eva02_tiny_for_tests(img_size: int = 64, depth: int = 4,
                         embed_dim: int = 32, num_heads: int = 2,
                         out_indices: Sequence[int] = (0, 1, 2, 3),
                         lora: Optional[LoRASpec] = None,
                         dtype: torch.dtype = torch.float32
                         ) -> VisionTransformer:
    return build_eva02(
        patch_size=16, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
        img_size=img_size, out_indices=out_indices, pt_hw_seq_len=4,
        lora=lora, dtype=dtype)
