"""CLIP ViT-L visual tower backbone factory and the FPN pyramid of its Rein
variant.

Port of vfmseg_tpu/models/backbones/clip.py:41-142. ``build_clip`` makes the
ViT core of ``vit.py`` CLIP's visual encoder: a bias-free patch embedding, the
class-embedding vector with its double add at the cls position, a bilinear
resize of the position grid at any other grid, ``ln_pre``, QuickGELU MLPs,
LayerNorm eps 1e-5 and no LayerScale. The attention is DINOv2's fused qkv
(B2 at inference; B3 and B5's fused backward in training): CLIP's LoRA
targets ``out_proj``/``mlp.c_fc``/``mlp.c_proj``, normalised to
``proj``/``fc1``/``fc2`` (``adapters.normalize_lora_targets``), leave the
qkv projection alone.

:class:`ClipFPN` turns the four /16 maps into /4, /8, /16 and /32 (the
reference's fpn1..fpn4, clip.py:224-260): GroupNorm(1) and two stride-2
transposed convolutions with BatchNorm and GELU between, GroupNorm(1) and
one transposed convolution, GroupNorm(1) alone, and GroupNorm(1) then a 2x2
max-pool. Its BatchNorm is flax's (``common.BatchNorm``: momentum 0.9 in
flax's convention is PyTorch's 0.1) and moves its statistics in training
mode.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models.backbones.adapters import LoRASpec, ReinsSpec
from vfmseg_tpu_torch.models.backbones.vit import (
    ViTConfig,
    VisionTransformer,
)
from vfmseg_tpu_torch.models.common import (
    BatchNorm,
    ConvTranspose2d,
    GroupNorm,
    max_pool,
)


def build_clip(
    input_resolution: int = 512,
    patch_size: int = 16,
    width: int = 1024,
    layers: int = 24,
    heads: int = 16,
    out_indices: Sequence[int] = (7, 11, 15, 23),
    drop_path_rate: float = 0.0,
    output_dim: int = 512,
    get_embeddings: bool = False,
    lora: Optional[LoRASpec] = None,
    reins: Optional[ReinsSpec] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    remat: bool = False,
    resize_feat: bool = False,
) -> VisionTransformer:
    """``output_dim`` and ``get_embeddings`` (CLIP's embedding head) are
    config parity, read by neither builder: the backbone returns the
    feature maps."""
    del output_dim, get_embeddings
    cfg = ViTConfig(
        patch_size=patch_size, embed_dim=width, depth=layers, num_heads=heads,
        mlp_ratio=4.0, img_size=input_resolution,
        out_indices=tuple(out_indices), ffn_act="quick_gelu",
        init_values=None, drop_path_rate=drop_path_rate, ln_eps=1e-5,
        pos_interp="bilinear", cls_style="clip_embed", pre_norm=True,
        patch_embed_bias=False, attn_impl=attn_impl, resize_feat=resize_feat,
        remat=remat, dtype=dtype)
    return VisionTransformer(cfg, lora=lora, reins=reins)


class ClipFPN(nn.Module):
    """The Rein-CLIP pyramid over four NHWC maps (clip.py:100-130)."""

    def __init__(self, embed_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        e = embed_dim

        def gn():
            return GroupNorm(1, e, eps=1e-5, dtype=dtype)

        def up():
            return ConvTranspose2d(e, e, 2, stride=2, dtype=dtype)

        self.fpn1_gn, self.fpn1_up1 = gn(), up()
        self.fpn1_bn = BatchNorm(e, eps=1e-5, momentum=0.9, dtype=dtype)
        self.fpn1_up2 = up()
        self.fpn2_gn, self.fpn2_up = gn(), up()
        self.fpn3_gn = gn()
        self.fpn4_gn = gn()

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        f0, f1, f2, f3 = feats
        x = F.gelu(self.fpn1_bn(self.fpn1_up1(self.fpn1_gn(f0))))
        return (self.fpn1_up2(x), self.fpn2_up(self.fpn2_gn(f1)),
                self.fpn3_gn(f2), max_pool(self.fpn4_gn(f3), 2, 2))


def clip_large(input_resolution: int = 512, lora: Optional[LoRASpec] = None,
               reins: Optional[ReinsSpec] = None,
               dtype: torch.dtype = torch.float32,
               attn_impl: str = "auto") -> VisionTransformer:
    return build_clip(input_resolution=input_resolution, lora=lora,
                      reins=reins, dtype=dtype, attn_impl=attn_impl)


def clip_tiny_for_tests(input_resolution: int = 64, layers: int = 4,
                        width: int = 32, heads: int = 2,
                        out_indices: Sequence[int] = (0, 1, 2, 3),
                        lora: Optional[LoRASpec] = None,
                        dtype: torch.dtype = torch.float32
                        ) -> VisionTransformer:
    return build_clip(input_resolution=input_resolution, patch_size=16,
                      width=width, layers=layers, heads=heads,
                      out_indices=out_indices, lora=lora, dtype=dtype)
