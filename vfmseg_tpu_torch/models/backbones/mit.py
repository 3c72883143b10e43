"""MixVisionTransformer (SegFormer's MiT-B0..B5) backbone.

Port of vfmseg_tpu/models/backbones/mit.py:36-203: four stages, each an
overlapping patch embedding (7x7 stride 4, then 3x3 stride 2) with its
LayerNorm, ``depths[s]`` blocks and a closing LayerNorm; one NHWC map per
stage at /4, /8, /16 and /32. Every LayerNorm runs on B1
(``ops/norm.py``) over the ``[B, H, W, C]`` maps.

* :class:`EfficientAttention`: q from the tokens, k and v from one ``kv``
  projection of the tokens reduced by a strided ``sr`` conv (ratio 8, 4, 2,
  1 by stage) and its LayerNorm, through ``multi_head_attention``. Where
  ``sr_ratio`` > 1 the key count differs from the query count and the
  attention runs on B5 (forward, and its fused backward in training) over
  ``[B, H, N, D]`` views: k and v are strided views of the ``kv`` output,
  which B5 reads as they are. At ``sr_ratio`` 1 (stage 4) q and kv project
  the same tokens, so the two weights concatenate into one fused
  ``[3C, C]`` product whose q|k|v thirds B2 reads at inference and B3 with
  B5's fused backward in training (``multi_head_attention_qkv_tm``), as the
  ViTs' fused qkv does.
* :class:`MixFFN`: Dense, a depthwise 3x3 conv (``groups=C``, flax's
  ``feature_group_count``), exact GELU, Dense.
* :class:`MiTBlock`: pre-LN attention and Mix-FFN residuals with per-sample
  drop-path in training (the ``dropout`` stream), the rate growing linearly
  over all blocks.

Module names follow the flax tree (``patch_embed1``, ``embed_norm1``,
``stage1_block0``, ``norm1``...), so ``weights.state_dict_from_flax`` maps
one onto the other.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models.backbones.vit import drop_path
from vfmseg_tpu_torch.models.common import Conv2d, Dense
from vfmseg_tpu_torch.ops.attention import (
    multi_head_attention,
    multi_head_attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.norm import LayerNorm


class EfficientAttention(nn.Module):
    """SegFormer's spatial-reduction attention over an NHWC map."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.dtype = dtype
        self.q = Dense(dim, dim, dtype=dtype)
        if sr_ratio > 1:
            # flax's default "SAME" padding: none where sr divides the map
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio,
                             padding="SAME", dtype=dtype)
            self.sr_norm = LayerNorm(dim, 1e-6, dtype)
        self.kv = Dense(dim, 2 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        d = c // heads
        if self.sr_ratio == 1:
            weight = torch.cat([self.q.weight, self.kv.weight])
            bias = torch.cat([self.q.bias, self.kv.bias])
            qkv = F.linear(x.to(self.dtype).reshape(b, h * w, c),
                           weight.to(self.dtype), bias.to(self.dtype))
            out = multi_head_attention_qkv_tm(qkv, heads)
            return self.proj(out.reshape(b, h, w, c))
        q = self.q(x).reshape(b, h * w, heads, d)
        src = self.sr_norm(self.sr(x))
        nk = src.shape[1] * src.shape[2]
        kv = self.kv(src).reshape(b, nk, 2, heads, d)
        out = multi_head_attention(q, kv[:, :, 0], kv[:, :, 1])
        return self.proj(out.reshape(b, h, w, c))


class MixFFN(nn.Module):
    """Dense -> depthwise 3x3 -> GELU -> Dense."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.dwconv = Conv2d(hidden, hidden, 3, padding="SAME",
                             groups=hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio, dtype)
        self.norm2 = LayerNorm(dim, 1e-6, dtype)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.drop_path_rate
        x = x + drop_path(self.attn(self.norm1(x)), rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), rate, self.training)


class MixVisionTransformer(nn.Module):
    """Four-stage hierarchical encoder: NHWC [B, H, W, 3] -> one NHWC map
    per stage ([H/4, H/8, H/16, H/32])."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 6, 40, 3),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = tuple(embed_dims)
        self.depths = tuple(depths)
        total = sum(self.depths)
        block = 0
        in_ch = 3
        for s in range(4):
            k, stride = (7, 4) if s == 0 else (3, 2)
            self.add_module(f"patch_embed{s + 1}", Conv2d(
                in_ch, embed_dims[s], k, stride=stride, padding=k // 2,
                dtype=dtype))
            self.add_module(f"embed_norm{s + 1}",
                            LayerNorm(embed_dims[s], 1e-6, dtype))
            for i in range(self.depths[s]):
                self.add_module(f"stage{s + 1}_block{i}", MiTBlock(
                    embed_dims[s], num_heads[s], mlp_ratio, sr_ratios[s],
                    drop_path_rate * block / max(total - 1, 1), dtype))
                block += 1
            self.add_module(f"norm{s + 1}",
                            LayerNorm(embed_dims[s], 1e-6, dtype))
            in_ch = embed_dims[s]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = []
        for s in range(1, 5):
            x = getattr(self, f"embed_norm{s}")(
                getattr(self, f"patch_embed{s}")(x))
            for i in range(self.depths[s - 1]):
                x = getattr(self, f"stage{s}_block{i}")(x)
            x = getattr(self, f"norm{s}")(x)
            feats.append(x)
        return tuple(feats)


# the MiT variants (SegFormer paper, Table 1): (embed_dims, depths)
MIT_VARIANTS = {
    "b0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "b1": ((64, 128, 320, 512), (2, 2, 2, 2)),
    "b2": ((64, 128, 320, 512), (3, 4, 6, 3)),
    "b3": ((64, 128, 320, 512), (3, 4, 18, 3)),
    "b4": ((64, 128, 320, 512), (3, 8, 27, 3)),
    "b5": ((64, 128, 320, 512), (3, 6, 40, 3)),
}


def build_mit(variant: Optional[str] = None,
              embed_dims: Sequence[int] = (64, 128, 320, 512),
              depths: Sequence[int] = (3, 6, 40, 3),
              num_heads: Sequence[int] = (1, 2, 5, 8),
              sr_ratios: Sequence[int] = (8, 4, 2, 1),
              mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
              style: str = "pytorch", init_cfg=None,
              lora=None, dtype: torch.dtype = torch.float32,
              attn_impl: str = "auto") -> MixVisionTransformer:
    """mit.py:168-191: a ``variant`` (``mit_b0``..``mit_b5``) sets the
    widths and depths. ``style`` and ``init_cfg`` are config parity (mmseg's
    and the pretrained file, loaded by the weight tooling); ``attn_impl``:
    the attention has one route in the port. MiT takes no LoRA."""
    del style, init_cfg, attn_impl
    if lora is not None:
        raise NotImplementedError("LoRA on MixVisionTransformer is not "
                                  "ported")
    if variant is not None:
        embed_dims, depths = MIT_VARIANTS[variant]
    return MixVisionTransformer(embed_dims, depths, num_heads, sr_ratios,
                                mlp_ratio, drop_path_rate, dtype)


def _variant_builder(variant: str):
    def build(**kwargs) -> MixVisionTransformer:
        kwargs.pop("variant", None)
        return build_mit(variant=variant, **kwargs)
    return build


MIT_BUILDERS = {"MixVisionTransformer": build_mit,
                **{f"mit_{v}": _variant_builder(v) for v in MIT_VARIANTS}}
