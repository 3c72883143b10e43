"""Vision Transformer core, the DINOv2 inference path.

Port of vfmseg_tpu/models/backbones/vit.py:44-128, 164-201, 321-406 and
409-580, restricted to the configuration the headline model uses: one fused
qkv linear (optionally LoRA), no RoPE, no relative positions, no windows, an
exact-erf GELU MLP, LayerScale, a learned cls token and position embedding
(bicubic interpolation with DINOv2's +0.1 trick at other grid sizes), and
pre-norm feature maps taken at ``out_indices``. Eval only: drop-path and the
other families' options wait for their slices.

Module and parameter names follow the flax tree (``blocks.<i>`` for
``blocks_<i>``), so ``weights.state_dict_from_flax`` maps one onto the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models.backbones.adapters import LoRASpec, make_dense
from vfmseg_tpu_torch.models.common import Conv2d
from vfmseg_tpu_torch.ops.attention import multi_head_attention_qkv_tm
from vfmseg_tpu_torch.ops.norm import LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    img_size: int = 512
    out_indices: Tuple[int, ...] = (7, 11, 15, 23)
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    init_values: Optional[float] = 1e-5  # LayerScale; None disables
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool,
                 lora: Optional[LoRASpec], dtype: torch.dtype):
        super().__init__()
        self.fc1 = make_dense(dim, hidden, bias, "fc1", lora, dtype)
        self.fc2 = make_dense(hidden, dim, bias, "fc2", lora, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Fused-qkv MHA; attention reads q/k/v straight out of the qkv output
    and returns token-major [B, N, E] for the proj linear."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec]):
        super().__init__()
        dim = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.qkv = make_dense(dim, 3 * dim, cfg.qkv_bias, "qkv", lora,
                              cfg.dtype)
        self.proj = make_dense(dim, dim, cfg.proj_bias, "proj", lora,
                               cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = multi_head_attention_qkv_tm(self.qkv(x), self.num_heads)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float, dtype: torch.dtype):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block with LayerScale (dino_layers/block.py)."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec]):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = LayerNorm(dim, cfg.ln_eps, cfg.dtype)
        self.attn = Attention(cfg, lora)
        self.norm2 = LayerNorm(dim, cfg.ln_eps, cfg.dtype)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), cfg.ffn_bias, lora,
                       cfg.dtype)
        if cfg.init_values is not None:
            self.ls1 = LayerScale(dim, cfg.init_values, cfg.dtype)
            self.ls2 = LayerScale(dim, cfg.init_values, cfg.dtype)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class VisionTransformer(nn.Module):
    """ViT backbone: NHWC image [B, H, W, 3] -> tuple of NHWC feature maps
    [B, H/p, W/p, E], one per ``out_indices`` entry."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec] = None):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.patch_embed = Conv2d(3, e, cfg.patch_size, stride=cfg.patch_size,
                                  dtype=cfg.dtype)
        n_grid = (cfg.img_size // cfg.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_grid + 1, e))
        self.blocks = nn.ModuleList(Block(cfg, lora)
                                    for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        cfg = self.cfg
        b, h, w, _ = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        x = self.patch_embed(x).reshape(b, gh * gw, cfg.embed_dim)
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.interpolated_pos_embed(gh, gw).to(x.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.out_indices:
                outs.append(x[:, 1:, :].reshape(b, gh, gw, cfg.embed_dim))
        return tuple(outs)

    def interpolated_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """DINOv2's pos-embed at a (gh, gw) grid (dino_v2.py:184-215): torch
        bicubic with the +0.1 scale-factor trick on the grid part; the cls
        position passes through. fp32."""
        pos = self.pos_embed
        side = int(math.sqrt(pos.shape[1] - 1))
        if (gh, gw) == (side, side):
            return pos
        grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(
            grid.float(), mode="bicubic", align_corners=False,
            scale_factor=((gh + 0.1) / side, (gw + 0.1) / side),
            recompute_scale_factor=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :1], grid.to(pos.dtype)], dim=1)
