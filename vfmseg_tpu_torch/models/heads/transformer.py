"""Cross-attention decoder blocks.

Port of vfmseg_tpu/models/heads/transformer.py:30-157: BasicTransformerBlock
is pre-LN self-attention, then cross-attention over a context stream, then a
GEGLU feed-forward, with dropout after each attention's ``to_out`` and after
the GEGLU in training mode; TransformerDecoder GroupNorms the spatial query,
flattens it to tokens and runs ``depth`` blocks. With ``mask_ratio > 0``
(MaskTransformerDecoder) and ``mask_enable``, query pixels whose uniform draw
from the ``mask`` stream is not above ``mask_ratio`` are swapped for the
learned ``mask_token`` first (transformer.py:138-145); inference runs with
the mask off (vfmseg_tpu/eval/evaluator.py:55-56).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.common import Dense, GroupNorm, gn_groups
from vfmseg_tpu_torch.ops.attention import multi_head_attention
from vfmseg_tpu_torch.ops.norm import LayerNorm


class CrossAttention(nn.Module):
    """q from x, k/v from context (self-attention if context is None)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads = heads
        self.dim_head = dim_head
        self.dropout = dropout
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        context = x if context is None else context
        nk = context.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        k = self.to_k(context).reshape(b, nk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(b, nk, self.heads, self.dim_head)
        out = multi_head_attention(q, k, v)
        out = self.to_out(out.reshape(b, n, self.heads * self.dim_head))
        return rng.dropout(out, self.dropout, self.training)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult, dtype)
        self.out = Dense(dim * mult, dim, dtype=dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(rng.dropout(self.geglu(x), self.dropout,
                                    self.training))


class BasicTransformerBlock(nn.Module):
    def __init__(self, query_dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(query_dim, 1e-5, dtype)
        self.attn1 = CrossAttention(query_dim, None, n_heads, d_head, dropout,
                                    dtype)
        self.norm2 = LayerNorm(query_dim, 1e-5, dtype)
        self.attn2 = CrossAttention(query_dim, context_dim, n_heads, d_head,
                                    dropout, dtype)
        self.norm3 = LayerNorm(query_dim, 1e-5, dtype)
        self.ff = FeedForward(query_dim, 4, dropout, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TransformerDecoder(nn.Module):
    """Decode a spatial NHWC query stream against a spatial NHWC context
    stream; returns NHWC at the context's spatial size."""

    def __init__(self, query_dim: int, img_feat_dim: int, n_heads: int = 8,
                 d_head: int = 64, depth: int = 1, dropout: float = 0.0,
                 mask_ratio: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_ratio = mask_ratio
        if mask_ratio > 0:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, query_dim))
        self.norm = GroupNorm(gn_groups(query_dim), query_dim, eps=1e-6,
                              dtype=dtype)
        self.block = nn.ModuleList(
            BasicTransformerBlock(query_dim, n_heads, d_head, img_feat_dim,
                                  dropout, dtype) for _ in range(depth))

    def forward(self, query: torch.Tensor, context: torch.Tensor,
                mask_enable: bool = False) -> torch.Tensor:
        b, qh, qw, c = query.shape
        ch, cw = context.shape[1], context.shape[2]
        if self.mask_ratio > 0 and mask_enable:
            keep = rng.uniform("mask", rng.PerSample((b, qh, qw, 1)),
                               query.device) > self.mask_ratio
            query = torch.where(keep, query,
                                self.mask_token.to(query.dtype))
        x = self.norm(query).reshape(b, qh * qw, c)
        context = context.reshape(b, ch * cw, context.shape[-1])
        for blk in self.block:
            x = blk(x, context)
        # the reference reshapes with the *context* spatial dims
        # (Transformer.py:251); query and context are co-spatial here
        return x.reshape(b, ch, cw, c)
