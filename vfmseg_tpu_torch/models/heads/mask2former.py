"""Mask2Former decode head: the deformable pixel decoder, the masked decoder,
and the semantic post-processing.

Port of vfmseg_tpu/models/heads/mask2former.py:42-476: the learned
``query_embed`` is the positional query, or with ``rein_queries``
(ReinMask2FormerHead) the Rein backbone's query vector, and the head then
has no ``query_embed``, as the flax tree has none. NHWC throughout; names
follow the flax tree
(``encoder_layer<i>``, ``decoder_layer<i>``, ``input_conv<i>``), so
``weights.state_dict_from_flax`` maps one onto the other.

* :func:`sine_positional_encoding`: the DETR sine table (mmdet
  SinePositionalEncoding, normalised), the port's own numpy copy.
* :class:`MSDeformAttention`: multi-scale deformable attention through
  ``ops/deform_attn.py``: the fused core's kernel where nothing needs a
  gradient, B8 level by level under autograd.
* :class:`MSDeformAttnPixelDecoder`: 6 post-norm deformable encoder layers
  over the three lowest-resolution maps, then the FPN lateral for the mask
  features.
* :class:`Mask2FormerHead`: 9 decoder layers of masked cross-attention,
  self-attention and FFN (post-norm), cycling the three memory levels. The
  attention (:class:`TorchMHA`) is plain PyTorch math with the mask as a
  -1e9 bias, as the JAX head takes ``xla_attention``. In training every
  stage predicts and the mask is formed in mmdet's order; at inference only
  the last stage predicts, and each attention mask is formed at the level's
  resolution against mask features resized first (mask2former.py:425-467):
  ``sigmoid < 0.5`` can flip on rounding, so the order is the JAX head's.
* :func:`semantic_inference`: softmax(cls) x sigmoid(mask) logits.

LayerNorms run on B1 on CUDA tensors; the GEMMs and convolutions are
PyTorch's.

Profiler ranges (``utils/profiling.py`` ``span``): ``vfmseg.pixel_decoder``
(the pixel decoder) and ``vfmseg.mask_decoder`` (the level inputs, the
decoder layers with their masks, and the prediction). While a profiler runs
the head also counts, as device tensors, the (query, key) pairs its
cross-attention masks hide after the all-masked-row rule
(``stat_hidden_pairs`` of ``stat_pairs``) and the rows that rule reset
(``stat_reset_rows`` of ``stat_rows``); with none running it counts
nothing.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.models.common import Conv2d, Dense, GroupNorm
from vfmseg_tpu_torch.ops.attention import attention_plain
from vfmseg_tpu_torch.ops.deform_attn import (
    fused_supported,
    ms_deform_attn,
    ms_deform_attn_levels,
)
from vfmseg_tpu_torch.ops.norm import LayerNorm
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=64)
def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             temperature: float = 10000.0) -> np.ndarray:
    """DETR sine embedding [h*w, 2*num_feats] fp32 (mmdet
    SinePositionalEncoding, normalize=True, scale=2*pi, eps=1e-6), all-valid
    mask. Cached: callers must not write to it."""
    eps, scale = 1e-6, 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float64)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float64)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (np.arange(num_feats) // 2) / num_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).reshape(
        h * w, 2 * num_feats).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sine_on(h: int, w: int, num_feats: int,
             device: torch.device) -> torch.Tensor:
    """:func:`sine_positional_encoding` on ``device``, copied there once per
    shape (a host-to-device copy waits for the stream); a normal tensor even
    when first made under ``torch.inference_mode``, since a later training
    step may save it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(sine_positional_encoding(
            h, w, num_feats)).to(device)


@functools.lru_cache(maxsize=64)
def _reference_points(shapes: Tuple[Tuple[int, int], ...],
                      device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Each token's normalised centre over the levels' ``shapes``, as fp32
    x and y vectors on ``device`` (shared by every level: all-valid
    ratios); normal tensors, as :func:`_sine_on`'s."""
    refs = []
    for (h, w) in shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        refs.append(np.stack(np.meshgrid(xs, ys), axis=-1).reshape(h * w, 2))
    ref = np.concatenate(refs, axis=0)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(ref[:, i])).to(
            device) for i in range(2))


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention (mmcv semantics). Both projections
    that read the query (``sampling_offsets``, ``attention_weights``) are
    plain linears; the JAX init zeroes their kernels, the port's seeded init
    (``weights.init_params``) does not, so samples depend on the query.

    Two routes, chosen by what the call needs: where nothing needs a
    gradient (grad mode off, or neither the inputs nor the parameters
    require one) and the kernel takes the head, level and point counts, the
    fused core (``ops/deform_attn.py`` ``ms_deform_attn``) reads the three
    projections' outputs as they are; otherwise B8 samples level by level
    (``ms_deform_attn_levels``) under autograd."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = embed_dims
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points = num_points
        self.value_proj = Dense(c, c, dtype=dtype)
        self.sampling_offsets = Dense(
            c, num_heads * num_levels * num_points * 2, dtype=dtype)
        self.attention_weights = Dense(
            c, num_heads * num_levels * num_points, dtype=dtype)
        self.output_proj = Dense(c, c, dtype=dtype)

    def _wants_grad(self, query: torch.Tensor, value: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (
            query.requires_grad or value.requires_grad
            or any(p.requires_grad for p in self.parameters()))

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                shapes: Sequence[Tuple[int, int]], ref_x: torch.Tensor,
                ref_y: torch.Tensor) -> torch.Tensor:
        """query: [B, Nq, C]; value: [B, sum(H*W), C], the levels' maps of
        ``shapes`` back to back; ref_x / ref_y: [Nq] normalised reference
        coordinates."""
        h_, l_, p_ = self.num_heads, self.num_levels, self.num_points
        if not self._wants_grad(query, value) and fused_supported(l_, p_):
            out = ms_deform_attn(self.value_proj(value),
                                 self.sampling_offsets(query),
                                 self.attention_weights(query), ref_x, ref_y,
                                 shapes, h_, p_)
            return self.output_proj(out)
        values = [self.value_proj(v) for v in _split_levels(value, shapes)]
        out = ms_deform_attn_levels(values, self.sampling_offsets(query),
                                    self.attention_weights(query), ref_x,
                                    ref_y, h_, p_)
        return self.output_proj(out)


class FFN(nn.Module):
    """fc1 -> ReLU -> fc2 with the residual (mmcv FFN)."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(F.relu(self.fc1(x)))


class TorchMHA(nn.Module):
    """torch ``nn.MultiheadAttention`` with its fused in-projection kept in
    the flax layout (``in_proj_kernel [C, 3C]``), a ``[B, Nq, Nk]`` boolean
    mask (True: do not attend) as a -1e9 bias, and the attention as plain
    PyTorch math (:func:`attention_plain`, the twin of ``xla_attention``)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = embed_dims
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_kernel = nn.Parameter(torch.zeros(c, 3 * c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = Dense(c, c, dtype=dtype)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c, h_ = self.in_proj_bias.shape[0] // 3, self.num_heads
        w = self.in_proj_kernel.to(self.dtype)
        bias = self.in_proj_bias.to(self.dtype)
        qp, kp, vp = (x @ w[:, i * c:(i + 1) * c] + bias[i * c:(i + 1) * c]
                      for i, x in enumerate((q, k, v)))
        b, nq, nk = qp.shape[0], qp.shape[1], kp.shape[1]
        mask_bias = None
        if attn_mask is not None:
            mask_bias = torch.where(attn_mask[:, None], -1e9, 0.0).float()
        out = attention_plain(qp.reshape(b, nq, h_, c // h_),
                              kp.reshape(b, nk, h_, c // h_),
                              vp.reshape(b, nk, h_, c // h_), bias=mask_bias)
        return self.out_proj(out.reshape(b, nq, c))


class DeformableEncoderLayer(nn.Module):
    """Post-norm deformable self-attention and FFN (mmdet
    DeformableDetrTransformerEncoderLayer, FFN 1024 with ReLU)."""

    def __init__(self, embed_dims: int = 256, num_levels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MSDeformAttention(embed_dims=embed_dims,
                                           num_levels=num_levels, dtype=dtype)
        self.norm1 = LayerNorm(embed_dims, 1e-5, dtype)
        self.ffn = FFN(embed_dims, 1024, dtype=dtype)
        self.norm2 = LayerNorm(embed_dims, 1e-5, dtype)

    def forward(self, x, pos, shapes, ref_x, ref_y):
        # the value is the token stream itself, split into its level maps
        attn_out = self.self_attn(x + pos, x, shapes, ref_x, ref_y)
        x = self.norm1(x + attn_out)
        return self.norm2(self.ffn(x))


def _split_levels(tokens: torch.Tensor,
                  shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """[B, sum(H*W), ...] -> one [B, H, W, ...] map per level."""
    outs, start = [], 0
    for (h, w) in shapes:
        outs.append(tokens[:, start:start + h * w].reshape(
            (tokens.shape[0], h, w) + tuple(tokens.shape[2:])))
        start += h * w
    return outs


class MSDeformAttnPixelDecoder(nn.Module):
    """Deformable encoder on the three lowest-resolution maps and the FPN
    lateral for the stride-4 mask features (mmdet
    MSDeformAttnPixelDecoder)."""

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, num_encoder_layers: int = 6,
                 num_encoder_levels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = feat_channels
        self.feat_channels = c
        self.dtype = dtype
        self.level_embed = nn.Parameter(torch.zeros(num_encoder_levels, c))
        # encoder inputs, lowest resolution first: maps 3, 2, 1
        for i in range(num_encoder_levels):
            self.add_module(f"input_conv{i}", Conv2d(
                in_channels[len(in_channels) - 1 - i], c, 1, dtype=dtype))
            self.add_module(f"input_gn{i}", GroupNorm(32, c, dtype=dtype))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", DeformableEncoderLayer(
                c, num_encoder_levels, dtype=dtype))
        self.num_encoder_levels = num_encoder_levels
        self.num_encoder_layers = num_encoder_layers
        self.lateral_conv = Conv2d(in_channels[0], c, 1, bias=False,
                                   dtype=dtype)
        self.lateral_gn = GroupNorm(32, c, dtype=dtype)
        self.output_conv = Conv2d(c, c, 3, bias=False, padding=1, dtype=dtype)
        self.output_gn = GroupNorm(32, c, dtype=dtype)
        self.mask_feature = Conv2d(c, out_channels, 1, dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: 4 NHWC maps, high to low resolution. Returns
        (mask_features [B, H0, W0, C], the memories low to high
        resolution)."""
        c = self.feat_channels
        b = feats[0].shape[0]
        tokens, poses, shapes = [], [], []
        for i in range(self.num_encoder_levels):
            f = feats[len(feats) - 1 - i]
            x = getattr(self, f"input_gn{i}")(
                getattr(self, f"input_conv{i}")(f))
            h, w = x.shape[1], x.shape[2]
            shapes.append((h, w))
            tokens.append(x.reshape(b, h * w, c))
            pos = _sine_on(h, w, c // 2, x.device)
            poses.append((pos[None] + self.level_embed[i][None, None]).expand(
                b, h * w, c))
        x = torch.cat(tokens, dim=1)
        pos = torch.cat(poses, dim=1).to(self.dtype)
        shapes = tuple(shapes)
        ref_x, ref_y = _reference_points(shapes, x.device)
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"encoder_layer{i}")(x, pos, shapes, ref_x,
                                                   ref_y)
        memories = _split_levels(x, shapes)
        # FPN: the stride-4 lateral plus the top-down highest memory
        lat = self.lateral_gn(self.lateral_conv(feats[0]))
        y = lat + resize(memories[-1], size=lat.shape[1:3], method="bilinear")
        y = F.relu(self.output_gn(self.output_conv(y)))
        return self.mask_feature(y), memories


class MaskEmbedMLP(nn.Module):
    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = Dense(dim, dim, dtype=dtype)
        self.fc1 = Dense(dim, dim, dtype=dtype)
        self.fc2 = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(F.relu(self.fc0(x)))))


class Mask2FormerDecoderLayer(nn.Module):
    """Masked cross-attention, self-attention, FFN, each post-norm (mmdet
    Mask2FormerTransformerDecoderLayer)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross_attn = TorchMHA(embed_dims, num_heads, dtype)
        self.norm1 = LayerNorm(embed_dims, 1e-5, dtype)
        self.self_attn = TorchMHA(embed_dims, num_heads, dtype)
        self.norm2 = LayerNorm(embed_dims, 1e-5, dtype)
        self.ffn = FFN(embed_dims, ffn_dim, dtype=dtype)
        self.norm3 = LayerNorm(embed_dims, 1e-5, dtype)

    def forward(self, query, key, query_pos, key_pos, cross_attn_mask):
        x = self.cross_attn(query + query_pos, key + key_pos, key,
                            cross_attn_mask)
        query = self.norm1(query + x)
        qp = query + query_pos
        query = self.norm2(query + self.self_attn(qp, qp, query))
        return self.norm3(self.ffn(query))


def _attention_mask(logits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, Nq, h, w] mask logits -> ([B, Nq, h*w] True where a query does
    not attend (sigmoid < 0.5), [B, Nq, 1] True where a row was masked
    everywhere and so attends everywhere (rein_mask2former.py:71))."""
    am = torch.sigmoid(logits.float()) < 0.5
    am = am.reshape(am.shape[0], am.shape[1], -1)
    reset = am.all(dim=-1, keepdim=True)
    return am & ~reset, reset


class Mask2FormerHead(nn.Module):
    """The Mask2Former head. The positional queries are learned
    (``query_embed``), or with ``rein_queries`` the backbone's Rein query
    vector (rein_mask2former.py:26-30, 79); ``replace_query_feat`` maps
    them to the content queries through a linear (``querys2feat``)."""

    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 num_classes: int = 19, num_queries: int = 100,
                 feat_channels: int = 256, num_transformer_feat_level: int = 3,
                 num_decoder_layers: int = 9, num_heads: int = 8,
                 replace_query_feat: bool = False, rein_queries: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = feat_channels
        self.num_classes, self.num_queries = num_classes, num_queries
        self.num_levels = num_transformer_feat_level
        self.num_decoder_layers = num_decoder_layers
        self.dtype = dtype
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels, feat_channels=c, out_channels=c, dtype=dtype)
        self.level_embed = nn.Parameter(torch.zeros(self.num_levels, c))
        self.rein_queries = rein_queries
        if not rein_queries:
            self.query_embed = nn.Parameter(torch.zeros(num_queries, c))
        if replace_query_feat:
            self.querys2feat = Dense(c, c, dtype=dtype)
        else:
            self.query_feat = nn.Parameter(torch.zeros(num_queries, c))
        self.decoder_norm = LayerNorm(c, 1e-5, dtype)
        self.cls_embed = Dense(c, num_classes + 1, dtype=dtype)
        self.mask_embed = MaskEmbedMLP(c, dtype=dtype)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", Mask2FormerDecoderLayer(
                c, num_heads, dtype=dtype))
        # the masks' counters, kept only while a profiler runs
        self.stat_hidden_pairs: Optional[torch.Tensor] = None
        self.stat_reset_rows: Optional[torch.Tensor] = None
        self.stat_pairs = 0
        self.stat_rows = 0

    def _mask(self, logits: torch.Tensor) -> torch.Tensor:
        """The cross-attention mask of ``logits`` (:func:`_attention_mask`),
        counted while a profiler runs."""
        mask, reset = _attention_mask(logits)
        if profiling.active():
            hidden, resets = mask.sum(), reset.sum()
            if self.stat_hidden_pairs is not None:
                hidden = hidden + self.stat_hidden_pairs
                resets = resets + self.stat_reset_rows
            self.stat_hidden_pairs, self.stat_reset_rows = hidden, resets
            self.stat_pairs += mask.numel()
            self.stat_rows += reset.numel()
        return mask

    def forward(self, feats: Sequence[torch.Tensor],
                queries: Optional[torch.Tensor] = None, train: bool = False):
        """feats: 4 NHWC maps (strides 4, 8, 16, 32 in the reference; all
        at one stride for a plain ViT); queries: the ``[Nq, C]`` Rein query
        vector, which a head with ``rein_queries`` needs. Returns
        (cls_preds, mask_preds): lists over the predicting stages of
        [B, Nq, num_classes + 1] and [B, Nq, H0, W0]; every stage with
        ``train``, else the last only."""
        if self.rein_queries and queries is None:
            raise ValueError("a head with rein_queries needs the backbone's "
                             "queries")
        with profiling.span("vfmseg.pixel_decoder"):
            mask_features, memories = self.pixel_decoder(feats)
        with profiling.span("vfmseg.mask_decoder"):
            return self._decode(mask_features, memories, queries, train)

    def _decode(self, mask_features: torch.Tensor,
                memories: Sequence[torch.Tensor],
                queries: Optional[torch.Tensor], train: bool):
        """The decoder over the pixel decoder's outputs; as ``forward``."""
        b = mask_features.shape[0]
        inputs, poses, shapes = [], [], []
        for i in range(self.num_levels):
            m = memories[i]
            h, w, c = m.shape[1:]
            shapes.append((h, w))
            inputs.append(m.reshape(b, h * w, c)
                          + self.level_embed[i].to(m.dtype)[None, None])
            poses.append(_sine_on(h, w, c // 2, m.device)[None].expand(
                b, h * w, c).to(m.dtype))
        pos = queries if self.rein_queries else self.query_embed
        query_pos = pos[None].expand((b,) + tuple(pos.shape)).to(self.dtype)
        if hasattr(self, "querys2feat"):
            query_feat = self.querys2feat(query_pos)
        else:
            query_feat = self.query_feat[None].expand(
                (b,) + tuple(self.query_feat.shape)).to(self.dtype)

        def layer(i, qf, mask):
            lvl = i % self.num_levels
            return getattr(self, f"decoder_layer{i}")(
                qf, inputs[lvl], query_pos, poses[lvl], mask)

        def predict(qf):
            out = self.decoder_norm(qf)
            mask_pred = torch.einsum("bqc,bhwc->bqhw", self.mask_embed(out),
                                     mask_features)
            return self.cls_embed(out), mask_pred

        if train:
            cls_preds, mask_preds = [], []
            for i in range(self.num_decoder_layers + 1):
                if i:
                    query_feat = layer(i - 1, query_feat, attn_mask)
                cls_pred, mask_pred = predict(query_feat)
                cls_preds.append(cls_pred)
                mask_preds.append(mask_pred)
                target = shapes[i % self.num_levels]
                attn_mask = self._mask(resize(
                    mask_pred.permute(0, 2, 3, 1), size=target,
                    method="bilinear").permute(0, 3, 1, 2))
            return cls_preds, mask_preds

        # inference: the mask at each level's resolution against mask
        # features resized first (resize commutes with the channel product in
        # real arithmetic; the rounding differs)
        feats_lvl = [resize(mask_features, size=s, method="bilinear")
                     for s in shapes]

        def attn_mask_at(qf, lvl):
            membed = self.mask_embed(self.decoder_norm(qf))
            return self._mask(torch.einsum("bqc,bhwc->bqhw", membed,
                                           feats_lvl[lvl]))

        attn_mask = attn_mask_at(query_feat, 0)
        for i in range(self.num_decoder_layers):
            query_feat = layer(i, query_feat, attn_mask)
            if i + 1 < self.num_decoder_layers:
                attn_mask = attn_mask_at(query_feat,
                                         (i + 1) % self.num_levels)
        cls_pred, mask_pred = predict(query_feat)
        return [cls_pred], [mask_pred]


def semantic_inference(cls_pred: torch.Tensor, mask_pred: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """Last-stage predictions -> semantic logits [B, H, W, num_classes] in
    fp32: softmax(cls) without the no-object class times sigmoid(mask)."""
    probs = torch.softmax(cls_pred.float(), dim=-1)[..., :num_classes]
    masks = torch.sigmoid(mask_pred.float())
    return torch.einsum("bqc,bqhw->bhwc", probs, masks)
