"""The plain reference: the MsVFM segmentor's inference in float32.

Written from the layer equations of the configurations the benchmark runs
(LoRA DINOv2-L and LoRA EVA02-L under the MsVFM segmentor: LinearHead,
VFMHead with its cross-attention decoder), in plain PyTorch, with no kernel,
cache or batching of the program. Every product of a matrix multiplication,
a convolution (the patch embedding, the 1x1 and the 2x2 stride-2
convolutions, the 2x2 stride-2 transposed convolutions) and attention goes
through :class:`Products`, so the same model computes in float32 or, as the
control, with each product's operands rounded to float8 (e4m3, one scale a
tensor). Module and parameter names are those of the program's state dict,
so one set of tensors loads into both.

Departures from the published description, all shared with the program as
configured: the ViT runs at patch 16 on a 32 x 32 position grid (VFMSeg's
converted checkpoints), LoRA is folded into its base weight in inference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 format under one scale for the tensor."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in float8 e4m3, and in the backward the
    incoming gradient in float8 e5m2 (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Products:
    """How the reference computes: its products in float32, or (the
    control, the precision step below the bf16 that the configurations
    state) with each operand rounded to float8 e4m3 under a per-tensor
    scale, and in training each product's incoming gradient to float8
    e5m2; and in training, the named random streams its dropout, mask and
    crop draws come from (``gens``: name -> ``torch.Generator``; None in
    inference)."""

    def __init__(self, fp8: bool = False, gens: Optional[Dict] = None):
        self.fp8 = fp8
        self.gens = gens

    @property
    def training(self) -> bool:
        return self.gens is not None

    def linear(self, x, w, b=None):
        y = self.matmul(x, w.t())
        return y if b is None else y + b

    def matmul(self, a, b):
        if not self.fp8:
            return a @ b
        if a.dim() > b.dim():
            lead = a.shape[:-1]
            return _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(
                *lead, b.shape[-1])
        return _Fp8Matmul.apply(a, b)

    def uniform(self, name: str, shape, device) -> torch.Tensor:
        g = self.gens[name]
        return torch.rand(tuple(shape), generator=g, device=g.device).to(
            device)

    def drop_path(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Stochastic depth: one keep draw a sample from the ``dropout``
        stream, kept samples scaled by 1 / (1 - rate)."""
        if not self.training or rate == 0.0:
            return x
        keep = self.uniform("dropout", (x.shape[0],) + (1,) * (x.dim() - 1),
                            x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Keep with probability 1 - rate, kept values scaled by
        1 / (1 - rate), from the ``dropout`` stream; the identity in
        inference."""
        if not self.training or rate == 0.0:
            return x
        keep = self.uniform("dropout", x.shape, x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Linear(nn.Module):
    """y = x (W + (alpha / r) B A)^T + b in inference; LoRA only where
    ``rank``, and in training on the dropped-out input."""

    def __init__(self, fin: int, fout: int, bias: bool = True,
                 rank: int = 0, alpha: float = 1.0, dropout: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None
        self.rank = rank
        if rank:
            self.scaling = alpha / rank
            self.dropout = dropout
            self.lora_a = nn.Parameter(torch.empty(rank, fin))
            self.lora_b = nn.Parameter(torch.empty(fout, rank))

    def effective_weight(self) -> torch.Tensor:
        w = self.weight
        if self.rank:
            w = w + (self.lora_b @ self.lora_a) * self.scaling
        return w

    def forward(self, x: torch.Tensor, pr: Products) -> torch.Tensor:
        if not (pr.training and self.rank):
            return pr.linear(x, self.effective_weight(), self.bias)
        # training: x W^T + b + (alpha / r) dropout(x) A^T B^T
        low = pr.linear(pr.linear(pr.dropout(x, self.dropout), self.lora_a),
                        self.lora_b)
        return pr.linear(x, self.weight, self.bias) + low * self.scaling


class Conv(nn.Module):
    """A convolution whose stride equals its kernel (the patch embedding,
    1x1 and 2x2 stride-2) on NHWC input, as a product over patches; the
    weight is PyTorch's [out, in, k, k]."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, pr: Products) -> torch.Tensor:
        b, h, w, c = x.shape
        k = self.k
        if k > 1:
            x = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 5, 2, 4)
            x = x.reshape(b, h // k, w // k, c * k * k)
        return pr.linear(x, self.weight.reshape(self.weight.shape[0], -1),
                         self.bias)


class ConvT(nn.Module):
    """A 2x2 stride-2 transposed convolution on NHWC input; the weight is
    PyTorch's [in, out, 2, 2]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, pr: Products) -> torch.Tensor:
        b, h, w, _ = x.shape
        cout = self.weight.shape[1]
        y = pr.matmul(x, self.weight.reshape(self.weight.shape[0], -1))
        y = y.reshape(b, h, w, cout, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return y.reshape(b, 2 * h, 2 * w, cout) + self.bias


class Norm(nn.Module):
    """Affine LayerNorm over the last axis."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm of NHWC input."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.groups = _groups(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), self.groups, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm of NHWC input: the running statistics in inference, the
    batch's (biased variance) in training."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, pr: Products):
        if pr.training:
            var, mean = torch.var_mean(x, dim=(0, 1, 2), unbiased=False)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) \
            + self.bias


def _groups(channels: int, preferred: int = 32) -> int:
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def attention(pr: Products, q, k, v, block: int = 4) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, H, N, D], in blocks of the batch
    so that the [B, H, N, N] scores fit."""
    scale = q.shape[-1] ** -0.5
    out = []
    for i in range(0, q.shape[0], block):
        s = pr.matmul(q[i:i + block], k[i:i + block].transpose(-1, -2))
        p = torch.softmax(s * scale, dim=-1)
        out.append(pr.matmul(p, v[i:i + block]))
    return torch.cat(out)


def resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NHWC input (half-pixel centres, no antialias)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def rope_tables(gh: int, gw: int, head_dim: int, pt_seq_len: int,
                intp_freq: bool, theta: float = 10000.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """EVA02's 2D rotary tables over the patch grid, [gh*gw, head_dim]:
    per axis the frequencies 1/theta^(2i/half) over half the head dim,
    positions ``arange(n) / n * pt_seq_len`` (interpolated), each frequency
    repeated for a pair; rows then columns."""
    half = head_dim // 2
    inv = 1.0 / theta ** (np.arange(0, half, 2, dtype=np.float64)[:half // 2]
                          / half)

    def axis(n):
        t = np.arange(n, dtype=np.float64)
        if intp_freq:
            t = t / n * pt_seq_len
        return np.repeat(np.outer(t, inv), 2, axis=-1)

    fy, fx = axis(gh), axis(gw)
    ang = np.concatenate([np.broadcast_to(fy[:, None], (gh, gw, half)),
                          np.broadcast_to(fx[None, :], (gh, gw, half))],
                         axis=-1).reshape(gh * gw, head_dim)
    return np.cos(ang), np.sin(ang)


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


class Block(nn.Module):
    """Pre-norm ViT block: DINOv2's (fused qkv, GELU MLP, LayerScale) or
    EVA02's (q, k, v projections with k bias-free, RoPE, SwiGLU with its
    sub-LayerNorm, no LayerScale)."""

    def __init__(self, e: int, heads: int, hidden: int, eva: bool,
                 layer_scale: bool, lora: Dict, drop_path: float = 0.0):
        super().__init__()
        self.heads = heads
        self.drop_path = drop_path
        self.eva = eva
        self.norm1 = Norm(e, 1e-6)
        self.norm2 = Norm(e, 1e-6)
        attn = nn.Module()

        def lin(name, fin, fout, bias=True):
            r = lora["rank"] if name in lora["targets"] else 0
            return Linear(fin, fout, bias, r, lora["alpha"], lora["dropout"])

        if eva:
            attn.q_proj = lin("q_proj", e, e)
            attn.k_proj = lin("k_proj", e, e, bias=False)
            attn.v_proj = lin("v_proj", e, e)
        else:
            attn.qkv = lin("qkv", e, 3 * e)
        attn.proj = lin("proj", e, e)
        self.attn = attn
        mlp = nn.Module()
        if eva:
            mlp.w1 = lin("w1", e, hidden)
            mlp.w2 = lin("w2", e, hidden)
            mlp.ffn_ln = Norm(hidden, 1e-6)
            mlp.w3 = lin("w3", hidden, e)
        else:
            mlp.fc1 = lin("fc1", e, hidden)
            mlp.fc2 = lin("fc2", hidden, e)
        self.mlp = mlp
        if layer_scale:
            self.ls1 = nn.Module()
            self.ls1.gamma = nn.Parameter(torch.empty(e))
            self.ls2 = nn.Module()
            self.ls2.gamma = nn.Parameter(torch.empty(e))
        self.layer_scale = layer_scale

    def _attention(self, x, pr: Products, rope) -> torch.Tensor:
        b, n, e = x.shape
        h = self.heads
        a = self.attn
        if self.eva:
            q, k, v = (lin(x, pr) for lin in (a.q_proj, a.k_proj, a.v_proj))
        else:
            q, k, v = a.qkv(x, pr).split(e, dim=-1)
        q, k, v = (t.reshape(b, n, h, e // h).transpose(1, 2)
                   for t in (q, k, v))
        if rope is not None:
            cos, sin = rope
            q = q * cos + rotate_pairs(q) * sin
            k = k * cos + rotate_pairs(k) * sin
        out = attention(pr, q, k, v).transpose(1, 2).reshape(b, n, e)
        return a.proj(out, pr)

    def _mlp(self, x, pr: Products) -> torch.Tensor:
        m = self.mlp
        if self.eva:
            return m.w3(m.ffn_ln(F.silu(m.w1(x, pr)) * m.w2(x, pr)), pr)
        return m.fc2(F.gelu(m.fc1(x, pr)), pr)

    def forward(self, x, pr: Products, rope=None):
        y = self._attention(self.norm1(x), pr, rope)
        y = y * self.ls1.gamma if self.layer_scale else y
        x = x + pr.drop_path(y, self.drop_path)
        y = self._mlp(self.norm2(x), pr)
        y = y * self.ls2.gamma if self.layer_scale else y
        return x + pr.drop_path(y, self.drop_path)


class ViT(nn.Module):
    """The backbone: patch embedding, a cls token, the learned position
    embedding (bicubic with DINOv2's +0.1 scale trick at another grid),
    ``depth`` blocks, the maps after the blocks of ``out_indices``."""

    def __init__(self, bb: Dict, lora: Dict):
        super().__init__()
        eva = bb["type"] == "EVA2"
        e = int(bb.get("embed_dim", 1024))
        self.e = e
        self.p = int(bb.get("patch_size", 16))
        self.heads = int(bb.get("num_heads", 16))
        self.side = int(bb.get("img_size", 512)) // self.p
        self.depth = int(bb.get("depth", 24))
        self.out_indices = tuple(bb.get("out_indices", (7, 11, 15, 23)))
        self.eva = eva
        self.rope_cfg = ((int(bb.get("pt_hw_seq_len", 16)),
                          bool(bb.get("intp_freq", True)))
                         if eva and bb.get("rope", True) else None)
        ratio = float(bb.get("mlp_ratio", 4.0))
        layer_scale = bb.get("init_values", None if eva else 1e-5) is not None
        self.patch_embed = Conv(3, e, self.p)
        self.cls_token = nn.Parameter(torch.empty(1, 1, e))
        self.pos_embed = nn.Parameter(torch.empty(1, self.side ** 2 + 1, e))
        rate = float(bb.get("drop_path_rate", 0.0))
        # the drop-path rate grows linearly over the depth
        self.blocks = nn.ModuleList(
            Block(e, self.heads, int(e * ratio), eva, layer_scale, lora,
                  rate * i / max(self.depth - 1, 1))
            for i in range(self.depth))

    def _pos(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.pos_embed
        if (gh, gw) == (self.side, self.side):
            return pos
        g = pos[:, 1:].reshape(1, self.side, self.side, -1).permute(0, 3, 1, 2)
        g = F.interpolate(g, mode="bicubic", align_corners=False,
                          scale_factor=((gh + 0.1) / self.side,
                                        (gw + 0.1) / self.side),
                          recompute_scale_factor=False)
        g = g.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :1], g], dim=1)

    def _rope(self, gh: int, gw: int, device):
        if self.rope_cfg is None:
            return None
        cos, sin = rope_tables(gh, gw, self.e // self.heads, *self.rope_cfg)
        d = cos.shape[1]
        cos = np.concatenate([np.ones((1, d)), cos])
        sin = np.concatenate([np.zeros((1, d)), sin])
        return tuple(torch.tensor(t, dtype=torch.float32, device=device)
                     for t in (cos, sin))

    def forward(self, img: torch.Tensor, pr: Products) -> List[torch.Tensor]:
        b, h, w, _ = img.shape
        gh, gw = h // self.p, w // self.p
        x = self.patch_embed(img, pr).reshape(b, gh * gw, self.e)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self._pos(gh, gw)
        rope = self._rope(gh, gw, img.device)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, pr, rope)
            if i in self.out_indices:
                outs.append(x[:, 1:].reshape(b, gh, gw, self.e))
        return outs


class LinearHead(nn.Module):
    """Concatenated maps -> 1x1 conv, GroupNorm, ReLU -> 2x2 stride-2
    transposed conv, BatchNorm, GELU -> transposed conv, GELU -> dropout in
    training -> 1x1 classifier (at 4x the grid)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        c = int(cfg["in_channels"][0])
        cin = sum(int(x) for x in cfg["in_channels"])
        self.fusion_conv = Conv(cin, c, 1)
        self.fusion_gn = GroupNorm(c, 1e-5)
        self.up1 = ConvT(c, c // 2)
        self.up_bn = BatchNorm(c // 2)
        self.up2 = ConvT(c // 2, c // 4)
        self.conv_seg = Conv(c // 4, int(cfg["num_classes"]), 1)
        self.rate = float(cfg.get("dropout_ratio", 0.0))

    def forward(self, feats, pr: Products):
        x = F.relu(self.fusion_gn(self.fusion_conv(torch.cat(feats, -1), pr)))
        x = F.gelu(self.up_bn(self.up1(x, pr), pr))
        x = F.gelu(self.up2(x, pr))
        return self.conv_seg(pr.dropout(x, self.rate), pr)


class CrossAttention(nn.Module):
    """q from x, k and v from the context; dropout after ``to_out`` in
    training."""

    def __init__(self, dim: int, heads: int, d_head: int, rate: float,
                 context_dim: int):
        super().__init__()
        inner = heads * d_head
        self.heads = heads
        self.rate = rate
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x, context, pr: Products):
        b, n, _ = x.shape
        nk = context.shape[1]
        h = self.heads

        def heads(t, m):
            return t.reshape(b, m, h, -1).transpose(1, 2)

        out = attention(pr, heads(self.to_q(x, pr), n),
                        heads(self.to_k(context, pr), nk),
                        heads(self.to_v(context, pr), nk))
        out = self.to_out(out.transpose(1, 2).reshape(b, n, -1), pr)
        return pr.dropout(out, self.rate)


class DecoderBlock(nn.Module):
    """Pre-norm self-attention, cross-attention to the context, GEGLU (with
    dropout after the gate in training)."""

    def __init__(self, dim: int, heads: int, d_head: int, rate: float,
                 context_dim: int):
        super().__init__()
        self.rate = rate
        self.norm1 = Norm(dim, 1e-5)
        self.attn1 = CrossAttention(dim, heads, d_head, rate, dim)
        self.norm2 = Norm(dim, 1e-5)
        self.attn2 = CrossAttention(dim, heads, d_head, rate, context_dim)
        self.norm3 = Norm(dim, 1e-5)
        ff = nn.Module()
        ff.geglu = nn.Module()
        ff.geglu.proj = Linear(dim, 8 * dim)
        ff.out = Linear(4 * dim, dim)
        self.ff = ff

    def forward(self, x, context, pr: Products):
        h = self.norm1(x)
        x = x + self.attn1(h, h, pr)
        x = x + self.attn2(self.norm2(x), context, pr)
        a, gate = self.ff.geglu.proj(self.norm3(x), pr).chunk(2, dim=-1)
        return x + self.ff.out(pr.dropout(a * F.gelu(gate), self.rate), pr)


class VFMHead(nn.Module):
    """Fused maps (1x1 conv, GroupNorm, GELU) as the decoder's query; the
    context logits resized to 4x the grid and embedded by two 2x2 stride-2
    convolutions and a 1x1 (each with GroupNorm) as its context; the
    decoder (GroupNorm of the query, ``depth`` blocks; in training a
    share ``mask_ratio`` of the query's pixels swapped for the mask token
    first); dropout in training; 1x1 classifier."""

    def __init__(self, cfg: Dict):
        super().__init__()
        t = cfg["transformer"]
        ch = int(cfg["channels"])
        k = int(cfg["num_classes"])
        cin = sum(int(x) for x in cfg["in_channels"])
        self.fuse_conv = Conv(cin, ch, 1)
        self.fuse_gn = GroupNorm(ch, 1e-5)
        self.embed_conv1 = Conv(k, ch // 4, 2)
        self.embed_gn1 = GroupNorm(ch // 4, 1e-5)
        self.embed_conv2 = Conv(ch // 4, ch // 2, 2)
        self.embed_gn2 = GroupNorm(ch // 2, 1e-5)
        self.embed_conv3 = Conv(ch // 2, ch, 1)
        self.embed_gn3 = GroupNorm(ch, 1e-5)
        qd = int(t.get("query_dim", ch))
        dec = nn.Module()
        self.mask_ratio = float(t.get("mask_ratio", 0.0))
        if self.mask_ratio > 0:
            dec.mask_token = nn.Parameter(torch.empty(1, 1, 1, qd))
        dec.norm = GroupNorm(qd, 1e-6)
        dec.block = nn.ModuleList(
            DecoderBlock(qd, int(t["n_heads"]), int(t["d_head"]),
                         float(t.get("dropout", 0.0)), ch)
            for _ in range(int(t["depth"])))
        self.transformer_decoder = dec
        self.conv_seg = Conv(ch, k, 1)
        self.rate = float(cfg.get("dropout_ratio", 0.0))

    def forward(self, feats, context_logits, pr: Products):
        b, gh, gw, _ = feats[0].shape
        ctx = resize(context_logits, (gh * 4, gw * 4))
        q = F.gelu(self.fuse_gn(self.fuse_conv(torch.cat(feats, -1), pr)))
        e = F.gelu(self.embed_gn1(self.embed_conv1(ctx, pr)))
        e = F.gelu(self.embed_gn2(self.embed_conv2(e, pr)))
        e = self.embed_gn3(self.embed_conv3(e, pr))
        dec = self.transformer_decoder
        if pr.training and self.mask_ratio > 0:
            # the masked decoder: query pixels swapped for the mask token
            keep = pr.uniform("mask", (b, gh, gw, 1), q.device) \
                > self.mask_ratio
            q = torch.where(keep, q, dec.mask_token)
        x = dec.norm(q).reshape(b, gh * gw, -1)
        e = e.reshape(b, -1, e.shape[-1])
        for blk in dec.block:
            x = blk(x, e, pr)
        x = pr.dropout(x.reshape(b, gh, gw, -1), self.rate)
        return self.conv_seg(x, pr)


class MsVFM(nn.Module):
    """The segmentor: ``lr_forward`` (backbone and LinearHead, logits at
    the image's size) and ``hr_forward`` (backbone and VFMHead given the
    context logits)."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        bb = model_cfg["backbone"]
        lora_cfg = bb.get("Lora_config", {}) if bb["type"] == "LoRABackbone" \
            else {}
        inner = bb.get("backbone", bb)
        alias = {"attn.proj": "proj", "out_proj": "proj"}
        lora = dict(rank=int(lora_cfg.get("r", 0)),
                    alpha=float(lora_cfg.get("lora_alpha", 1.0)),
                    dropout=float(lora_cfg.get("lora_dropout", 0.0)),
                    targets={alias.get(t, t)
                             for t in lora_cfg.get("target_modules", ())})
        self.backbone = ViT(inner, lora)
        self.decode_head = LinearHead(model_cfg["decode_head"])
        self.aux_head = VFMHead(model_cfg["aux_head"])

    def lr_forward(self, img, pr: Products):
        logits = self.decode_head(self.backbone(img, pr), pr)
        return resize(logits, img.shape[1:3])

    def train_losses(self, img, labels, pr: Products, hr_crop: Sequence[int],
                     divisible: int, detail_loss: float) -> Dict:
        """The two-scale training losses: the image at half scale (labels
        at their even pixels) through the backbone and the LinearHead; an
        ``hr_crop`` box at full scale, its corner drawn from the ``crop``
        stream on multiples of ``divisible``, through the backbone (one
        call with the half-scale view) and the masked VFMHead, conditioned
        on the detached half-scale logits cut to the box. Cross-entropy
        over every pixel, ignored ones (255) adding 0."""
        b, h, w, _ = img.shape
        ch, cw = hr_crop
        lr_img = resize(img, (h // 2, w // 2))
        lr_labels = labels[:, ::2, ::2]
        y1 = int(torch.randint(0, max((h - ch + 1) // divisible, 1), (1,),
                               generator=pr.gens["crop"])) * divisible
        x1 = int(torch.randint(0, max((w - cw + 1) // divisible, 1), (1,),
                               generator=pr.gens["crop"])) * divisible
        hr_img = img[:, y1:y1 + ch, x1:x1 + cw]
        hr_labels = labels[:, y1:y1 + ch, x1:x1 + cw]
        feats = self.backbone(torch.cat([lr_img, hr_img]), pr)
        lr_logits = resize(self.decode_head([f[:b] for f in feats], pr),
                           lr_labels.shape[1:3])
        context = lr_logits.detach()[:, y1 // 2:y1 // 2 + ch // 2,
                                     x1 // 2:x1 // 2 + cw // 2]
        hr_logits = resize(self.aux_head([f[b:] for f in feats], context,
                                         pr), (ch, cw))
        return {"decode_lr.loss_ce": cross_entropy(lr_logits, lr_labels),
                "decode_hr.loss_ce": cross_entropy(hr_logits, hr_labels)
                * detail_loss}

    def hr_forward(self, img, context, pr: Products, block: int = 6):
        out = []
        for i in range(0, img.shape[0], block):
            logits = self.aux_head(self.backbone(img[i:i + block], pr),
                                   context[i:i + block], pr)
            out.append(resize(logits, img.shape[1:3]))
        return torch.cat(out)


def cross_entropy(logits, labels, ignore: int = 255) -> torch.Tensor:
    """Summed over the pixels that are not ignored, over every pixel."""
    nll = F.cross_entropy(logits.permute(0, 3, 1, 2), labels.long(),
                          ignore_index=ignore, reduction="none")
    return nll.sum() / labels.numel()


def build(model_cfg: Dict, device) -> MsVFM:
    """The reference model, parameters uninitialised, on ``device``
    (``"meta"`` for the shapes alone)."""
    with torch.device(device):
        return MsVFM(model_cfg).eval()


def slide_grid(hw: Tuple[int, int], crop: Tuple[int, int],
               stride: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The (y, x) origins of the slide windows, row-major: windows at
    multiples of the stride, the last of each axis moved back inside."""
    (h, w), (ch, cw), (sh, sw) = hw, crop, stride
    rows = max(h - ch + sh - 1, 0) // sh + 1
    cols = max(w - cw + sw - 1, 0) // sw + 1
    return [(max(min(i * sh + ch, h) - ch, 0),
             max(min(j * sw + cw, w) - cw, 0))
            for i in range(rows) for j in range(cols)]


def confident_share(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """Share of a window's pixels whose largest softmax probability
    exceeds ``threshold``, for [G, h, w, C] window logits."""
    p = torch.softmax(logits, dim=-1).amax(dim=-1)
    return (p > threshold).float().mean(dim=(1, 2))

