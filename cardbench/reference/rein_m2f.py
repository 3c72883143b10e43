"""The plain reference of ``rein_m2f``: Rein DINOv2 under the Mask2Former
head, mmseg's slide inference, in float32.

Written from the published equations in plain PyTorch, with no kernel,
cache or batching of the program, and importing nothing of it:

* the DINOv2 blocks (``model.ViT``) with Rein after every block (Wei et al.,
  CVPR 2024; ``reins.py``): per layer ``l`` the tokens ``T_l = A_l B_l``
  (LoRAReins), ``attn = softmax(x T_l^T / sqrt(E))`` over the tokens,
  ``delta = mlp_delta_f(attn[:, :, 1:] mlp_token2feat(T_l[1:]) + x)`` and
  ``x + scale * delta`` on the patch tokens, the cls token passing; the
  query vector ``merge([max_l, mean_l, last] of transform(T))``;
* the ``resize_feat`` pyramid: the four maps resized x4, x2, x1, x0.5
  (bilinear, half-pixel centres);
* mmdet's ``MSDeformAttnPixelDecoder``: 1x1 convolution and GroupNorm per
  level on the stride-32, 16 and 8 maps, the normalised sine positions plus
  a level embedding, 6 post-norm deformable encoder layers (mmcv's
  ``MultiScaleDeformableAttention``, its sampling written as
  ``multi_scale_deformable_attn_pytorch`` writes it: ``grid_sample``,
  bilinear, zero padding, ``align_corners=False``), the FPN lateral with the
  top-down memory and the mask features;
* mmdet's ``Mask2FormerHead`` at inference (Cheng et al., CVPR 2022): the
  Rein queries as positional queries and ``querys2feat`` of them as content
  queries (``ReinMask2FormerHead``); before each of the 9 post-norm decoder
  layers (masked cross-attention, self-attention, FFN) a mask from the
  current queries, ``sigmoid(mask logits) < 0.5`` at the level's size,
  where a row that would hide every key attends to all of them; the last
  stage's prediction;
* the semantic inference ``sum_q softmax(cls)[:19] sigmoid(mask)``, and
  mmseg's slide: each crop's logits resized to the crop, summed over the
  windows, divided by the coverage, resized to the frame.

Every product of a matrix multiplication, convolution or attention goes
through ``model.Products``, so the control computes them with float8
operands; the bilinear sampling and its weighted sum are not products.
Names and shapes are those of the program's state dict.

Departures from the published description, all shared with the program:
the ViT runs at patch 16 on a 32 x 32 position grid (VFMSeg's converted
checkpoints); the semantic logits are formed at the mask features'
resolution and then resized to the crop (the VFMSeg JAX package's order;
mmseg resizes the mask logits first); the attention-mask logits are the
product at the mask features' resolution resized to the level (mmdet's
order; the program resizes the mask features first, which is equal in exact
arithmetic); a masked key gets -inf (the program adds -1e9; the same
weights where no row is all masked, which the rule ensures).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.model import (
    GroupNorm,
    Linear,
    Norm,
    Products,
    ViT,
    resize,
    slide_grid,
)
from cardbench.reference.model import Conv as Conv1


class Conv(nn.Module):
    """A stride-1 convolution of odd size ``k`` with zero padding (k - 1) / 2
    on NHWC input, as one product over the k x k patches; the weight is
    PyTorch's [out, in, k, k]."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool):
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor, pr: Products) -> torch.Tensor:
        b, h, w, _ = x.shape
        k, r = self.k, self.k // 2
        if k > 1:
            xp = F.pad(x, (0, 0, r, r, r, r))
            # patch channel index c * k * k + dy * k + dx, as the weight's
            x = torch.stack([xp[:, dy:dy + h, dx:dx + w]
                             for dy in range(k) for dx in range(k)], dim=-1)
            x = x.reshape(b, h, w, -1)
        return pr.linear(x, self.weight.reshape(self.weight.shape[0], -1),
                         self.bias)


class Reins(nn.Module):
    """LoRAReins: a rank-r token bank for each of ``layers`` blocks, its
    update of the patch tokens, and the query vector."""

    def __init__(self, layers: int, e: int, tokens: int, rank: int,
                 query_dims: int):
        super().__init__()
        self.e, self.rank = e, rank
        self.learnable_tokens_a = nn.Parameter(torch.empty(layers, tokens,
                                                           rank))
        self.learnable_tokens_b = nn.Parameter(torch.empty(layers, rank, e))
        self.scale = nn.Parameter(torch.empty(()))
        self.mlp_token2feat = Linear(e, e)
        self.mlp_delta_f = Linear(e, e)
        self.transform = Linear(e, query_dims)
        self.merge = Linear(3 * query_dims, query_dims)

    def tokens(self, pr: Products) -> torch.Tensor:
        """[L, T, E]."""
        return pr.matmul(self.learnable_tokens_a, self.learnable_tokens_b)

    def adapt(self, x: torch.Tensor, t: torch.Tensor,
              pr: Products) -> torch.Tensor:
        """x: [B, 1 + N, E] (cls first); t: the layer's [T, E] tokens."""
        cls, feats = x[:, :1], x[:, 1:]
        attn = torch.softmax(pr.matmul(feats, t.t()) * self.e ** -0.5, -1)
        delta = pr.matmul(attn[:, :, 1:], self.mlp_token2feat(t[1:], pr))
        delta = self.mlp_delta_f(delta + feats, pr)
        return torch.cat([cls, feats + self.scale * delta], dim=1)

    def queries(self, t: torch.Tensor, pr: Products) -> torch.Tensor:
        """[T, query_dims] from every layer's tokens ``t`` [L, T, E]."""
        q = self.transform(t, pr)
        return self.merge(torch.cat([q.amax(0), q.mean(0), q[-1]], -1), pr)


class ReinViT(ViT):
    """DINOv2 with Rein after every block: (the four maps as the
    ``resize_feat`` pyramid, the query vector)."""

    def __init__(self, bb: Dict):
        super().__init__(bb, dict(rank=0, alpha=1.0, dropout=0.0,
                                  targets=set()))
        rc = bb["reins_config"]
        self.reins = Reins(self.depth, self.e, int(rc["token_length"]),
                           int(rc["lora_dim"]),
                           int(rc.get("query_dims", 256)))

    def forward(self, img: torch.Tensor, pr: Products
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        b, h, w, _ = img.shape
        gh, gw = h // self.p, w // self.p
        x = self.patch_embed(img, pr).reshape(b, gh * gw, self.e)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self._pos(gh, gw)
        tokens = self.reins.tokens(pr)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = self.reins.adapt(blk(x, pr), tokens[i], pr)
            if i in self.out_indices:
                outs.append(x[:, 1:].reshape(b, gh, gw, self.e))
        pyramid = [_scale(f, s) for f, s in zip(outs, (4.0, 2.0, 1.0, 0.5))]
        return pyramid, self.reins.queries(tokens, pr)


def _scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` by ``s`` (half-pixel centres)."""
    if s == 1.0:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=s, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def sine_positions(h: int, w: int, num_feats: int,
                   device) -> torch.Tensor:
    """mmdet's ``SinePositionalEncoding`` (normalize, scale 2 pi, eps 1e-6,
    temperature 10000) of an all-valid h x w map: [h * w, 2 num_feats], the
    y half first."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = (y / (y[-1] + eps) * scale)[:, None].expand(h, w)
    x = (x / (x[-1] + eps) * scale)[None, :].expand(h, w)
    i = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(i, 2, rounding_mode="floor")
                        / num_feats)

    def embed(t):
        t = t[..., None] / dim_t
        return torch.stack([t[..., 0::2].sin(), t[..., 1::2].cos()],
                           dim=-1).reshape(h, w, num_feats)

    return torch.cat([embed(y), embed(x)], dim=-1).reshape(h * w, -1)


class FFN(nn.Module):
    """fc2(relu(fc1(x))) plus the residual (mmcv ``FFN``)."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(c, hidden)
        self.fc2 = Linear(hidden, c)

    def forward(self, x, pr: Products):
        return x + self.fc2(F.relu(self.fc1(x, pr)), pr)


class DeformAttn(nn.Module):
    """mmcv's ``MultiScaleDeformableAttention``: 8 heads, 3 levels, 4
    points; offsets and weights from the query plus its position, the value
    projected from the tokens without it; the residual added by the
    caller."""

    def __init__(self, c: int, heads: int = 8, levels: int = 3,
                 points: int = 4):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = Linear(c, c)
        self.sampling_offsets = Linear(c, heads * levels * points * 2)
        self.attention_weights = Linear(c, heads * levels * points)
        self.output_proj = Linear(c, c)

    def forward(self, query, value, ref, shapes, pr: Products):
        """query, value: [B, N, C]; ref: [N, 2] normalised (x, y); shapes:
        the levels' (h, w), in the order of ``value``'s tokens."""
        b, n, c = query.shape
        hd, lv, pt = self.heads, self.levels, self.points
        d = c // hd
        v = self.value_proj(value, pr).reshape(b, -1, hd, d)
        off = self.sampling_offsets(query, pr).reshape(b, n, hd, lv, pt, 2)
        wts = torch.softmax(self.attention_weights(query, pr).reshape(
            b, n, hd, lv * pt), -1)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=query.device)
        loc = ref[None, :, None, None, None, :] \
            + off / norm[None, None, None, :, None, :]
        grids = 2 * loc - 1
        samples, start = [], 0
        for lvl, (h, w) in enumerate(shapes):
            vl = v[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
                b * hd, d, h, w)
            start += h * w
            g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
                b * hd, n, pt, 2)
            samples.append(F.grid_sample(vl, g, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=False))
        # [B*heads, d, N, L*P] against [B*heads, 1, N, L*P]
        s = torch.stack(samples, dim=-2).flatten(-2)
        wts = wts.permute(0, 2, 1, 3).reshape(b * hd, 1, n, lv * pt)
        out = (s * wts).sum(-1).reshape(b, hd * d, n).transpose(1, 2)
        return self.output_proj(out, pr)


class EncoderLayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.self_attn = DeformAttn(c)
        self.norm1 = Norm(c, 1e-5)
        self.ffn = FFN(c, 1024)
        self.norm2 = Norm(c, 1e-5)

    def forward(self, x, pos, ref, shapes, pr: Products):
        x = self.norm1(x + self.self_attn(x + pos, x, ref, shapes, pr))
        return self.norm2(self.ffn(x, pr))


class PixelDecoder(nn.Module):
    def __init__(self, e: int, c: int, layers: int = 6, levels: int = 3):
        super().__init__()
        self.c, self.levels, self.layers = c, levels, layers
        self.level_embed = nn.Parameter(torch.empty(levels, c))
        for i in range(levels):
            self.add_module(f"input_conv{i}", Conv1(e, c, 1))
            self.add_module(f"input_gn{i}", GroupNorm(c, 1e-5))
        for i in range(layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(c))
        self.lateral_conv = Conv(e, c, 1, bias=False)
        self.lateral_gn = GroupNorm(c, 1e-5)
        self.output_conv = Conv(c, c, 3, bias=False)
        self.output_gn = GroupNorm(c, 1e-5)
        self.mask_feature = Conv1(c, c, 1)

    def forward(self, feats: Sequence[torch.Tensor], pr: Products):
        """feats: the pyramid, strides 4 to 32. Returns (mask features
        [B, H0, W0, C], the memories at strides 32, 16, 8)."""
        b = feats[0].shape[0]
        tokens, poses, shapes = [], [], []
        for i in range(self.levels):
            f = feats[len(feats) - 1 - i]
            x = getattr(self, f"input_gn{i}")(
                getattr(self, f"input_conv{i}")(f, pr))
            h, w = x.shape[1:3]
            shapes.append((h, w))
            tokens.append(x.reshape(b, h * w, self.c))
            poses.append(sine_positions(h, w, self.c // 2, x.device)
                         + self.level_embed[i])
        ref = torch.cat([torch.stack(torch.meshgrid(
            (torch.arange(w, device=feats[0].device) + 0.5) / w,
            (torch.arange(h, device=feats[0].device) + 0.5) / h,
            indexing="xy"), -1).reshape(h * w, 2) for h, w in shapes])
        x = torch.cat(tokens, 1)
        pos = torch.cat(poses)[None]
        for i in range(self.layers):
            x = getattr(self, f"encoder_layer{i}")(x, pos, ref, shapes, pr)
        memories, start = [], 0
        for h, w in shapes:
            memories.append(x[:, start:start + h * w].reshape(b, h, w,
                                                              self.c))
            start += h * w
        lat = self.lateral_gn(self.lateral_conv(feats[0], pr))
        y = lat + resize(memories[-1], lat.shape[1:3])
        y = F.relu(self.output_gn(self.output_conv(y, pr)))
        return self.mask_feature(y, pr), memories


class MHA(nn.Module):
    """``nn.MultiheadAttention`` with its in-projection ``[C, 3C]`` (q, k, v
    columns) and a boolean mask (True: do not attend)."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_kernel = nn.Parameter(torch.empty(c, 3 * c))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * c))
        self.out_proj = Linear(c, c)

    def forward(self, q, k, v, pr: Products, mask=None):
        c = q.shape[-1]
        w, bias = self.in_proj_kernel, self.in_proj_bias

        def proj(x, i):
            y = pr.matmul(x, w[:, i * c:(i + 1) * c]) + bias[i * c:(i + 1) * c]
            return y.reshape(x.shape[0], x.shape[1], self.heads, -1
                             ).transpose(1, 2)

        qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
        s = pr.matmul(qh, kh.transpose(-1, -2)) * qh.shape[-1] ** -0.5
        if mask is not None:
            s = s.masked_fill(mask[:, None], float("-inf"))
        out = pr.matmul(torch.softmax(s, -1), vh)
        return self.out_proj(out.transpose(1, 2).reshape(q.shape), pr)


class DecoderLayer(nn.Module):
    def __init__(self, c: int, heads: int = 8, ffn: int = 2048):
        super().__init__()
        self.cross_attn = MHA(c, heads)
        self.norm1 = Norm(c, 1e-5)
        self.self_attn = MHA(c, heads)
        self.norm2 = Norm(c, 1e-5)
        self.ffn = FFN(c, ffn)
        self.norm3 = Norm(c, 1e-5)

    def forward(self, query, memory, query_pos, key_pos, mask,
                pr: Products):
        x = self.cross_attn(query + query_pos, memory + key_pos, memory, pr,
                            mask)
        query = self.norm1(query + x)
        qp = query + query_pos
        query = self.norm2(query + self.self_attn(qp, qp, query, pr))
        return self.norm3(self.ffn(query, pr))


class Bf16Products(Products):
    """Products with each operand rounded to bfloat16, the precision the
    configuration states, and accumulated in float32: the rounding that a
    bf16 computation of these equations cannot avoid, the check's
    yardstick of how far rounding moves a seed's scores."""

    def matmul(self, a, b):
        return a.bfloat16().float() @ b.bfloat16().float()


def attention_mask(logits: torch.Tensor) -> torch.Tensor:
    """[B, Q, h, w] mask logits -> [B, Q, h*w], True where a query does not
    attend: sigmoid < 0.5, except in a row that would hide every key."""
    m = (logits.sigmoid() < 0.5).flatten(2)
    return m & ~m.all(-1, keepdim=True)


class Head(nn.Module):
    """ReinMask2FormerHead at inference (``replace_query_feat``)."""

    def __init__(self, cfg: Dict, e: int):
        super().__init__()
        c = int(cfg["feat_channels"])
        self.num_classes = int(cfg["num_classes"])
        self.levels = int(cfg["num_transformer_feat_level"])
        self.layers = int(cfg["transformer_decoder"]["num_layers"])
        self.pixel_decoder = PixelDecoder(e, c)
        self.level_embed = nn.Parameter(torch.empty(self.levels, c))
        self.querys2feat = Linear(c, c)
        self.decoder_norm = Norm(c, 1e-5)
        self.cls_embed = Linear(c, self.num_classes + 1)
        self.mask_embed = nn.Module()
        for i in range(3):
            setattr(self.mask_embed, f"fc{i}", Linear(c, c))
        for i in range(self.layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(c))
        # a list keeps every mask the forward calls make, in their order
        self.kept: Optional[List[torch.Tensor]] = None

    def layer_masks(self, kept: List[torch.Tensor]) -> List[torch.Tensor]:
        """Masks ``kept`` over forward calls (each call ``layers`` masks,
        one a layer) as one [crops, Q, keys] mask a decoder layer."""
        return [torch.cat(kept[i::self.layers]) for i in range(self.layers)]

    def _predict(self, q, mask_features, pr: Products):
        """(class logits [B, Q, K+1], mask logits [B, Q, H0, W0])."""
        out = self.decoder_norm(q)
        m = self.mask_embed
        emb = m.fc2(F.relu(m.fc1(F.relu(m.fc0(out, pr)), pr)), pr)
        b, h, w, c = mask_features.shape
        masks = pr.matmul(emb, mask_features.reshape(b, h * w, c)
                          .transpose(1, 2)).reshape(b, -1, h, w)
        return self.cls_embed(out, pr), masks

    def forward(self, feats, queries, pr: Products) -> torch.Tensor:
        """Semantic logits [B, H0, W0, num_classes]."""
        mask_features, memories = self.pixel_decoder(feats, pr)
        b = mask_features.shape[0]
        keys, key_pos, shapes = [], [], []
        for i, mem in enumerate(memories):
            h, w, c = mem.shape[1:]
            shapes.append((h, w))
            keys.append(mem.reshape(b, h * w, c) + self.level_embed[i])
            key_pos.append(sine_positions(h, w, c // 2, mem.device)[None])
        query_pos = queries[None].expand(b, -1, -1)
        q = self.querys2feat(query_pos, pr)

        def mask_at(q, lvl):
            _, logits = self._predict(q, mask_features, pr)
            mask = attention_mask(resize(logits.permute(0, 2, 3, 1),
                                         shapes[lvl]).permute(0, 3, 1, 2))
            if self.kept is not None:
                self.kept.append(mask)
            return mask

        mask = mask_at(q, 0)
        for i in range(self.layers):
            lvl = i % self.levels
            q = getattr(self, f"decoder_layer{i}")(q, keys[lvl], query_pos,
                                                   key_pos[lvl], mask, pr)
            if i + 1 < self.layers:
                mask = mask_at(q, (i + 1) % self.levels)
        cls, masks = self._predict(q, mask_features, pr)
        probs = torch.softmax(cls, -1)[..., :self.num_classes]
        return pr.matmul(masks.sigmoid().permute(0, 2, 3, 1),
                         probs[:, None])


class ReinM2F(nn.Module):
    """The segmentor: ``backbone`` (Rein DINOv2) and ``decode_head``."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        self.backbone = ReinViT(model_cfg["backbone"])
        self.decode_head = Head(model_cfg["decode_head"], self.backbone.e)

    def forward(self, crops: torch.Tensor, pr: Products) -> torch.Tensor:
        """Semantic logits [B, h, w, K] of crops [B, h, w, 3], at the
        crop's size."""
        feats, queries = self.backbone(crops, pr)
        return resize(self.decode_head(feats, queries, pr),
                      crops.shape[1:3])

    def slide_logits(self, img: torch.Tensor, test_cfg: Dict, pr: Products,
                     block: int = 6) -> torch.Tensor:
        """mmseg's slide inference of one frame [1, H, W, 3]: the crops'
        logits in blocks of ``block``, summed into the frame and divided by
        the coverage; [H, W, K]."""
        hw = tuple(img.shape[1:3])
        crop = tuple(test_cfg["crop_size"])
        boxes = slide_grid(hw, crop, tuple(test_cfg["stride"]))
        out = torch.zeros(hw + (self.decode_head.num_classes,),
                          device=img.device)
        count = torch.zeros(hw + (1,), device=img.device)
        with torch.no_grad():
            for i in range(0, len(boxes), block):
                part = boxes[i:i + block]
                crops = torch.cat([img[:, y:y + crop[0], x:x + crop[1]]
                                   for y, x in part])
                for (y, x), lg in zip(part, self(crops, pr)):
                    out[y:y + crop[0], x:x + crop[1]] += lg
                    count[y:y + crop[0], x:x + crop[1]] += 1
        return resize((out / count)[None], hw)[0]


def build(model_cfg: Dict, device) -> ReinM2F:
    """The reference model, parameters uninitialised, on ``device``
    (``"meta"`` for the shapes alone)."""
    with torch.device(device):
        return ReinM2F(model_cfg).eval()
