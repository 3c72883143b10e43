"""Vision Transformer core: the DINOv2, EVA02, CLIP and SAM paths.

Port of vfmseg_tpu/models/backbones/vit.py:44-128, 147-340 and 343-580,
restricted to what the DINOv2-L, EVA02-L, CLIP-L and SAM ViT-H configs use:
a learned cls token and position embedding (bicubic interpolation with
DINOv2's +0.1 trick at other grid sizes), or SAM's grid-shaped one without a
cls token (bilinear at other grid sizes), pre-norm blocks, optional
LayerScale, drop-path in training, feature maps taken before any final norm
at ``out_indices``, and four block families:

* DINOv2 (``attn_type="fused"``, ``ffn_layer="mlp"``): one fused qkv linear
  (optionally LoRA) read straight by the attention kernel, and an exact-erf
  GELU MLP.
* EVA02 (``attn_type="split_subln"``, ``ffn_layer="swiglu_eva"``,
  ``use_rope``): separate q/k/v projections (k without bias), 2D RoPE on the
  patch tokens, and the SwiGLU with its sub-LN over the hidden width. The
  attention has two routes, as the JAX module does:

  - *eval* (not training, no gradient wanted; vit.py:202-247): the three
    projections' LoRA-folded weights concatenate into one ``[3E, E]``
    product with the q/k rows permuted to the evens|odds RoPE layout, and
    the rotation happens inside the fused-qkv attention kernel (B2-RoPE);
  - *training* (vit.py:249-314): per-slot projections (LoRA sequential, with
    dropout), the rotation in PyTorch with the natural tables, and the
    head-major attention (B5 under autograd).

  The SwiGLU picks its route the same way: in eval its hidden is padded to
  16 bytes with zero weights (:class:`SwiGLUEva`).
* CLIP (``attn_type="fused"``, ``ffn_act="quick_gelu"``; vit.py:59-68):
  DINOv2's fused attention, an MLP with QuickGELU ``x sigmoid(1.702 x)``, no
  LayerScale, and CLIP's stem: a bias-free patch embedding, a
  ``class_embedding`` vector as the cls token that is added to the cls
  position a second time (``cls_style="clip_embed"``, vit.py:436-462), the
  position grid resized by size-based bilinear interpolation at any other
  grid (``pos_interp="bilinear"``, no +0.1 trick; vit.py:553-576) and
  ``ln_pre`` after the position add (``pre_norm``).
* SAM (``attn_type="fused"``, ``use_rel_pos``, ``window_size``;
  vit.py:282-311, 363-385): q, k and v are head-major views of the fused
  qkv output, the decomposed relative-position terms are built from q and
  the block's ``rel_pos_h``/``rel_pos_w`` tables, and the attention adds
  them to its logits (B7). With ``attn_impl="pallas_bias"`` (vit.py:291-298)
  the block instead materialises the ``[B, H, N, N]`` bias from the terms
  and runs the head-major attention with it (B5's bias kernels, whose dq
  kernel writes dbias; autograd takes it back through the bias builder to q
  and the tables). Windowed blocks partition the normalised tokens
  into zero-padded windows around the attention only; the blocks at
  ``global_attn_indexes`` attend over the whole grid with tables sized for
  the pretraining grid, resized to the grid at hand.

The RoPE tables are built once per grid size and device and shared by every
block, with identity rows for the cls token (vit.py:484-502).

With a :class:`ReinsSpec` (the Rein backbones, ``rein_backbones.py``) the
Rein adapter refines the tokens after every block, or only after the blocks
at ``apply_indices`` (SAM's global blocks), and with ``link_token_to_query``
the forward returns ``(feats, queries)`` (vit.py:478-548):
``returns_queries`` says so, so no caller guesses from the output's shape.
``resize_feat`` turns the four maps into a pyramid: x4, x2, x1 and x0.5
bilinear (vit.py:536-544). ``remat`` recomputes each block's activations
in the backward (``nn.remat`` at vit.py:508-509; :func:`remat_call`).

Module and parameter names follow the flax tree (``blocks.<i>`` for
``blocks_<i>``), so ``weights.state_dict_from_flax`` maps one onto the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.backbones.adapters import (
    LoRALinear,
    LoRASpec,
    Reins,
    ReinsSpec,
    make_dense,
)
from vfmseg_tpu_torch.models.common import Conv2d
from vfmseg_tpu_torch.ops.attention import (
    multi_head_attention_decomposed_hm,
    multi_head_attention_headmajor,
    multi_head_attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.norm import LayerNorm
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.ops.rope import (
    apply_rope,
    evens_odds_perm,
    permuted_rope_tables,
    vit_rope_tables,
)
from vfmseg_tpu_torch.ops.swiglu import padded_width, swiglu_gate_ln
from vfmseg_tpu_torch.ops.window import (
    decomposed_rel_pos_bias_hm,
    decomposed_rel_pos_terms_hm,
    window_partition,
    window_unpartition,
)


# the compute.attn_impl values the JAX package takes
ATTN_IMPLS = ("auto", "pallas", "xla", "pallas_bias")


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
    # "mlp" (DINOv2, CLIP) or "swiglu_eva" (EVA02: w1/w2, sub-LN, w3)
    ffn_layer: str = "mlp"
    # the MLP's activation: "gelu" (exact erf) or "quick_gelu" (CLIP)
    ffn_act: str = "gelu"
    # CLIP's stem: ln_pre after the position add, the class-embedding
    # vector added to the cls position again ("clip_embed"), the grid
    # resized bilinearly by size, and a patch embedding without bias
    pre_norm: bool = False
    cls_style: str = "token"
    pos_interp: str = "bicubic"
    patch_embed_bias: bool = True
    init_values: Optional[float] = 1e-5  # LayerScale; None disables
    drop_path_rate: float = 0.0
    ln_eps: float = 1e-6
    # "fused" (one qkv linear) or "split_subln" (EVA02: q/k/v, k bias-free)
    attn_type: str = "fused"
    # EVA02 2D rotary embedding on the patch tokens' q/k
    use_rope: bool = False
    rope_pt_seq_len: int = 16
    rope_intp_freq: bool = True
    num_cls_tokens: int = 1  # 0: no cls token (SAM)
    # "learned": [1, cls + grid, E], bicubic at other grids (DINOv2, EVA02);
    # "learned_2d": [1, side, side, E], bilinear at other grids (SAM)
    pos_embed: str = "learned"
    # SAM: the window of the windowed blocks, the blocks that attend
    # globally, the decomposed relative positions, and the pretraining
    # grid that sizes the global blocks' tables (1024 / 16)
    window_size: Optional[int] = None
    global_attn_indexes: Tuple[int, ...] = ()
    use_rel_pos: bool = False
    rel_pos_pretrain_extent: int = 64
    # "auto", "pallas" or "xla": the port's one route (the kernels on CUDA
    # tensors, the plain versions on the CPU); "pallas_bias": SAM's blocks
    # attend with the materialised rel-pos bias (ATTN_IMPLS)
    attn_impl: str = "auto"
    # the Rein pyramid: the four maps resized x4, x2, x1, x0.5
    resize_feat: bool = False
    # recompute each block's activations in the backward (vit.py:508-509)
    remat: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")
        for key, value, allowed in (
                ("ffn_act", self.ffn_act, ("gelu", "quick_gelu")),
                ("cls_style", self.cls_style, ("token", "clip_embed")),
                ("pos_interp", self.pos_interp, ("bicubic", "bilinear"))):
            if value not in allowed:
                raise ValueError(f"{key} {value!r} is not one of {allowed}")


def remat_call(fn: Callable, *args):
    """``fn(*args)`` under activation checkpointing (``nn.remat``): its
    activations are dropped after the forward and recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant). The recomputation
    must draw the numbers the forward drew, as ``nn.remat`` replays its
    keys; ``checkpoint`` restores only PyTorch's global generators, so the
    streams of ``models/rng.py`` (drop-path, LoRA dropout) are snapshot
    before the call and replayed from fresh generators in the recompute,
    which may run after the step's ``rng.streams`` has closed."""
    saved = rng.snapshot()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        with rng.replay(saved):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


class RopeTables(NamedTuple):
    """fp32 ``[N, head_dim]`` tables over all tokens: natural (pairwise)
    for the training route, evens|odds permuted for the kernel."""

    cos: torch.Tensor
    sin: torch.Tensor
    cos_p: torch.Tensor
    sin_p: torch.Tensor


def _wants_grad(x: torch.Tensor, module: nn.Module) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Stochastic depth on a residual branch (vit.py:333-340): one keep draw
    per sample from the ``dropout`` stream, kept samples scaled by
    1 / (1 - rate); the identity outside training."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = rng.uniform("dropout", rng.PerSample(shape), x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> exact GELU or QuickGELU ``x sigmoid(1.702 x)`` (vit.py:114)
    -> fc2."""

    def __init__(self, dim: int, hidden: int, bias: bool,
                 lora: Optional[LoRASpec], dtype: torch.dtype,
                 act: str = "gelu"):
        super().__init__()
        self.fc1 = make_dense(dim, hidden, bias, "fc1", lora, dtype)
        self.fc2 = make_dense(hidden, dim, bias, "fc2", lora, dtype)
        self.quick_gelu = act == "quick_gelu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = x * torch.sigmoid(1.702 * x) if self.quick_gelu else F.gelu(x)
        return self.fc2(x)


class SwiGLUEva(nn.Module):
    """EVA02's SwiGLU: silu(w1 x) * (w2 x) -> sub-LN -> w3 (vit.py:147-161);
    no LoRA. Two routes, picked as :class:`SplitAttention` picks its own:

    - *eval* (not training, no gradient wanted): the hidden padded to
      ``padded_width(hidden)`` (EVA02-L's 2730 -> 2736) with zero weights,
      w1 and w2 as one ``[2 Hp, E]`` product, the gate and the sub-LN in one
      kernel that writes exact zeros in the pad (``ops/swiglu.py``), and w3
      at K = Hp. The padded extents keep the GEMMs on cuBLAS's Hopper
      kernels, which a 2730-wide leading dimension (5460 bytes) kept them
      off; the zeros add nothing.
    - *training*: the three layers and the sub-LN as they are, under
      autograd.
    """

    def __init__(self, dim: int, hidden: int, ln_eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.w1 = make_dense(dim, hidden, True, "w1", None, dtype)
        self.w2 = make_dense(dim, hidden, True, "w2", None, dtype)
        self.ffn_ln = LayerNorm(hidden, ln_eps, dtype)
        self.w3 = make_dense(hidden, dim, True, "w3", None, dtype)
        self._padded: Optional[Tuple[torch.Tensor, ...]] = None
        self._padded_key = None

    def padded_weights(self) -> Tuple[torch.Tensor, ...]:
        """The eval route's ``[2 Hp, E]`` w1|w2 weight and ``[2 Hp]`` bias
        (w1's rows, zero rows, w2's rows, zero rows) and ``[E, Hp]`` w3
        (zero columns past the hidden) with its bias, in the compute dtype.

        Cached until a parameter of the three layers is written in place
        (loading a state dict), moved, or the dtype changes."""
        lins = (self.w1, self.w2, self.w3)
        params = [p for lin in lins for p in lin.parameters()]
        key = (self.dtype,) + tuple((p.device, p.data_ptr(), p._version)
                                    for p in params)
        if key != self._padded_key:
            pad = padded_width(self.hidden) - self.hidden
            with torch.no_grad():
                w12 = torch.cat([F.pad(self.w1.weight, (0, 0, 0, pad)),
                                 F.pad(self.w2.weight, (0, 0, 0, pad))])
                b12 = torch.cat([F.pad(self.w1.bias, (0, pad)),
                                 F.pad(self.w2.bias, (0, pad))])
                self._padded = tuple(t.to(self.dtype).contiguous() for t in (
                    w12, b12, F.pad(self.w3.weight, (0, pad)), self.w3.bias))
            self._padded_key = key
        return self._padded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and not _wants_grad(x, self):
            w12, b12, w3, b3 = self.padded_weights()
            g = F.linear(x.to(self.dtype), w12, b12)
            ln = self.ffn_ln
            return F.linear(swiglu_gate_ln(g, self.hidden, ln.weight, ln.bias,
                                           ln.eps), w3, b3)
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class Attention(nn.Module):
    """Fused-qkv MHA; attention reads q/k/v straight out of the qkv output
    and returns token-major [B, N, E] for the proj linear.

    With ``rel_pos_len`` (SAM), the block's ``[rel_pos_len, head_dim]``
    tables give the decomposed relative-position terms over the ``hw`` grid
    of the tokens, and q, k, v are head-major views of the qkv output; the
    attention adds the terms to its logits (B7), or with
    ``attn_impl="pallas_bias"`` adds the whole bias built from them (B5)."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec],
                 rel_pos_len: int = 0):
        super().__init__()
        dim = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.bias_route = cfg.attn_impl == "pallas_bias"
        self.qkv = make_dense(dim, 3 * dim, cfg.qkv_bias, "qkv", lora,
                              cfg.dtype)
        self.proj = make_dense(dim, dim, cfg.proj_bias, "proj", lora,
                               cfg.dtype)
        self.rel_pos_h = self.rel_pos_w = None
        if rel_pos_len:
            shape = (rel_pos_len, dim // cfg.num_heads)
            self.rel_pos_h = nn.Parameter(torch.zeros(shape))
            self.rel_pos_w = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, rope: Optional[RopeTables] = None,
                hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if rope is not None:
            raise NotImplementedError("RoPE with a fused qkv linear is not "
                                      "ported")
        qkv = self.qkv(x)
        if self.rel_pos_h is None:
            return self.proj(multi_head_attention_qkv_tm(qkv, self.num_heads))
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        tables = (q, self.rel_pos_h.to(q.dtype), self.rel_pos_w.to(q.dtype),
                  hw)
        if self.bias_route:
            out = multi_head_attention_headmajor(
                q, k, v, bias=decomposed_rel_pos_bias_hm(*tables))
        else:
            out = multi_head_attention_decomposed_hm(
                q, k, v, *decomposed_rel_pos_terms_hm(*tables))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


def _fp32_weight(lin: nn.Module) -> torch.Tensor:
    """A projection's fp32 ``[out, in]`` weight, LoRA folded in."""
    w = lin.weight.float()
    if isinstance(lin, LoRALinear):
        w = w + (lin.lora_b.float() @ lin.lora_a.float()) * lin.scaling
    return w


class SplitAttention(nn.Module):
    """EVA02's attention: separate q/k/v projections, k without bias, 2D
    RoPE on q and k, one proj (vit.py:164-318)."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec]):
        super().__init__()
        dim = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.q_proj = make_dense(dim, dim, cfg.qkv_bias, "q_proj", lora,
                                 cfg.dtype)
        self.k_proj = make_dense(dim, dim, False, "k_proj", lora, cfg.dtype)
        self.v_proj = make_dense(dim, dim, cfg.qkv_bias, "v_proj", lora,
                                 cfg.dtype)
        self.proj = make_dense(dim, dim, cfg.proj_bias, "proj", lora,
                               cfg.dtype)
        self._fused: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._fused_key = None

    def fused_qkv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval route's ``[3E, E]`` weight and ``[3E]`` bias in the
        compute dtype: LoRA folded in fp32, q and k rows in the evens|odds
        layout, k's bias zero (vit.py:221-240).

        Cached until a parameter of the three projections is written in
        place (loading a state dict), moved, or the dtype changes."""
        lins = (self.q_proj, self.k_proj, self.v_proj)
        params = [p for lin in lins for p in lin.parameters()]
        key = (self.dtype,) + tuple((p.device, p.data_ptr(), p._version)
                                    for p in params)
        if key != self._fused_key:
            dim = self.q_proj.out_features
            perm = torch.from_numpy(evens_odds_perm(
                self.num_heads, dim // self.num_heads)).to(params[0].device)
            wq, wk, wv = (_fp32_weight(lin) for lin in lins)
            zeros = torch.zeros(dim, device=wq.device)

            def bias(lin):
                return zeros if lin.bias is None else lin.bias.float()

            with torch.no_grad():
                w = torch.cat([wq[perm], wk[perm], wv]).to(self.dtype)
                b = torch.cat([bias(self.q_proj)[perm], zeros,
                               bias(self.v_proj)]).to(self.dtype)
            self._fused = (w, b)
            self._fused_key = key
        return self._fused

    def forward(self, x: torch.Tensor, rope: Optional[RopeTables] = None,
                hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``hw``: unused; the split attention has no relative positions."""
        b, n, c = x.shape
        h = self.num_heads
        if rope is not None and not self.training and not _wants_grad(x,
                                                                      self):
            w, bias = self.fused_qkv()
            qkv = F.linear(x.to(self.dtype), w, bias)
            out = multi_head_attention_qkv_tm(qkv, h,
                                              rope_cs=(rope.cos_p, rope.sin_p))
            return self.proj(out)
        q, k, v = (lin(x).reshape(b, n, h, c // h)
                   for lin in (self.q_proj, self.k_proj, self.v_proj))
        if rope is not None:
            cos = rope.cos.to(q.dtype)[None, :, None, :]
            sin = rope.sin.to(q.dtype)[None, :, None, :]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = multi_head_attention_headmajor(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float, dtype: torch.dtype):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block with optional LayerScale and drop-path
    (dino_layers/block.py; vit.py:343-406); with ``window_size`` (a SAM
    windowed block) the attention runs over zero-padded windows of the
    normalised tokens (vit.py:371-385)."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec],
                 drop_path_rate: float = 0.0, window_size: int = 0):
        super().__init__()
        dim = cfg.embed_dim
        hidden = int(dim * cfg.mlp_ratio)
        self.drop_path_rate = drop_path_rate
        self.window_size = window_size
        rel_pos_len = 0
        if cfg.use_rel_pos:
            extent = window_size or cfg.rel_pos_pretrain_extent
            rel_pos_len = 2 * extent - 1
        self.norm1 = LayerNorm(dim, cfg.ln_eps, cfg.dtype)
        if cfg.attn_type == "fused":
            self.attn = Attention(cfg, lora, rel_pos_len)
        elif cfg.use_rel_pos:
            raise NotImplementedError("relative positions with split q/k/v "
                                      "are not ported")
        elif cfg.attn_type == "split_subln":
            self.attn = SplitAttention(cfg, lora)
        else:
            raise NotImplementedError(f"attn_type={cfg.attn_type!r} is not "
                                      f"ported")
        self.norm2 = LayerNorm(dim, cfg.ln_eps, cfg.dtype)
        if cfg.ffn_layer == "mlp":
            self.mlp = Mlp(dim, hidden, cfg.ffn_bias, lora, cfg.dtype,
                           cfg.ffn_act)
        elif cfg.ffn_layer == "swiglu_eva":
            self.mlp = SwiGLUEva(dim, hidden, cfg.ln_eps, cfg.dtype)
        else:
            raise NotImplementedError(f"ffn_layer={cfg.ffn_layer!r} is not "
                                      f"ported")
        if cfg.init_values is not None:
            self.ls1 = LayerScale(dim, cfg.init_values, cfg.dtype)
            self.ls2 = LayerScale(dim, cfg.init_values, cfg.dtype)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor, rope: Optional[RopeTables] = None,
                hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """x: [B, N, E] tokens; hw: the (gh, gw) grid of the patch tokens."""
        rate = self.drop_path_rate
        h = self.norm1(x)
        if self.window_size:
            b, n, c = h.shape
            ws = self.window_size
            wins, pad_hw = window_partition(h.reshape(b, *hw, c), ws)
            h = self.attn(wins.reshape(-1, ws * ws, c), hw=(ws, ws))
            h = window_unpartition(h.reshape(-1, ws, ws, c), ws, pad_hw,
                                   hw).reshape(b, n, c)
        else:
            h = self.attn(h, rope, hw)
        h = self.ls1(h)
        x = x + drop_path(h, rate, self.training)
        h = self.ls2(self.mlp(self.norm2(x)))
        return x + drop_path(h, rate, self.training)


class VisionTransformer(nn.Module):
    """ViT backbone: NHWC image [B, H, W, 3] -> tuple of NHWC feature maps
    [B, H/p, W/p, E], one per ``out_indices`` entry (resized with
    ``resize_feat``); with ``returns_queries``, ``(maps, queries)``."""

    def __init__(self, cfg: ViTConfig, lora: Optional[LoRASpec] = None,
                 reins: Optional[ReinsSpec] = None):
        super().__init__()
        self.cfg = cfg
        self.reins = None
        if reins is not None:
            self.reins = Reins(reins, cfg.depth, cfg.embed_dim,
                               cfg.patch_size, dtype=cfg.dtype)
        self.returns_queries = bool(reins and reins.link_token_to_query)
        e = cfg.embed_dim
        p = cfg.num_cls_tokens
        self.patch_embed = Conv2d(3, e, cfg.patch_size, stride=cfg.patch_size,
                                  bias=cfg.patch_embed_bias, dtype=cfg.dtype)
        side = cfg.img_size // cfg.patch_size
        clip_embed = cfg.cls_style == "clip_embed"
        if clip_embed and p != 1:
            raise NotImplementedError("cls_style='clip_embed' takes one cls "
                                      "token")
        self.cls_token = (nn.Parameter(torch.zeros(1, p, e))
                          if p and not clip_embed else None)
        self.class_embedding = (nn.Parameter(torch.zeros(e)) if clip_embed
                                else None)
        self.ln_pre = (LayerNorm(e, cfg.ln_eps, cfg.dtype) if cfg.pre_norm
                       else None)
        if cfg.pos_embed == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, side * side + p, e))
        elif cfg.pos_embed == "learned_2d" and not p:
            self.pos_embed = nn.Parameter(torch.zeros(1, side, side, e))
        else:
            raise NotImplementedError(
                f"pos_embed={cfg.pos_embed!r} with {p} cls tokens is not "
                f"ported")

        def window(i: int) -> int:
            if cfg.window_size and i not in cfg.global_attn_indexes:
                return cfg.window_size
            return 0

        # drop-path rate grows linearly over the depth (vit.py:504-506)
        self.blocks = nn.ModuleList(
            Block(cfg, lora, cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
                  window(i))
            for i in range(cfg.depth))
        self._rope: Dict[tuple, RopeTables] = {}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        cfg = self.cfg
        p = cfg.num_cls_tokens
        b, h, w, _ = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        x = self.patch_embed(x).reshape(b, gh * gw, cfg.embed_dim)
        pos = self.interpolated_pos_embed(gh, gw)
        if self.class_embedding is not None:
            # CLIP: the vector is the cls token and is added to the cls
            # position again (vit.py:436-462)
            cls = self.class_embedding.reshape(1, 1, -1)
            pos = torch.cat([pos[:, :1] + cls, pos[:, 1:]], dim=1)
            x = torch.cat([cls.to(x.dtype).expand(b, -1, -1), x], dim=1)
        elif p:
            cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + pos.to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        rope = self.rope_tables(gh, gw, x.device) if cfg.use_rope else None
        reins = self.reins
        outs = []
        remat = cfg.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                x = remat_call(blk, x, rope, (gh, gw))
            else:
                x = blk(x, rope, (gh, gw))
            if reins is not None and reins.spec.applies_at(i):
                x = reins.adapt(x, i, num_prefix_tokens=p)
            if i in cfg.out_indices:
                outs.append(x[:, p:, :].reshape(b, gh, gw, cfg.embed_dim))
        if cfg.resize_feat and len(outs) == 4:
            outs = [resize(outs[0], scale_factor=4.0, method="bilinear"),
                    resize(outs[1], scale_factor=2.0, method="bilinear"),
                    outs[2],
                    resize(outs[3], scale_factor=0.5, method="bilinear")]
        if self.returns_queries:
            return tuple(outs), reins.queries()
        return tuple(outs)

    def rope_tables(self, gh: int, gw: int,
                    device: torch.device) -> RopeTables:
        """The blocks' RoPE tables at a (gh, gw) grid on ``device``, built
        once and kept (normal tensors even when first built under
        ``torch.inference_mode``: the training route saves them for its
        backward)."""
        key = (gh, gw, device)
        if key not in self._rope:
            cfg = self.cfg
            cos, sin = vit_rope_tables(
                gh, gw, cfg.embed_dim // cfg.num_heads, 1,
                cfg.rope_pt_seq_len, cfg.rope_intp_freq)
            cos_p, sin_p = permuted_rope_tables(cos, sin)
            with torch.inference_mode(False):
                self._rope[key] = RopeTables(*(
                    torch.from_numpy(np.ascontiguousarray(t)).to(device)
                    for t in (cos, sin, cos_p, sin_p)))
        return self._rope[key]

    def interpolated_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """The pos-embed at a (gh, gw) grid, [1, cls + gh*gw, E] fp32.

        DINOv2's (dino_v2.py:184-215): torch bicubic with the +0.1
        scale-factor trick on the grid part; the cls position passes through.
        CLIP's (``pos_interp="bilinear"``, vit.py:553-576): bilinear to
        (gh, gw) by size. SAM's grid-shaped one (vit.py:461-472): bilinear
        to (gh, gw)."""
        pos = self.pos_embed
        p = self.cfg.num_cls_tokens
        if self.cfg.pos_embed == "learned_2d":
            if tuple(pos.shape[1:3]) != (gh, gw):
                pos = resize(pos.float(), size=(gh, gw), method="bilinear")
            return pos.reshape(1, gh * gw, -1)
        side = int(math.sqrt(pos.shape[1] - p))
        if (gh, gw) == (side, side):
            return pos
        grid = pos[:, p:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
        if self.cfg.pos_interp == "bilinear":
            grid = F.interpolate(grid.float(), size=(gh, gw),
                                 mode="bilinear", align_corners=False)
        else:
            grid = F.interpolate(
                grid.float(), mode="bicubic", align_corners=False,
                scale_factor=((gh + 0.1) / side, (gw + 0.1) / side),
                recompute_scale_factor=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :p], grid.to(pos.dtype)], dim=1)
