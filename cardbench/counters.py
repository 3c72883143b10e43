"""Work reckoned from the algorithm and its shapes, and the card's peaks.

Everything here is arithmetic on the configuration's sizes: no kernel, no
path of the program and no measurement goes into it, so the same image
reckons the same work whatever kernel carries it.

FLOPs count the products of matrix multiplications and convolutions, two
a multiply-add; elementwise work (norms, activations, softmax, resizes) is
left out.

Inference (one image of the MsVFM two-stage gated predictor):

* stage 1: one ViT pass over the image resized to ``lr_img_size`` (at
  512 x 1024 and patch 16, 2048 patch tokens and the cls token) and the
  LinearHead over its four maps;
* each window the gate sends on (0.968 / 0.8 rule): one ViT pass over the
  512 x 512 window (1025 tokens) and the VFMHead with its decoder. Windows
  that a path computes and then discards, and the compact engine's padded
  rows, are not reckoned.

LoRA is folded into its base weight in inference (``W + (alpha / r) B A``,
once per weight load, as the reference package's dropout-free path does),
so an image costs no low-rank products.

Per ViT block over N tokens of width E: ``24 E^2 N`` for the qkv, proj and
4E-wide MLP products (EVA02: ``8 E^2 N`` for q, k, v and proj and
``6 E F N`` for its SwiGLU of width F), plus ``4 N^2 E`` for attention
(``q k^T`` and ``p v``). The patch embedding is a ``3 p^2 -> E`` product
per token. The heads' convolutions and matmuls follow from their shapes
below.

The attention bound of one call is max(FLOPs / peak, bytes / bandwidth),
with q, k, v read once and the output written once in bf16 (B, H, N, D
each); RoPE's cos and sin tables add their fp32 bytes.

A train step is reckoned as its forward plus the backward that the step
needs (``train_step_flops``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
FP32_BYTES = 4


def _backbone(cfg: Dict) -> Dict:
    bb = cfg["model"]["backbone"]
    return bb.get("backbone", bb)


def vit_dims(cfg: Dict) -> Dict:
    """The ViT's sizes from a configuration file's ``model`` section."""
    bb = _backbone(cfg)
    e = int(bb.get("embed_dim", 1024))
    eva = bb["type"] == "EVA2"
    ratio = float(bb.get("mlp_ratio", 2.6666666666666665 if eva else 4.0))
    return dict(embed=e, depth=int(bb.get("depth", 24)),
                heads=int(bb.get("num_heads", 16)),
                patch=int(bb.get("patch_size", 16)), hidden=int(e * ratio),
                swiglu=eva, rope=eva and bool(bb.get("rope", True)))


def vit_flops(cfg: Dict, h: int, w: int) -> float:
    """One ViT pass over an ``h`` x ``w`` image (one cls token)."""
    d = vit_dims(cfg)
    e, p = d["embed"], d["patch"]
    patches = (h // p) * (w // p)
    n = patches + 1
    if d["swiglu"]:
        dense = 8 * e * e * n + 6 * e * d["hidden"] * n
    else:
        dense = 8 * e * e * n + 4 * e * d["hidden"] * n
    attn = 4 * n * n * e
    return 2.0 * patches * 3 * p * p * e + d["depth"] * (dense + attn)


def linear_head_flops(cfg: Dict, gh: int, gw: int) -> float:
    """LinearHead over four ``gh`` x ``gw`` maps: the 1x1 fusion, two 2x2
    stride-2 transposed convolutions (C -> C/2 -> C/4) and the 1x1
    classifier at 4x the grid."""
    head = cfg["model"]["decode_head"]
    c = int(head["in_channels"][0])
    cin = sum(int(x) for x in head["in_channels"])
    k = int(head["num_classes"])
    px = gh * gw
    return 2.0 * (px * cin * c + px * 4 * c * (c // 2)
                  + 4 * px * 4 * (c // 2) * (c // 4) + 16 * px * (c // 4) * k)


def vfm_head_flops(cfg: Dict, gh: int, gw: int) -> float:
    """VFMHead over four ``gh`` x ``gw`` maps and the context logits: the
    1x1 fusion, the context embedding (2x2 stride-2 convolutions from 4x the
    grid, then 1x1), the decoder's blocks and the 1x1 classifier."""
    head = cfg["model"]["aux_head"]
    t = head["transformer"]
    ch = int(head["channels"])
    cin = sum(int(x) for x in head["in_channels"])
    k = int(head["num_classes"])
    inner = int(t["n_heads"]) * int(t["d_head"])
    px = gh * gw
    n = px  # the query and the embedded context share the feature grid
    embed = (4 * px * (k * 4) * (ch // 4) + px * ((ch // 4) * 4) * (ch // 2)
             + px * (ch // 2) * ch)
    block = (3 * n * ch * inner + n * inner * ch      # self-attention
             + 2 * n * n * inner                       # its q k^T and p v
             + n * ch * inner + 2 * n * ch * inner     # cross q, and k, v
             + n * inner * ch + 2 * n * n * inner      # cross out, products
             + n * ch * 8 * ch + n * 4 * ch * ch)      # GEGLU and out
    return 2.0 * (px * cin * ch + embed + px * ch * k) + 2.0 * int(
        t["depth"]) * block


def grid(cfg: Dict, h: int, w: int) -> Tuple[int, int]:
    p = vit_dims(cfg)["patch"]
    return h // p, w // p


def stage1_flops(cfg: Dict) -> float:
    """The whole-image pass at ``lr_img_size``: ViT and LinearHead."""
    lh, lw = cfg["test_cfg"]["lr_img_size"]
    return vit_flops(cfg, lh, lw) + linear_head_flops(cfg, *grid(cfg, lh,
                                                                   lw))


def window_flops(cfg: Dict) -> float:
    """One refined window: ViT and VFMHead over the crop."""
    ch, cw = cfg["test_cfg"]["crop_size"]
    return vit_flops(cfg, ch, cw) + vfm_head_flops(cfg, *grid(cfg, ch, cw))


def image_flops(cfg: Dict, refined_windows: int) -> float:
    """One image: stage 1 and the windows the gate sends on."""
    return stage1_flops(cfg) + refined_windows * window_flops(cfg)


def bound_s(flops: float, bytes_moved: float) -> float:
    """The least time the card could take: operations over the bf16 peak
    or bytes over the memory rate, whichever is larger."""
    return max(flops / PEAK_BF16_FLOPS, bytes_moved / HBM_BYTES_PER_S)


def attention_call(b: int, h: int, nq: int, nk: int, d: int,
                   rope: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call: q [b, h, nq, d] against k, v
    [b, h, nk, d], out [b, h, nq, d], bf16; RoPE adds its two fp32
    [nq, d] tables."""
    flops = 4.0 * b * h * nq * nk * d
    moved = BF16_BYTES * b * h * d * (2 * nq + 2 * nk)
    if rope:
        moved += 2 * FP32_BYTES * nq * d
    return flops, moved


def attention_calls(cfg: Dict, refined_windows: int
                    ) -> List[Tuple[float, float]]:
    """Every attention call one image needs, as (FLOPs, bytes): the ViT's
    blocks at stage 1 and over each refined window, and the decoder's
    self- and cross-attention of each refined window."""
    d = vit_dims(cfg)
    hd = d["embed"] // d["heads"]
    lh, lw = cfg["test_cfg"]["lr_img_size"]
    ch, cw = cfg["test_cfg"]["crop_size"]
    gl, gc = grid(cfg, lh, lw), grid(cfg, ch, cw)
    n1 = gl[0] * gl[1] + 1
    nw = gc[0] * gc[1] + 1
    t = cfg["model"]["aux_head"]["transformer"]
    nd = gc[0] * gc[1]
    calls = [attention_call(1, d["heads"], n1, n1, hd, d["rope"])
             ] * d["depth"]
    for _ in range(refined_windows):
        calls += [attention_call(1, d["heads"], nw, nw, hd, d["rope"])
                  ] * d["depth"]
        calls += [attention_call(1, int(t["n_heads"]), nd, nd,
                                 int(t["d_head"]))] * (2 * int(t["depth"]))
    return calls


def attention_bound_s(cfg: Dict, refined_windows: int) -> float:
    """The least time the card could take for one image's attention: the
    sum of each call's bound."""
    return sum(bound_s(f, b) for f, b in attention_calls(cfg,
                                                          refined_windows))


def frames_flops(cfg: Dict, refined: Iterable[int]) -> float:
    return sum(image_flops(cfg, n) for n in refined)


def frames_attention_bound_s(cfg: Dict, refined: Iterable[int]) -> float:
    return sum(attention_bound_s(cfg, n) for n in refined)


# ------------------------------------------------------------ training
def _lora(cfg: Dict) -> Tuple[int, List[Tuple[int, int]], List[str]]:
    """(rank, [(in, out)] of the LoRA linears of one block, their names)."""
    bb = cfg["model"]["backbone"]
    lc = bb.get("Lora_config", {}) if bb["type"] == "LoRABackbone" else {}
    e = vit_dims(cfg)["embed"]
    shapes = {"qkv": (e, 3 * e), "q_proj": (e, e), "k_proj": (e, e),
              "v_proj": (e, e), "proj": (e, e)}
    alias = {"attn.proj": "proj", "out_proj": "proj"}
    names = [alias.get(t, t) for t in lc.get("target_modules", ())]
    return int(lc.get("r", 0)), [shapes[n] for n in names], names


def train_step_flops(cfg: Dict, batch: int, crop_hw: Tuple[int, int]
                     ) -> float:
    """One two-scale train step over ``batch`` crops of ``crop_hw``: the
    forward of the ViT over the half-scale views and the HR crops (one
    call, 2 x ``batch`` images of ``hr_crop_size``), LoRA in its sequential
    form, the LinearHead and the VFMHead over ``batch`` maps each; and the
    backward the step needs. Only LoRA and the heads train, and LoRA sits
    in every block, so input gradients run through every block down to
    block 0, whose frozen q, k, v products and LoRA inputs take none;
    every attention takes its backward (four products, twice its forward);
    the trainable weights take their weight gradients; the heads take both,
    but for the first convolution of the context embedding, whose input
    (the detached half-scale logits) takes none."""
    d = vit_dims(cfg)
    e, depth = d["embed"], d["depth"]
    hh, hw = cfg["model"].get("hr_crop_size", (crop_hw[0] // 2,
                                               crop_hw[1] // 2))
    gh, gw = grid(cfg, hh, hw)
    n = gh * gw + 1
    images = 2 * batch
    r, lora, names = _lora(cfg)
    lora_fwd = sum(2.0 * n * (fi * r + r * fo) for fi, fo in lora)
    vit = vit_flops(cfg, hh, hw)
    attn = 4.0 * n * n * e
    dense = (vit - 2.0 * gh * gw * 3 * d["patch"] ** 2 * e) / depth - attn
    fwd = images * (vit + depth * lora_fwd)
    # backward of the ViT: dX of every frozen product, but block 0's q, k,
    # v; attention twice its forward; LoRA's dW (its forward) and dX (its
    # forward, less block 0's A on a gradient-free input)
    qkv_base = 6.0 * e * e * n
    lora_x_block0 = sum(2.0 * n * fi * r for (fi, _), name in zip(lora, names)
                        if name != "proj")
    vit_bwd = (depth * dense - qkv_base + depth * 2 * attn
               + depth * 2 * lora_fwd - lora_x_block0)
    head = cfg["model"]["aux_head"]
    k = int(head["num_classes"])
    ch = int(head["channels"])
    embed1 = 2.0 * (4 * gh * gw) * (k * 4) * (ch // 4)
    heads = linear_head_flops(cfg, gh, gw) + vfm_head_flops(cfg, gh, gw)
    return fwd + images * vit_bwd + batch * (3 * heads - embed1)


def attention_train_call(b: int, h: int, n: int, d: int
                         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention's forward with its log-sum-exp and
    its backward: six products of 2 N^2 d a head; q, k, v, out, dout read
    and dq, dk, dv written in bf16, the LSE written and read in fp32 (the
    output is written once, by the forward)."""
    flops = 12.0 * b * h * n * n * d
    moved = (BF16_BYTES * b * h * n * d * (4 + 5 + 3)
             + 2 * FP32_BYTES * b * h * n)
    return flops, moved


def train_attention_bound_s(cfg: Dict, batch: int) -> float:
    """The least time for one train step's attention: the ViT's blocks over
    2 x ``batch`` images of the HR crop size and the decoder's self- and
    cross-attention over ``batch`` maps, forward and backward."""
    d = vit_dims(cfg)
    hh, hw = cfg["model"].get("hr_crop_size", (512, 512))
    gh, gw = grid(cfg, hh, hw)
    t = cfg["model"]["aux_head"]["transformer"]
    vit = attention_train_call(2 * batch, d["heads"], gh * gw + 1,
                               d["embed"] // d["heads"])
    dec = attention_train_call(batch, int(t["n_heads"]), gh * gw,
                               int(t["d_head"]))
    return (d["depth"] * bound_s(*vit)
            + 2 * int(t["depth"]) * bound_s(*dec))
