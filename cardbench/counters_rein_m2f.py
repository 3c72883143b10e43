"""Work of ``rein_m2f`` reckoned from the equations and the configuration's
sizes (``reference/rein_m2f.py`` states the equations): no kernel, path or
measurement of the program goes into it.

FLOPs count the products of matrix multiplications, convolutions and
attention, two a multiply-add, as ``counters.py`` does; elementwise work
(norms, softmax, sigmoid, the bilinear sampling and its weighted sum, the
resizes, the overlap average) is left out. One image is mmseg's slide over
the frame: its crops, all through the model in one forward call.

Per crop of ``c`` x ``c`` pixels (patch ``p``, N = (c / p)^2 patch tokens):

* the ViT (``counters.vit_flops``);
* Rein after each of its L blocks, over the N patch tokens, T tokens:
  ``N T E`` for the token attention, ``N (T - 1) E`` for its update and
  ``N E^2`` for ``mlp_delta_f``; once a forward call, per layer, the tokens
  ``T r E`` and ``mlp_token2feat`` of T - 1 of them ``(T - 1) E^2``, and the
  query vector (``transform`` of L T tokens, ``merge`` of T);
* the pixel decoder over the stride-32, 16 and 8 maps (K tokens in all, C
  channels): the three 1x1 input convolutions from E; per encoder layer the
  value projection and output projection ``K C^2`` each, the offsets and
  weights ``K C (heads levels points) (2 + 1)``, the 1024-wide FFN
  ``2 K C 1024``; the stride-4 lateral (1x1 from E), the 3x3 output
  convolution and the 1x1 mask features;
* the decoder, Q queries: per layer i at level i mod 3 (K_l keys): the
  cross-attention's q and output projections ``Q C^2`` each, its k and v
  ``K_l C^2`` each, ``2 Q K_l C`` of attention; the self-attention
  ``4 Q C^2 + 2 Q^2 C``; the FFN ``2 Q C F``. Each of its masks, the least
  the equations need at inference: the mask embedding (three ``Q C^2``)
  and its product with the mask features at the level's size (the bilinear
  resize commutes with the channel product), ``Q C K_l``; then the last
  stage's class logits ``Q C (K + 1)``, its mask embedding and mask at the
  mask features' size ``Q C H0 W0``;
* the semantic inference ``Q K H0 W0``.

The ViT's attention bound (B2, ``attention_qkv_kernel``): each block's
call over the frame's crops, 1 + N tokens, as ``counters.attention_call``
counts it. Rein's token attention and the decoder's attention are plain
products and softmax, not B2's, and are left out.

B8's bytes (``deform_sample_kernel``, one call a level in each encoder
layer): each input byte read once and each output byte written once, as a
roofline counts them: the level's value ``[B heads, h, w, d]`` in the
compute dtype, the x and y of every sample in fp32, and the samples
``[B heads, points K, d]`` in the compute dtype.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from cardbench import counters

HEADS, LEVELS, POINTS = 8, 3, 4  # mmcv's deformable attention, as built
ENCODER_LAYERS, ENCODER_FFN, DECODER_FFN = 6, 1024, 2048


def _sizes(cfg: Dict) -> Dict:
    bb = cfg["model"]["backbone"]
    head = cfg["model"]["decode_head"]
    rc = bb["reins_config"]
    ch, cw = cfg["test_cfg"]["crop_size"]
    p = int(bb.get("patch_size", 16))
    g = (ch // p, cw // p)
    # the resize_feat pyramid: the grid x4, x2, x1, x0.5
    pyramid = [(int(g[0] * s), int(g[1] * s)) for s in (4.0, 2.0, 1.0, 0.5)]
    return dict(
        e=int(bb.get("embed_dim", 1024)), depth=int(bb.get("depth", 24)),
        n=g[0] * g[1], t=int(rc.get("token_length", 100)),
        r=int(rc.get("lora_dim", 16)), q=int(rc.get("query_dims", 256)),
        c=int(head.get("feat_channels", 256)),
        k=int(head.get("num_classes", 19)),
        layers=int(head["transformer_decoder"]["num_layers"]),
        # the encoder's levels, lowest resolution first
        levels=pyramid[:0:-1], mask_hw=pyramid[0])


def crops(cfg: Dict, hw: Tuple[int, int]) -> int:
    """The slide's crops of an ``hw`` frame."""
    h, w = hw
    (ch, cw), (sh, sw) = cfg["test_cfg"]["crop_size"], cfg["test_cfg"][
        "stride"]
    return ((max(h - ch + sh - 1, 0) // sh + 1)
            * (max(w - cw + sw - 1, 0) // sw + 1))


def crop_flops(cfg: Dict) -> float:
    """One crop's FLOPs, the work done once a forward call left out."""
    s = _sizes(cfg)
    e, n, t, c = s["e"], s["n"], s["t"], s["c"]
    ch, cw = cfg["test_cfg"]["crop_size"]
    vit = counters.vit_flops(cfg, ch, cw)
    rein = s["depth"] * (n * t * e + n * (t - 1) * e + n * e * e)
    kv = sum(h * w for h, w in s["levels"])
    h0, w0 = s["mask_hw"]
    pixel = (kv * e * c
             + ENCODER_LAYERS * (2 * kv * c * c
                                 + 3 * kv * c * HEADS * LEVELS * POINTS
                                 + 2 * kv * c * ENCODER_FFN)
             + h0 * w0 * (e * c + 9 * c * c + c * c))
    q = t
    decoder = 0
    for i in range(s["layers"]):
        kl = _level_tokens(s, i)
        decoder += (2 * q * c * c + 2 * kl * c * c + 2 * q * kl * c
                    + 4 * q * c * c + 2 * q * q * c + 2 * q * c * DECODER_FFN)
        decoder += 3 * q * c * c + q * c * kl  # the mask before layer i
    decoder += q * c * (s["k"] + 1) + 3 * q * c * c + q * c * h0 * w0
    semantic = q * s["k"] * h0 * w0
    return vit + 2.0 * (rein + pixel + decoder + semantic)


def _level_tokens(s: Dict, i: int) -> int:
    h, w = s["levels"][i % LEVELS]
    return h * w


def call_flops(cfg: Dict) -> float:
    """The work done once a forward call, whatever its batch: Rein's tokens
    and their ``mlp_token2feat`` in every layer, and the query vector."""
    s = _sizes(cfg)
    e, t, q, L = s["e"], s["t"], s["q"], s["depth"]
    return 2.0 * (L * (t * s["r"] * e + (t - 1) * e * e)
                  + L * t * e * q + t * 3 * q * q + t * q * s["c"])


def image_flops(cfg: Dict, hw: Tuple[int, int]) -> float:
    """One ``hw`` frame: its crops in one forward call."""
    return crops(cfg, hw) * crop_flops(cfg) + call_flops(cfg)


def deform_bytes_by_level(cfg: Dict, hw: Tuple[int, int],
                          value_bytes: int = counters.BF16_BYTES
                          ) -> List[float]:
    """B8's bytes for one ``hw`` frame, by level (lowest resolution first):
    every encoder layer's call at that level over the frame's crops."""
    s = _sizes(cfg)
    b = crops(cfg, hw)
    kv = sum(h * w for h, w in s["levels"])
    samples = b * HEADS * POINTS * kv
    out = []
    for h, w in s["levels"]:
        value = b * h * w * s["c"] * value_bytes
        coords = 2 * samples * counters.FP32_BYTES
        result = samples * (s["c"] // HEADS) * value_bytes
        out.append(ENCODER_LAYERS * float(value + coords + result))
    return out


def deform_bound_s(cfg: Dict, hw: Tuple[int, int]) -> float:
    """The least time the card could take for one frame's B8 calls: bytes
    over the memory rate (their FLOPs are far below the peak's share)."""
    return sum(deform_bytes_by_level(cfg, hw)) / counters.HBM_BYTES_PER_S


def attention_bound_s(cfg: Dict, hw: Tuple[int, int]) -> float:
    """The least time the card could take for one ``hw`` frame's ViT
    attention: every block's call over the frame's crops."""
    d = counters.vit_dims(cfg)
    ch, cw = cfg["test_cfg"]["crop_size"]
    gh, gw = counters.grid(cfg, ch, cw)
    n = gh * gw + 1
    call = counters.attention_call(crops(cfg, hw), d["heads"], n, n,
                                   d["embed"] // d["heads"])
    return d["depth"] * counters.bound_s(*call)
