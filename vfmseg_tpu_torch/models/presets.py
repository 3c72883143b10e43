"""Model and test config presets, and the repo's configs by name.

Port of vfmseg_tpu/models/presets.py, with the same names and signatures:
the canonical backbone and head dicts of the reference's model bases
(DINOv2-L, EVA02-L, CLIP-L, SAM ViT-H, MiT-B5; LoRA targets per family) and
the test settings. The files under ``configs/`` compose these; the port's
loader (``core/config.py``) runs them with this module in place of the JAX
one. :func:`config` loads a config by name or path, and the named functions
below (``headline_config`` ...) are the configs the port's paths run. Only
DINOv2, EVA02 and SAM (with LoRA or Rein) with the LinearHead, VFMHead and
(Rein)Mask2Former heads build in the port so far; the other dicts are
config data.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from vfmseg_tpu_torch.core.config import Config, load_config

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

PREPROCESSOR = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, pad_val=0,
                    seg_pad_val=255)

LORA_TARGETS = {
    "dinov2": ["qkv"],
    "eva02": ["q_proj", "k_proj", "v_proj", "attn.proj"],
    "clip": ["out_proj", "mlp.c_fc", "mlp.c_proj"],
    "sam": ["qkv"],
}

CHECKPOINTS = {
    "dinov2": "checkpoints/dinov2_converted.npz",
    "eva02": "checkpoints/eva02_converted.npz",
    "clip": "checkpoints/clip_converted.npz",
    "sam": "checkpoints/sam_converted.npz",
}

FEAT_DIM = {"dinov2": 1024, "eva02": 1024, "clip": 1024, "sam": 1280}


# ---------------------------------------------------------------- backbones
def dinov2_l(img_size: int = 512) -> dict:
    return dict(
        type="DinoVisionTransformer", patch_size=16, embed_dim=1024, depth=24,
        num_heads=16, mlp_ratio=4, img_size=img_size, ffn_layer="mlp",
        init_values=1e-05, qkv_bias=True, proj_bias=True, ffn_bias=True)


def eva02_l(img_size: int = 512) -> dict:
    return dict(
        type="EVA2", patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_ratio=2.6666666666666665, img_size=img_size, init_values=None,
        drop_path_rate=0.1, rope=True, pt_hw_seq_len=16, intp_freq=True,
        subln=True, naiveswiglu=True, use_abs_pos_emb=True,
        out_indices=[7, 11, 15, 23])


def clip_l(input_resolution: int = 512) -> dict:
    return dict(
        type="CLIPVisionTransformer", patch_size=16, width=1024, layers=24,
        heads=16, input_resolution=input_resolution, drop_path_rate=0.1,
        out_indices=[7, 11, 15, 23], get_embeddings=False, output_dim=512)


def sam_h(img_size: int = 512) -> dict:
    return dict(
        type="SAMViT", img_size=img_size, embed_dim=1280, depth=32,
        num_heads=16, window_size=14, global_attn_indexes=[7, 15, 23, 31],
        out_indices=[7, 15, 23, 31], use_rel_pos=True)


def mit_b5() -> dict:
    return dict(type="mit_b5", style="pytorch")


_BACKBONES = {"dinov2": dinov2_l, "eva02": eva02_l, "clip": clip_l,
              "sam": sam_h}


def backbone(family: str, img_size: int = 512) -> dict:
    return _BACKBONES[family](img_size)


def lora_backbone(family: str, img_size: int = 512, r: int = 32) -> dict:
    """LoRABackbone wrapper dict (reference Lora_config values)."""
    return dict(
        type="LoRABackbone",
        backbone=backbone(family, img_size),
        checkpoint=CHECKPOINTS[family],
        Lora_config=dict(r=r, lora_alpha=r,
                         target_modules=LORA_TARGETS[family],
                         lora_dropout=0.1),
    )


def reins_backbone(family: str, img_size: int = 512,
                   resize_feat: Optional[bool] = None,
                   lora_dim: int = 16) -> dict:
    """Reins* backbone dict (reference reins_config type=LoRAReins,
    token_length=100, link_token_to_query=True)."""
    types = {
        "dinov2": "ReinsDinoVisionTransformer",
        "eva02": "ReinsEVA2",
        "clip": "ReinsCLIPVisionTransformer",
        "sam": "ReinsSAMViT",
    }
    cfg = backbone(family, img_size)
    cfg["type"] = types[family]
    cfg["reins_config"] = dict(type="LoRAReins", token_length=100,
                               lora_dim=lora_dim, link_token_to_query=True)
    if resize_feat is not None:
        cfg["resize_feat"] = resize_feat
    return cfg


# -------------------------------------------------------------------- heads
def linear_head(in_dim: int = 1024, channels: int = 256,
                num_classes: int = 19) -> dict:
    return dict(type="LinearHead", in_channels=[in_dim] * 4,
                channels=channels, dropout_ratio=0.1,
                num_classes=num_classes, align_corners=False)


def vfm_aux_head(in_dim: int = 1024, channels: int = 256,
                 num_classes: int = 19, masked: bool = True) -> dict:
    """VFMHead + (Mask)TransformerDecoder (lora_dinov2_ms{,_masked}.py);
    masked=False is the plain TransformerDecoder 'ms' variant."""
    transformer = dict(
        type="MaskTransformerDecoder" if masked else "TransformerDecoder",
        query_dim=channels, n_heads=8, d_head=64, depth=3, dropout=0.1,
        mask_ratio=0.2 if masked else 0.0)
    return dict(type="VFMHead", transformer=transformer,
                in_channels=[in_dim] * 4, channels=channels,
                dropout_ratio=0.1, num_classes=num_classes,
                align_corners=False)


def segformer_head(in_dim: int = 1024, channels: int = 256,
                   num_classes: int = 19) -> dict:
    return dict(type="SegformerHead", in_channels=[in_dim] * 4,
                channels=channels, dropout_ratio=0.1,
                num_classes=num_classes, align_corners=False)


def daformer_head(in_channels: Sequence[int] = (1024,) * 4,
                  channels: int = 256, num_classes: int = 19) -> dict:
    return dict(type="DAFormerHead", in_channels=list(in_channels),
                channels=channels, dropout_ratio=0.1,
                num_classes=num_classes, align_corners=False)


def mask2former_head(in_dim: int = 1024, num_classes: int = 19,
                     rein: bool = True) -> dict:
    """(Rein)Mask2FormerHead dict (rein_dinov2_mask2former.py values)."""
    return dict(
        type="ReinMask2FormerHead" if rein else "Mask2FormerHead",
        replace_query_feat=rein,
        in_channels=[in_dim] * 4, strides=[4, 8, 16, 32], feat_channels=256,
        out_channels=256, num_classes=num_classes, num_queries=100,
        num_transformer_feat_level=3, align_corners=False,
        transformer_decoder=dict(num_layers=9),
        train_cfg=dict(num_points=12544, oversample_ratio=3.0,
                       importance_sample_ratio=0.75))


def hrda_head(in_dim: int = 1024, channels: int = 256,
              num_classes: int = 19) -> dict:
    return dict(
        type="HRDAHead",
        seg_head=linear_head(in_dim, channels, num_classes),
        single_scale_head=dict(type="AttentionHead",
                               in_channels=[in_dim] * 4, channels=channels,
                               dropout_ratio=0.1, num_classes=num_classes,
                               align_corners=False),
        hr_loss_weight=0.1)


# ------------------------------------------------------------ test settings
def slide_test_cfg(crop: int = 512, stride: int = 341) -> dict:
    return dict(mode="slide", crop_size=(crop, crop),
                stride=(stride, stride))


def ms_test_cfg(masked: bool = True) -> dict:
    """MsVFM two-stage test cfg (the reference's 0.968 / 0.8 gate; masked
    -> ms_slide_inference, plain -> hr_slide_inference)."""
    return dict(
        mode="ms_slide_inference" if masked else "hr_slide_inference",
        threshold=0.968, conf=0.8, lr_img_size=(512, 1024),
        stride=(320, 320), crop_size=(512, 512))


def hrda_test_cfg() -> dict:
    return dict(mode="slide", stride=(682, 682), crop_size=(1024, 1024))


# ------------------------------------------------------- configs by name
def config(name_or_path: str, overrides: Iterable[str] = ()) -> Config:
    """A config of ``configs/`` by bare name or path, through the port's
    loader, with ``--cfg-options`` overrides."""
    return load_config(name_or_path, overrides)


def headline_config() -> Config:
    """dg_lora_dinov2_ms_masked: the MsVFM segmentor on LoRA DINOv2-L."""
    return config("dg_lora_dinov2_ms_masked")


def eva02_config() -> Config:
    """dg_lora_eva02_ms_masked: the headline on LoRA EVA02-L."""
    return config("dg_lora_eva02_ms_masked")


def sam_config() -> Config:
    """dg_lora_sam_ms_masked: the headline on LoRA SAM ViT-H."""
    return config("dg_lora_sam_ms_masked")


def mask2former_config() -> Config:
    """dg_lora_dinov2_mask2former: LoRA DINOv2-L with the Mask2Former head
    at 512x512 crops, slide eval at 512 / 341."""
    return config("dg_lora_dinov2_mask2former")

