"""Model and test config presets, and the ported configs as data.

Port of the DINOv2, EVA02, SAM and MsVFM parts of
vfmseg_tpu/models/presets.py. The repo's config files import the JAX
package, so the port carries its configs as data: the headline
(configs/dg/gta2citys/dg_lora_dinov2_ms_masked.py over
configs/_base_/models/lora_dinov2_ms_masked.py) in :func:`headline_config`,
and the same MsVFM segmentor on a LoRA EVA02-L backbone
(configs/dg/gta2citys/dg_lora_eva02_ms_masked.py) in :func:`eva02_config`
and on a LoRA SAM ViT-H backbone (configs/dg/gta2citys/
dg_lora_sam_ms_masked.py) in :func:`sam_config`; :func:`config` looks any of
them up by name, and :func:`apply_cfg_options` applies ``--cfg-options``
overrides. The CPU smoke config ``smoke_tiny_ms_masked`` is carried too
(:func:`smoke_tiny_config`), so the two eval CLIs can be compared. Tests
hold each equal to the JAX ``load_config``.
"""

from __future__ import annotations

import ast
import copy
from typing import Iterable

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

PREPROCESSOR = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, pad_val=0,
                    seg_pad_val=255)

DINOV2_CHECKPOINT = "checkpoints/dinov2_converted.npz"
DINOV2_DIM = 1024
EVA02_CHECKPOINT = "checkpoints/eva02_converted.npz"
SAM_CHECKPOINT = "checkpoints/sam_converted.npz"
SAM_DIM = 1280


def dinov2_l(img_size: int = 512) -> dict:
    return dict(
        type="DinoVisionTransformer", patch_size=16, embed_dim=1024, depth=24,
        num_heads=16, mlp_ratio=4, img_size=img_size, ffn_layer="mlp",
        init_values=1e-05, qkv_bias=True, proj_bias=True, ffn_bias=True)


def lora_dinov2(img_size: int = 512, r: int = 32) -> dict:
    """LoRABackbone wrapper dict (reference Lora_config values)."""
    return dict(
        type="LoRABackbone",
        backbone=dinov2_l(img_size),
        checkpoint=DINOV2_CHECKPOINT,
        Lora_config=dict(r=r, lora_alpha=r, target_modules=["qkv"],
                         lora_dropout=0.1),
    )


def eva02_l(img_size: int = 512) -> dict:
    return dict(
        type="EVA2", patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_ratio=2.6666666666666665, img_size=img_size, init_values=None,
        drop_path_rate=0.1, rope=True, pt_hw_seq_len=16, intp_freq=True,
        subln=True, naiveswiglu=True, use_abs_pos_emb=True,
        out_indices=[7, 11, 15, 23])


def lora_eva02(img_size: int = 512, r: int = 32) -> dict:
    """LoRABackbone wrapper dict with EVA02's reference targets (its own
    module names; ``attn.proj`` is normalised to ``proj`` at build)."""
    return dict(
        type="LoRABackbone",
        backbone=eva02_l(img_size),
        checkpoint=EVA02_CHECKPOINT,
        Lora_config=dict(r=r, lora_alpha=r,
                         target_modules=["q_proj", "k_proj", "v_proj",
                                         "attn.proj"],
                         lora_dropout=0.1),
    )


def sam_h(img_size: int = 512) -> dict:
    return dict(
        type="SAMViT", img_size=img_size, embed_dim=SAM_DIM, depth=32,
        num_heads=16, window_size=14, global_attn_indexes=[7, 15, 23, 31],
        out_indices=[7, 15, 23, 31], use_rel_pos=True)


def lora_sam(img_size: int = 512, r: int = 32) -> dict:
    """LoRABackbone wrapper dict with LoRA on SAM's fused qkv."""
    return dict(
        type="LoRABackbone",
        backbone=sam_h(img_size),
        checkpoint=SAM_CHECKPOINT,
        Lora_config=dict(r=r, lora_alpha=r, target_modules=["qkv"],
                         lora_dropout=0.1),
    )


def linear_head(in_dim: int = 1024, channels: int = 256,
                num_classes: int = 19) -> dict:
    return dict(type="LinearHead", in_channels=[in_dim] * 4, channels=channels,
                dropout_ratio=0.1, num_classes=num_classes,
                align_corners=False)


def vfm_aux_head(in_dim: int = 1024, channels: int = 256,
                 num_classes: int = 19) -> dict:
    """VFMHead + MaskTransformerDecoder (lora_dinov2_ms_masked.py)."""
    transformer = dict(
        type="MaskTransformerDecoder", query_dim=channels, n_heads=8,
        d_head=64, depth=3, dropout=0.1, mask_ratio=0.2)
    return dict(type="VFMHead", transformer=transformer,
                in_channels=[in_dim] * 4, channels=channels, dropout_ratio=0.1,
                num_classes=num_classes, align_corners=False)


def ms_test_cfg() -> dict:
    """MsVFM two-stage test cfg (the reference's 0.968 / 0.8 gate)."""
    return dict(
        mode="ms_slide_inference", threshold=0.968, conf=0.8,
        lr_img_size=(512, 1024), stride=(320, 320), crop_size=(512, 512))


def dg_test_data() -> dict:
    """The evaluation sets of the GTAV -> Cityscapes/BDD100K/Mapillary DG
    configs (``data.val``, ``data.test``, ``data.test_resize_wh``); no
    config sets ``data.test_keep_ratio``, which defaults to True."""
    citys = dict(type="CityscapesDataset", data_root="data/cityscapes",
                 img_dir="leftImg8bit/val", ann_dir="gtFine/val", key="citys")
    return dict(
        val=[dict(citys)],
        test=[dict(citys),
              dict(type="BDD100KDataset", data_root="data/bdd100k",
                   key="bdd"),
              dict(type="MapillaryDataset", data_root="data/mapillary",
                   key="map")],
        test_resize_wh=(2048, 1024),
    )


def headline_config() -> dict:
    """The headline model, test, training and compute settings
    (dg_lora_dinov2_ms_masked) and its evaluation sets; the training data
    is not carried: the port trains on synthetic batches of ``crop_size``."""
    d = DINOV2_DIM
    return dict(
        name="dg_lora_dinov2_ms_masked",
        crop_size=(1024, 1024),
        num_classes=19,
        data=dg_test_data(),
        preprocessor=dict(PREPROCESSOR),
        model=dict(
            type="MsVFMEncoderDecoder",
            backbone=lora_dinov2(img_size=512),
            decode_head=linear_head(d, channels=256),
            aux_head=vfm_aux_head(d, channels=256),
            detail_loss=1.0,
            scales=[1, 0.5],
            hr_crop_size=(512, 512),
            crop_coord_divisible=32,
            feature_scale=0.5,
        ),
        test_cfg=ms_test_cfg(),
        optimizer=dict(lr=1e-4, weight_decay=0.05, betas=(0.9, 0.999),
                       eps=1e-8, poly_power=0.9, warmup_steps=0),
        schedule=dict(max_iters=40000, val_interval=8000,
                      checkpoint_interval=4000, max_keep_ckpts=3,
                      log_interval=50, seed=0),
        peft=dict(enabled=True, adapter_keywords=["lora"]),
        batch_size=2,
        compute=dict(dtype="bfloat16", attn_impl="auto"),
    )


def eva02_config() -> dict:
    """dg_lora_eva02_ms_masked: the headline config with its backbone
    replaced by LoRA EVA02-L (the config's ``_delete_``); heads, test,
    training and compute settings are the headline's."""
    cfg = copy.deepcopy(headline_config())
    cfg["name"] = "dg_lora_eva02_ms_masked"
    cfg["model"]["backbone"] = lora_eva02(img_size=512)
    return cfg


def sam_config() -> dict:
    """dg_lora_sam_ms_masked: the headline config with LoRA SAM ViT-H as its
    backbone and both heads taking its 1280-wide maps (the decode head's
    ``channels`` 320); test, training and compute settings are the
    headline's."""
    cfg = copy.deepcopy(headline_config())
    cfg["name"] = "dg_lora_sam_ms_masked"
    m = cfg["model"]
    m["backbone"] = lora_sam(img_size=512)
    m["decode_head"].update(in_channels=[SAM_DIM] * 4, channels=320)
    m["aux_head"].update(in_channels=[SAM_DIM] * 4)
    return cfg


def smoke_tiny_config() -> dict:
    """smoke_tiny_ms_masked (configs/smoke/): the MsVFM scheme on a 4-block,
    32-wide ViT in fp32, runnable on a CPU; its evaluation part (the
    training data and schedule are not carried)."""
    return dict(
        name="smoke_tiny_ms_masked",
        crop_size=(128, 128),
        num_classes=19,
        model=dict(
            type="MsVFMEncoderDecoder",
            backbone=dict(
                type="LoRABackbone",
                backbone=dict(
                    type="DinoVisionTransformer", patch_size=16, embed_dim=32,
                    depth=4, num_heads=2, mlp_ratio=4, img_size=64,
                    init_values=1e-05, out_indices=[0, 1, 2, 3]),
                checkpoint="",
                Lora_config=dict(r=4, lora_alpha=4, target_modules=["qkv"],
                                 lora_dropout=0.1),
            ),
            decode_head=dict(
                type="LinearHead", in_channels=[32] * 4, channels=8,
                dropout_ratio=0.1, num_classes=19, align_corners=False),
            aux_head=dict(
                type="VFMHead",
                transformer=dict(query_dim=16, n_heads=2, d_head=8, depth=1,
                                 dropout=0.1, mask_ratio=0.2),
                in_channels=[32] * 4, channels=16, dropout_ratio=0.1,
                num_classes=19, align_corners=False),
            detail_loss=1.0,
            hr_crop_size=(64, 64),
            crop_coord_divisible=32,
        ),
        test_cfg=dict(
            mode="ms_slide_inference", threshold=0.968, conf=0.8,
            lr_img_size=(64, 64), stride=(32, 32), crop_size=(64, 64)),
        data=dict(
            test=[dict(type="GTADataset", data_root="/tmp/synth_gta",
                       key="synth")],
            test_resize_wh=(128, 128),
        ),
        compute=dict(dtype="float32", attn_impl="xla"),
    )


CONFIGS = {"dg_lora_dinov2_ms_masked": headline_config,
           "dg_lora_eva02_ms_masked": eva02_config,
           "dg_lora_sam_ms_masked": sam_config,
           "smoke_tiny_ms_masked": smoke_tiny_config}


def config(name: str) -> dict:
    """A ported config by its name in configs/."""
    if name not in CONFIGS:
        raise NotImplementedError(f"config {name!r} is not ported")
    return CONFIGS[name]()


def get_path(cfg: dict, dotted: str, default=None):
    """The value at a dotted key path (``data.test_resize_wh``), or
    ``default`` where the path is missing."""
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def parse_value(raw: str):
    """A ``--cfg-options`` value: a Python literal where it parses as one,
    else the string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def apply_cfg_options(cfg: dict, overrides: Iterable[str]) -> dict:
    """Set each ``key.path=value`` of ``overrides`` in ``cfg`` (in place,
    making missing dicts on the way), as vfmseg_tpu/core/config.py:131-172
    does for ``--cfg-options``; returns ``cfg``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key.path=value")
        key, raw = item.split("=", 1)
        *parents, leaf = key.strip().split(".")
        node = cfg
        for part in parents:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[leaf] = parse_value(raw.strip())
    return cfg
