"""Config dict -> model (the reference registry ``type=`` surface).

Port of vfmseg_tpu/models/build.py:37-252: MsVFMEncoderDecoder,
EncoderDecoder (with a (Rein)Mask2FormerHead it builds the MaskFormer
segmentor), FrozenBackboneEncoderDecoder, LoraBackboneEncoderDecoder,
HRDAEncoderDecoder and FrozenHRDAEncoderDecoder (with an HRDAHead over a
seg head and an AttentionHead) and MultiScaleEncoderDecoder; the heads
LinearHead, VFMHead, SegformerHead, AttentionHead, DAFormerHead and
DINOhead; the backbones of ``backbones/dinov2.py`` ``build_backbone``; and
the DomainGeneral wrapper around any of those segmentors.
``attn_impl`` (a config's ``compute.attn_impl``) reaches every backbone and
head, as in the JAX builder. A key that a builder neither uses nor names
as ignored raises ``TypeError``, so no config option is dropped silently.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from vfmseg_tpu_torch.models.algorithms.dg import DomainGeneral
from vfmseg_tpu_torch.models.backbones.dinov2 import build_backbone
from vfmseg_tpu_torch.models.backbones.vit import ATTN_IMPLS
from vfmseg_tpu_torch.models.common import not_ported
from vfmseg_tpu_torch.models.heads.attention_head import AttentionHead
from vfmseg_tpu_torch.models.heads.daformer import DAFormerHead
from vfmseg_tpu_torch.models.heads.dino_head import DINOHead
from vfmseg_tpu_torch.models.heads.linear_head import LinearHead
from vfmseg_tpu_torch.models.heads.mask2former import Mask2FormerHead
from vfmseg_tpu_torch.models.heads.segformer import SegformerHead
from vfmseg_tpu_torch.models.heads.vfm_head import VFMHead
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import EncoderDecoder
from vfmseg_tpu_torch.models.segmentors.hrda import (
    HRDAEncoderDecoder,
    HRDAHead,
)
from vfmseg_tpu_torch.models.segmentors.maskformer import MaskFormerSegmentor
from vfmseg_tpu_torch.models.segmentors.ms_vfm import MsVFMSegmentor
from vfmseg_tpu_torch.models.segmentors.multiscale import (
    MultiScaleEncoderDecoder,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# head keys the JAX builder drops before building any head
_HEAD_IGNORED = ("in_index", "norm_cfg", "loss_decode")
# the keys the JAX builder passes to a DINOhead (build.py:22-30); it drops
# any other, which the port refuses
_DINO_HEAD_KEYS = {"in_channels", "channels", "num_classes", "dropout_ratio",
                   "align_corners"}


def compute_dtype(cfg: Dict[str, Any]) -> torch.dtype:
    """The compute dtype named by a config's ``compute.dtype``."""
    return _DTYPES[cfg.get("compute", {}).get("dtype", "bfloat16")]


def compute_attn_impl(cfg: Dict[str, Any]) -> str:
    """The attention route named by a config's ``compute.attn_impl``."""
    return cfg.get("compute", {}).get("attn_impl", "auto")


def _build_head(cfg: Dict[str, Any], dtype: torch.dtype, attn_impl: str):
    cfg = {k: v for k, v in cfg.items() if k not in _HEAD_IGNORED}
    kind = cfg.pop("type")
    if kind == "LinearHead":
        return LinearHead(dtype=dtype, **cfg)
    if kind == "VFMHead":
        return VFMHead(dtype=dtype, attn_impl=attn_impl, **cfg)
    if kind == "SegformerHead":
        return SegformerHead(dtype=dtype, **cfg)
    if kind == "AttentionHead":
        return AttentionHead(dtype=dtype, **cfg)
    if kind == "DAFormerHead":
        return DAFormerHead(dtype=dtype, **cfg)
    if kind == "DINOhead":
        unknown = set(cfg) - _DINO_HEAD_KEYS
        if unknown:
            raise TypeError(f"DINOhead keys {sorted(unknown)} are not read "
                            f"by the JAX builder")
        return DINOHead(dtype=dtype, attn_impl=attn_impl, **cfg)
    raise not_ported("head", kind)


_M2F_TRAIN_KEYS = {"num_points", "oversample_ratio", "importance_sample_ratio"}


def _build_mask2former_head(
    type: str,
    backbone: torch.nn.Module,
    in_channels=None,
    num_classes: int = 19,
    num_queries: int = 100,
    feat_channels: int = 256,
    num_transformer_feat_level: int = 3,
    transformer_decoder: Optional[dict] = None,
    replace_query_feat: bool = False,
    train_cfg: Optional[dict] = None,
    strides=None,
    out_channels: int = 256,
    align_corners: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Tuple[Mask2FormerHead, int]:
    """JAX build.py:114-135: the head and the loss's ``num_points`` (from
    ``train_cfg``, default 12544). The head's input widths are the
    backbone's (the flax head reads them off the maps). A
    ReinMask2FormerHead takes the backbone's queries where the backbone
    returns them: the flax head then has no ``query_embed``. Config parity,
    read by neither builder: ``in_channels``, ``strides``,
    ``out_channels`` (the pixel decoder's width is ``feat_channels``),
    ``align_corners``, and ``train_cfg``'s ``oversample_ratio`` and
    ``importance_sample_ratio`` (the loss's 3.0 and 0.75, which every
    config under ``configs/`` names)."""
    del in_channels, strides, out_channels, align_corners
    train_cfg = dict(train_cfg or {})
    unknown = set(train_cfg) - _M2F_TRAIN_KEYS
    if unknown:
        raise TypeError(f"train_cfg keys {sorted(unknown)} are not ported")
    layers = dict(transformer_decoder or {})
    num_layers = layers.pop("num_layers", 9)
    if layers:
        raise TypeError(f"transformer_decoder keys {sorted(layers)} are not "
                        f"ported")
    return Mask2FormerHead(
        in_channels=(backbone.cfg.embed_dim,) * 4, num_classes=num_classes,
        num_queries=num_queries, feat_channels=feat_channels,
        num_transformer_feat_level=num_transformer_feat_level,
        num_decoder_layers=num_layers, replace_query_feat=replace_query_feat,
        rein_queries=type.startswith("Rein") and backbone.returns_queries,
        dtype=dtype), train_cfg.get("num_points", 12544)


def build_ms_vfm_encoder_decoder(
    backbone: Dict[str, Any],
    decode_head: Dict[str, Any],
    aux_head: Dict[str, Any],
    hr_crop_size=(512, 512),
    crop_coord_divisible: int = 32,
    detail_loss: float = 1.0,
    scales=(1, 0.5),
    feature_scale: float = 0.5,
    data_preprocessor: Optional[dict] = None,
    train_cfg: Optional[dict] = None,
    test_cfg: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> MsVFMSegmentor:
    """``scales``, ``feature_scale``, ``data_preprocessor``, ``train_cfg``
    and ``test_cfg`` are read by neither builder (the two scales are fixed
    at 1 and 0.5; the eval functions read the config's ``test_cfg``)."""
    del scales, feature_scale, data_preprocessor, train_cfg, test_cfg
    return MsVFMSegmentor(
        backbone=build_backbone(backbone, dtype=dtype, attn_impl=attn_impl),
        decode_head=_build_head(decode_head, dtype, attn_impl),
        aux_head=_build_head(aux_head, dtype, attn_impl),
        hr_crop_size=tuple(hr_crop_size),
        crop_coord_divisible=crop_coord_divisible,
        detail_loss=detail_loss,
    )


def build_encoder_decoder(
    backbone: Dict[str, Any],
    decode_head: Dict[str, Any],
    data_preprocessor: Optional[dict] = None,
    train_cfg: Optional[dict] = None,
    test_cfg: Optional[dict] = None,
    frozen_backbone: bool = False,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> EncoderDecoder:
    """JAX build.py:101-144: a Mask2Former decode head makes the MaskFormer
    segmentor, any other head the plain encoder-decoder."""
    del data_preprocessor, train_cfg, test_cfg
    bb = build_backbone(backbone, dtype=dtype, attn_impl=attn_impl)
    if "Mask2Former" in decode_head.get("type", ""):
        head, num_points = _build_mask2former_head(backbone=bb, dtype=dtype,
                                                   **decode_head)
        return MaskFormerSegmentor(bb, head, num_classes=head.num_classes,
                                   num_points=num_points,
                                   frozen_backbone=frozen_backbone)
    return EncoderDecoder(bb, _build_head(decode_head, dtype, attn_impl),
                          frozen_backbone=frozen_backbone)


def build_frozen_encoder_decoder(**kwargs) -> EncoderDecoder:
    """frozen_encoder_decoder.py:19-34: the backbone's features detached."""
    return build_encoder_decoder(frozen_backbone=True, **kwargs)


def build_lora_encoder_decoder(backbone: Dict[str, Any], Lora_config: dict,
                               checkpoint: str = "",
                               **kwargs) -> EncoderDecoder:
    """Lora_encoder_decoder.py:14-43: an encoder-decoder that LoRA-wraps its
    own backbone (the effect of LoRABackbone); ``checkpoint`` is the
    converted backbone file, loaded by the weight tooling."""
    wrapped = dict(type="LoRABackbone", backbone=dict(backbone),
                   Lora_config=dict(Lora_config), checkpoint=checkpoint)
    return build_encoder_decoder(backbone=wrapped, **kwargs)


_HRDA_HEAD_KEYS = {"type", "seg_head", "single_scale_head", "lr_loss_weight",
                   "hr_loss_weight", *_HEAD_IGNORED}


def build_hrda_encoder_decoder(
    backbone: Dict[str, Any],
    decode_head: Dict[str, Any],
    scales=(1, 0.5),
    hr_crop_size=(512, 512),
    crop_coord_divisible: int = 8,
    hr_slide_inference: bool = True,
    feature_scale: float = 0.5,
    frozen: bool = False,
    data_preprocessor: Optional[dict] = None,
    train_cfg: Optional[dict] = None,
    test_cfg: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> HRDAEncoderDecoder:
    """JAX build.py:159-194: the HRDAHead from ``seg_head`` and
    ``single_scale_head`` (the scale attention); ``scales`` sorted, so the
    first is the LR scale. Read by neither builder: ``hr_slide_inference``
    (inference always slides the HR crops), ``feature_scale``,
    ``data_preprocessor``, ``train_cfg`` and ``test_cfg``."""
    del hr_slide_inference, feature_scale, data_preprocessor, train_cfg
    del test_cfg
    unknown = set(decode_head) - _HRDA_HEAD_KEYS
    if unknown:
        raise TypeError(f"HRDAHead keys {sorted(unknown)} are not ported")
    head = HRDAHead(
        seg_head=_build_head(decode_head["seg_head"], dtype, attn_impl),
        scale_attention=_build_head(decode_head["single_scale_head"], dtype,
                                    attn_impl),
        lr_loss_weight=decode_head.get("lr_loss_weight", 0.0),
        hr_loss_weight=decode_head.get("hr_loss_weight", 0.1))
    return HRDAEncoderDecoder(
        backbone=build_backbone(backbone, dtype=dtype, attn_impl=attn_impl),
        decode_head=head, scales=tuple(sorted(scales)),
        hr_crop_size=tuple(hr_crop_size),
        crop_coord_divisible=crop_coord_divisible, frozen_backbone=frozen)


def build_frozen_hrda_encoder_decoder(**kwargs) -> HRDAEncoderDecoder:
    """hrda_encoder_decoder.py:450-464: the backbone's features carry no
    gradient."""
    return build_hrda_encoder_decoder(frozen=True, **kwargs)


def build_multiscale_encoder_decoder(
    backbone: Dict[str, Any],
    decode_head: Dict[str, Any],
    hr_crop_size=(512, 512),
    crop_coord_divisible: int = 32,
    detail_loss: float = 1.0,
    data_preprocessor: Optional[dict] = None,
    train_cfg: Optional[dict] = None,
    test_cfg: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> MultiScaleEncoderDecoder:
    """JAX build.py:205-230: one context-aware decode head shared by both
    scales. ``data_preprocessor``, ``train_cfg`` and ``test_cfg``: read by
    neither builder."""
    del data_preprocessor, train_cfg, test_cfg
    return MultiScaleEncoderDecoder(
        backbone=build_backbone(backbone, dtype=dtype, attn_impl=attn_impl),
        decode_head=_build_head(decode_head, dtype, attn_impl),
        hr_crop_size=tuple(hr_crop_size),
        crop_coord_divisible=crop_coord_divisible, detail_loss=detail_loss)


def build_domain_general(
    model_cfg: Dict[str, Any], dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto", train_cfg: Optional[dict] = None,
    enable_mask_loss: bool = False, color_jitter_strength: float = 0.25,
    color_jitter_probability: float = 0.2, blur: bool = True,
    mask_ratio: float = 0.7, mask_block_size: int = 64,
    lamda_mask: float = 0.5,
) -> DomainGeneral:
    """JAX build.py:230-247: the wrapper around the segmentor of
    ``model_cfg``, built with the same ``dtype`` and ``attn_impl``, with
    the seven keys the JAX builder passes on (any other key raises
    ``TypeError`` here, where the JAX builder drops it); ``train_cfg``:
    read by neither builder."""
    del train_cfg
    inner = dict(model_cfg)
    kind = inner.pop("type")
    if kind not in _SEGMENTORS:
        raise not_ported("segmentor", kind)
    return DomainGeneral(
        _SEGMENTORS[kind](dtype=dtype, attn_impl=attn_impl, **inner),
        enable_mask_loss=enable_mask_loss,
        color_jitter_strength=color_jitter_strength,
        color_jitter_probability=color_jitter_probability, blur=blur,
        mask_ratio=mask_ratio, mask_block_size=mask_block_size,
        lamda_mask=lamda_mask)


_SEGMENTORS = {"MsVFMEncoderDecoder": build_ms_vfm_encoder_decoder,
               "EncoderDecoder": build_encoder_decoder,
               "FrozenBackboneEncoderDecoder": build_frozen_encoder_decoder,
               "LoraBackboneEncoderDecoder": build_lora_encoder_decoder,
               "HRDAEncoderDecoder": build_hrda_encoder_decoder,
               "FrozenHRDAEncoderDecoder": build_frozen_hrda_encoder_decoder,
               "MultiScaleEncoderDecoder": build_multiscale_encoder_decoder,
               "DomainGeneral": build_domain_general}


def build_segmentor(model_cfg: Dict[str, Any],
                    dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda",
                    attn_impl: str = "auto"):
    """Build the segmentor of a config's ``model`` section, in eval mode
    (``.train()`` for the training forward), with parameters in fp32 on
    ``device`` and compute in ``dtype``. The device is the card unless the
    caller asks for another (``device="cpu"``); with no card, asking for it
    raises. ``attn_impl``: the config's ``compute.attn_impl``
    (:func:`compute_attn_impl`): ``"auto"``, ``"pallas"`` and ``"xla"``
    take the port's one route, ``"pallas_bias"`` SAM's bias route; any
    other value raises ``ValueError``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of "
                         f"{ATTN_IMPLS}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_segmentor: no CUDA device "
                           "(torch.cuda.is_available() is false); pass "
                           "device='cpu' to build on the CPU")
    cfg = dict(model_cfg)
    kind = cfg.pop("type")
    if kind not in _SEGMENTORS:
        raise not_ported("segmentor", kind)
    with device:
        return _SEGMENTORS[kind](dtype=dtype, attn_impl=attn_impl,
                                 **cfg).eval()
