"""Config dict -> model (the reference registry ``type=`` surface).

Port of vfmseg_tpu/models/build.py:71-101 and 250-252 for the types the
headline model uses; every other type raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from vfmseg_tpu_torch.models.backbones.dinov2 import build_backbone
from vfmseg_tpu_torch.models.heads.linear_head import LinearHead
from vfmseg_tpu_torch.models.heads.vfm_head import VFMHead
from vfmseg_tpu_torch.models.segmentors.ms_vfm import MsVFMSegmentor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_HEADS = {"LinearHead": LinearHead, "VFMHead": VFMHead}


def compute_dtype(cfg: Dict[str, Any]) -> torch.dtype:
    """The compute dtype named by a config's ``compute.dtype``."""
    return _DTYPES[cfg.get("compute", {}).get("dtype", "bfloat16")]


def _build_head(cfg: Dict[str, Any], dtype: torch.dtype):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in _HEADS:
        raise NotImplementedError(f"head type {kind!r} is not ported")
    return _HEADS[kind](dtype=dtype, **cfg)


def build_ms_vfm_encoder_decoder(
    backbone: Dict[str, Any],
    decode_head: Dict[str, Any],
    aux_head: Dict[str, Any],
    hr_crop_size=(512, 512),
    crop_coord_divisible: int = 32,
    detail_loss: float = 1.0,
    dtype: torch.dtype = torch.float32,
    **_unused,
) -> MsVFMSegmentor:
    """``_unused``: ``scales`` and ``feature_scale``, which the JAX builder
    does not read either (the two scales are fixed at 1 and 0.5)."""
    return MsVFMSegmentor(
        backbone=build_backbone(backbone, dtype=dtype),
        decode_head=_build_head(decode_head, dtype),
        aux_head=_build_head(aux_head, dtype),
        hr_crop_size=tuple(hr_crop_size),
        crop_coord_divisible=crop_coord_divisible,
        detail_loss=detail_loss,
    )


_SEGMENTORS = {"MsVFMEncoderDecoder": build_ms_vfm_encoder_decoder}


def build_segmentor(model_cfg: Dict[str, Any],
                    dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda"
                    ) -> MsVFMSegmentor:
    """Build the segmentor of a config's ``model`` section, in eval mode
    (``.train()`` for the training forward), with parameters in fp32 on
    ``device`` and compute in ``dtype``. The device is the card unless the
    caller asks for another (``device="cpu"``); with no card, asking for it
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_segmentor: no CUDA device "
                           "(torch.cuda.is_available() is false); pass "
                           "device='cpu' to build on the CPU")
    cfg = dict(model_cfg)
    kind = cfg.pop("type")
    if kind not in _SEGMENTORS:
        raise NotImplementedError(f"segmentor type {kind!r} is not ported")
    with device:
        return _SEGMENTORS[kind](dtype=dtype, **cfg).eval()
