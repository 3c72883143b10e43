"""Every config under configs/ builds in the torch port and runs one training
forward, on the CPU: the port's twin of tests/test_configs_build_all.py.

Each file loads through the port's loader; a model config is shrunk as the
JAX test shrinks it (width 32, 4 blocks, 2 heads; MiT at (8, 16, 32, 64);
heads at 16 channels; Mask2Former at 32 channels, 10 queries, one layer,
16 points; HR crops of 64), built with ``build_segmentor(device="cpu")``,
filled by ``init_params`` and run once in training mode inside
``rng.streams`` on a 64 px batch (128 px for the two-scale segmentors): at
least one loss entry, all finite. The ``DomainGeneral`` config wraps the
shrunk headline with its mask branch on: its ``mask.*`` losses are there
too, and finite. The shrinking itself is the JAX test's
(``_shrink_model``), so both packages build the same shapes.
"""

import glob
import os

import numpy as np
import pytest
import torch

from test_configs_build_all import _shrink_model
from vfmseg_tpu_torch.core.config import load_config
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.train.step import step_generators
from vfmseg_tpu_torch.weights import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "configs", "**", "*.py"), recursive=True))
TWO_SCALE = ("MsVFMEncoderDecoder", "HRDAEncoderDecoder",
             "FrozenHRDAEncoderDecoder", "MultiScaleEncoderDecoder")


def _batch(size):
    rs = np.random.RandomState(1)
    img = torch.from_numpy(rs.standard_normal((1, size, size, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rs.randint(0, 19, (1, size, size)))
    return img, labels


@pytest.mark.parametrize(
    "path", ALL_CONFIGS,
    ids=[os.path.relpath(p, os.path.join(REPO, "configs"))
         for p in ALL_CONFIGS])
def test_config_builds_and_forwards(path):
    cfg = load_config(path)
    if "model" not in cfg:
        assert any(k in cfg for k in ("data", "optimizer", "schedule")), (
            f"{path} is neither a model config nor a recognized fragment")
        return
    model_cfg = cfg.model.to_dict()
    _shrink_model(model_cfg)
    wrapped = model_cfg["type"] == "DomainGeneral"
    inner_type = model_cfg["model_cfg"]["type"] if wrapped else (
        model_cfg["type"])
    model = init_params(build_segmentor(model_cfg, device="cpu"), 0).train()
    img, labels = _batch(128 if inner_type in TWO_SCALE else 64)
    with rng.streams(step_generators(0, 0, torch.device("cpu"))):
        losses = model(img, labels)
    loss_keys = [k for k in losses if "loss" in k]
    assert loss_keys, f"{path}: no loss entries in {sorted(losses)}"
    if wrapped and model_cfg.get("enable_mask_loss"):
        assert any(k.startswith("mask.") for k in loss_keys), sorted(losses)
    for k in loss_keys:
        assert torch.isfinite(losses[k]), f"{path}: {k} not finite"
