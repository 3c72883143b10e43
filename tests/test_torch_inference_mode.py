"""Tensors the port caches across calls (SAM's rel-pos index and resize
matrices in ``ops/window.py``, the ViT's RoPE tables, Mask2Former's sine
positions and reference points) stay normal tensors when a predictor first
makes them under ``torch.inference_mode``: a training step on the same
shapes afterwards saves them for its backward, which PyTorch refuses for
inference tensors. (The SAM case of tests/test_torch_remat.py failed so
when another file's inference had run first in the same process.)"""

import numpy as np
import pytest
import torch

from test_torch_models import toy_config
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.models.heads import mask2former
from vfmseg_tpu_torch.ops import window
from vfmseg_tpu_torch.train.step import step_generators
from vfmseg_tpu_torch.weights import init_params


def test_cached_tensors_are_normal_tensors():
    cpu = torch.device("cpu")
    for fn in (window._coords_on, window._linear_matrix, mask2former._sine_on,
               mask2former._reference_points):
        fn.cache_clear()
    with torch.inference_mode():
        made = [window._coords_on(5, 5, cpu), window._linear_matrix(9, 5, cpu),
                mask2former._sine_on(3, 4, 8, cpu),
                *mask2former._reference_points(((2, 3),), cpu)]
    assert not any(t.is_inference() for t in made)


@pytest.mark.parametrize("family", ["sam", "eva02"])
def test_training_after_inference_mode(family):
    """The toy backbone run under ``torch.inference_mode`` at the step's
    grids, then one training step of the whole segmentor."""
    window._coords_on.cache_clear()
    window._linear_matrix.cache_clear()
    model = init_params(build_segmentor(toy_config(family=family)["model"],
                                        device="cpu"), 2)
    rs = np.random.RandomState(3)
    img = torch.from_numpy(rs.standard_normal((2, 128, 128, 3)).astype(
        np.float32))
    lab = torch.from_numpy(rs.randint(0, 19, (2, 128, 128)))
    model.eval()
    with torch.inference_mode():
        model.backbone(img[:, :64, :64])
    model.train()
    with rng.streams(step_generators(0, 0, torch.device("cpu"))):
        out = model(img, lab)
    sum(v for k, v in out.items() if "loss" in k).backward()
    assert all(p.grad is not None for p in model.backbone.parameters()
               if p.requires_grad)
