"""The fused deformable-attention core (``csrc/deform_attn.cu``) on the
card: against its plain twin at Rein's slide shapes and off them, and its
launches through the Rein Mask2Former model: a slide frame takes the fused
core once an encoder layer and B8 never; a train step takes B8 once a level
of each layer and the fused core never.

Every test is marked ``card`` and skips without one. The card's machine has
no JAX, which tests/conftest.py imports, so run the file there without it:
``python -m pytest tests/test_torch_deform_attn_card.py --noconftest -q``."""

import numpy as np
import pytest
import torch

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.eval.evaluator import make_shape_aware_predict_fn
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.ops.deform_attn import (
    ms_deform_attn_cuda,
    ms_deform_attn_plain,
)
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step
from vfmseg_tpu_torch.weights import init_params

# bf16: the output's one rounding (half an ulp, 2^-9 of it) and sums taken
# in another order; fp32: sums in another order
TOL = {torch.bfloat16: (1e-5, 2.0 ** -8), torch.float32: (1e-5, 1e-5)}
REIN_LEVELS = ((16, 16), (32, 32), (64, 64))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return torch.device("cuda", 0)


def inputs(dev, b, nq, shapes, heads, d, points, dtype, seed, value_skip=0):
    """Seeded value, offsets, logits and reference points: offsets of a few
    pixels (so taps and whole samples fall off small planes) and some far
    outside; ``value_skip`` elements of offset from the storage's start."""
    gen = torch.Generator().manual_seed(seed)
    lp = len(shapes) * points
    nv = sum(h * w for h, w in shapes)
    value = torch.randn(b * nv * heads * d + value_skip, generator=gen)
    value = value.to(dev, dtype)[value_skip:].view(b, nv, heads * d)
    off = torch.randn(b, nq, heads * lp * 2, generator=gen) * 3
    off[:, ::7] *= 40
    logits = torch.randn(b, nq, heads * lp, generator=gen) * 2
    ref_x, ref_y = (torch.rand(nq, generator=gen).to(dev) for _ in range(2))
    return value, off.to(dev, dtype), logits.to(dev, dtype), ref_x, ref_y


@pytest.mark.card
@pytest.mark.parametrize("b, nq, shapes, heads, d, points, dtype, skip", [
    (18, 5376, REIN_LEVELS, 8, 32, 4, torch.bfloat16, 0),   # Rein's slide
    (18, 5376, REIN_LEVELS, 8, 32, 4, torch.float32, 0),
    (2, 5376, REIN_LEVELS, 8, 32, 4, torch.bfloat16, 0),    # a train batch
    (3, 333, ((5, 7),), 8, 32, 1, torch.bfloat16, 0),       # 1 level, 1 point
    (2, 101, ((3, 4), (6, 8), (12, 16), (24, 32)), 8, 32, 4,
     torch.bfloat16, 0),                                   # 4 levels
    (2, 77, ((4, 4), (8, 8), (16, 16)), 8, 8, 4, torch.bfloat16, 0),
    (2, 77, ((4, 4), (8, 8), (16, 16)), 4, 64, 4, torch.float32, 0),
    (2, 50, ((4, 4), (8, 8), (16, 16)), 8, 4, 4, torch.bfloat16, 0),
    (2, 50, ((4, 4), (8, 8)), 3, 5, 2, torch.bfloat16, 0),  # one element
    (2, 90, ((4, 4), (8, 8), (16, 16)), 8, 32, 4, torch.bfloat16, 4),
    (1, 40, ((6, 6), (3, 3)), 1, 32, 16, torch.float32, 0),  # L P = 32
    (2, 60, ((3, 4), (6, 8), (12, 16), (24, 32)), 16, 16, 4,
     torch.bfloat16, 0),                                   # 16 heads
])
def test_kernel_matches_twin(card, b, nq, shapes, heads, d, points, dtype,
                             skip):
    args = inputs(card, b, nq, shapes, heads, d, points, dtype, nq + d, skip)
    before = kernels.DEFORM_ATTN.launches
    got = ms_deform_attn_cuda(*args, shapes, heads, points)
    torch.cuda.synchronize(card)
    assert kernels.DEFORM_ATTN.launches == before + 1
    assert got.shape == (b, nq, heads * d) and got.dtype == dtype
    f32 = [t.float() for t in args]
    want = ms_deform_attn_plain(*f32, shapes, heads, points)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def _rein_toy(dev):
    """The tiny Rein model with B2's head dim (64) in its ViT."""
    cfg = presets.config("smoke_tiny_rein_m2f", ["model.backbone.embed_dim=128",
                                                 "model.backbone.num_heads=2"])
    model = init_params(build_segmentor(cfg["model"], dtype=torch.bfloat16,
                                        device=dev), 0)
    return cfg, model


@pytest.mark.card
def test_launches_per_slide_frame(card):
    """One frame through the toy Rein model's slide predictor (its crops in
    one batch): the fused core once an encoder layer, B8 never."""
    cfg, model = _rein_toy(card)
    layers = model.decode_head.pixel_decoder.num_encoder_layers
    predict = make_shape_aware_predict_fn(model, cfg["test_cfg"])
    img = torch.randn(1, 96, 128, 3,
                      generator=torch.Generator().manual_seed(1)).to(card)
    kernels.reset_launch_counts()
    predict(model, img, (96, 128))
    torch.cuda.synchronize(card)
    assert layers == 6
    assert kernels.DEFORM_ATTN.launches == layers
    assert kernels.DEFORM_SAMPLE.launches == 0


@pytest.mark.card
def test_launches_per_train_step(card):
    """One train step of the toy Rein model: B8 once a level of each encoder
    layer (6 x 3), the fused core never."""
    cfg, model = _rein_toy(card)
    model.train()
    state = create_train_state(model, cfg, max_iters=10)
    rs = np.random.RandomState(24)
    batch = {"img": rs.standard_normal((2, 64, 64, 3)).astype(np.float32),
             "label": rs.randint(0, 19, (2, 64, 64)).astype(np.int32)}
    kernels.reset_launch_counts()
    make_train_step()(state, batch, 0)
    torch.cuda.synchronize(card)
    assert kernels.DEFORM_SAMPLE.launches == 18
    assert kernels.DEFORM_ATTN.launches == 0
