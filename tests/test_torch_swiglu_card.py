"""The SwiGLU gate-and-sub-LN kernel (``csrc/swiglu_gate_ln.cu``) on the
card: against its plain twin at the eval route's shapes and off them, and
its launches through the dense predictor (48 an EVA02-L image: 24 blocks in
stage 1 and 24 in the refine call; none for DINOv2-L, whose FFN is an MLP).

Every test is marked ``card`` and skips without one. The card's machine has
no JAX, which tests/conftest.py imports, so run the file there without it:
``python -m pytest tests/test_torch_swiglu_card.py --noconftest -q``."""

import pytest
import torch

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.eval.evaluator import make_shape_aware_predict_fn
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.models.presets import eva02_config, headline_config
from vfmseg_tpu_torch.ops.swiglu import (
    swiglu_gate_ln_cuda,
    swiglu_gate_ln_plain,
)
from vfmseg_tpu_torch.weights import init_params

# chip_smoke.py's LN_TOL: output rounding and another summation order
TOL = {torch.bfloat16: (3e-2, 1e-2), torch.float32: (1e-4, 1e-5)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("rows, h, hp, dtype", [
    (18 * 1025, 2730, 2736, torch.bfloat16),   # the refine call
    (2049, 2730, 2736, torch.bfloat16),        # stage 1
    (2049, 2048, 2048, torch.bfloat16),        # an aligned width (EVA02-B)
    (2049, 2730, 2752, torch.bfloat16),        # a wider pad
    (37, 10, 16, torch.bfloat16),              # a toy width
    (33, 4000, 4000, torch.bfloat16),          # 4 vectors a thread
    (513, 1000, 1000, torch.float32),          # fp32
    (65, 2730, 2736, torch.float32),           # fp32, 8 vectors a thread
    (9, 9000, 9000, torch.bfloat16),           # past a block's registers
    (9, 5000, 5000, torch.float32),            # the same in fp32
])
def test_kernel_matches_twin(card, rows, h, hp, dtype):
    gen = torch.Generator().manual_seed(rows + h)
    g = (torch.randn(rows, 2 * hp, generator=gen) * 2).to(card, dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen)).to(card)
    b = (0.1 * torch.randn(h, generator=gen)).to(card)
    before = kernels.SWIGLU_GATE_LN.launches
    got = swiglu_gate_ln_cuda(g, h, w, b, 1e-6)
    torch.cuda.synchronize(card)
    assert kernels.SWIGLU_GATE_LN.launches == before + 1
    want = swiglu_gate_ln_plain(g.float(), h, w, b, 1e-6)
    assert got.shape == (rows, hp) and got.dtype == dtype
    assert torch.equal(got[:, h:], torch.zeros_like(got[:, h:]))
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.card
@pytest.mark.parametrize("make_cfg, launches", [(eva02_config, 48),
                                                (headline_config, 0)])
def test_launches_per_dense_image(card, make_cfg, launches):
    """One 1024x2048 image through the dense predictor of the config's
    segmentor (bf16, seeded weights)."""
    cfg = make_cfg()
    model = init_params(build_segmentor(
        cfg["model"], dtype=compute_dtype(cfg),
        attn_impl=compute_attn_impl(cfg)), 0)
    predict = make_shape_aware_predict_fn(model, cfg["test_cfg"])
    img = torch.randn(1, 1024, 2048, 3,
                      generator=torch.Generator().manual_seed(1)).to(card)
    kernels.reset_launch_counts()
    predict(model, img, (1024, 2048))
    torch.cuda.synchronize(card)
    assert kernels.SWIGLU_GATE_LN.launches == launches
