"""The reckoned work against what PyTorch's FLOP counter sees over the
program's plain CPU path, and the bound arithmetic against hand-worked
shapes of PERF.md's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench import counters, program, weights
from cardbench_toys import toy


@pytest.mark.parametrize("config", ["dinov2_ms", "eva02_ms"])
def test_flops_match_the_flop_counter(config):
    cfg = toy(f"toy_{config}")
    model = program.build(cfg, weights.make(cfg["model"], 3, "cpu"), "cpu")
    t = cfg["test_cfg"]
    img = torch.randn(1, *t["lr_img_size"], 3)
    win = torch.randn(2, *t["crop_size"], 3)
    ctx = torch.randn(2, *t["crop_size"], cfg["num_classes"])
    with torch.inference_mode():
        model.lr_forward(img)          # LoRA folds once, outside the count
        with FlopCounterMode(display=False) as stage1:
            model.lr_forward(img)
        with FlopCounterMode(display=False) as refine:
            model.hr_forward(win, ctx)
    assert stage1.get_total_flops() == counters.stage1_flops(cfg)
    assert refine.get_total_flops() == 2 * counters.window_flops(cfg)
    assert counters.image_flops(cfg, 3) == (counters.stage1_flops(cfg)
                                            + 3 * counters.window_flops(cfg))


def test_full_size_flops():
    """DINOv2-L: 24 E^2 N + 4 N^2 E a block; stage 1 at 2049 tokens."""
    cfg = toy("toy_dinov2_ms")
    bb = cfg["model"]["backbone"]["backbone"]
    bb.update(embed_dim=1024, depth=24, num_heads=16, img_size=512)
    e, n = 1024, 2049
    want = 2.0 * 2048 * 3 * 256 * e + 24 * (24 * e * e * n + 4 * n * n * e)
    assert counters.vit_flops(cfg, 512, 1024) == want


@pytest.mark.parametrize("shape, bound_ms", [
    ((18, 16, 1025, 1025, 64), 0.0783),   # B2 over the 18 refine windows
    ((1, 16, 2049, 2049, 64), 0.0174),    # B2 at stage 1
    ((18, 8, 1024, 1024, 64), 0.0391),    # the decoder's B2
    ((4, 16, 1025, 1025, 64), 0.0174),    # B3 in the train step
])
def test_attention_bounds_match_the_kernel_table(shape, bound_ms):
    f, b = counters.attention_call(*shape)
    assert counters.bound_s(f, b) * 1e3 == pytest.approx(bound_ms, rel=2e-3)
    assert f / counters.PEAK_BF16_FLOPS > b / counters.HBM_BYTES_PER_S


def test_bytes_bound_when_little_work():
    f, b = counters.attention_call(1, 1, 16, 16, 64, rope=True)
    assert b == 2 * 64 * (2 * 16 + 2 * 16) + 2 * 4 * 16 * 64
    assert counters.bound_s(f, b) == b / counters.HBM_BYTES_PER_S


def test_attention_calls_count_the_gated_work():
    cfg = toy("toy_eva02_ms")
    calls0 = counters.attention_calls(cfg, 0)
    calls2 = counters.attention_calls(cfg, 2)
    depth = cfg["model"]["backbone"]["backbone"]["depth"]
    dec = cfg["model"]["aux_head"]["transformer"]["depth"]
    assert len(calls0) == depth
    assert len(calls2) == depth + 2 * (depth + 2 * dec)
    assert counters.attention_bound_s(cfg, 2) > counters.attention_bound_s(
        cfg, 0)


@pytest.mark.parametrize("config", ["dinov2_ms", "eva02_ms"])
def test_train_flops_match_the_flop_counter(config):
    """A train step's forward and backward on the program's CPU path: the
    counter sees the reckoned work plus the q k^T product that the plain
    attention backward recomputes (an implementation's choice, not
    reckoned)."""
    from vfmseg_tpu_torch.models import rng
    from vfmseg_tpu_torch.train.step import step_generators

    cfg = toy(f"toy_{config}")
    model = program.build(cfg, weights.make(cfg["model"], 3, "cpu"), "cpu")
    program.TrainStep(model, cfg)           # LoRA and the heads train
    model.train()
    g = torch.Generator().manual_seed(0)
    b, hw = 2, (128, 128)
    img = torch.randn(b, *hw, 3, generator=g)
    label = torch.randint(0, cfg["num_classes"], (b, *hw), generator=g)
    with FlopCounterMode(display=False) as count:
        with rng.streams(step_generators(5, 0, torch.device("cpu"))):
            losses = model(img, label)
        sum(v for k, v in losses.items() if "loss" in k).backward()
    d = counters.vit_dims(cfg)
    gh, gw = counters.grid(cfg, *cfg["model"]["hr_crop_size"])
    t = cfg["model"]["aux_head"]["transformer"]
    recompute = (d["depth"] * 2.0 * (2 * b) * d["heads"] * (gh * gw + 1) ** 2
                 * (d["embed"] // d["heads"])
                 + 2 * t["depth"] * 2.0 * b * t["n_heads"] * (gh * gw) ** 2
                 * t["d_head"])
    assert count.get_total_flops() == counters.train_step_flops(cfg, b, hw) \
        + recompute


def test_train_attention_bound():
    """Forward and backward of one ViT attention of the train step, (4, 16,
    1025, 64): six products, three times B3's forward bound of the kernel
    table (0.0174 ms); the table's B4 row (0.0435 ms) counts five products
    for the backward, the recomputed q k^T among them."""
    f, b = counters.attention_train_call(4, 16, 1025, 64)
    assert counters.bound_s(f, b) * 1e3 == pytest.approx(3 * 0.0174,
                                                         rel=3e-3)
    cfg = toy("toy_dinov2_ms")
    assert counters.train_attention_bound_s(cfg, 2) > 0
