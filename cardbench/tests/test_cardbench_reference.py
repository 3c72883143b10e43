"""The plain reference against the program's CPU path at toy sizes, in
float32: the same state dict, the same stage-1 and refine logits, the same
gated prediction, and the judge's gaps."""

import pytest
import torch

from cardbench import check, program, weights
from cardbench.reference import model as ref
from cardbench_toys import toy
from vfmseg_tpu_torch.eval.evaluator import make_logits_fn

CONFIGS = ["dinov2_ms", "eva02_ms"]


def _pair(config, seed=4):
    cfg = toy(f"toy_{config}")
    sd = weights.make(cfg["model"], seed, "cpu")
    weights.scale_classifier(sd, 200.0)  # a gate that skips some windows
    port = program.build(cfg, sd, "cpu")
    rm = ref.build(cfg["model"], "cpu")
    rm.load_state_dict(sd, strict=True)
    return cfg, port, rm


@pytest.mark.parametrize("config", CONFIGS)
def test_state_dicts_agree(config):
    cfg = toy(f"toy_{config}")
    port = program.build(cfg, weights.make(cfg["model"], 1, "cpu"), "cpu")
    rm = ref.build(cfg["model"], "meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in rm.state_dict().items()}


@pytest.mark.parametrize("config", CONFIGS)
def test_logits_match_the_program(config):
    cfg, port, rm = _pair(config)
    t = cfg["test_cfg"]
    g = torch.Generator().manual_seed(0)
    img = torch.randn(2, *t["lr_img_size"], 3, generator=g)
    win = torch.randn(3, *t["crop_size"], 3, generator=g)
    ctx = 5 * torch.randn(3, *t["crop_size"], cfg["num_classes"],
                          generator=g)
    pr = ref.Products()
    with torch.inference_mode():
        for got, want in ((port.lr_forward(img), rm.lr_forward(img, pr)),
                          (port.hr_forward(win, ctx),
                           rm.hr_forward(win, ctx, pr))):
            assert got.shape == want.shape
            err = (got - want).abs().max() / want.abs().max()
            assert err < 1e-5, err


@pytest.mark.parametrize("config", CONFIGS)
def test_gated_prediction_matches_the_program(config):
    cfg, port, rm = _pair(config)
    t = cfg["test_cfg"]
    g = torch.Generator().manual_seed(1)
    img = torch.randn(1, 128, 256, 3, generator=g)
    with torch.inference_mode():
        want = make_logits_fn(port, t, t["mode"])(port, img)[0]
    judge = check.Judge(rm, t, img, ref.Products(), gate_tolerance=0.0)
    assert 0 < len(judge.own) < len(judge.boxes)
    got = judge.logits(judge.own)
    assert (got - want).abs().max() / want.abs().max() < 1e-5
    assert float(judge.gaps(want.argmax(-1)).max()) == 0.0


def test_gaps_price_a_wrong_label():
    cfg, port, rm = _pair("dinov2_ms")
    img = torch.randn(1, 128, 256, 3,
                      generator=torch.Generator().manual_seed(2))
    judge = check.Judge(rm, cfg["test_cfg"], img, ref.Products(), 0.0)
    lg = judge.logits(judge.own)
    second = lg.topk(2, dim=-1).indices[..., 1]
    gaps = judge.gaps(second)
    top2 = lg.topk(2, dim=-1).values
    torch.testing.assert_close(gaps, top2[..., 0] - top2[..., 1])


def test_undecided_windows_take_either_side():
    """A window within the gate's tolerance may be refined or not: labels
    from either composition read no gap."""
    cfg, port, rm = _pair("eva02_ms")
    img = torch.randn(1, 128, 256, 3,
                      generator=torch.Generator().manual_seed(3))
    judge = check.Judge(rm, cfg["test_cfg"], img, ref.Products(), 1.0)
    assert len(judge.open) == len(judge.boxes)
    for chosen in ([], judge.own, list(range(len(judge.boxes)))):
        labels = judge.logits(chosen).argmax(-1)
        assert float(judge.gaps(labels).max()) == 0.0


def test_fp8_products_round():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 32, generator=g, requires_grad=True)
    b = torch.randn(32, 16, generator=g, requires_grad=True)
    q = ref._fp8(a)
    assert 0 < (q - a).abs().max() < 0.1 * a.abs().max()
    assert len(torch.unique(q)) < len(torch.unique(a))
    y = ref.Products(fp8=True).matmul(a, b)
    torch.testing.assert_close(y, ref._fp8(a) @ ref._fp8(b))
    y.sum().backward()
    ga = ref._fp8(torch.ones(64, 16), torch.float8_e5m2) @ ref._fp8(b).t()
    torch.testing.assert_close(a.grad, ga)
