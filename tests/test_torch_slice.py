"""The torch port's whole inference slice against the JAX package's.

The headline structure at toy width, and the same segmentor on a toy EVA02
backbone, run the dense gated two-stage slide inference
(``make_logits_fn(..., "ms_slide_inference")``) on both sides from the same
weights: a 128x256 image, stage 1 at 64x128, 64-pixel crops at stride 32
(21 windows). EVA02 takes the fused-rope eval route on both sides. The gate's threshold and conf are picked from the
JAX stage-1 output so that both gate outcomes occur, with margin on either
side. fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import jax_model_and_variables, port_model, toy_config
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.eval import slide as jax_slide
from vfmseg_tpu.eval.evaluator import _finish as jax_finish
from vfmseg_tpu.eval.evaluator import make_logits_fn as jax_make_logits_fn
from vfmseg_tpu.eval.evaluator import (
    make_shape_aware_predict_fn as jax_make_predict_fn,
)
from vfmseg_tpu.models.segmentors.ms_vfm import MsVFMSegmentor as JaxMsVFM
from vfmseg_tpu_torch.eval import slide
from vfmseg_tpu_torch.eval.evaluator import (
    make_logits_fn,
    make_shape_aware_predict_fn,
)
from vfmseg_tpu_torch.models.presets import eva02_config, headline_config
from vfmseg_tpu_torch.ops.resize import resize

IMG_HW = (128, 256)
GEOMETRY = dict(lr_img_size=(64, 128), crop_size=(64, 64), stride=(32, 32))


def _midpoint_gap(values, lo_q, hi_q):
    """Midpoint of the widest gap between sorted values in a quantile band,
    so that no value sits near the cut."""
    v = np.sort(np.unique(values))
    lo, hi = np.searchsorted(v, np.quantile(v, [lo_q, hi_q]))
    i = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[i] + v[i + 1]) / 2)


def _gate(stage1, test_cfg):
    """Per-window refine decisions from stage-1 logits at full size."""
    boxes = slide.compute_slide_grid(IMG_HW, test_cfg["crop_size"],
                                     test_cfg["stride"])
    ctx = slide.extract_crops(torch.from_numpy(np.array(stage1)), boxes,
                              test_cfg["crop_size"])
    return (slide.confident_mask(ctx, test_cfg["threshold"]).mean(dim=(1, 2))
            < test_cfg["conf"]).numpy()


def _slice_pair(family):
    cfg = toy_config(family=family)
    jmodel, variables = jax_model_and_variables(cfg, seed=1)
    model = port_model(cfg, variables)
    img = np.random.RandomState(5).standard_normal(
        (1,) + IMG_HW + (3,)).astype(np.float32)

    # JAX stage 1 at full size: pick the threshold between two max-softmax
    # values near the median, then conf between two window confidences
    lr = jax_slide.resize(jnp.asarray(img), size=GEOMETRY["lr_img_size"],
                          method="bilinear")
    stage1 = jax_slide.resize(
        jax.jit(lambda v, x: jmodel.apply(
            v, x, method=JaxMsVFM.lr_forward))(variables, lr),
        size=IMG_HW, method="bilinear")
    pmax = np.asarray(jax.nn.softmax(stage1, axis=-1).max(-1)).ravel()
    threshold = _midpoint_gap(pmax, 0.4, 0.6)
    boxes = jax_slide.compute_slide_grid(IMG_HW, GEOMETRY["crop_size"],
                                         GEOMETRY["stride"])
    conf_w = np.asarray(jnp.mean(jax_slide.confident_mask(
        jax_slide.extract_crops(stage1, boxes, GEOMETRY["crop_size"]),
        threshold), axis=(1, 2)))
    conf = _midpoint_gap(conf_w, 0.3, 0.7)
    test_cfg = dict(headline_config()["test_cfg"], threshold=threshold,
                    conf=conf, **GEOMETRY)
    jax_logits = jax.jit(jax_make_logits_fn(
        jmodel, test_cfg, "ms_slide_inference"))(variables, jnp.asarray(img))
    return dict(jmodel=jmodel, variables=variables, model=model, img=img,
                test_cfg=test_cfg,
                jax_stage1=np.asarray(stage1), jax_logits=jax_logits)


@pytest.fixture(scope="module")
def slice_pair():
    return _slice_pair("dinov2")


@pytest.fixture(scope="module")
def eva02_slice_pair():
    return _slice_pair("eva02")


def _check_gated_slide(s):
    test_cfg = s["test_cfg"]
    want = np.asarray(s["jax_logits"])
    with torch.inference_mode():
        got = make_logits_fn(s["model"], test_cfg, "ms_slide_inference")(
            s["model"], torch.from_numpy(s["img"])).numpy()
        ours_stage1 = resize(s["model"].lr_forward(resize(
            torch.from_numpy(s["img"]), size=test_cfg["lr_img_size"])),
            size=IMG_HW)

    gate_jax = _gate(s["jax_stage1"], test_cfg)
    gate_ours = _gate(ours_stage1.numpy(), test_cfg)
    assert 0 < gate_jax.sum() < gate_jax.size, "both gate outcomes occur"
    np.testing.assert_array_equal(gate_ours, gate_jax)
    assert got.shape == want.shape == (1,) + IMG_HW + (19,)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert agree >= 0.999, agree


def test_gated_slide_matches_jax(slice_pair):
    """Logits at atol 1e-3, argmax agreement >= 99.9%, gate decisions
    equal."""
    _check_gated_slide(slice_pair)


def test_gated_slide_matches_jax_eva02(eva02_slice_pair):
    """As the headline's, on the EVA02 backbone (the RoPE attention's CPU
    twin against JAX's rotation in XLA)."""
    _check_gated_slide(eva02_slice_pair)


def _check_predict(s):
    test_cfg = s["test_cfg"]
    out_hw = (96, 200)
    want = np.asarray(jax_finish(s["jax_logits"], out_hw))
    predict = make_shape_aware_predict_fn(s["model"], test_cfg)
    got = predict(s["model"], torch.from_numpy(s["img"]), out_hw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1,) + out_hw
    assert float((got.numpy() == want).mean()) >= 0.999


def test_predict_matches_jax(slice_pair):
    """The per-image entry point: predict(model, img, out_hw) -> labels at
    the label resolution, against JAX logits finished the same way."""
    _check_predict(slice_pair)


def test_predict_matches_jax_eva02(eva02_slice_pair):
    _check_predict(eva02_slice_pair)


def test_predict_pads_small_images_like_jax(slice_pair):
    """An image smaller than one crop is padded bottom-right with zeros,
    run, and cropped back before the label-size resize."""
    s = slice_pair
    img = s["img"][:, :48, :100]
    out_hw = (48, 100)
    want = np.asarray(jax_make_predict_fn(s["jmodel"], s["test_cfg"])(
        s["variables"], jnp.asarray(img), out_hw))
    got = make_shape_aware_predict_fn(s["model"], s["test_cfg"])(
        s["model"], torch.from_numpy(np.ascontiguousarray(img)), out_hw)
    assert tuple(got.shape) == (1,) + out_hw
    assert float((got.numpy() == want).mean()) >= 0.999


def test_headline_config_equals_jax_load_config():
    """The port's headline config, carried as data, equals what the JAX
    package loads from configs/, so the two cannot drift apart."""
    jcfg = load_config("dg_lora_dinov2_ms_masked")
    ours = headline_config()
    for key in ("model", "test_cfg", "compute", "crop_size", "num_classes",
                "preprocessor", "optimizer", "schedule", "peft"):
        assert ours[key] == jcfg[key], key
    assert ours["data"]["batch_size"] == jcfg["data"]["batch_size"]


def test_eva02_config_equals_jax_load_config():
    """dg_lora_eva02_ms_masked as data equals the JAX load_config, its
    backbone (EVA02-L with LoRA on the reference target names) included."""
    jcfg = load_config("dg_lora_eva02_ms_masked")
    ours = eva02_config()
    assert ours["name"] == jcfg["name"]
    for key in ("model", "test_cfg", "compute", "crop_size", "num_classes",
                "preprocessor", "optimizer", "schedule", "peft"):
        assert ours[key] == jcfg[key], key
    assert ours["data"]["batch_size"] == jcfg["data"]["batch_size"]
    assert ours["model"]["backbone"]["backbone"]["type"] == "EVA2"
