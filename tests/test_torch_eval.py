"""The port's evaluation path against the JAX package's, on the CPU: the
other MsVFM inference modes, TTA, shape bucketing, the compact stream, the
IoU metric, the test pipeline and dataset readers, the config data and
``--cfg-options``, and the eval CLI against tools/test.py on one checkpoint
and one PNG dataset. Toy widths, fp32; inputs from numpy seeds, the same
weights on both sides through ``state_dict_from_flax``.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import (
    _fill,
    jax_model_and_variables,
    port_model,
    toy_config,
)
from test_torch_slice import _midpoint_gap
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.data import datasets as jax_datasets
from vfmseg_tpu.data import transforms as jax_transforms
from vfmseg_tpu.eval import evaluator as jax_evaluator
from vfmseg_tpu.eval import metrics as jax_metrics
from vfmseg_tpu.eval.tta import tta_logits as jax_tta_logits
from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.models.segmentors.ms_vfm import MsVFMSegmentor as JaxMsVFM
from vfmseg_tpu.utils.visualization import colorize_label as jax_colorize
from vfmseg_tpu_torch.data import datasets, transforms
from vfmseg_tpu_torch.eval import evaluator, metrics
from vfmseg_tpu_torch.eval.compact import window_confidence
from vfmseg_tpu_torch.eval.slide import compute_slide_grid
from vfmseg_tpu_torch.eval.tta import tta_logits
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.tools import test as port_cli
from vfmseg_tpu_torch.train.checkpoint import load_npz_tree
from vfmseg_tpu_torch.utils.visualization import colorize_label

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(lr_img_size=(64, 128), crop_size=(64, 64), stride=(32, 32))
ATOL = 1e-4


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    cfg = toy_config()
    jmodel, variables = jax_model_and_variables(cfg, seed=3)
    return jmodel, variables, port_model(cfg, variables)


def _test_cfg(mode, **kw):
    return dict(presets.headline_config()["test_cfg"], mode=mode, **GEOMETRY,
                **kw)


# --------------------------------------------------------------- modes ----

@pytest.mark.parametrize("mode", ["lr_slide_inference", "hr_slide_inference",
                                  "msfull_slide_inference"])
def test_slide_modes_match_jax(pair, mode):
    jmodel, variables, model = pair
    img = _np(11, (1, 128, 256, 3))
    test_cfg = _test_cfg(mode)
    want = jax.jit(jax_evaluator.make_logits_fn(jmodel, test_cfg, mode))(
        variables, jnp.asarray(img))
    with torch.inference_mode():
        got = evaluator.make_logits_fn(model, test_cfg, mode)(
            model, torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (1, 128, 256, 19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_encode_decode_modes_raise_on_msvfm(pair, mode):
    """``whole`` and ``slide`` call ``encode_decode``, which MsVFM has in
    neither package."""
    _jmodel, _variables, model = pair
    assert not hasattr(JaxMsVFM, "encode_decode")
    with pytest.raises(NotImplementedError):
        evaluator.make_logits_fn(model, _test_cfg(mode), mode)


def test_tta_logits_match_jax(pair):
    """Flip and a 0.75 scale over the coarse path, softmax-averaged."""
    jmodel, variables, model = pair
    img = _np(12, (1, 128, 256, 3))
    want = jax_tta_logits(
        lambda v: jmodel.apply(variables, v, method=JaxMsVFM.lr_forward),
        jnp.asarray(img), flip=True, scales=(1.0, 0.75))
    with torch.inference_mode():
        got = tta_logits(model.lr_forward, torch.from_numpy(img), flip=True,
                         scales=(1.0, 0.75))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_tta_predict_matches_jax(pair):
    """``predict`` with ``tta`` over a slide mode: labels at the label size
    agree with the JAX predictor's on >= 99.9% of pixels."""
    jmodel, variables, model = pair
    img = _np(13, (1, 128, 256, 3))
    test_cfg = _test_cfg("hr_slide_inference", tta_scales=(1.0, 0.5))
    want = np.asarray(jax_evaluator.make_shape_aware_predict_fn(
        jmodel, test_cfg, tta=True)(variables, jnp.asarray(img), (100, 200)))
    got = evaluator.make_shape_aware_predict_fn(model, test_cfg, tta=True)(
        model, torch.from_numpy(img), (100, 200)).numpy()
    assert got.shape == want.shape == (1, 100, 200)
    assert float((got == want).mean()) >= 0.999


@pytest.mark.parametrize("gate", [None, "compact"])
def test_pad_multiple_matches_jax(pair, gate):
    """Shape bucketing: a 100x150 image pads to 144x192 (multiple 48), runs,
    and is cropped back, on the dense and the compact route."""
    jmodel, variables, model = pair
    img = _np(14, (1, 100, 150, 3))
    test_cfg = _test_cfg("ms_slide_inference", gate=gate)
    padded, valid = evaluator._pad_to_min(torch.from_numpy(img), (64, 64),
                                          multiple=48)
    jpadded, jvalid = jax_evaluator._pad_to_min(jnp.asarray(img), (64, 64),
                                                multiple=48)
    assert valid == jvalid == (100, 150)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    want = np.asarray(jax_evaluator.make_shape_aware_predict_fn(
        jmodel, test_cfg, pad_multiple=48)(variables, jnp.asarray(img),
                                           (100, 150)))
    got = evaluator.make_shape_aware_predict_fn(
        model, test_cfg, pad_multiple=48)(model, torch.from_numpy(img),
                                          (100, 150)).numpy()
    assert got.shape == want.shape == (1, 100, 150)
    assert float((got == want).mean()) >= 0.999


def test_stream_evaluate_two_shapes_matches_jax(pair):
    """The compact stream over images of two sizes, each with its own label
    size, consumed all at once: equal to the JAX stream fed the sizes in
    order. tools/test.py:167-169 feeds the JAX stream from the head of a
    queue that its consumer pops, so there the sizes are right only while
    the consumer pops once per prediction; the port carries each image's
    (valid size, label size) in the stream's own queue, which holds for any
    consumer (ROADMAP §C)."""
    jmodel, variables, model = pair
    shapes = [(128, 256), (128, 256), (96, 160), (96, 160), (128, 256)]
    images = [_np(30 + i, s + (3,)) for i, s in enumerate(shapes)]
    hws = [(64 + 8 * i, 100 + 4 * i) for i in range(len(images))]
    test_cfg = _test_cfg("ms_slide_inference", gate="compact")
    want = [np.asarray(p) for p in jax_evaluator.stream_evaluate(
        jmodel, variables, test_cfg, [jnp.asarray(im) for im in images],
        None, group=2, out_hw_iter=iter(hws))]
    got = list(evaluator.stream_evaluate(
        model, test_cfg, [(torch.from_numpy(im), hw)
                          for im, hw in zip(images, hws)], group=2))
    assert len(got) == len(want) == len(images)
    for g, w, hw in zip(got, want, hws):
        assert tuple(g.shape) == w.shape == hw
        assert float((g.numpy() == w).mean()) >= 0.999


# -------------------------------------------------------------- metrics ----

def _maps(seed, shape, n_cls=5):
    rs = np.random.RandomState(seed)
    pred = rs.randint(0, n_cls, shape).astype(np.int32)
    label = rs.randint(0, n_cls, shape).astype(np.int32)
    label[rs.rand(*shape) < 0.2] = 255
    pred[label == 2] = 2          # one class with real overlap
    return pred, label


def test_intersect_and_union_matches_jax():
    """int64 bincounts equal the JAX fp32 one-hot sums (exact here)."""
    pred, label = _maps(0, (37, 53))
    want = jax_metrics.intersect_and_union(jnp.asarray(pred),
                                           jnp.asarray(label), 5, 255)
    got = metrics.intersect_and_union(torch.from_numpy(pred),
                                      torch.from_numpy(label), 5, 255)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mean_used", [None, ["citys"]])
def test_iou_accumulator_matches_jax(mean_used):
    """Ignore 255, key grouping by path substring (an unmatched path goes
    to ``default``) and ``mean_used_keys``. With None the mean covers every
    key, which is what tools/test.py:91 asks for by passing every key: a
    citys->ACDC mean then includes the source key. The port's CLI keeps
    that for parity (ROADMAP §C, still open)."""
    kw = dict(num_classes=5, dataset_keys=["citys", "bdd"],
              mean_used_keys=mean_used)
    ours, theirs = metrics.IoUAccumulator(**kw), jax_metrics.IoUAccumulator(
        **kw)
    for i, path in enumerate(["data/citys/a.png", "data/bdd/b.png",
                              "data/citys/c.png", "elsewhere/d.png"]):
        pred, label = _maps(i + 1, (24, 40))
        ours.update(torch.from_numpy(pred), label, path)
        theirs.update(jnp.asarray(pred), label, path)
    ours.update(torch.zeros(4, 4, dtype=torch.int32), None, "data/citys")
    got, want = ours.compute(), theirs.compute()
    assert set(got) == {"citys_mIoU", "citys_aAcc", "bdd_mIoU", "bdd_aAcc",
                        "default_mIoU", "default_aAcc", "mean_mIoU"}
    assert got == want
    for key in ("citys", "bdd", "default"):
        assert json.dumps(ours.per_class_iou(key)) == json.dumps(
            theirs.per_class_iou(key))
    assert metrics.CITYSCAPES_CLASSES == jax_metrics.CITYSCAPES_CLASSES


# ------------------------------------------------------- data transforms ----

@pytest.mark.parametrize("wh", [(40, 30), (133, 75), (200, 150)])
def test_uint8_resizes_match_jax(wh):
    img = np.random.RandomState(1).randint(0, 256, (75, 133, 3), np.uint8)
    label = np.random.RandomState(2).randint(0, 20, (75, 133)).astype(
        np.uint8)
    np.testing.assert_array_equal(transforms.bilinear_resize_u8(img, wh),
                                  jax_transforms.bilinear_resize_u8(img, wh))
    np.testing.assert_array_equal(transforms.nearest_resize_u8(label, wh),
                                  jax_transforms.nearest_resize_u8(label, wh))


@pytest.mark.parametrize("keep_ratio", [True, False])
def test_test_pipeline_matches_jax(keep_ratio):
    img = np.random.RandomState(3).randint(0, 256, (75, 133, 3), np.uint8)
    label = np.random.RandomState(4).randint(0, 19, (75, 133)).astype(
        np.uint8)
    for lab in (label, None):
        got = transforms.TestPipeline((128, 96), keep_ratio)(img, lab)
        want = jax_transforms.TestPipeline((128, 96), keep_ratio)(img, lab)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert got["img"].shape == ((72, 128, 3) if keep_ratio else (96, 128, 3))


def _write_png_set(root, shapes, seed=0):
    """A GTA-layout set: images/<i>.png and labels/<i>_labelTrainIds.png
    (blocky colours; classes 0-18 with some 255)."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        coarse = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
        img = np.clip(img + rs.randint(-12, 13, img.shape), 0, 255)
        lab = np.repeat(np.repeat(rs.randint(0, 19, (h // 16 + 1,
                                                     w // 16 + 1)), 16, 0),
                        16, 1)[:h, :w]
        lab[rs.rand(h, w) < 0.05] = 255
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, "images", f"f{i}.png"))
        Image.fromarray(lab.astype(np.uint8)).save(
            os.path.join(root, "labels", f"f{i}_labelTrainIds.png"))


def test_datasets_match_jax(tmp_path):
    """The GTA reader over PNGs, and the Cityscapes reader's suffixes, read
    what the JAX readers read."""
    _write_png_set(str(tmp_path / "gta"), [(40, 56), (24, 32)])
    got = datasets.build_dataset({"type": "GTADataset",
                                  "data_root": str(tmp_path / "gta")})
    want = jax_datasets.gta_dataset(str(tmp_path / "gta"))
    assert len(got) == len(want) == 2
    for i in range(2):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    city = tmp_path / "city"
    (city / "leftImg8bit/val/x").mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        city / "leftImg8bit/val/x/a_leftImg8bit.png")
    ours = datasets.cityscapes_dataset(str(city), "leftImg8bit/val",
                                       "gtFine/val")
    theirs = jax_datasets.cityscapes_dataset(str(city), "leftImg8bit/val",
                                             "gtFine/val")
    assert ours.samples == theirs.samples and "label" not in ours[0]
    # every type of the JAX registry, the DG and UDA wrappers included
    from vfmseg_tpu.core.registry import DATASETS as JAX_DATASETS

    assert set(datasets.DATASETS) == set(JAX_DATASETS._registry)


def test_colorize_label_matches_jax():
    label = np.random.RandomState(5).randint(0, 19, (9, 11))
    label[0, 0] = 255
    np.testing.assert_array_equal(colorize_label(label), jax_colorize(label))


# --------------------------------------------------- configs and options ----

@pytest.mark.parametrize("name", ["dg_lora_dinov2_ms_masked",
                                  "dg_lora_eva02_ms_masked",
                                  "dg_lora_sam_ms_masked"])
def test_test_sets_equal_jax_load_config(name):
    jcfg = load_config(name)
    ours = presets.config(name)
    for key in ("val", "test", "test_resize_wh"):
        assert ours["data"][key] == jcfg["data"][key], key
    assert jcfg.get_path("data.test_keep_ratio") is None
    assert "test_keep_ratio" not in ours["data"]


def test_smoke_config_equals_jax_load_config():
    jcfg = load_config("smoke_tiny_ms_masked")
    ours = presets.config("smoke_tiny_ms_masked")
    for key in ("name", "model", "test_cfg", "compute", "crop_size",
                "num_classes"):
        assert ours[key] == jcfg[key], key
    for key in ("test", "test_resize_wh"):
        assert ours["data"][key] == jcfg["data"][key], key


def test_cfg_options_match_jax():
    overrides = ["test_cfg.gate=compact", "test_cfg.threshold=0.5",
                 "data.eval_pad_multiple=64", "new.key.path=hello",
                 "data.test=[{'type': 'GTADataset', 'data_root': 'x'}]",
                 "test_cfg.stride=(16, 16)"]
    jcfg = load_config("smoke_tiny_ms_masked", overrides)
    ours = presets.config("smoke_tiny_ms_masked", overrides)
    for path in ("test_cfg", "data.eval_pad_multiple", "new.key.path",
                 "data.test", "data.test_resize_wh"):
        assert ours.get_path(path) == jcfg.get_path(path), path
    with pytest.raises(ValueError):
        presets.config("smoke_tiny_ms_masked", ["no_equals_sign"])


# ------------------------------------------------------------------ CLI ----

def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """smoke_tiny_ms_masked with seeded weights: heads and LoRA in a
    trainable npz (``t/...``), the rest of the backbone in a converted
    backbone npz; a 3-image PNG set of two sizes; a gate threshold and conf
    picked from the port's stage 1 so that both outcomes occur."""
    root = tmp_path_factory.mktemp("cli")
    jcfg = load_config("smoke_tiny_ms_masked")
    jmodel = jax_build_segmentor(jcfg.model, dtype=jnp.float32,
                                 attn_impl="xla")
    shapes = jax.eval_shape(lambda: jmodel.init(
        {n: jax.random.PRNGKey(i) for i, n in
         enumerate(("params", "crop", "mask", "dropout"))},
        jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 128, 128), jnp.int32)))
    params = _fill(dict(shapes["params"]), np.random.RandomState(7))
    flat = _flat(params, "")
    trainable = {f"t/{k}": v for k, v in flat.items()
                 if not k.startswith("backbone/") or "lora" in k}
    backbone = {k[len("backbone/"):]: v for k, v in flat.items()
                if k.startswith("backbone/") and "lora" not in k}
    ckpt = str(root / "iter_0000010.trainable.npz")
    bb = str(root / "backbone.npz")
    np.savez(ckpt, **trainable)
    np.savez(bb, **backbone)
    data = str(root / "synth")
    _write_png_set(data, [(96, 160), (96, 160), (128, 128)], seed=3)

    model = build_segmentor(presets.config("smoke_tiny_ms_masked")["model"],
                            device="cpu")
    port_cli.load_weights(model, ckpt, bb)
    test_cfg = presets.config("smoke_tiny_ms_masked")["test_cfg"]
    engine = evaluator.make_compact_ms_slide(model, test_cfg)
    pipe = transforms.TestPipeline((128, 128), True)
    fulls, confs = [], []
    for item in datasets.gta_dataset(data):
        img = torch.from_numpy(pipe(item["img"], None)["img"])[None]
        with torch.inference_mode():
            full, _ = engine._stage1_impl(model, img, tuple(img.shape[1:3]))
        fulls.append(full)
    pmax = np.concatenate([torch.softmax(f, -1).amax(-1).numpy().ravel()
                           for f in fulls])
    threshold = _midpoint_gap(pmax, 0.4, 0.6)
    for f in fulls:
        boxes = compute_slide_grid(tuple(f.shape[1:3]), (64, 64), (32, 32))
        confs.append(window_confidence(f, boxes, (64, 64), threshold).numpy())
    conf = _midpoint_gap(np.concatenate(confs), 0.3, 0.7)
    options = [f"data.test=[{{'type': 'GTADataset', 'data_root': {data!r}, "
               f"'key': 'synth'}}]", f"test_cfg.threshold={threshold!r}",
               f"test_cfg.conf={conf!r}"]
    return dict(root=root, ckpt=ckpt, backbone=bb, options=options,
                model=model, threshold=threshold, conf=conf)


@pytest.mark.parametrize("gate", ["dense", "compact"])
def test_cli_matches_jax_cli(cli_setup, gate, monkeypatch):
    """``python -m vfmseg_tpu_torch.tools.test`` and tools/test.py on one
    checkpoint and one 3-image PNG set (two sizes, so the compact stream
    flushes a group): the same metrics JSON, through the per-image
    predictor and through the compact stream."""
    s = cli_setup
    options = list(s["options"])
    if gate == "compact":
        options.append("test_cfg.gate=compact")
    common = ["smoke_tiny_ms_masked", s["ckpt"], "--backbone", s["backbone"],
              "--cfg-options", *options]
    jax_out = str(s["root"] / f"jax_{gate}.json")
    monkeypatch.setattr(sys, "argv", ["tools/test.py", *common, "--out",
                                      jax_out])
    runpy.run_path(os.path.join(REPO, "tools", "test.py"),
                   run_name="__main__")
    port_out = str(s["root"] / f"port_{gate}.json")
    show = s["root"] / f"show_{gate}"
    got = port_cli.main([*common, "--out", port_out, "--device", "cpu",
                         "--show-dir", str(show)])
    with open(jax_out) as f:
        want = json.load(f)
    with open(port_out) as f:
        assert json.load(f) == got
    assert got == want
    assert set(got) == {"synth_mIoU", "synth_aAcc", "mean_mIoU"}
    assert sorted(os.listdir(show / "synth")) == ["f0.png", "f1.png",
                                                  "f2.png"]


def test_cli_gate_is_mixed(cli_setup):
    """The CLI runs above exercise both gate outcomes: the compact engine
    refines some but not all windows of the set."""
    s = cli_setup
    test_cfg = dict(presets.config("smoke_tiny_ms_masked")["test_cfg"],
                    threshold=s["threshold"], conf=s["conf"],
                    gate="compact")
    engine = evaluator.make_compact_ms_slide(s["model"], test_cfg)
    pipe = transforms.TestPipeline((128, 128), True)
    items = [(torch.from_numpy(pipe(it["img"], None)["img"]), (8, 8))
             for it in datasets.gta_dataset(str(s["root"] / "synth"))]
    list(evaluator.stream_evaluate(s["model"], test_cfg, items,
                                   engine=engine))
    assert 0 < engine.stat_refined < engine.stat_windows


def test_cli_loads_batch_stats_beside_the_checkpoint(cli_setup, tmp_path):
    """A divergence from tools/test.py, which never reads the BatchNorm
    statistics saved beside the trainable file and so evaluates with zero
    running statistics: the port's CLI loads ``iter_N.batch_stats.npz``
    when it is there (ROADMAP §C)."""
    s = cli_setup
    model = s["model"]
    name = "decode_head.up_bn.running_var"
    bn = dict(model.named_buffers())[name]
    ckpt = str(tmp_path / "iter_0000001.trainable.npz")
    np.savez(ckpt, **dict(np.load(s["ckpt"])))
    port_cli.load_weights(model, ckpt, s["backbone"])
    assert float(bn.abs().sum()) == 0.0          # zero, as in the JAX CLI
    var = np.linspace(0.5, 1.5, bn.numel()).astype(np.float32)
    np.savez(str(tmp_path / "iter_0000001.batch_stats.npz"),
             **{"b/decode_head/up_bn/var": var,
                "b/decode_head/up_bn/mean": np.zeros_like(var)})
    port_cli.load_weights(model, ckpt, s["backbone"])
    np.testing.assert_array_equal(bn.numpy(), var)
    assert load_npz_tree(s["backbone"])["blocks_0"]["attn"]["qkv"][
        "kernel"].shape == (32, 96)
    port_cli.load_weights(model, s["ckpt"], s["backbone"])
