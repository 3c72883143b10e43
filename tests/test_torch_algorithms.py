"""The torch port's strong augmentations and DomainGeneral against the JAX
package's, on the CPU.

The augmentations' random numbers are fed to both sides (``fed_augment``):
``jax.random.uniform`` as vfmseg_tpu/models/algorithms/augment.py calls it
and the port's ``rng.uniform`` on its ``augment`` stream return the same
raw U[0, 1) draws in the same order, each mapped to its [minval, maxval)
as jax.random.uniform maps it. Covered, fp32: the HSV conversions both
ways, the colour jitter, the blur at the 23-tap cap and at a small size,
the strong transform with each coin either way, at atol 1e-5; ClassMix's
masks, ``one_mix``, ``block_mask`` (Python's rounding of the grid) and the
nearest resize under it, exactly; the DomainGeneral wrapper's training
forward through each package's make_train_step on ``smoke_tiny_dg_maskloss``
and ``smoke_tiny_dg_msvfm`` (losses rtol 1e-4, accuracies within 2 pixels,
every trainable gradient within 2e-4 of the largest, BatchNorm statistics
atol 1e-5); the wrapper's dense and compact predictions equal to its inner
model's; its builder's keys; the eval CLI on a wrapped config.
"""

import contextlib
import os
import runpy
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_clip import _deterministic
from test_torch_models import _fill
from vfmseg_tpu.core.config import load_config as jax_load_config
from vfmseg_tpu.models.algorithms import augment as jaug
from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.ops.resize import resize as jax_resize
from vfmseg_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
    partition_params,
    trainable_predicate as jax_trainable_predicate,
)
from vfmseg_tpu_torch.core.config import load_config
from vfmseg_tpu_torch.eval.evaluator import (
    make_logits_fn,
    make_shape_aware_predict_fn,
    unwrap_model,
)
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.algorithms import augment
from vfmseg_tpu_torch.models.algorithms.dg import DomainGeneral
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.tools import test as test_cli
from vfmseg_tpu_torch.train.checkpoint import save_pytree
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    init_params,
    state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
ATOL = 1e-5


@contextlib.contextmanager
def fed_augment(values, side, repeat=1, drawn_all=True):
    """Patch ``side``'s augment draws ("jax": ``jax.random.uniform`` as the
    JAX augment module calls it; "torch": ``rng.uniform`` on the
    ``augment`` stream) to return ``values`` in turn, ``repeat`` times over
    (a jitted JAX step traces its draws once; the port draws every step),
    each checked against the shape asked for; with ``drawn_all``, every
    value must be drawn. Other callers and streams draw as usual."""
    vals = list(values) * repeat
    real_jax, real_torch = jax.random.uniform, rng.uniform

    def jax_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                    maxval=1.0):
        if sys._getframe(1).f_globals["__name__"] != jaug.__name__:
            return real_jax(key, shape, dtype, minval, maxval)
        v = vals.pop(0)
        assert v.shape == tuple(shape)
        lo, hi = jnp.float32(minval), jnp.float32(maxval)
        return jnp.maximum(lo, jnp.asarray(v) * (hi - lo) + lo)

    def torch_uniform(name, shape, device):
        if name != "augment":
            return real_torch(name, shape, device)
        v = vals.pop(0)
        assert v.shape == tuple(shape)
        return torch.from_numpy(v).to(device)

    patch = (mock.patch("jax.random.uniform", jax_uniform) if side == "jax"
             else mock.patch.object(rng, "uniform", torch_uniform))
    with patch:
        yield
    assert not (drawn_all and vals), "draws left over"


def scalars(*us):
    """Raw scalar draws."""
    return [np.array(u, np.float32) for u in us]


def _np(seed, shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=0, err_msg=msg)


def _rgb01(seed, shape=(2, 9, 11, 3)):
    """[0, 1] images with grey pixels, equal channel pairs and saturated
    values among them (the HSV branches)."""
    x = np.round(_np(seed, shape, 0.0, 1.0) * 8) / 8
    x[0, 0] = 0.5                     # grey
    x[0, 1, :, 1] = x[0, 1, :, 0]     # r == g
    x[0, 2, :, 2] = x[0, 2, :, 1]     # g == b
    x[1, 0] = 0.0                     # black
    x[1, 1] = 1.0                     # white
    return x.astype(np.float32)


# ---------------------------------------------------------- augment ----

def test_rgb_to_hsv_matches_jax():
    x = _rgb01(0)
    want = jaug._rgb_to_hsv(jnp.asarray(x))
    got = augment._rgb_to_hsv(torch.from_numpy(x))
    for g, w, name in zip(got, want, "hsv"):
        _close(g, w, msg=name)


def test_hsv_to_rgb_matches_jax():
    h = _np(1, (2, 9, 11), 0.0, 1.0)
    h[0, 0] = 0.0
    h[0, 1] = 5.0 / 6.0
    s, v = _np(2, (2, 9, 11), 0.0, 1.0), _np(3, (2, 9, 11), 0.0, 1.0)
    want = jaug._hsv_to_rgb(*map(jnp.asarray, (h, s, v)))
    got = augment._hsv_to_rgb(*map(torch.from_numpy, (h, s, v)))
    _close(got, want)


def test_color_jitter_matches_jax():
    """The four factors (brightness, contrast, saturation, hue) from the
    fed draws; the contrast's grey is the mean over H, W and C."""
    x = _rgb01(4, (2, 16, 20, 3))
    draws = scalars(0.9, 0.1, 0.7, 0.05)
    with fed_augment(draws, "jax"):
        want = jaug.color_jitter(jax.random.PRNGKey(0), jnp.asarray(x), 0.25)
    with fed_augment(draws, "torch"), rng.streams({}):
        got = augment.color_jitter(torch.from_numpy(x), 0.25)
    _close(got, want)


@pytest.mark.parametrize("hw,taps", [((20, 56), (3, 5)),
                                     ((256, 240), (23, 23))])
def test_gaussian_blur_matches_jax(hw, taps):
    """A small image (3 and 5 taps) and one at the 23-tap cap; zero
    padding at the borders."""
    assert tuple(map(augment.blur_kernel_size, hw)) == taps
    x = _np(5, (2,) + hw + (3,))
    draws = scalars(0.6)
    with fed_augment(draws, "jax"):
        want = jaug.gaussian_blur(jax.random.PRNGKey(0), jnp.asarray(x))
    with fed_augment(draws, "torch"), rng.streams({}):
        got = augment.gaussian_blur(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("coins,blur_prob", [
    ((0.9, 0.9), 1.0), ((0.1, 0.9), 1.0), ((0.9, 0.2), 1.0),
    ((0.5, None), 0.0)])
def test_strong_transform_matches_jax(coins, blur_prob):
    """Jitter when its coin is above p = 0.2, blur when its coin is above
    0.5 and blur is on; with blur off neither the blur coin nor sigma is
    drawn. Normalised images of 48 x 64."""
    x = (_np(6, (2, 48, 64, 3), 0.0, 255.0) - np.float32(MEAN)) / np.float32(
        STD)
    jit_coin, blur_coin = coins
    draws = scalars(jit_coin, 0.8, 0.3, 0.6, 0.9)
    if blur_prob:
        draws += scalars(blur_coin, 0.4)
    mean, std = np.float32(MEAN), np.float32(STD)
    with fed_augment(draws, "jax"):
        want = jaug.strong_transform(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mean),
            jnp.asarray(std), 0.25, 0.2, blur_prob)
    with fed_augment(draws, "torch"), rng.streams({}):
        got = augment.strong_transform(
            torch.from_numpy(x), torch.from_numpy(mean),
            torch.from_numpy(std), 0.25, 0.2, blur_prob)
    _close(got, want, atol=1e-4 * float(np.abs(np.asarray(want)).max()))


def _labels(seed, shape=(3, 24, 32), classes=19):
    rs = np.random.RandomState(seed)
    lab = rs.randint(0, 6, shape).astype(np.int32) * 3   # 6 of 19 present
    lab[0, :4] = 255
    lab[1, :, :5] = 1
    lab[2] = 255                       # nothing present
    lab[2, :2, :2] = 4
    return lab


def test_class_mix_masks_equal_jax():
    """ceil(n/2) of each sample's n present classes, by the lowest of the
    fed scores; ignored pixels never picked."""
    lab = _labels(7)
    scores = [_np(8, (3, 19), 0.0, 1.0)]
    with fed_augment(scores, "jax"):
        want = np.asarray(jaug.class_mix_masks(jax.random.PRNGKey(0),
                                               jnp.asarray(lab), 19))
    with fed_augment(scores, "torch"), rng.streams({}):
        got = augment.class_mix_masks(torch.from_numpy(lab), 19).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        present = set(np.unique(lab[i])) - {255}
        picked = set(np.unique(lab[i][got[i] > 0.5]))
        assert len(picked) == (len(present) + 1) // 2
        assert not got[i][lab[i] == 255].any()


def test_one_mix_equal_jax():
    mask = (_np(9, (2, 8, 8), 0.0, 1.0) > 0.5).astype(np.float32)
    a, b = _np(10, (2, 8, 8, 3)), _np(11, (2, 8, 8, 3))
    want = jaug.one_mix(*map(jnp.asarray, (mask, a, b)))
    got = augment.one_mix(*map(torch.from_numpy, (mask, a, b)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        augment.one_mix(torch.from_numpy(mask), torch.from_numpy(a[..., 0]),
                        torch.from_numpy(b[..., 0])).numpy(),
        np.asarray(want)[..., 0])


@pytest.mark.parametrize("hw,block,grid", [((96, 160), 64, (2, 2)),
                                           ((128, 112), 16, (8, 7)),
                                           ((40, 30), 64, (1, 1))])
def test_block_mask_equal_jax(hw, block, grid):
    """The keep grid's size by Python's round (96/64 = 1.5 and 160/64 =
    2.5 both give 2; at least 1), each cell kept where its draw is above
    0.7, nearest-resized to the image."""
    x = _np(12, (2,) + hw + (3,))
    keep = [_np(13, (2,) + grid + (1,), 0.0, 1.0)]
    with fed_augment(keep, "jax"):
        want = jaug.block_mask(jax.random.PRNGKey(0), jnp.asarray(x), 0.7,
                               block)
    with fed_augment(keep, "torch"), rng.streams({}):
        got = augment.block_mask(torch.from_numpy(x), 0.7, block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src,dst", [((3, 5), (10, 7)), ((7, 9), (5, 4)),
                                     ((2, 2), (128, 96))])
def test_nearest_resize_equal_jax(src, dst):
    """``method="nearest"``: src = floor(dst * in / out), up and down."""
    x = _np(14, (2,) + src + (3,))
    want = jax_resize(jnp.asarray(x), size=dst, method="nearest")
    got = resize(torch.from_numpy(x), size=dst, method="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------- DomainGeneral ----

def dg_configs(name):
    """Both packages' config with the inner model's dropout (its decode
    head's default 0.1 too), drop-path and mask ratio at 0 (DomainGeneral's
    own mask_ratio stays)."""
    jcfg, cfg = jax_load_config(name), load_config(name)
    for c in (jcfg, cfg):
        _deterministic(c["model"]["model_cfg"])
        c["model"]["model_cfg"]["decode_head"]["dropout_ratio"] = 0.0
    return jcfg, cfg


def pair(jcfg, cfg, seed, hw, rng_names):
    """The JAX segmentor with seeded variables of its training init (every
    ``rng_names`` stream given) and the port's loaded from them."""
    jmodel = jax_build_segmentor(jcfg["model"], dtype=jnp.float32,
                                 attn_impl=jcfg["compute"]["attn_impl"])
    img = jnp.zeros((1,) + hw + (3,), jnp.float32)
    lab = jnp.zeros((1,) + hw, jnp.int32)
    rngs = {n: jax.random.PRNGKey(i)
            for i, n in enumerate(("params",) + tuple(rng_names))}
    tree = jax.eval_shape(lambda: jmodel.init(rngs, img, lab))
    variables = {col: _fill(dict(tree[col]), np.random.RandomState(seed))
                 for col in ("params", "batch_stats") if col in tree}
    variables.setdefault("batch_stats", {})
    model = build_segmentor(cfg["model"], device="cpu",
                            attn_impl=cfg["compute"]["attn_impl"])
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    return jmodel, variables, model


def grad_capture():
    """An optax transformation that passes the gradients on and keeps the
    last ones in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def jax_state(jcfg, variables, lr):
    peft = jcfg.get("peft", {})
    trainable, frozen = partition_params(
        variables["params"], jax_trainable_predicate(
            peft=peft.get("enabled", True),
            adapter_keywords=tuple(peft.get("adapter_keywords", ()))))
    tx = optax.chain(grad_capture(),
                     jax_make_optimizer(trainable, base_lr=lr, max_steps=100))
    return tx, JaxTrainState(step=jnp.zeros((), jnp.int32),
                             trainable=trainable, frozen=frozen,
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(trainable))


def check_metrics(metrics, jmetrics, pixels):
    assert sorted(metrics) == sorted(jmetrics)
    for key, want in jmetrics.items():
        if "acc" in key:
            np.testing.assert_allclose(float(metrics[key]), float(want),
                                       atol=2 * 100.0 / pixels, err_msg=key)
        else:
            np.testing.assert_allclose(float(metrics[key]), float(want),
                                       rtol=1e-4, err_msg=key)


def check_grads(model, jgrads, variables_after=None):
    """Every trainable gradient within 2e-4 of the largest; the BatchNorm
    statistics atol 1e-5."""
    want_g = {k: v.numpy() for k, v in
              state_dict_from_flax({"params": jgrads}, model).items()}
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    assert scale > 0
    assert {n for n, p in model.named_parameters()
            if p.requires_grad} == want_g.keys()
    for name, p in model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), want_g[name],
                                       atol=2e-4 * scale, rtol=0,
                                       err_msg=name)
    if variables_after:
        own = model.state_dict()
        for name, want in state_dict_from_flax(
                {"batch_stats": variables_after}, model).items():
            if "running" in name:
                np.testing.assert_allclose(own[name].numpy(), want.numpy(),
                                           atol=1e-5, rtol=0, err_msg=name)


def dg_batch(seed, hw=(128, 128)):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (2,) + hw).astype(np.int32)
    label[:, :, :6] = 255
    return {"img": rs.standard_normal((2,) + hw + (3,)).astype(np.float32),
            "label": label}


@pytest.mark.parametrize("name,grid,crops", [
    ("smoke_tiny_dg_maskloss", (2, 2), []),
    ("smoke_tiny_dg_msvfm", (8, 8), [1, 0, 0, 1])])
def test_dg_train_step_matches_jax(name, grid, crops):
    """One step of each package's make_train_step on the wrapped config:
    the inner losses and the ``mask.*`` losses (scaled by the first
    call's accuracy / 100 x lamda_mask), grad_norm, every trainable
    gradient and the BatchNorm statistics. The jitter, blur and block-mask
    draws are fed to both (jitter and blur on), and with MsVFM the two
    inner calls' crop origins."""
    jcfg, cfg = dg_configs(name)
    batch = dg_batch(15)
    jmodel, variables, model = pair(
        jcfg, cfg, 16, (128, 128), ("crop", "mask", "dropout", "augment"))
    assert isinstance(model, DomainGeneral)
    draws = scalars(0.9, 0.8, 0.3, 0.6, 0.9, 0.7, 0.4) + [
        _np(17, (2,) + grid + (1,), 0.0, 1.0)]
    lr = 1e-3
    tx, jstate = jax_state(jcfg, variables, lr)
    jcrops = list(crops)
    with fed_augment(draws, "jax"), mock.patch(
            "jax.random.randint",
            lambda *a, **k: jnp.asarray(jcrops.pop(0), jnp.int32)):
        new_jstate, jmetrics = jax_make_train_step(jmodel, tx, donate=False)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
    assert not jcrops

    cfg["optimizer"]["lr"] = lr
    state = create_train_state(model, cfg, max_iters=100)
    with fed_augment(draws, "torch"), mock.patch.object(
            rng, "randint", side_effect=list(crops)):
        state, metrics = make_train_step()(state, batch, 0)
    assert any(k.startswith("mask.") and "loss" in k for k in metrics)
    check_metrics(metrics, jmetrics, batch["label"].size)
    check_grads(model, new_jstate.opt_state[0], new_jstate.batch_stats)


@pytest.mark.parametrize("gate", ["dense", "compact"])
def test_dg_predictions_equal_inner_model(gate):
    """``smoke_tiny_dg_msvfm``'s gated slide (ms_slide_inference) through
    the wrapper and through ``unwrap_model``'s inner segmentor: the
    logits and the labels equal, on the dense and the compact engine."""
    cfg = load_config("smoke_tiny_dg_msvfm")
    test_cfg = dict(cfg["test_cfg"])
    if gate == "compact":
        test_cfg["gate"] = "compact"
    dg = init_params(build_segmentor(cfg["model"], device="cpu"), 3)
    inner = unwrap_model(dg)
    assert inner is dg.model and unwrap_model(inner) is inner
    img = torch.from_numpy(_np(18, (1, 96, 128, 3)))
    labels = [make_shape_aware_predict_fn(m, test_cfg)(m, img, (96, 128))
              for m in (dg, inner)]
    assert torch.equal(labels[0], labels[1])
    if gate == "dense":
        with torch.no_grad():
            logits = [make_logits_fn(m, test_cfg, test_cfg["mode"])(m, img)
                      for m in (dg, inner)]
        assert torch.equal(logits[0], logits[1])


def test_dg_builder_takes_its_seven_keys():
    """The seven keys the JAX builder passes on reach the wrapper; any
    other raises ``TypeError``; the inner model takes the dtype."""
    cfg = load_config("smoke_tiny_dg_msvfm")
    model_cfg = dict(cfg["model"], mask_ratio=0.5, lamda_mask=0.25,
                     blur=False)
    dg = build_segmentor(model_cfg, dtype=torch.bfloat16, device="cpu")
    assert (dg.mask_ratio, dg.lamda_mask, dg.blur,
            dg.mask_block_size) == (0.5, 0.25, False, 16)
    assert dg.model.decode_head.conv_seg.dtype == torch.bfloat16
    with pytest.raises(TypeError):
        build_segmentor(dict(model_cfg, mean=(0, 0, 0)), device="cpu")


def test_eval_cli_evaluates_a_wrapped_config(tmp_path):
    """The eval CLI on ``smoke_tiny_dg_maskloss``: the inner segmentor
    (``unwrap_model``), loaded from a checkpoint saved from the wrapper
    (paths under ``t/model/``), gives the inner model's predictions."""
    root = str(tmp_path / "synth")
    argv = sys.argv
    try:
        sys.argv = ["make_synthetic_dataset.py", root, "--n", "2", "--size",
                    "64"]
        runpy.run_path(os.path.join(REPO, "tools",
                                    "make_synthetic_dataset.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    name = "smoke_tiny_dg_maskloss"
    dg = init_params(build_segmentor(load_config(name)["model"],
                                     device="cpu"), 4)
    tree = flax_from_state_dict(dg.state_dict(), dg)
    assert set(tree["params"]) == {"model"}
    ckpt = str(tmp_path / "iter_0000001.trainable.npz")
    save_pytree(ckpt, {"t": tree["params"]})
    if tree["batch_stats"]:
        save_pytree(ckpt.replace("trainable", "batch_stats"),
                    {"b": tree["batch_stats"]})
    data = [{"type": "GTADataset", "data_root": root, "key": "synth"}]
    built = []
    real = test_cli.build_segmentor

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    with mock.patch.object(test_cli, "build_segmentor", spy), \
            mock.patch.object(test_cli, "evaluate_dataset",
                              wraps=test_cli.evaluate_dataset) as ev:
        results = test_cli.main([name, ckpt, "--device", "cpu",
                                 "--cfg-options", f"data.test={data}",
                                 "data.test_resize_wh=(64, 64)"])
    assert isinstance(built[0], DomainGeneral)
    evaluated = ev.call_args.args[0]
    assert evaluated is built[0].model
    own = dict(dg.model.state_dict())
    for k, v in evaluated.state_dict().items():
        if "running" in k or k in dict(dg.model.named_parameters()):
            assert torch.equal(v, own[k]), k
    assert np.isfinite(results["synth_mIoU"])
