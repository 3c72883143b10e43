"""The train CLI's debug grids (``vfmseg_tpu_torch/tools/train.py``
``debug_panels`` / ``make_debug_fn``, ``utils/visualization.py``) against
the JAX CLI's.

The JAX ``debug_fn`` is a closure inside tools/train.py's ``main``, so its
panels are rebuilt here from the calls it makes (tools/train.py:267-310):
``MsVFMSegmentor.lr_forward`` / ``hr_forward`` for the headline,
``encode_decode`` for any other segmentor, and ``make_dacs_debug_fn``
under DACS. Argmax panels agree on at least 99.9% of their pixels, float
panels within 1e-4, the image and labels exactly.
"""

import builtins
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_algorithms import fed_augment, jax_state, pair
from test_torch_models import jax_model_and_variables, port_model, toy_config
from test_torch_uda import (
    HW,
    LR,
    _configs,
    calibrated_threshold,
    step_draws,
    uda_batch,
)
from vfmseg_tpu.models.segmentors.ms_vfm import MsVFMSegmentor as JaxMsVFM
from vfmseg_tpu.train.optim import merge_params
from vfmseg_tpu.train.uda import DACSConfig as JaxDACSConfig
from vfmseg_tpu.train.uda import make_dacs_debug_fn as jax_debug_fn
from vfmseg_tpu.utils import visualization as jax_vis
from vfmseg_tpu_torch.models.presets import config
from vfmseg_tpu_torch.tools import train as train_cli
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.uda import DACSConfig, init_ema, make_dacs_debug_fn
from vfmseg_tpu_torch.utils import visualization

ARGMAX_AGREE = 0.999
FLOAT_ATOL = 1e-4


def _entropy(logits):
    """The JAX CLI's ``_entropy`` (tools/train.py:259-262)."""
    p = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.sum(p * jnp.log(p + 1e-12), axis=-1) / jnp.log(
        jnp.float32(p.shape[-1]))


def _check(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, k
        if k in ("image", "gt", "target"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif np.issubdtype(w.dtype, np.integer):
            assert float((g == w).mean()) >= ARGMAX_AGREE, k
        else:
            np.testing.assert_allclose(g, w, atol=FLOAT_ATOL, rtol=0,
                                       err_msg=k)


def _batch(seed, n=2, hw=(128, 128)):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (n,) + hw).astype(np.int32)
    label[:, :, :9] = 255
    return {"img": rs.standard_normal((n,) + hw + (3,)).astype(np.float32),
            "label": label}


def test_msvfm_panels_match_jax():
    """The toy headline: image, labels, the LR prediction and its entropy,
    and the centre crop refined with the LR logits of the crop as
    context."""
    cfg = toy_config()
    jmodel, variables = jax_model_and_variables(cfg, seed=11)
    batch = _batch(12)
    img = jnp.asarray(batch["img"][:1])
    lr_logits = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxMsVFM.lr_forward))(variables, img)
    ch, cw = jmodel.hr_crop_size
    y0, x0 = (img.shape[1] - ch) // 2, (img.shape[2] - cw) // 2
    hr_logits = jax.jit(lambda v, x, c: jmodel.apply(
        v, x, c, False, False, method=JaxMsVFM.hr_forward))(
        variables, img[:, y0:y0 + ch, x0:x0 + cw],
        lr_logits[:, y0:y0 + ch, x0:x0 + cw])
    want = {"image": jax_vis.denormalize_image(batch["img"][0]),
            "gt": batch["label"][0],
            "lr_pred": np.asarray(jnp.argmax(lr_logits, -1))[0],
            "lr_entropy": np.asarray(_entropy(lr_logits))[0],
            "hr_refined": np.asarray(jnp.argmax(hr_logits, -1))[0]}
    model = port_model(cfg, variables).train()
    state = create_train_state(model, cfg, max_iters=10)
    got = train_cli.debug_panels(state, batch, 0)
    assert model.training   # the mode is restored
    _check(got, want)


def test_dacs_panels_match_jax():
    """The tiny DACS config (an EncoderDecoder): its prediction and entropy
    by ``encode_decode``, then the target, the pseudo-label, the mix mask,
    the mixed image and labels and the teacher's entropy, the augment
    draws fed to both sides."""
    jcfg, cfg = _configs("smoke_tiny_uda")
    batch = uda_batch(51)
    jmodel, variables, model = pair(jcfg, cfg, 52, HW,
                                    ("crop", "mask", "dropout"))
    kw = dict(pseudo_threshold=calibrated_threshold(model, batch),
              psweight_ignore_top=4, psweight_ignore_bottom=8)
    draws = step_draws(53)
    _, jstate = jax_state(jcfg, variables, LR)
    head = merge_params(jstate.trainable, jstate.frozen)["decode_head"]
    jstate = jstate.replace(ema=head)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=type(jmodel).encode_decode))(variables, jb["img"][:1])
    with fed_augment(draws, "jax"):
        d = jax_debug_fn(jmodel, JaxDACSConfig(**kw))(
            jstate, jb, jax.random.PRNGKey(0))
    want = {"image": jax_vis.denormalize_image(batch["img"][0]),
            "gt": batch["label"][0],
            "pred": np.asarray(jnp.argmax(logits, -1))[0],
            "entropy": np.asarray(_entropy(logits))[0],
            "target": jax_vis.denormalize_image(batch["target_img"][0]),
            "pseudo_label": np.asarray(d["pseudo_label"])[0],
            "mix_mask": np.asarray(d["mix_mask"])[0],
            "mixed_image": jax_vis.denormalize_image(
                np.asarray(d["mixed_img"][0])),
            "mixed_label": np.asarray(d["mixed_lbl"])[0],
            "teacher_entropy": np.asarray(d["entropy"])[0]}
    state = create_train_state(model, cfg, max_iters=10)
    state.ema = init_ema(model)
    with fed_augment(draws, "torch"):
        got = train_cli.debug_panels(state, batch, 0,
                                     make_dacs_debug_fn(DACSConfig(**kw)))
    _check(got, want)


def _panels():
    rs = np.random.RandomState(0)
    return {"image": rs.uniform(size=(16, 24, 3)).astype(np.float32),
            "gt": rs.randint(0, 19, (16, 24)),
            "entropy": rs.uniform(size=(16, 24)).astype(np.float32)}


def test_save_debug_grid_writes_a_png(tmp_path):
    """A grid of an image, a label map and a heat map lands at
    ``<dir>/<step:06d>.png``, as the JAX helper names it."""
    pytest.importorskip("matplotlib")
    got = visualization.save_debug_grid(str(tmp_path / "port"), 7,
                                        _panels())
    want = jax_vis.save_debug_grid(str(tmp_path / "jax"), 7, _panels())
    assert os.path.basename(got) == os.path.basename(want) == "000007.png"
    with open(got, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(
        visualization.denormalize_image(_panels()["image"]),
        jax_vis.denormalize_image(_panels()["image"]))


def test_save_debug_grid_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib both helpers write nothing and return None."""
    real = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    out = tmp_path / "grids"
    assert visualization.save_debug_grid(str(out), 1, _panels()) is None
    assert jax_vis.save_debug_grid(str(out), 1, _panels()) is None
    assert not out.exists()


class _Source:
    """Four in-memory 96 x 96 samples with labels."""

    def __init__(self):
        rs = np.random.RandomState(3)
        self.items = [{"img": rs.randint(0, 256, (96, 96, 3), np.uint8),
                       "label": rs.randint(0, 19, (96, 96)).astype(np.uint8)}
                      for _ in range(4)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_train_cli_writes_debug_grids(tmp_path):
    """The train CLI with ``schedule.debug_interval=1`` (refused before A11)
    writes one grid a step under ``<work_dir>/class_mix_debug``."""
    pytest.importorskip("matplotlib")
    work = tmp_path / "run"
    args = train_cli.parse_args([
        "smoke_tiny_ms_masked", "--device", "cpu", "--work-dir", str(work),
        "--max-iters", "2"])
    cfg = config("smoke_tiny_ms_masked", [
        "schedule.debug_interval=1", "schedule.checkpoint_interval=0",
        "data.rare_class_sampling=None", "data.num_workers=1",
        "data.train_pipeline.resize_scale_wh=(96, 96)",
        "data.train_pipeline.photometric=False"])
    state = train_cli.run(cfg, args, source=_Source())
    assert state.step == 2
    assert sorted(os.listdir(work / "class_mix_debug")) == [
        "000001.png", "000002.png"]
