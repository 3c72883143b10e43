"""The torch port's HRDA segmentor and its heads against the JAX package's,
on the CPU.

Both sides are built from one seeded flax variables tree
(``state_dict_from_flax``), in fp32, atol 1e-4 unless stated. Covered:
``AttentionHead`` and ``SegformerHead``; HRDA's ``_fuse`` at crop boxes
inside and at the edges of the image; ``encode_decode`` (the LR pass and
nine HR crops at stride 32 in one batch) and the ``slide`` logits of the
predictor at HRDA's test_cfg shape, scaled down (windows of 128 at stride
64, each through ``encode_decode``); the predictor's labels (an image
smaller than a crop, padded) and the eval CLI's loop; one train step of
``smoke_tiny_hrda`` against JAX ``make_train_step``
(``test_torch_rein.check_step``: the fused and HR losses and accuracies at
rtol 1e-4, gradients, updates, the LinearHead's BatchNorm statistics), the
crop's two ``randint`` draws fed to both by patching ``rng.randint`` and
``jax.random.randint``; a step of the Rein
SegFormer, whose unused query layers AdamW decays as optax's adamw does;
and the Frozen variant: its losses equal JAX's and its backbone gets
no gradient, where JAX's gradient there is exactly zero.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_configs_build_all import _shrink_model
from test_torch_clip import _close, _deterministic, _np
from test_torch_rein import _variables, batch_of, check_step
from test_torch_models import _fill
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.eval.evaluator import make_logits_fn as jax_make_logits_fn
from vfmseg_tpu.eval.evaluator import (
    make_shape_aware_predict_fn as jax_predict_fn,
)
from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.models.heads.attention_head import (
    AttentionHead as JaxAttentionHead,
)
from vfmseg_tpu.models.heads.segformer import SegformerHead as JaxSegformer
from vfmseg_tpu.models.segmentors import hrda as jhrda
from vfmseg_tpu.train import make_optimizer as jax_make_optimizer
from vfmseg_tpu_torch.data.transforms import TestPipeline
from vfmseg_tpu_torch.eval.evaluator import (
    make_logits_fn,
    make_shape_aware_predict_fn,
)
from vfmseg_tpu_torch.eval.metrics import IoUAccumulator
from vfmseg_tpu_torch.models import presets, rng
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.models.heads.attention_head import AttentionHead
from vfmseg_tpu_torch.models.heads.segformer import SegformerHead
from vfmseg_tpu_torch.models.segmentors.hrda import HRDAEncoderDecoder
from vfmseg_tpu_torch.tools.test import evaluate_dataset
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step, step_generators
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    init_params,
    state_dict_from_flax,
)

NAME = "smoke_tiny_hrda"


@pytest.mark.parametrize("kind", ["attention", "segformer"])
def test_head_matches_jax(kind):
    """Four maps of width 24 at /4 .. /32 of a 64 x 96 image (the
    SegFormer head resizes them to the first); 8 channels, 5 classes."""
    shapes = [(2, 16, 24), (2, 8, 12), (2, 4, 6), (2, 2, 3)]
    if kind == "attention":
        shapes = [shapes[0]] * 4
    feats = tuple(_np(i, s + (24,)) for i, s in enumerate(shapes))
    kw = dict(in_channels=(24,) * 4, channels=8, num_classes=5,
              dropout_ratio=0.0)
    jhead, head = ((JaxAttentionHead(**kw), AttentionHead(**kw))
                   if kind == "attention"
                   else (JaxSegformer(**kw), SegformerHead(**kw)))
    variables = _variables(jhead, 7, tuple(map(jnp.asarray, feats)))
    want = jax.jit(jhead.apply)(variables, tuple(map(jnp.asarray, feats)))
    head.load_state_dict(state_dict_from_flax(variables, head), strict=True)
    with torch.no_grad():
        got = head(tuple(map(torch.from_numpy, feats)))
    _close(got, want, 1e-4, kind)


def _pair(seed, model_cfg=None):
    """The JAX HRDA segmentor of ``smoke_tiny_hrda`` (or ``model_cfg``)
    with seeded variables, and the port's loaded from them."""
    model_cfg = model_cfg or presets.config(NAME)["model"]
    jmodel = jax_build_segmentor(model_cfg, dtype=jnp.float32,
                                 attn_impl="xla")
    img = jnp.zeros((1, 128, 128, 3), jnp.float32)
    lab = jnp.zeros((1, 128, 128), jnp.int32)
    rngs = {n: jax.random.PRNGKey(i) for i, n in
            enumerate(("params", "crop", "dropout"))}
    tree = jax.eval_shape(lambda: jmodel.init(rngs, img, lab))
    variables = {col: _fill(dict(tree[col]), np.random.RandomState(seed))
                 for col in ("params", "batch_stats")}
    model = build_segmentor(model_cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("yx", [(0, 0), (24, 40), (64, 64)])
def test_fuse_matches_jax(yx):
    """``_fuse`` of 16 x 16 LR logits and attention with 16 x 16 HR
    logits of a 64-pixel crop at (y1, x1) in a 128 x 128 image: the crop
    mask at the LR-seg grid, the paste at the /4 grid, the x2 resizes."""
    jmodel, _variables_, model = _pair(3)
    lr_seg, hr_seg = _np(10, (2, 16, 16, 19)), _np(11, (2, 16, 16, 19))
    att = 1 / (1 + np.exp(-_np(12, (2, 16, 16, 19))))
    want = jmodel.apply({}, *map(jnp.asarray, (lr_seg, hr_seg, att)),
                        tuple(map(jnp.int32, yx)), (128, 128),
                        method=jhrda.HRDAEncoderDecoder._fuse)
    got = model._fuse(*map(torch.from_numpy, (lr_seg, hr_seg, att)), yx)
    _close(got, want, 1e-5, str(yx))


def test_encode_decode_and_slide_match_jax():
    """``encode_decode`` of a 128 x 128 batch (the LR pass at 64, nine HR
    crops of 64 at stride 32 in one backbone batch) and the predictor's
    ``slide`` logits with HRDA's test_cfg scaled down (128-pixel windows at
    stride 64 over 128 x 192: two windows, each an ``encode_decode``)."""
    jmodel, variables, model = _pair(4)
    assert isinstance(model, HRDAEncoderDecoder)
    img = _np(13, (2, 128, 128, 3))
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jhrda.HRDAEncoderDecoder.encode_decode))(
        variables, jnp.asarray(img))
    with torch.no_grad():
        got = model.encode_decode(torch.from_numpy(img))
    _close(got, want, 1e-4, "encode_decode")
    test_cfg = dict(mode="slide", crop_size=(128, 128), stride=(64, 64))
    img = _np(14, (1, 128, 192, 3))
    want = jax.jit(jax_make_logits_fn(jmodel, test_cfg, "slide"))(
        variables, jnp.asarray(img))
    with torch.no_grad():
        got = make_logits_fn(model, test_cfg, "slide")(
            model, torch.from_numpy(img))
    _close(got, want, 1e-4, "slide")


def test_predictor_and_eval_loop_take_hrda_slide():
    """The shape-aware predictor and the eval CLI's loop take HRDA's
    ``slide`` test_cfg as any encoder-decoder's: labels at the label size
    for a 96 x 160 image (padded up to a 128 crop), equal to the JAX
    predictor's at >= 99.9% of pixels (fp32 near-ties), and
    ``evaluate_dataset`` over two labelled images."""
    jmodel, variables, model = _pair(8)
    test_cfg = dict(mode="slide", crop_size=(128, 128), stride=(64, 64))
    img = _np(15, (1, 96, 160, 3))
    want = np.asarray(jax_predict_fn(jmodel, test_cfg)(
        variables, jnp.asarray(img), (48, 80)))
    predict = make_shape_aware_predict_fn(model, test_cfg)
    with torch.no_grad():
        got = predict(model, torch.from_numpy(img), (48, 80)).numpy()
    assert got.shape == want.shape == (1, 48, 80)
    assert (got == want).mean() >= 0.999
    rs = np.random.RandomState(16)
    data = [dict(img=rs.randint(0, 256, (96, 160, 3)).astype(np.uint8),
                 label=rs.randint(0, 19, (96, 160)).astype(np.uint8))
            for _ in range(2)]
    acc = IoUAccumulator(num_classes=19, dataset_keys=["synth"])
    with torch.no_grad():
        n = evaluate_dataset(model, test_cfg, data,
                             TestPipeline((160, 96), True), acc, "synth")
    results = acc.compute()
    assert n == 2 and np.isfinite(list(results.values())).all()


def test_smoke_tiny_hrda_train_step_matches_jax():
    """One step of ``smoke_tiny_hrda`` (LoRA DINOv2 of width 32, LinearHead
    seg head, AttentionHead, no dropout) with the HR crop at (y1, x1) =
    (24, 40) on both sides."""
    jcfg, cfg = load_config(NAME), presets.config(NAME)
    for c in (jcfg, cfg):
        head = c["model"]["decode_head"]
        for sub in ("seg_head", "single_scale_head"):
            head[sub]["dropout_ratio"] = 0.0
        _deterministic(c["model"])
    check_step(jcfg, cfg, batch_of(31, (128, 128)), [], crops=[3, 5])


def test_rein_segformer_step_decays_unused_query_layers():
    """``dg_rein_dinov2_segformer`` shrunk as the build-all test shrinks it:
    its head takes no Rein queries, so the loss never reaches the reins'
    query layers. The step gives them a zero gradient, as ``jax.grad``
    does, and AdamW moves them as the JAX package's optimizer (optax's
    adamw) moves them on a zero gradient: the kernels decay, the biases
    stay (atol 1e-7, the fp32 spacing at |p| < 1)."""
    name = "dg_rein_dinov2_segformer"
    cfg = presets.config(name)
    model_cfg = cfg["model"].to_dict()
    _shrink_model(model_cfg)
    cfg["model"] = model_cfg
    cfg["optimizer"]["lr"] = 1e-3
    model = init_params(build_segmentor(model_cfg, device="cpu"), 0)
    state = create_train_state(model, cfg, max_iters=100)
    reins = model.backbone.reins
    query = {f"backbone.reins.{m}.{p}": getattr(getattr(reins, m), p)
             for m in ("transform", "merge") for p in ("weight", "bias")}
    before = {n: p.detach().clone() for n, p in query.items()}
    make_train_step()(state, batch_of(35, (64, 64)), 0)
    tree = flax_from_state_dict(before, model)["params"]
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    tx = jax_make_optimizer(tree, base_lr=1e-3, max_steps=100)
    updates, _ = tx.update(zeros, tx.init(tree), tree)
    want = state_dict_from_flax({"params": optax.apply_updates(
        tree, updates)}, model)
    for name, p in query.items():
        assert p.grad is not None and not p.grad.any(), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-7, rtol=0, err_msg=name)
        assert torch.equal(p, before[name]) == name.endswith("bias"), name


def test_frozen_hrda_matches_jax_with_no_backbone_gradient():
    """FrozenHRDAEncoderDecoder (the frozen DINOv2 base, shrunk as the
    build-all test shrinks it, no dropout): the training losses equal the
    JAX module's with the crop fed to both (rtol 1e-4), every backbone
    gradient of JAX's is exactly zero, and the port's backbone gets none
    (its features carry no graph) while the heads do."""
    model_cfg = load_config("dinov2_hrda_frozen").model.to_dict()
    _shrink_model(model_cfg)
    _deterministic(model_cfg)
    jmodel, variables, model = _pair(5, model_cfg)
    assert model.frozen_backbone
    batch = batch_of(32, (128, 128))
    img, lab = jnp.asarray(batch["img"]), jnp.asarray(batch["label"])

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            img, lab, rngs={"crop": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        return sum(v for k, v in out.items() if "loss" in k), out

    draws = [2, 7]
    with mock.patch("jax.random.randint",
                    lambda *a, **k: jnp.asarray(draws.pop(0), jnp.int32)):
        grads, want = jax.jit(jax.grad(loss, has_aux=True))(
            variables["params"])
    for leaf in jax.tree_util.tree_leaves(grads["backbone"]):
        assert not np.asarray(leaf).any()
    assert any(np.asarray(g).any()
               for g in jax.tree_util.tree_leaves(grads["decode_head"]))

    model.train()
    with rng.streams(step_generators(0, 0, torch.device("cpu"))), \
            mock.patch.object(rng, "randint", side_effect=[2, 7]):
        got = model(torch.from_numpy(batch["img"]),
                    torch.from_numpy(batch["label"]))
    sum(v for k, v in got.items() if "loss" in k).backward()
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    for name, p in model.named_parameters():
        if name.startswith("backbone."):
            assert p.grad is None, name
    assert model.decode_head.seg_head.conv_seg.weight.grad.abs().max() > 0
