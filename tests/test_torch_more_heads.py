"""The torch port's DINOhead, MultiScaleEncoderDecoder and ResNetV1c (plain
and with Rein) against the JAX package's, on the CPU.

Both sides are built from one seeded flax variables tree
(``state_dict_from_flax``), in fp32, atol 1e-4 unless stated. Covered:
``DINOhead`` without context and with coarse logits as cross-attention
context; ``MultiScaleEncoderDecoder`` (a toy LoRA DINOv2 under a DINOhead,
no dropout): the training losses (rtol 1e-4), the crop origin fed to
both, and the
context-conditioned slide (``ms_slide_inference`` over its ``lr_forward``
and ``hr_forward``); ``ResNetV1c`` and ``ReinsResNetV1c`` (one bottleneck a
stage, flax's asymmetric "SAME" padding at every stride 2) in eval mode and
in training mode with their BatchNorm statistics (atol 1e-5), the Rein
variant's summed queries, and ``build_reins_resnet``'s per-stage specs. In
training mode the maps are held to atol 1e-4 plus rtol 5e-4: there
BatchNorm divides by the standard deviation of as few as 8 values a
channel (stage 4 at 2 x 2, batch 2), and flax's one-pass variance
E[x^2] - E[x]^2 against the port's two-pass one moves stage 4's outputs by
up to 2.4e-4 of themselves.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_clip import _close, _np
from test_torch_rein import _pair, _variables, batch_of
from vfmseg_tpu.eval.slide import ms_slide_inference as jax_ms_slide
from vfmseg_tpu.models.backbones import resnet as jresnet
from vfmseg_tpu.models.heads.dino_head import DINOHead as JaxDINOHead
from vfmseg_tpu.models.segmentors.multiscale import (
    MultiScaleEncoderDecoder as JaxMultiScale,
)
from vfmseg_tpu_torch.eval.slide import ms_slide_inference
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.backbones import resnet
from vfmseg_tpu_torch.models.backbones.rein_backbones import (
    reins_spec_from_config,
)
from vfmseg_tpu_torch.models.heads.dino_head import DINOHead
from vfmseg_tpu_torch.models.segmentors.multiscale import (
    MultiScaleEncoderDecoder,
)
from vfmseg_tpu_torch.train.step import step_generators
from vfmseg_tpu_torch.weights import state_dict_from_flax

HEAD = dict(in_channels=(24,) * 4, channels=16, num_classes=5, n_heads=2,
            d_head=8, dropout_ratio=0.0)


@pytest.mark.parametrize("context", [False, True])
def test_dino_head_matches_jax(context):
    """Four maps of width 24 at /4 .. /32 of a 64 x 96 image; with context,
    5-class logits at 32 x 48, resized to the fused 16 x 24 grid and
    attended by the ``refine`` decoder."""
    shapes = [(2, 16, 24), (2, 8, 12), (2, 4, 6), (2, 2, 3)]
    feats = tuple(_np(i, s + (24,)) for i, s in enumerate(shapes))
    ctx = _np(9, (2, 32, 48, 5)) if context else None
    jf = tuple(map(jnp.asarray, feats))
    jctx = None if ctx is None else jnp.asarray(ctx)
    jhead = JaxDINOHead(**HEAD)
    variables = _variables(jhead, 4, jf, jnp.asarray(_np(9, (2, 32, 48, 5))))
    want = jax.jit(lambda v, f: jhead.apply(v, f, jctx))(variables, jf)
    head = DINOHead(**HEAD).eval()
    head.load_state_dict(state_dict_from_flax(variables, head), strict=True)
    with torch.no_grad():
        got = head(tuple(map(torch.from_numpy, feats)),
                   None if ctx is None else torch.from_numpy(ctx))
    _close(got, want, 1e-4, f"context={context}")


def _multiscale_cfg():
    backbone = dict(
        type="LoRABackbone", checkpoint="",
        backbone=dict(type="DinoVisionTransformer", patch_size=16,
                      embed_dim=32, depth=4, num_heads=2, img_size=64,
                      init_values=1e-5, out_indices=[0, 1, 2, 3]),
        Lora_config=dict(r=4, lora_alpha=4, target_modules=["qkv"],
                         lora_dropout=0.0))
    model = dict(type="MultiScaleEncoderDecoder", backbone=backbone,
                 decode_head=dict(type="DINOhead", in_channels=[32] * 4,
                                  channels=16, num_classes=19,
                                  dropout_ratio=0.0),
                 hr_crop_size=(64, 64), crop_coord_divisible=32)
    return dict(model=model, compute=dict(attn_impl="xla"),
                peft=dict(enabled=True, adapter_keywords=["lora"]),
                optimizer={})


def test_multiscale_losses_match_jax():
    """The training losses, the HR crop at (y1, x1) = (0, 32) on both
    sides: the LR branch without context and the HR crop with the detached
    LR logits of the crop as context, through the one head; rtol 1e-4,
    accuracies within 2 pixels."""
    cfg = _multiscale_cfg()
    jmodel, variables, model = _pair(cfg, cfg, 5, (128, 128))
    assert isinstance(model, MultiScaleEncoderDecoder)
    batch = batch_of(34, (128, 128))
    draws = [0, 1]
    with mock.patch("jax.random.randint",
                    lambda *a, **k: jnp.asarray(draws.pop(0), jnp.int32)):
        want = jax.jit(lambda v, x, y: jmodel.apply(
            v, x, y, rngs={"crop": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}))(
            variables, jnp.asarray(batch["img"]),
            jnp.asarray(batch["label"]))
    model.train()
    with rng.streams(step_generators(0, 0, torch.device("cpu"))), \
            mock.patch.object(rng, "randint", side_effect=[0, 1]), \
            torch.no_grad():
        got = model(torch.from_numpy(batch["img"]),
                    torch.from_numpy(batch["label"]))
    assert sorted(got) == sorted(want)
    pixels = batch["label"].size
    for key in got:
        if "acc" in key:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       atol=2 * 100.0 / pixels, err_msg=key)
        else:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-4, err_msg=key)


def test_multiscale_context_slide_matches_jax():
    """``ms_slide_inference`` over the two forwards: stage 1 at 64 x 64,
    then nine 64-pixel windows at stride 32 of a 128 x 128 image decoded
    with their stage-1 context, the gate's windows kept or refined."""
    cfg = _multiscale_cfg()
    jmodel, variables, model = _pair(cfg, cfg, 6, (128, 128))
    img = _np(7, (1, 128, 128, 3))
    kw = dict(crop=(64, 64), stride=(32, 32), lr_size=(64, 64))

    @jax.jit
    def want_fn(v, x):
        return jax_ms_slide(
            lambda t: jmodel.apply(v, t, method=JaxMultiScale.lr_forward),
            lambda t, c: jmodel.apply(v, t, c,
                                      method=JaxMultiScale.hr_forward),
            x, **kw)

    want = want_fn(variables, jnp.asarray(img))
    with torch.no_grad():
        got = ms_slide_inference(model.lr_forward, model.hr_forward,
                                 torch.from_numpy(img), **kw)
    _close(got, want, 1e-4, "context slide")


SPECS = dict(type="LoRAReins", token_length=4, query_dims=8, lora_dim=2,
             link_token_to_query=True)


@pytest.mark.parametrize("rein", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_resnet_matches_jax(rein, train):
    """One bottleneck a stage over a 64 x 48 image (stem at 32 x 24, pool
    16 x 12, stages 16 x 12 .. 2 x 2); with Rein, a bank per stage after
    every block and the four stages' queries summed."""
    specs = None
    if rein:
        specs = tuple(reins_spec_from_config(dict(SPECS)) for _ in range(4))
        jspecs = tuple(jresnet.reins_spec_from_config(dict(SPECS))
                       for _ in range(4))
    else:
        jspecs = None
    jnet = jresnet.ResNetV1c(depth_blocks=(1, 1, 1, 1), stem_channels=16,
                             reins_specs=jspecs)
    x = _np(8, (2, 64, 48, 3))
    variables = _variables(jnet, 9, jnp.asarray(x))
    want, new_state = jax.jit(lambda v, t: jnet.apply(
        v, t, deterministic=not train, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    net = resnet.ResNetV1c((1, 1, 1, 1), 16, reins_specs=specs).train(train)
    net.load_state_dict(state_dict_from_flax(variables, net), strict=True)
    assert net.returns_queries == rein
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    if rein:
        (got, queries), (want, wq) = got, want
        _close(queries, wq, 1e-4, "queries")
    rtol = 5e-4 if train else 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=rtol, err_msg=f"stage {i}")
    new = state_dict_from_flax(new_state, net)
    for name, value in new.items():
        if "running" in name:
            _close(net.state_dict()[name], value.numpy(), 1e-5, name)


def test_build_reins_resnet_specs_match_jax():
    """``ReinsResNetV1c``'s builder: ResNet-50's blocks and one spec per
    stage, the base ``reins_config`` updated by each stage's entry of
    ``distinct_cfgs``, as the JAX builder makes them."""
    distinct = [dict(token_length=2 + i) for i in range(4)]
    net = resnet.build_reins_resnet(dict(SPECS), distinct_cfgs=distinct)
    jnet = jresnet.build_reins_resnet(dict(SPECS), distinct_cfgs=distinct)
    assert net.depth_blocks == tuple(jnet.depth_blocks) == (3, 4, 6, 3)
    for spec, jspec in zip(net.reins_specs, jnet.reins_specs):
        for field in ("token_length", "query_dims", "lora_dim",
                      "link_token_to_query", "scale_init", "use_softmax"):
            assert getattr(spec, field) == getattr(jspec, field), field
    assert [net.reins_3.spec.token_length, net.reins_0.spec.token_length] \
        == [5, 2]
