"""The torch port's Mask2Former serving path against the JAX package's, on
the CPU.

B8's plain twin (``sample_plain``) against ``_sample_pallas`` (the Pallas
kernel in TPU interpret mode, as tests/test_ops.py runs it) and
``_sample_nhwc_xy``, and its autograd Function against ``jax.grad`` of
``_sample_pallas``; ``ms_deform_attn_core``; the pixel decoder and the
Mask2Former head (both branches, every stage) at toy width; a toy LoRA
DINOv2 + Mask2Former segmentor and the LinearHead encoder-decoder through
``slide`` and ``whole`` against JAX ``make_logits_fn``; the three configs
against ``load_config``; weights both ways; one train step of the LinearHead
encoder-decoder and of the frozen-backbone Mask2Former against JAX
``make_train_step`` (``test_torch_rein.check_step``). Inputs and weights
come from numpy seeds; fp32 throughout, so the budgets are fp32 ones
(PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_m2f_loss import draws
from test_torch_models import _fill
from test_torch_rein import batch_of, check_step
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.eval.evaluator import make_logits_fn as jax_make_logits_fn
from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.models.heads import mask2former as jm2f
from vfmseg_tpu.ops import deform_attn as jdeform
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.eval.evaluator import make_logits_fn
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.models.heads import mask2former as m2f
from vfmseg_tpu_torch.models.segmentors.maskformer import MaskFormerSegmentor
from vfmseg_tpu_torch.ops.deform_attn import (
    DeformSample,
    ms_deform_attn_core,
    sample_cuda,
    sample_plain,
)
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    init_params,
    state_dict_from_flax,
)


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _coords(seed, shape):
    """Normalised coordinates in [-0.2, 1.2]: a share of the taps, and some
    whole samples, fall outside the plane."""
    return np.random.RandomState(seed).uniform(-0.2, 1.2, shape).astype(
        np.float32)


# ------------------------------------------------------------------- B8 ----

@pytest.mark.parametrize("shape,n", [((3, 7, 9, 5), 40), ((2, 6, 6, 32), 130)])
def test_sample_plain_matches_pallas_and_gather(shape, n):
    """The twin against the TPU kernel in interpret mode (N = 40 and 130,
    not multiples of its 128-sample block; 5 and 32 channels) and against
    _sample_nhwc_xy, with out-of-range coordinates; fp32, atol 1e-5 (the
    Pallas kernel contracts y first, the gather x first)."""
    value = _np(0, shape)
    xn, yn = _coords(1, (shape[0], n)), _coords(2, (shape[0], n))
    jin = [jnp.asarray(t) for t in (value, xn, yn)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdeform._sample_pallas(*jin))
    want_gather = np.asarray(jdeform._sample_nhwc_xy(*jin))
    counts = kernels.launch_counts()
    got = sample_plain(*map(torch.from_numpy, (value, xn, yn))).numpy()
    routed = DeformSample.apply(*map(torch.from_numpy, (value, xn, yn)))
    assert kernels.launch_counts() == counts
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_gather, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(routed.numpy(), got)
    assert (got[np.logical_or.reduce([xn < -0.5 / shape[2],
                                      xn > 1 + 0.5 / shape[2],
                                      yn < -0.5 / shape[1],
                                      yn > 1 + 0.5 / shape[1]])] == 0).all()


def test_deform_sample_grads_match_jax():
    """DeformSample's gradients for the value and both coordinates (its
    backward recomputes through the twin) against jax.grad of
    _sample_pallas (the Pallas forward in interpret mode, its VJP through
    the matmul formulation), out-of-range taps included; fp32, atol 1e-5."""
    value = _np(3, (2, 6, 7, 4))
    xn, yn = _coords(4, (2, 25)), _coords(5, (2, 25))
    w = _np(6, (2, 25, 4))

    def f(v, x, y):
        return jnp.sum(jdeform._sample_pallas(v, x, y) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(
            *map(jnp.asarray, (value, xn, yn)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (value, xn, yn)]
    (DeformSample.apply(*ts) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("value", "x", "y"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_sample_cuda_refuses_cpu_tensors():
    value = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    xy = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        sample_cuda(value, xy, xy)


def test_ms_deform_attn_core_matches_jax():
    """Three levels of other sizes, 2 heads of 4 channels, 4 points, 10
    queries, locations partly outside, weights softmaxed over (levels,
    points); against the JAX core (its CPU route is the gather); fp32, atol
    1e-5."""
    b, heads, d, points, nq = 2, 2, 4, 4, 10
    shapes = [(4, 4), (3, 5), (2, 2)]
    values = [_np(10 + i, (b, h, w, heads, d)) for i, (h, w) in
              enumerate(shapes)]
    loc_x = _coords(20, (b, heads, 3, points, nq))
    loc_y = _coords(21, (b, heads, 3, points, nq))
    logits = _np(22, (b, heads, 3 * points, nq))
    wts = np.exp(logits) / np.exp(logits).sum(2, keepdims=True)
    wts = wts.reshape(b, heads, 3, points, nq).astype(np.float32)
    want = jdeform.ms_deform_attn_core(
        [jnp.asarray(v) for v in values], jnp.asarray(loc_x),
        jnp.asarray(loc_y), jnp.asarray(wts))
    got = ms_deform_attn_core([torch.from_numpy(v) for v in values],
                              *map(torch.from_numpy, (loc_x, loc_y, wts)))
    assert tuple(got.shape) == (b, nq, heads * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ------------------------------------------------------------ the head ----

def test_sine_positional_encoding_equals_jax():
    np.testing.assert_array_equal(m2f.sine_positional_encoding(5, 7, 32),
                                  jm2f.sine_positional_encoding(5, 7, 32))


HEAD = dict(num_classes=19, num_queries=10, feat_channels=64,
            num_decoder_layers=4)
IN_CH = 32


def _head_pair(shapes, seed):
    """The JAX Mask2FormerHead (no Rein queries) and the port's from one
    seeded variables tree, and NHWC features of ``shapes``."""
    feats = [_np(seed + i, (2, h, w, IN_CH)) for i, (h, w) in
             enumerate(shapes)]
    jhead = jm2f.Mask2FormerHead(rein_queries=False, **HEAD)
    jfeats = [jnp.asarray(f) for f in feats]
    tree = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jfeats))
    variables = {"params": _fill(dict(tree["params"]),
                                 np.random.RandomState(seed))}
    head = m2f.Mask2FormerHead(in_channels=(IN_CH,) * 4, **HEAD)
    head.load_state_dict(state_dict_from_flax(variables, head), strict=True)
    return jhead, variables, head, feats


# a plain ViT's four maps at one stride (DINOv2's 1/16), and a pyramid at
# strides 4-32 (the maps the reference's hierarchical backbones give)
HEAD_SHAPES = [[(6, 6)] * 4, [(16, 12), (8, 6), (4, 3), (2, 2)]]


@pytest.mark.parametrize("shapes", HEAD_SHAPES)
def test_pixel_decoder_and_head_match_jax(shapes):
    """The pixel decoder's mask features and memories, and the head's
    predictions: every stage of the training branch (masks formed in
    mmdet's order) and the last stage of the inference branch (masks
    formed at each level against resized mask features); fp32, atol 1e-4
    (deformable sampling, 4 masked decoder layers); the attention masks of
    both sides come out equal on these inputs."""
    jhead, variables, head, feats = _head_pair(shapes, 40)
    jfeats = [jnp.asarray(f) for f in feats]
    tfeats = [torch.from_numpy(f) for f in feats]
    jdec = jm2f.MSDeformAttnPixelDecoder(feat_channels=64, out_channels=64)
    want_mf, want_mem = jdec.apply(
        {"params": variables["params"]["pixel_decoder"]}, jfeats)
    with torch.no_grad():
        got_mf, got_mem = head.pixel_decoder(tfeats)
    np.testing.assert_allclose(got_mf.numpy(), np.asarray(want_mf),
                               atol=1e-4, rtol=0)
    for g, w in zip(got_mem, want_mem):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    for train in (True, False):
        want_cls, want_mask = jhead.apply(variables, jfeats, train=train)
        with torch.no_grad():
            got_cls, got_mask = head(tfeats, train=train)
        assert len(got_cls) == len(want_cls) == (5 if train else 1)
        for g, w in zip(got_cls + got_mask, want_cls + want_mask):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=0)
    np.testing.assert_allclose(
        m2f.semantic_inference(got_cls[-1], got_mask[-1], 19).numpy(),
        np.asarray(jm2f.semantic_inference(want_cls[-1], want_mask[-1], 19)),
        atol=1e-5, rtol=0)


# ----------------------------------------------------------- the slice ----

def toy_config(name):
    """A ported encoder-decoder config cut to toy widths: DINOv2 at 64
    wide, 4 blocks of 4 heads, 64 px; LoRA rank 4; Mask2Former at 64 feature
    channels, 10 queries, 3 decoder layers; crops of 64 at stride 43 (the
    512 / 341 ratio)."""
    cfg = presets.config(name)
    m = cfg["model"]
    bb = m["backbone"]
    inner = bb.get("backbone", bb)
    inner.update(embed_dim=64, depth=4, num_heads=4, img_size=64,
                 out_indices=[0, 1, 2, 3])
    lora = m.get("Lora_config") or bb.get("Lora_config")
    if lora is not None:
        lora.update(r=4, lora_alpha=8)
    head = m["decode_head"]
    head["in_channels"] = [64] * 4
    if "Mask2Former" in head["type"]:
        head.update(feat_channels=64, num_queries=10,
                    transformer_decoder=dict(num_layers=3))
    else:
        head["channels"] = 16
    cfg["test_cfg"] = dict(cfg["test_cfg"], crop_size=(64, 64),
                           stride=(43, 43))
    return cfg


def _segmentor_pair(name, seed):
    cfg = toy_config(name)
    jmodel = jax_build_segmentor(cfg["model"], dtype=jnp.float32)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    tree = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), img, method=type(jmodel).forward))
    variables = {col: _fill(dict(tree[col]), np.random.RandomState(seed))
                 for col in tree}
    variables.setdefault("batch_stats", {})
    model = build_segmentor(cfg["model"], device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    return cfg, jmodel, variables, model


CONFIGS = ["dg_lora_dinov2_mask2former", "dg_lora_dinov2_linearhead",
           "dg_fzn_dinov2_mask2former_512x512"]


@pytest.mark.parametrize("name", CONFIGS)
def test_slide_and_whole_match_jax(name):
    """The toy segmentor of each config through ``slide`` (a 64 x 107
    image: 3 crops of 64 at stride 43, the last one shifted back to the
    edge) and ``whole`` (64 x 64) against JAX make_logits_fn; fp32 logits
    at atol 1e-4 and argmax agreement >= 99.9%."""
    cfg, jmodel, variables, model = _segmentor_pair(name, 50)
    if "mask2former" in name:
        assert isinstance(model, MaskFormerSegmentor)
        assert model.frozen_backbone == name.startswith("dg_fzn")
    for mode, hw in (("slide", (64, 107)), ("whole", (64, 64))):
        img = _np(51, (1,) + hw + (3,))
        want = np.asarray(jax_make_logits_fn(jmodel, cfg["test_cfg"], mode)(
            variables, jnp.asarray(img)))
        counts = kernels.launch_counts()
        with torch.no_grad():
            got = make_logits_fn(model, cfg["test_cfg"], mode)(
                model, torch.from_numpy(img)).numpy()
        assert kernels.launch_counts() == counts
        assert got.shape == want.shape == (1,) + hw + (19,)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                   err_msg=mode)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_jax_load_config(name):
    """Each encoder-decoder config as data equals the JAX load_config: the
    model, test, training and compute settings and the test sets."""
    jcfg = load_config(name)
    ours = presets.config(name)
    assert ours["name"] == jcfg["name"]
    for key in ("model", "test_cfg", "compute", "crop_size", "num_classes",
                "preprocessor", "optimizer", "schedule", "peft"):
        assert ours[key] == jcfg[key], key
    assert ours["data"]["batch_size"] == jcfg["data"]["batch_size"]
    for key in ("val", "test", "test_resize_wh"):
        assert ours["data"][key] == jcfg["data"][key], key


def test_weights_cross_both_ways_and_init_is_nontrivial():
    """state_dict_from_flax covers the Mask2Former segmentor's every leaf
    (HWIO convolutions, GroupNorms, the fused in-projection, level
    embeddings and queries) and flax_from_state_dict inverts it exactly;
    init_params is seeded, covers every parameter, and draws non-zero
    sampling_offsets and attention_weights kernels."""
    cfg, _jmodel, variables, model = _segmentor_pair(CONFIGS[0], 52)
    back = flax_from_state_dict(model.state_dict(), model)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]), flat_b[k])
    a = init_params(build_segmentor(cfg["model"], device="cpu"), 9)
    b = init_params(build_segmentor(cfg["model"], device="cpu"), 9)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    layer = a.decode_head.pixel_decoder.encoder_layer0.self_attn
    for lin in (layer.sampling_offsets, layer.attention_weights):
        assert lin.weight.abs().min() > 0


# toy encoder-decoder configs shrunk through overrides, as --cfg-options
# gives them: DINOv2 64 wide, 4 blocks, every dropout 0
TOY_ED = ["model.backbone.embed_dim=64", "model.backbone.depth=4",
          "model.backbone.num_heads=4", "model.backbone.img_size=64",
          "model.backbone.out_indices=[0,1,2,3]",
          "model.decode_head.in_channels=[64,64,64,64]",
          "compute.dtype=float32"]
ED_CONFIGS = {
    "dg_lora_dinov2_linearhead": [
        s.replace("backbone.", "backbone.backbone.") for s in TOY_ED[:5]
    ] + TOY_ED[5:] + [
        "model.backbone.Lora_config.r=4",
        "model.backbone.Lora_config.lora_dropout=0.0",
        "model.decode_head.channels=16",
        "model.decode_head.dropout_ratio=0.0"],
    "dg_fzn_dinov2_mask2former_512x512": TOY_ED + [
        "model.decode_head.feat_channels=32",
        "model.decode_head.num_queries=8",
        "model.decode_head.transformer_decoder.num_layers=2",
        "model.decode_head.train_cfg.num_points=64"],
}


@pytest.mark.parametrize("name", list(ED_CONFIGS))
def test_encoder_decoder_train_steps_match_jax(name):
    """A toy LinearHead encoder-decoder (LoRA, CE and accuracy at label
    resolution, the head's BatchNorm statistics) and the frozen-backbone
    Mask2Former (the backbone detached and run without a graph, the set
    loss over 3 stages of 64 points) through one step of each package's
    make_train_step, held as ``check_step`` holds the Rein step."""
    jcfg = load_config(name, ED_CONFIGS[name])
    cfg = presets.config(name, ED_CONFIGS[name])
    values = draws(23, 2, 19, 64, 3) if "mask2former" in name else []
    model = check_step(jcfg, cfg, batch_of(22, (64, 64)), values)
    assert model.frozen_backbone == ("fzn" in name)
