"""The torch port's Rein adapters, Rein backbones and ReinMask2FormerHead,
and the encoder-decoder train steps, against the JAX package's on the CPU.

Both sides are built at toy width from one seeded flax variables tree
(``state_dict_from_flax``), in fp32. The Mask2Former loss's point draws are
fed to both sides (``test_torch_m2f_loss.fed``). Covered: ``Reins.adapt``
and ``queries()`` (Reins and LoRAReins, with and without the softmax, with
``zero_mlp_delta_f``); the Rein ViTs' maps and queries (DINOv2 with and
without ``resize_feat``, EVA02, SAM with the adapter at its global blocks
only); the head with Rein queries; the flax round trip and ``init_params``;
one whole train step of ``smoke_tiny_rein_m2f`` against JAX
``make_train_step`` (``check_step``, which test_torch_mask2former also
runs on the LinearHead and frozen Mask2Former encoder-decoders); the
slide logits of the tiny Rein model; and every config of the slice built
(or refused, naming its queue item).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_m2f_loss import draws, fed
from test_torch_models import _fill
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.eval.evaluator import make_logits_fn as jax_make_logits_fn
from vfmseg_tpu.models.backbones import adapters as jadapters
from vfmseg_tpu.models.backbones import rein_backbones as jrein
from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.models.heads import mask2former as jm2f
from vfmseg_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
    partition_params,
    trainable_predicate as jax_trainable_predicate,
)
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.eval.evaluator import make_logits_fn
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.backbones.adapters import Reins, ReinsSpec
from vfmseg_tpu_torch.models.backbones.dinov2 import build_backbone
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.models.heads import mask2former as m2f
from vfmseg_tpu_torch.models.segmentors.maskformer import MaskFormerSegmentor
from vfmseg_tpu_torch.train.optim import decays
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    flax_name,
    init_params,
    state_dict_from_flax,
)


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _variables(module, seed, *args, **kwargs):
    """A seeded variables tree of ``module``'s shapes."""
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kwargs))
    return {col: _fill(dict(tree[col]), np.random.RandomState(seed))
            for col in tree}


def _close(got, want, atol, what=""):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


# -------------------------------------------------------------- Reins ----

@pytest.mark.parametrize("lora_dim,softmax,zero_delta", [
    (0, True, False), (4, True, False), (4, False, False), (0, True, True)])
def test_reins_adapt_and_queries_match_jax(lora_dim, softmax, zero_delta):
    """``adapt`` at two layers (one cls token passing through) and
    ``queries()`` for Reins and LoRAReins, with and without the softmax,
    and with ``zero_mlp_delta_f`` (no ``scale``); fp32, atol 1e-5."""
    kw = dict(token_length=6, query_dims=16, use_softmax=softmax,
              zero_mlp_delta_f=zero_delta, lora_dim=lora_dim)
    jmod = jadapters.Reins(spec=jadapters.ReinsSpec(**kw), num_layers=3,
                           embed_dims=32, patch_size=16)
    x = _np(1, (2, 10, 32))

    def both(m, x):
        return m.adapt(x, 0), m.adapt(x, 2), m.queries()

    variables = _variables(jmod, 2, jnp.asarray(x), method=both)
    want = jmod.apply(variables, jnp.asarray(x), method=both)
    mod = Reins(ReinsSpec(**kw), 3, 32, 16)
    mod.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert hasattr(mod, "scale") == (not zero_delta)
    with torch.no_grad():
        got = (mod.adapt(torch.from_numpy(x), 0),
               mod.adapt(torch.from_numpy(x), 2), mod.queries())
    np.testing.assert_array_equal(got[0][:, 0].numpy(), x[:, 0])
    for g, w, what in zip(got, want, ("layer 0", "layer 2", "queries")):
        _close(g, w, 1e-5, what)


# ------------------------------------------------------- Rein backbones ----

TINY = dict(patch_size=16, embed_dim=32, depth=4, num_heads=2, img_size=64,
            out_indices=[0, 1, 2, 3])
REINS_CFG = dict(type="LoRAReins", token_length=5, lora_dim=4, query_dims=16)
BACKBONES = {
    "dinov2": ("ReinsDinoVisionTransformer", jrein.build_reins_dinov2, {}),
    "eva02": ("ReinsEVA2", jrein.build_reins_eva02,
              dict(pt_hw_seq_len=4)),
    "sam": ("ReinsSAMViT", jrein.build_reins_sam,
            dict(window_size=2, global_attn_indexes=[1, 3],
                 pretrain_img_size=128)),
}


@pytest.mark.parametrize("family,resize_feat", [
    ("dinov2", False), ("dinov2", True), ("eva02", True), ("sam", True)])
def test_rein_vit_matches_jax(family, resize_feat):
    """The Rein ViT's four maps (the x4/x2/x1/x0.5 pyramid with
    ``resize_feat``) and its query vector at an 80-px image (a 5x5 grid:
    the pos-embed resized, SAM's windows padded), eval mode; SAM adapts
    after its global blocks only. fp32, atol 1e-4."""
    kind, jbuild, extra = BACKBONES[family]
    kw = dict(TINY, **extra)
    jbb = jbuild(dict(REINS_CFG), resize_feat=resize_feat, **kw)
    x = _np(3, (2, 80, 80, 3))
    variables = _variables(jbb, 4, jnp.asarray(x))
    want_feats, want_q = jax.jit(lambda v, x: jbb.apply(v, x))(
        variables, jnp.asarray(x))
    bb = build_backbone(dict(type=kind, reins_config=dict(REINS_CFG),
                             resize_feat=resize_feat, **kw))
    bb.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert bb.returns_queries
    if family == "sam":
        assert bb.reins.spec.apply_indices == (1, 3)
    bb.eval()
    with torch.no_grad():
        feats, queries = bb(torch.from_numpy(x))
    sides = [20, 10, 5, 2] if resize_feat else [5] * 4
    for f, w, side in zip(feats, want_feats, sides):
        assert f.shape[1] == side
        _close(f, w, 1e-4, family)
    _close(queries, want_q, 1e-4, "queries")


HEAD = dict(num_classes=19, num_queries=8, feat_channels=32,
            num_decoder_layers=2, replace_query_feat=True)


def test_rein_head_matches_jax():
    """The head fed the Rein query vector (no ``query_embed`` in either
    tree; ``querys2feat`` maps it to the content queries): every training
    stage and the inference output; fp32, atol 1e-4."""
    feats = [_np(10 + i, (2, s, s, 24)) for i, s in
             enumerate((16, 8, 4, 2))]
    queries = _np(15, (8, 32))
    jhead = jm2f.Mask2FormerHead(rein_queries=True, **HEAD)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = _variables(jhead, 16, jfeats, jnp.asarray(queries))
    assert "query_embed" not in variables["params"]
    head = m2f.Mask2FormerHead(in_channels=(24,) * 4, rein_queries=True,
                               **HEAD)
    assert not hasattr(head, "query_embed")
    head.load_state_dict(state_dict_from_flax(variables), strict=True)
    tfeats = [torch.from_numpy(f) for f in feats]
    for train in (True, False):
        want = jax.jit(lambda v, f, q: jhead.apply(v, f, q, train=train))(
            variables, jfeats, jnp.asarray(queries))
        with torch.no_grad():
            got = head(tfeats, torch.from_numpy(queries), train=train)
        assert len(got[0]) == (3 if train else 1)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            _close(g, w, 1e-4, f"train={train}")
    with pytest.raises(ValueError, match="queries"):
        head(tfeats)


# ---------------------------------------------------- segmentors, steps ----

def _pair(jcfg, cfg, seed, hw):
    """The JAX segmentor and a seeded variables tree of its training
    init, and the port's segmentor loaded from it."""
    jmodel = jax_build_segmentor(jcfg["model"], dtype=jnp.float32,
                                 attn_impl=jcfg["compute"]["attn_impl"])
    img = jnp.zeros((1,) + hw + (3,), jnp.float32)
    lab = jnp.zeros((1,) + hw, jnp.int32)
    rngs = {n: jax.random.PRNGKey(i) for i, n in
            enumerate(("params", "mask", "dropout"))}
    tree = jax.eval_shape(lambda: jmodel.init(rngs, img, lab))
    variables = {col: _fill(dict(tree[col]), np.random.RandomState(seed))
                 for col in ("params", "batch_stats") if col in tree}
    variables.setdefault("batch_stats", {})
    model = build_segmentor(cfg["model"], device="cpu",
                            attn_impl=cfg["compute"]["attn_impl"])
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jmodel, variables, model


def _smoke_rein():
    name = "smoke_tiny_rein_m2f"
    return load_config(name), presets.config(name)


def batch_of(seed, hw):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (2,) + hw).astype(np.int32)
    label[label == 7] = 8      # an absent class
    label[:, :, :5] = 255
    return {"img": rs.standard_normal((2,) + hw + (3,)).astype(np.float32),
            "label": label}


def check_step(jcfg, cfg, batch, values, seed=3, lr=1e-3):
    """One train step of both packages from one weight set, the loss's
    draws fed to both: every loss entry and grad_norm (rtol 1e-4; accuracy
    within 2 pixels), every trainable gradient (atol 2e-4 of the largest),
    the AdamW update (2e-6 where the gradient stands above twice that
    tolerance, so its sign is settled; elsewhere Adam's first step is +-lr
    on either side, and both are held to |update| <= lr + decay), the
    frozen set untouched, and the BatchNorm statistics (atol 1e-5).

    The set loss keeps each mask's 0.75P most uncertain points of its 3P
    pool: where two uncertainties tie within fp32 noise at that cut, the
    packages may keep different points. In the Rein step's first stage two
    of them stand 1.1e-6 apart, and one swapped point of 256 moves that
    stage's loss_mask by 9e-5 of itself and a few gradients by up to
    1.3e-4 of the largest; the other entries agree within 1e-5. Returns the
    port's model."""
    hw = batch["label"].shape[1:]
    jmodel, variables, model = _pair(jcfg, cfg, seed, hw)
    keywords = tuple(cfg["peft"]["adapter_keywords"])
    trainable, frozen = partition_params(
        variables["params"], jax_trainable_predicate(
            adapter_keywords=keywords))
    tx = jax_make_optimizer(trainable, base_lr=lr, max_steps=100)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                           frozen=frozen,
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(trainable))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with fed(values, "jax"):
        new_jstate, jmetrics = jax_make_train_step(
            jmodel, tx, donate=False, rng_names=("mask", "dropout"))(
            jstate, jbatch, jax.random.PRNGKey(0))
    # the gradients, from the step itself: Adam's first moment after one
    # step is (1 - b1) g
    adam = [s for s in jax.tree_util.tree_leaves(
        new_jstate.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                    adam[0].mu)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg["optimizer"]["lr"] = lr
    state = create_train_state(model, cfg, max_iters=100)
    counts = kernels.launch_counts()
    with fed(values, "torch"):
        state, metrics = make_train_step()(state, batch, 0)
    assert kernels.launch_counts() == counts
    assert sorted(metrics) == sorted(jmetrics)
    pixels = batch["label"].size
    for key, want in jmetrics.items():
        if "acc" in key:
            np.testing.assert_allclose(float(metrics[key]), float(want),
                                       atol=2 * 100.0 / pixels, err_msg=key)
        else:
            np.testing.assert_allclose(float(metrics[key]), float(want),
                                       rtol=1e-4, err_msg=key)

    want_g = {k: v.numpy() for k, v in
              state_dict_from_flax({"params": jgrads}).items()}
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    own = model.state_dict()
    want_p = state_dict_from_flax({"params": new_jstate.trainable,
                                   "batch_stats": new_jstate.batch_stats})
    assert {n for n, p in model.named_parameters()
            if p.requires_grad} == want_g.keys()
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and torch.equal(own[name], before[name])
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[name],
                                   atol=2e-4 * scale, rtol=0, err_msg=name)
        got_u = (own[name] - before[name]).numpy()
        want_u = (want_p[name] - before[name]).numpy()
        signal = np.abs(want_g[name]) > 4e-4 * scale
        np.testing.assert_allclose(got_u[signal], want_u[signal], atol=2e-6,
                                   rtol=0, err_msg=name)
        bound = lr * (1 + 1e-3) + lr * 0.05 * np.abs(before[name].numpy())
        assert (np.abs(got_u) <= bound).all(), name
    for name, want in want_p.items():
        if "running" in name:
            np.testing.assert_allclose(own[name].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)
    return model


def test_smoke_rein_m2f_train_step_matches_jax():
    """``smoke_tiny_rein_m2f`` (LoRAReins on a 4-block DINOv2 of 32, the
    pyramid, a Rein Mask2Former head of 10 queries and 3 layers, 256
    points) through one step of each package's make_train_step: the 12
    loss entries, grad_norm, the reins' and the head's gradients and
    updates; the ViT's own weights stay frozen. The reins' scalar scale is
    in the no-decay group on both sides."""
    jcfg, cfg = _smoke_rein()
    batch = batch_of(20, (128, 128))
    model = check_step(jcfg, cfg, batch, draws(21, 2, 19, 256, 4))
    assert isinstance(model, MaskFormerSegmentor)
    assert flax_name("backbone.reins.scale", 0) == "backbone/reins/scale"
    assert not decays("backbone.reins.scale", model.backbone.reins.scale)
    assert not decays("backbone.reins.learnable_tokens_a",
                      model.backbone.reins.learnable_tokens_a)


def test_rein_slide_logits_match_jax():
    """The tiny Rein model's slide logits (crops of 64 at stride 32 over a
    96 x 128 image) against JAX make_logits_fn; fp32, atol 1e-4."""
    jcfg, cfg = _smoke_rein()
    jmodel, variables, model = _pair(jcfg, cfg, 5, (64, 64))
    img = _np(6, (1, 96, 128, 3))
    test_cfg = cfg["test_cfg"]
    want = np.asarray(jax_make_logits_fn(jmodel, test_cfg, "slide")(
        variables, jnp.asarray(img)))
    counts = kernels.launch_counts()
    with torch.no_grad():
        got = make_logits_fn(model, test_cfg, "slide")(
            model, torch.from_numpy(img)).numpy()
    assert kernels.launch_counts() == counts
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_rein_weights_round_trip_and_init():
    """The Rein model's state dict maps to the flax tree and back exactly
    (no ``query_embed`` in either; the scalar ``scale`` keeps its name);
    ``init_params`` covers the reins with the reference's initialisers."""
    jcfg, cfg = _smoke_rein()
    _jmodel, variables, model = _pair(jcfg, cfg, 7, (64, 64))
    assert "query_embed" not in variables["params"]["decode_head"]
    back = flax_from_state_dict(model.state_dict())
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert np.shape(flat_a[k]) == np.shape(flat_b[k]), k
        np.testing.assert_array_equal(np.asarray(flat_a[k]), flat_b[k])
    reins = init_params(build_segmentor(cfg["model"], device="cpu"),
                        1).backbone.reins
    bound = reins.token_bound
    assert bound == pytest.approx((6 / (3 * 16 ** 2 + (32 * 4) ** 0.5))
                                  ** 0.5)
    for t in (reins.learnable_tokens_a, reins.learnable_tokens_b):
        assert 0 < t.abs().max() <= bound
    assert reins.scale.item() == pytest.approx(1e-3)
    for lin in (reins.mlp_token2feat, reins.mlp_delta_f):
        assert 0 < lin.weight.abs().max() <= 32 ** -0.5


# ------------------------------------------------------------ configs ----

SHRINK = ["model.backbone.embed_dim=32", "model.backbone.depth=4",
          "model.backbone.num_heads=2", "model.backbone.img_size=64",
          "model.backbone.out_indices=[0,1,2,3]", "compute.dtype=float32"]
LINEAR = ["model.decode_head.in_channels=[32,32,32,32]",
          "model.decode_head.channels=16"]
M2F = ["model.decode_head.feat_channels=32",
       "model.decode_head.num_queries=8",
       "model.decode_head.transformer_decoder.num_layers=2",
       "model.decode_head.train_cfg.num_points=64"]
REIN_M2F = M2F + ["model.backbone.reins_config.query_dims=32",
                  "model.backbone.reins_config.token_length=8"]
SAM = ["model.backbone.window_size=2",
       "model.backbone.global_attn_indexes=[1,3]",
       "model.backbone.pretrain_img_size=128"]
BUILDS = {
    "dg_rein_dinov2_mask2former": SHRINK + REIN_M2F,
    "dg_rein_dinov2_linearhead": SHRINK + LINEAR,
    "dg_rein_dinov2_ms_1024x1024": SHRINK + LINEAR + [
        "model.aux_head.in_channels=[32,32,32,32]",
        "model.aux_head.channels=16",
        "model.aux_head.transformer.query_dim=16",
        "model.aux_head.transformer.n_heads=2",
        "model.aux_head.transformer.d_head=8", "model.hr_crop_size=[64,64]"],
    "dg_rein_eva02_mask2former_512x512_bs1x4": SHRINK + REIN_M2F + [
        "model.backbone.pt_hw_seq_len=4"],
    "rein_sam_h_mask2former_512x512_bs1x4": SHRINK + REIN_M2F + SAM,
    "smoke_tiny_rein_m2f": [],
    "dg_lora_dinov2_mask2former": SHRINK + M2F,
    "dg_lora_eva02_linearhead": SHRINK + LINEAR + [
        "model.backbone.pt_hw_seq_len=4"],
    "dg_lora_sam_linearhead": SHRINK + LINEAR + SAM,
    "frozen_dinov2_linear_512": SHRINK + LINEAR,
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_config_builds_and_trains_a_step(name):
    """Each config of the slice, shrunk through overrides, builds in the
    port with its Rein parts where it names them and takes one train step
    at 64 px with finite losses and moving trainable parameters."""
    cfg = presets.config(name, BUILDS[name])
    model = init_params(build_segmentor(cfg["model"], device="cpu"), 0)
    rein = "Reins" in cfg["model"]["backbone"]["type"]
    assert (getattr(model.backbone, "reins", None) is not None) == rein
    state = create_train_state(model, cfg, max_iters=10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    state, metrics = make_train_step()(state, batch_of(24, (64, 64)), 0)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters() if n in before)


@pytest.mark.parametrize("name,item", [
    ("rein_clip_l_mask2former_512x512_bs1x4", "A7"),
    ("dg_lora_dinov2_segformer", "A9"),
    ("dg_rein_dinov2_hrda_1024x1024", "A9")])
def test_unported_configs_name_their_queue_item(name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build_segmentor(presets.config(name)["model"], device="cpu")


def test_uda_configs_refuse_to_train_naming_a10():
    """The uda_* configs build (the Rein Mask2Former one is this slice's
    model) but the train CLI refuses their DACS step, naming A10."""
    from vfmseg_tpu_torch.tools import train as train_cli

    cfg = presets.config("uda_rein_dinov2_mask2former_512x512")
    args = train_cli.parse_args(["uda_rein_dinov2_mask2former_512x512"])
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        train_cli._check_ported(cfg, args)
