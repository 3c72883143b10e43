"""The torch port's CLIP against the JAX package's, on the CPU.

Both sides are built at toy width from one seeded flax variables tree
(``state_dict_from_flax``), in fp32. Covered: the toy CLIP ViT (LoRA on
proj/fc1/fc2) at 64 x 64 and at 64 x 128, where the 4 x 4 position grid is
resized bilinearly to 4 x 8 (atol 1e-4; PARITY.md gives CLIP 3e-4 at full
width); the LoRA target names; ``ClipFPN`` in eval mode and in training
mode with its BatchNorm statistics (atol 1e-5); the Rein CLIP with its
pyramid (maps and queries); one train step of ``smoke_tiny_clip`` against
JAX ``make_train_step`` (``test_torch_rein.check_step``: losses at rtol
1e-4, gradients, updates), the crop origin fed to both; the
ConvTranspose kernels of ``ClipFPN`` and ``LinearHead`` through flax ->
port -> flax bit-equal, where a choice by name or shape would lose the
kh/kw flip of the square 1024 -> 1024 kernels; and the jax-free
``convert_clip`` against tools/convert_clip.py.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_convert import _flat, _to_torch
from test_torch_rein import _variables, batch_of, check_step
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.models.backbones import clip as jclip
from vfmseg_tpu.models.backbones import rein_backbones as jrein
from vfmseg_tpu.models.backbones.adapters import LoRASpec as JaxLoRASpec
from vfmseg_tpu.models.heads.linear_head import LinearHead as JaxLinearHead
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.backbones import clip
from vfmseg_tpu_torch.models.backbones.adapters import (
    LoRALinear,
    LoRASpec,
    normalize_lora_targets,
)
from vfmseg_tpu_torch.models.backbones.dinov2 import build_backbone
from vfmseg_tpu_torch.models.backbones.rein_backbones import ReinsCLIPWithFPN
from vfmseg_tpu_torch.models.heads.linear_head import LinearHead
from vfmseg_tpu_torch.tools import convert_clip
from vfmseg_tpu_torch.train.checkpoint import load_pytree
from vfmseg_tpu_torch.weights import (
    conv_transpose_weights,
    flax_from_state_dict,
    state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ("out_proj", "mlp.c_fc", "mlp.c_proj")
LORA = dict(rank=4, alpha=8.0, targets=("proj", "fc1", "fc2"))


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, atol, what=""):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_clip_vit_matches_jax(hw):
    """The toy CLIP (width 32, 4 blocks, 2 heads, a 64-pixel pretraining
    grid) with LoRA on proj/fc1/fc2: the four maps in eval mode; at 64 x
    128 the position grid is resized bilinearly by size."""
    jvit = jclip.clip_tiny_for_tests(lora=JaxLoRASpec(**LORA))
    x = _np(1, (2,) + hw + (3,))
    variables = _variables(jvit, 2, jnp.asarray(x))
    assert "bias" not in variables["params"]["patch_embed"]
    want = jax.jit(jvit.apply)(variables, jnp.asarray(x))
    vit = clip.clip_tiny_for_tests(lora=LoRASpec(**LORA)).eval()
    vit.load_state_dict(state_dict_from_flax(variables, vit), strict=True)
    with torch.no_grad():
        got = vit(torch.from_numpy(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g, w, 1e-4, str(hw))


def test_clip_lora_targets_are_proj_fc1_fc2():
    """The reference's CLIP target names map to proj/fc1/fc2; the fused qkv
    stays a plain linear, so CLIP's attention keeps the fused-qkv kernels
    (B2 at inference, B3 and B5's backward in training)."""
    assert normalize_lora_targets(TARGETS) == ("proj", "fc1", "fc2")
    assert normalize_lora_targets(TARGETS) == jclip.normalize_lora_targets(
        TARGETS)
    vit = build_backbone(dict(
        type="LoRABackbone", Lora_config=dict(r=4, lora_alpha=4,
                                              target_modules=list(TARGETS)),
        backbone=dict(type="CLIPVisionTransformer", width=32, layers=2,
                      heads=2, input_resolution=64, out_indices=[0, 1])))
    blk = vit.blocks[0]
    assert not isinstance(blk.attn.qkv, LoRALinear)
    for lin in (blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
        assert isinstance(lin, LoRALinear)


@pytest.mark.parametrize("train", [False, True])
def test_clip_fpn_matches_jax(train):
    """ClipFPN on four 4 x 6 maps of width 32: /4, /8, /16, /32; in
    training mode the BatchNorm normalises with the batch's statistics and
    moves its running ones (momentum 0.9 in flax's convention)."""
    feats = tuple(_np(10 + i, (2, 4, 6, 32)) for i in range(4))
    jf = tuple(map(jnp.asarray, feats))
    jfpn = jclip.ClipFPN(embed_dim=32)
    variables = _variables(jfpn, 3, jf, train=True)
    want, new_state = jax.jit(lambda v, f: jfpn.apply(
        v, f, train=train, mutable=["batch_stats"]))(variables, jf)
    fpn = clip.ClipFPN(32).train(train)
    fpn.load_state_dict(state_dict_from_flax(variables, fpn), strict=True)
    with torch.no_grad():
        got = fpn(tuple(map(torch.from_numpy, feats)))
    assert [tuple(g.shape[1:3]) for g in got] == [(16, 24), (8, 12), (4, 6),
                                                 (2, 3)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"level {i}")
    stats = new_state["batch_stats"]["fpn1_bn"]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        _close(getattr(fpn.fpn1_bn, name), stats[key], 1e-5, name)
    if train:
        assert not np.allclose(np.asarray(stats["var"]),
                               variables["batch_stats"]["fpn1_bn"]["var"])


def test_rein_clip_with_fpn_matches_jax():
    """ReinsCLIPVisionTransformer (LoRAReins after every block, the pyramid
    on the four maps) in eval mode: the maps and the Rein queries."""
    kw = dict(width=32, layers=4, heads=2, input_resolution=64,
              out_indices=[0, 1, 2, 3])
    rc = dict(type="LoRAReins", token_length=5, query_dims=16, lora_dim=4,
              link_token_to_query=True)
    jbb = jrein.build_reins_clip(dict(rc), **kw)
    x = _np(20, (2, 64, 96, 3))
    variables = _variables(jbb, 21, jnp.asarray(x))
    (wmaps, wq), _ = jax.jit(lambda v, t: jbb.apply(
        v, t, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    bb = build_backbone(dict(type="ReinsCLIPVisionTransformer",
                             reins_config=dict(rc), **kw)).eval()
    assert isinstance(bb, ReinsCLIPWithFPN) and bb.returns_queries
    bb.load_state_dict(state_dict_from_flax(variables, bb), strict=True)
    with torch.no_grad():
        maps, queries = bb(torch.from_numpy(x))
    for g, w in zip(maps, wmaps):
        _close(g, w, 1e-4)
    _close(queries, wq, 1e-4, "queries")


def _deterministic(cfg):
    """Every dropout, drop-path and the mask ratio at 0, in place."""
    for key, val in list(cfg.items()):
        if isinstance(val, dict):
            _deterministic(val)
        elif key in ("dropout_ratio", "lora_dropout", "drop_path_rate",
                     "dropout", "mask_ratio"):
            cfg[key] = 0.0
    return cfg


def test_smoke_tiny_clip_train_step_matches_jax():
    """``smoke_tiny_clip`` (LoRA CLIP of width 32 in the MsVFM scheme, no
    dropout) through one step of each package's make_train_step, the HR
    crop at (y1, x1) = (32, 0) on both: the loss entries, grad_norm, the
    LoRA and heads' gradients and updates, the LinearHead's BatchNorm
    statistics; the CLIP weights stay frozen."""
    name = "smoke_tiny_clip"
    jcfg, cfg = load_config(name), presets.config(name)
    _deterministic(jcfg["model"])
    _deterministic(cfg["model"])
    model = check_step(jcfg, cfg, batch_of(30, (128, 128)), [], crops=[1, 0])
    assert model.backbone.class_embedding.grad is None


def test_conv_transpose_round_trip_and_forward():
    """ClipFPN's three 32 -> 32 up-convolutions and LinearHead's two map
    from flax to the port and back bit-equal; the port picks their layout
    by module type, so both forwards equal the JAX modules' (atol 1e-4)."""
    feats = tuple(_np(40 + i, (1, 3, 5, 32)) for i in range(4))
    jf = tuple(map(jnp.asarray, feats))
    cases = [(jclip.ClipFPN(embed_dim=32), clip.ClipFPN(32)),
             (JaxLinearHead(in_channels=(32,) * 4, num_classes=5,
                            dropout_ratio=0.0),
              LinearHead(in_channels=(32,) * 4, num_classes=5,
                         dropout_ratio=0.0))]
    for jmod, mod in cases:
        variables = _variables(jmod, 41, jf)
        mod.eval().load_state_dict(state_dict_from_flax(variables, mod),
                                   strict=True)
        names = conv_transpose_weights(mod)
        assert len(names) == (3 if isinstance(mod, clip.ClipFPN) else 2)
        back = flax_from_state_dict(mod.state_dict(), mod)
        for col in ("params", "batch_stats"):
            want, got = _flat(variables[col]), _flat(back[col])
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        want = jax.jit(jmod.apply)(variables, jf)
        with torch.no_grad():
            got = mod(tuple(map(torch.from_numpy, feats)))
        for g, w in zip(*(((got,), (want,)) if torch.is_tensor(got)
                          else (got, want))):
            _close(g, w, 1e-4, type(mod).__name__)
        # taken as a Conv's (for a model without ConvTranspose modules),
        # each kernel would load other values; ClipFPN's square ones with
        # the right shape, silently
        wrong = state_dict_from_flax(variables, nn.Module())
        for k in names:
            assert not torch.equal(wrong[k], mod.state_dict()[k]), k
            if isinstance(mod, clip.ClipFPN):
                assert wrong[k].shape == mod.state_dict()[k].shape


def _clip_sd(rs, width=32, layers=3, grid=5, patch=14):
    sd = {"visual.class_embedding": rs.randn(width),
          "visual.positional_embedding": rs.randn(1 + grid * grid, width),
          "visual.conv1.weight": rs.randn(width, 3, patch, patch),
          "visual.ln_pre.weight": rs.randn(width),
          "visual.ln_pre.bias": rs.randn(width),
          "visual.ln_post.weight": rs.randn(width),
          "visual.proj": rs.randn(width, 8),
          "logit_scale": rs.randn(1)}
    for i in range(layers):
        b = f"visual.transformer.resblocks.{i}."
        sd.update({b + "ln_1.weight": rs.randn(width),
                   b + "ln_1.bias": rs.randn(width),
                   b + "ln_2.weight": rs.randn(width),
                   b + "ln_2.bias": rs.randn(width),
                   b + "attn.in_proj_weight": rs.randn(3 * width, width),
                   b + "attn.in_proj_bias": rs.randn(3 * width),
                   b + "attn.out_proj.weight": rs.randn(width, width),
                   b + "attn.out_proj.bias": rs.randn(width),
                   b + "mlp.c_fc.weight": rs.randn(4 * width, width),
                   b + "mlp.c_fc.bias": rs.randn(4 * width),
                   b + "mlp.c_proj.weight": rs.randn(width, 4 * width),
                   b + "mlp.c_proj.bias": rs.randn(width)})
    return sd


@pytest.mark.parametrize("patch,grid", [(16, 4), (14, 5)])
def test_convert_clip_matches_jax_tool(patch, grid, tmp_path):
    """An OpenAI-layout state dict (``visual.*``, with keys the converter
    drops) through both command lines into the JAX ``.npz`` layout: the
    same keys; at the target patch and grid (16, 4 x 4) every array equal
    bit for bit; with a 14-pixel patch and a 5 x 5 grid the bicubic patch
    kernel and the bilinear position grid within atol 1e-5 (two
    interpolation implementations) and every other array equal."""
    sd = _clip_sd(np.random.RandomState(patch), grid=grid, patch=patch)
    src = str(tmp_path / "clip.pt")
    torch.save(_to_torch(sd), src)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    flags = ["--target-patch", "16", "--target-img", "64"]
    convert_clip.main([src, ours, *flags])
    argv = sys.argv
    sys.argv = ["convert_clip.py", src, theirs, *flags]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "convert_clip.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    got, want = _flat(load_pytree(ours)), _flat(load_pytree(theirs))
    assert got.keys() == want.keys()
    assert len(got) == 5 + 3 * 12
    for key, val in want.items():
        assert got[key].dtype == val.dtype and got[key].shape == val.shape
        if patch != 16 and key in ("pos_embed", "patch_embed/kernel"):
            np.testing.assert_allclose(got[key], val, atol=1e-5, rtol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert got["pos_embed"].shape == (1, 17, 32)
    assert got["patch_embed/kernel"].shape == (16, 16, 3, 32)
