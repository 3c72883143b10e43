"""The torch port's SAM path against the JAX package's, on the CPU.

Window partitioning and the decomposed relative positions (ops/window.py),
the rel-pos attention (B7's plain twin against the Pallas kernel in TPU
interpret mode, as tests/test_ops.py runs it, and its autograd Function
against ``jax.grad`` through ``flash_attention_relpos_hm``), a toy SAM ViT
with LoRA on qkv in eval and under grad, and the whole toy SAM segmentor:
the gated slide, one train step, the flax round trip, the trainable set and
the config against ``load_config``. Inputs come from numpy seeds; the
port's CPU tensors take the plain versions, through the same dispatch that
launches B7 on a card. The refusal of the new wrappers and of a card-less
``build_segmentor`` are checked here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_models import _fill, toy_config
from test_torch_slice import _check_gated_slide, _check_predict, _slice_pair
from test_torch_train import (
    _check_flax_round_trip,
    _check_train_step,
    _check_trainable_set_and_decay_mask,
)
from vfmseg_tpu.core.config import load_config
from vfmseg_tpu.models.backbones import sam as jax_sam
from vfmseg_tpu.models.backbones.adapters import LoRASpec as JaxLoRASpec
from vfmseg_tpu.ops import window as jwin
from vfmseg_tpu.ops.attention import xla_attention_decomposed_hm
from vfmseg_tpu.ops.flash_attention import flash_attention_relpos_hm
from vfmseg_tpu.ops.resize import _interp_matrix
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.models.backbones import sam
from vfmseg_tpu_torch.models.backbones.adapters import LoRASpec
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.models.presets import sam_config
from vfmseg_tpu_torch.ops import window
from vfmseg_tpu_torch.ops.attention import (
    attention_decomposed_plain,
    attention_relpos_hm,
    multi_head_attention_decomposed_hm,
)
from vfmseg_tpu_torch.weights import state_dict_from_flax


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape,ws", [((2, 5, 7, 3), 3), ((1, 4, 4, 2), 2)])
def test_window_partition_equals_jax(shape, ws):
    """Partition (zero-padded bottom-right when the grid is not a window
    multiple) and unpartition (cropping it back) equal the JAX functions;
    fp32, atol 1e-6 (both only move values)."""
    x = _np(1, shape)
    got, pad = window.window_partition(torch.from_numpy(x), ws)
    want, jpad = jwin.window_partition(jnp.asarray(x), ws)
    assert pad == jpad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    back = window.window_unpartition(got, ws, pad, shape[1:3])
    jback = jwin.window_unpartition(want, ws, jpad, shape[1:3])
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("q,k", [(7, 7), (5, 9), (9, 5)])
def test_relative_coords_equal_jax(q, k):
    np.testing.assert_array_equal(window.relative_coords(q, k),
                                  jwin.relative_coords(q, k))


@pytest.mark.parametrize("q,k,length", [(7, 7, 13), (4, 4, 15), (32, 32, 127),
                                        (5, 9, 7)])
def test_get_rel_pos_equals_jax(q, k, length):
    """Rows picked from a table of its own length, and from one resized
    linearly first (the port's interpolation matrix against the JAX one);
    fp32, atol 1e-6."""
    table = _np(2, (length, 16))
    got = window.get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    want = np.asarray(jwin.get_rel_pos(q, k, jnp.asarray(table)))
    assert got.shape == want.shape == (q, k, 16)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if length != 2 * max(q, k) - 1:
        mat = _interp_matrix(length, 2 * max(q, k) - 1, "bilinear", False,
                             None)
        np.testing.assert_allclose(got, (mat @ table)[jwin.relative_coords(
            q, k)], atol=1e-6, rtol=0)


def test_rel_pos_terms_and_bias_equal_jax():
    """rel_h / rel_w and the whole bias from a head-major q on a 6x9 grid,
    with tables that need resizing on both sides; fp32, atol 1e-5."""
    q = _np(3, (2, 3, 54, 16))
    th, tw = _np(4, (15, 16)), _np(5, (15, 16))
    args = (torch.from_numpy(th), torch.from_numpy(tw), (6, 9))
    jargs = (jnp.asarray(th), jnp.asarray(tw), (6, 9))
    got = window.decomposed_rel_pos_terms_hm(torch.from_numpy(q), *args)
    want = jwin.decomposed_rel_pos_terms_hm(jnp.asarray(q), *jargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(
        window.decomposed_rel_pos_bias_hm(torch.from_numpy(q), *args).numpy(),
        np.asarray(jwin.decomposed_rel_pos_bias_hm(jnp.asarray(q), *jargs)),
        atol=1e-5, rtol=0)


def _relpos_inputs(grid, d, b=2, h=2, seed=10):
    n = grid[0] * grid[1]
    q, k, v = (_np(seed + i, (b, h, n, d)) for i in range(3))
    rel_h = _np(seed + 3, (b, h, n, grid[0]), 0.5)
    rel_w = _np(seed + 4, (b, h, n, grid[1]), 0.5)
    return q, k, v, rel_h, rel_w


@pytest.mark.parametrize("grid,d", [((6, 9), 16), ((6, 9), 80),
                                    ((14, 14), 80)])
def test_decomposed_attention_matches_pallas(grid, d):
    """B7's plain twin against the TPU kernel _fwd_kernel_relpos in
    interpret mode and against xla_attention_decomposed_hm: a non-square
    6x9 grid, head dims 16 and 80, and a 14x14 window (N = 196, a ragged
    last key block); fp32, atol 2e-4 (the repo's attention budget; the TPU
    kernel's softmax is the no-max exp2 one). The dispatcher without grad
    takes the twin and launches nothing."""
    inputs = _relpos_inputs(grid, d)
    jin = [jnp.asarray(t) for t in inputs]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_attention_relpos_hm(*jin))
    want_xla = np.asarray(xla_attention_decomposed_hm(*jin))
    got = attention_decomposed_plain(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=2e-4, rtol=0)
    counts = kernels.launch_counts()
    routed = multi_head_attention_decomposed_hm(*map(torch.from_numpy,
                                                     inputs))
    assert kernels.launch_counts() == counts
    np.testing.assert_array_equal(routed.numpy(), got)


def test_decomposed_attention_grads_match_jax():
    """DecomposedRelPosAttention's gradients for q, k, v, rel_h and rel_w
    (its backward recomputes through the plain twin) against jax.grad
    through flash_attention_relpos_hm (the Pallas forward in interpret
    mode, its custom VJP through the XLA formulation) on a 6x9 grid; fp32,
    atol 2e-4."""
    inputs = _relpos_inputs((6, 9), 16, seed=20)
    w = _np(30, inputs[0].shape)

    def f(*args):
        return jnp.sum(flash_attention_relpos_hm(*args) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, inputs))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    out = multi_head_attention_decomposed_hm(*ts)
    assert "DecomposedRelPosAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4,
                                   rtol=0)


def test_relpos_wrapper_refuses_cpu_tensors_and_other_head_dims():
    def qkv(d):
        return [torch.zeros(1, 2, 4, d, dtype=torch.bfloat16)] * 3

    rel = torch.zeros(1, 2, 4, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention_relpos_hm(*qkv(80), rel, rel, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        attention_relpos_hm(*qkv(64), rel, rel, 0.1)
    for d in (16, 32, 128):
        with pytest.raises(ValueError, match="head dim"):
            attention_relpos_hm(*qkv(d), rel, rel, 0.1)


LORA = dict(rank=4, alpha=8.0, targets=("qkv",))


@pytest.fixture(scope="module")
def toy_vit():
    """sam_tiny_for_tests (2 heads of 16, windows of 2, global blocks 1 and
    3, tables for a 128-pixel pretraining grid) with LoRA on qkv on both
    sides, from one seeded variables tree."""
    jmodel = jax_sam.sam_tiny_for_tests(lora=JaxLoRASpec(**LORA))
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img))
    variables = {"params": _fill(dict(shapes["params"]),
                                 np.random.RandomState(6))}
    model = sam.sam_tiny_for_tests(lora=LoRASpec(**LORA))
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    assert model.cls_token is None and model.pos_embed.shape == (1, 4, 4, 32)
    assert [blk.window_size for blk in model.blocks] == [2, 0, 2, 0]
    assert [blk.attn.rel_pos_h.shape[0] for blk in model.blocks] == [3, 15,
                                                                     3, 15]
    return jmodel, variables, model


@pytest.mark.parametrize("hw", [(64, 64), (80, 80)])
def test_vit_eval_matches_jax(toy_vit, hw):
    """Eval (LoRA folded): at the pos-embed's own 4x4 grid, and at 80 px,
    whose 5x5 grid resizes the pos-embed and pads the windows to 6x6; the
    global tables resize from 15 rows in both; fp32, atol 1e-4."""
    jmodel, variables, model = toy_vit
    x = _np(40, (2,) + hw + (3,))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_vit_grad_matches_jax(toy_vit):
    """Training mode (LoRA sequential, dropout 0) at the 5x5 grid: features
    and the gradient of a weighted sum with respect to the image, through
    DecomposedRelPosAttention on the CPU twin against jax.grad; fp32, atol
    1e-4."""
    jmodel, variables, model = toy_vit
    x = _np(41, (2, 80, 80, 3))
    ws = [_np(42 + i, (2, 5, 5, 32)) for i in range(4)]

    def f(img):
        feats = jmodel.apply(variables, img, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(a * w) for a, w in zip(feats, ws)), feats

    (_, want), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    model.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    got = model(tx)
    sum((a * torch.from_numpy(w)).sum() for a, w in zip(got, ws)).backward()
    model.eval()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def sam_slice_pair():
    return _slice_pair("sam")


def test_gated_slide_matches_jax_sam(sam_slice_pair):
    """The toy SAM segmentor's dense gated slide (stage 1 on a 4x8 grid,
    refine crops on 4x4; windows of 3 padded on both) against JAX: logits
    at atol 1e-3, argmax agreement >= 99.9%, gate decisions equal."""
    _check_gated_slide(sam_slice_pair)


def test_predict_matches_jax_sam(sam_slice_pair):
    _check_predict(sam_slice_pair)


def test_train_step_matches_jax_sam():
    """One whole train step of the toy SAM segmentor against JAX
    make_train_step (losses, grad_norm, every gradient, the Adam update,
    the BatchNorm statistics; bounds as the headline's), through
    DecomposedRelPosAttention's recomputed backward on the CPU twin. The
    weights come from seed 3: from the headline's seed 2, the exactly-zero
    gradient of aux_head.embed_conv1.bias (ahead of one-channel GroupNorm
    groups) comes out as rounding noise of up to 5.5e-7 on both sides,
    above the bound's signal cut (1e-6 of the largest gradient, 3.4e-7
    there), and Adam's first step turns that noise into updates of 9.82e-5
    and 9.55e-5."""
    _check_train_step("sam", seed=3)


def test_trainable_set_and_decay_mask_equal_jax_sam():
    """Only LoRA (on qkv) and the heads train; the rel-pos tables and the
    grid pos-embed stay frozen, as in the JAX partition."""
    _check_trainable_set_and_decay_mask("sam")


def test_flax_round_trip_is_exact_sam():
    """flax_from_state_dict inverts state_dict_from_flax on SAM's tree: the
    grid-shaped pos-embed, the rel-pos tables of windowed and global blocks,
    LoRA on qkv, and no cls token."""
    params = _check_flax_round_trip("sam")
    blk = "backbone/blocks_"
    for leaf in ("0/attn/rel_pos_h", "1/attn/rel_pos_w", "0/attn/qkv/lora_a",
                 "1/attn/qkv/lora_b", "0/mlp/fc1/kernel"):
        assert blk + leaf in params, leaf
    assert params["backbone/pos_embed"].ndim == 4
    assert params[blk + "0/attn/rel_pos_h"].shape == (5, 16)
    assert params[blk + "1/attn/rel_pos_h"].shape == (15, 16)
    assert not any("cls_token" in k or "/ls1/" in k for k in params)


def test_sam_config_equals_jax_load_config():
    """dg_lora_sam_ms_masked as data equals the JAX load_config: LoRA SAM
    ViT-H and both heads on its 1280-wide maps."""
    jcfg = load_config("dg_lora_sam_ms_masked")
    ours = sam_config()
    assert ours["name"] == jcfg["name"]
    for key in ("model", "test_cfg", "compute", "crop_size", "num_classes",
                "preprocessor", "optimizer", "schedule", "peft"):
        assert ours[key] == jcfg[key], key
    assert ours["data"]["batch_size"] == jcfg["data"]["batch_size"]
    assert ours["model"]["backbone"]["backbone"]["type"] == "SAMViT"


def test_build_segmentor_defaults_to_the_card(monkeypatch):
    """With no card, build_segmentor raises unless the caller asks for the
    CPU; asked, it builds there, in eval mode."""
    cfg = toy_config(family="sam")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_segmentor(cfg["model"])
    model = build_segmentor(cfg["model"], device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert not model.training
