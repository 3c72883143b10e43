"""The torch port's EVA02 path against the JAX package's, on the CPU.

RoPE tables, the RoPE fused-qkv attention (B2 with ``rope=True``), the
head-major flash attention (B5) with its backward, drop-path, and a toy
EVA02 ViT with LoRA on all four reference targets, in eval (JAX's fused-rope
route) and in training mode (its head-major route). Inputs come from numpy
seeds; the JAX Pallas kernels run in TPU interpret mode, as tests/test_ops.py
runs them, and the port's CPU tensors take the plain versions, through the
same autograd Function that launches the CUDA kernels on a card. The whole
EVA02 segmentor's gated slide, train step and flax round trip are the
``*_eva02`` cases of test_torch_slice.py and test_torch_train.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_models import _fill
from vfmseg_tpu.models.backbones import eva02 as jax_eva02
from vfmseg_tpu.models.backbones import vit as jax_vit
from vfmseg_tpu.models.backbones.clip import normalize_lora_targets as jnorm
from vfmseg_tpu.models.backbones.dinov2 import build_lora_backbone as jbuild
from vfmseg_tpu.ops import rope as jrope
from vfmseg_tpu.ops.flash_attention import (
    _flash_forward_hm,
    flash_attention_headmajor,
    flash_attention_qkv_tm,
)
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.backbones import eva02, vit
from vfmseg_tpu_torch.models.backbones.adapters import normalize_lora_targets
from vfmseg_tpu_torch.models.backbones.dinov2 import build_backbone
from vfmseg_tpu_torch.ops import rope
from vfmseg_tpu_torch.ops.attention import (
    attention_fwd_lse_plain,
    attention_hm_bwd,
    attention_hm_fwd,
    attention_qkv_rope_tm,
    multi_head_attention,
    multi_head_attention_headmajor,
    multi_head_attention_qkv_tm,
)
from vfmseg_tpu_torch.weights import state_dict_from_flax

REFERENCE_TARGETS = ["q_proj", "k_proj", "v_proj", "attn.proj"]


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("grid,d,pt,intp", [((4, 4), 64, 4, True),
                                            ((32, 64), 64, 16, True),
                                            ((3, 5), 16, 16, False)])
def test_rope_tables_equal_jax(grid, d, pt, intp):
    """rope_2d_tables, evens_odds_perm and permuted_rope_tables equal the
    JAX package's exactly (both are numpy)."""
    ours = rope.rope_2d_tables(*grid, d, pt_seq_len=pt, intp_freq=intp)
    want = jrope.rope_2d_tables(*grid, d, pt_seq_len=pt, intp_freq=intp)
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rope.evens_odds_perm(3, d),
                                  jrope.evens_odds_perm(3, d))
    cos, sin = rope.vit_rope_tables(*grid, d, 1, pt, intp)
    for a, b in zip(rope.permuted_rope_tables(cos, sin),
                    jrope.permuted_rope_tables(cos, sin)):
        np.testing.assert_array_equal(a, b)
    tp = rope.permuted_rope_tables(torch.from_numpy(cos),
                                   torch.from_numpy(sin))
    for a, b in zip(tp, jrope.permuted_rope_tables(cos, sin)):
        np.testing.assert_array_equal(a.numpy(), b)
    x = _np(3, (2, cos.shape[0], d))
    np.testing.assert_allclose(
        rope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                        torch.from_numpy(sin)).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), cos, sin)),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("b,n,h,grid", [(2, 37, 2, (6, 6)),
                                        (1, 129, 2, (16, 8))])
def test_rope_attention_matches_pallas(b, n, h, grid):
    """The RoPE fused-qkv twin against the TPU kernel with rope=True in
    interpret mode, at a ragged N and at N=129, whose last query rides the
    kernel's aligned-tail side chain; fp32, atol 2e-4 (the repo's attention
    budget; the TPU kernel folds scale * log2 e into q before rotating)."""
    d = 16
    cos, sin = rope.vit_rope_tables(*grid, d, 1, 16, True)
    cos_p, sin_p = rope.permuted_rope_tables(cos, sin)
    qkv = _np(10 + n, (b, n, 3 * h * d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_attention_qkv_tm(
            jnp.asarray(qkv), h, rope_cs=(jnp.asarray(cos_p),
                                          jnp.asarray(sin_p))))
    counts = kernels.launch_counts()
    got = multi_head_attention_qkv_tm(
        torch.from_numpy(qkv), h,
        rope_cs=(torch.from_numpy(cos_p), torch.from_numpy(sin_p)))
    assert kernels.launch_counts() == counts
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_rope_attention_refuses_grad_and_cpu_kernel():
    qkv = torch.zeros(1, 5, 3 * 64, requires_grad=True)
    tables = (torch.ones(5, 64), torch.zeros(5, 64))
    with pytest.raises(NotImplementedError, match="inference"):
        multi_head_attention_qkv_tm(qkv, 1, rope_cs=tables)
    q = torch.zeros(1, 5, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention_qkv_rope_tm(q, q, q, *tables, 1, 0.125)


@pytest.mark.parametrize("b,h,nq,nk", [(2, 3, 77, 77), (2, 2, 33, 77)])
def test_headmajor_matches_pallas(b, h, nq, nk):
    """B5's twins against the TPU head-major kernels in interpret mode:
    output and LSE of _flash_forward_hm, and dq, dk, dv of jax.grad through
    flash_attention_headmajor (its _flash_hm custom VJP), ragged and with
    Nq != Nk; fp32, atol 2e-4."""
    d = 16
    q = _np(20, (b, h, nq, d))
    k, v = _np(21, (b, h, nk, d)), _np(22, (b, h, nk, d))
    w = _np(23, (b, h, nq, d))
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def f(q, k, v):
        return jnp.sum(flash_attention_headmajor(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _flash_forward_hm(jq, jk, jv, d ** -0.5)
        want_grads = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = attention_fwd_lse_plain(*(t.transpose(1, 2)
                                         for t in (tq, tk, tv)))
    np.testing.assert_allclose(out.transpose(1, 2).numpy(),
                               np.asarray(want_out), atol=2e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=2e-4, rtol=0)

    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    counts = kernels.launch_counts()
    got = multi_head_attention_headmajor(*ts)
    (got * torch.from_numpy(w)).sum().backward()
    assert kernels.launch_counts() == counts
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_out),
                               atol=2e-4, rtol=0)
    for t, g in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4,
                                   rtol=0)


def test_unmatched_lengths_take_the_headmajor_route():
    """multi_head_attention with Nq != Nk under differentiation runs
    HeadMajorAttention ([B, N, H, D] in, gradients in the inputs' layout);
    without grad the plain version; both equal xla-style attention."""
    q = torch.from_numpy(_np(40, (2, 21, 2, 16))).requires_grad_(True)
    k = torch.from_numpy(_np(41, (2, 33, 2, 16))).requires_grad_(True)
    v = torch.from_numpy(_np(42, (2, 33, 2, 16))).requires_grad_(True)
    out = multi_head_attention(q, k, v, scale=0.3)
    inner = out.grad_fn.next_functions[0][0]  # under the transpose back
    assert "HeadMajorAttention" in type(inner).__name__
    out.sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    logits = torch.einsum("bqhd,bkhd->bhqk", ref[0], ref[1]) * 0.3
    want = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), ref[2])
    want.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-5, rtol=0)
    for t, r in zip((q, k, v), ref):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), atol=1e-5,
                                   rtol=0)
    with torch.no_grad():
        np.testing.assert_allclose(
            multi_head_attention(q, k, v, scale=0.3).numpy(),
            want.detach().numpy(), atol=1e-5, rtol=0)


def test_headmajor_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention_hm_fwd(q, q, q, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        attention_hm_bwd(q, q, q, q, rows, rows, 0.125, q, q, q)


def test_lora_target_aliases_equal_jax():
    names = REFERENCE_TARGETS + ["out_proj", "mlp.c_fc", "mlp.c_proj",
                                 "lin1", "lin2", "qkv"]
    assert normalize_lora_targets(names) == jnorm(names)


def test_drop_path_given_one_keep_mask():
    """drop_path with the same per-sample keep mask on both sides: JAX's
    bernoulli draw against the port's uniform draw from the dropout stream;
    the identity outside training; fp32, exact."""
    x = _np(50, (4, 9, 32))
    keep = np.array([True, False, True, True])
    with mock.patch("jax.random.bernoulli",
                    lambda *a, **k: jnp.asarray(keep.reshape(4, 1, 1))):
        want = np.asarray(jax_vit.drop_path(jnp.asarray(x), 0.25, False,
                                            jax.random.PRNGKey(0)))

    def uniform(name, shape, device):
        assert name == "dropout" and tuple(shape) == (4, 1, 1)
        return torch.from_numpy(np.where(keep, 0.0, 0.9).astype(
            np.float32).reshape(shape))

    with mock.patch.object(rng, "uniform", uniform):
        got = vit.drop_path(torch.from_numpy(x), 0.25, True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].abs().sum() == 0
    tx = torch.from_numpy(x)
    assert vit.drop_path(tx, 0.25, False) is tx


TOY = dict(type="EVA2", patch_size=16, embed_dim=128, depth=2, num_heads=2,
           img_size=64, out_indices=[0, 1], pt_hw_seq_len=4,
           drop_path_rate=0.0)


@pytest.fixture(scope="module")
def toy_vit():
    """A toy EVA02 backbone (2 heads of 64) with LoRA on the four reference
    targets (``attn.proj`` normalised to ``proj``) on both sides, from one
    seeded variables tree."""
    lora = dict(r=4, lora_alpha=8, target_modules=REFERENCE_TARGETS,
                lora_dropout=0.0)
    jmodel = jbuild(backbone=dict(TOY), Lora_config=lora)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img))
    variables = {"params": _fill(dict(shapes["params"]),
                                 np.random.RandomState(3))}
    model = build_backbone(dict(type="LoRABackbone", backbone=dict(TOY),
                                Lora_config=lora))
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    lora_mods = {n.rsplit(".", 1)[0] for n, _ in model.named_parameters()
                 if "lora_a" in n}
    assert lora_mods == {f"blocks.{i}.attn.{p}" for i in range(2)
                         for p in ("q_proj", "k_proj", "v_proj", "proj")}
    return jmodel, variables, model


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_vit_eval_matches_jax_fused_rope_route(toy_vit, hw):
    """Eval: JAX's fused-rope route (one [E, 3E] product, permuted q/k
    columns, rotation in the attention) against the port's; at the
    pos-embed's own grid and an interpolated one; fp32, atol 1e-4."""
    jmodel, variables, model = toy_vit
    x = _np(60, (2,) + hw + (3,))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert model.blocks[0].attn._fused is not None  # the fused route ran
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_vit_training_matches_jax_headmajor_route(toy_vit):
    """Training mode with the dropouts at 0: JAX's head-major route
    (per-slot projections, rotate_half, head-major attention) against the
    port's (HeadMajorAttention on the CPU twins): features and the gradient
    of a weighted sum with respect to the image; fp32, atol 1e-4."""
    jmodel, variables, model = toy_vit
    x = _np(61, (2, 64, 128, 3))
    ws = [_np(62 + i, (2, 4, 8, 128)) for i in range(2)]

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


def test_tiny_builder_matches_jax():
    """eva02_tiny_for_tests without LoRA (the eval route folds plain
    projections) against the JAX factory of the same name, from one seeded
    tree: every leaf maps, and the features agree in eval; fp32, atol
    1e-4."""
    jmodel = jax_eva02.eva02_tiny_for_tests()
    x = _np(70, (2, 64, 96, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    variables = {"params": _fill(dict(shapes["params"]),
                                 np.random.RandomState(4))}
    want = jmodel.apply(variables, jnp.asarray(x), deterministic=True)
    model = eva02.eva02_tiny_for_tests().eval()
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_fused_weight_tracks_parameter_writes(toy_vit):
    """The eval route's cached [3E, E] weight follows an in-place write to
    any of the three projections' parameters."""
    _jmodel, _variables, model = toy_vit
    attn = model.blocks[0].attn
    model.eval()
    w0 = attn.fused_qkv()[0].clone()
    with torch.no_grad():
        attn.k_proj.lora_b.mul_(2.0)
    w1 = attn.fused_qkv()[0]
    e = attn.q_proj.out_features
    assert torch.equal(w0[:e], w1[:e]) and not torch.equal(w0[e:2 * e],
                                                           w1[e:2 * e])
    with torch.no_grad():
        attn.k_proj.lora_b.mul_(0.5)
    torch.testing.assert_close(attn.fused_qkv()[0], w0, atol=1e-6, rtol=0)
