"""``remat=True``: each ViT block's activations recomputed in the backward
(``models/backbones/vit.py`` ``remat_call``, the twin of ``nn.remat`` at
vfmseg_tpu/models/backbones/vit.py:508-509), against the port without it
and against the JAX ViT, with drop-path on.

A fault of the reference, and the port's divergence from it: the JAX ViT
with ``remat=True`` does not trace. ``nn.remat(Block, static_argnums=(1,
3))`` counts the module in its argument numbers, so ``deterministic`` stays
a tracer and ``drop_path``'s ``if deterministic`` raises
``TracerBoolConversionError``, in training and in inference alike. Remat
changes no value, so the port's remat is held to the JAX ViT without it.

The recomputation must draw the numbers the forward drew: the port's
streams are explicit ``torch.Generator``s, which ``torch.utils.checkpoint``
does not restore, so ``remat_call`` replays them; these tests fail if it
does not (the recompute would draw fresh masks and the gradients would be
silently wrong).
"""

import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _fill, toy_config
from vfmseg_tpu.models.backbones.dinov2 import build_lora_backbone as jbuild
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.backbones.dinov2 import build_backbone
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.train.step import step_generators
from vfmseg_tpu_torch.weights import init_params, state_dict_from_flax

TOY = dict(type="DinoVisionTransformer", patch_size=16, embed_dim=64,
           depth=3, num_heads=2, img_size=64, out_indices=[0, 1, 2],
           init_values=1e-5, drop_path_rate=0.3)
HW = (2, 64, 96, 3)


def _np(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _port(remat, lora_dropout, variables=None):
    lora = dict(r=4, lora_alpha=8, target_modules=["qkv", "fc1"],
                lora_dropout=lora_dropout)
    model = build_backbone(dict(type="LoRABackbone",
                                backbone=dict(TOY, remat=remat),
                                Lora_config=lora))
    if variables is None:
        init_params(model, 5)
    else:
        model.load_state_dict(state_dict_from_flax(variables, model),
                              strict=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model.train()


def _port_grads(model, x, ws):
    """Features and every parameter's gradient of a weighted sum of the
    features, step 0's streams; every uniform draw recorded."""
    draws = []
    real = rng.uniform

    def recording(name, shape, device):
        out = real(name, shape, device)
        draws.append(out.clone())
        return out

    model.zero_grad()
    with rng.streams(step_generators(0, 0, torch.device("cpu"))), \
            mock.patch.object(rng, "uniform", recording):
        feats = model(torch.from_numpy(x))
        n_forward = len(draws)
        sum((f * torch.from_numpy(w)).sum() for f, w in zip(feats, ws)
            ).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return feats, grads, draws, n_forward


def test_remat_gradients_equal_the_plain_backward():
    """Drop-path 0.3 and LoRA dropout 0.2: with remat the features and
    every gradient equal the port's without it (atol 1e-6, fp32), and the
    recomputation drew exactly the forward's masks again."""
    x = _np(1, HW)
    ws = [_np(2 + i, (2, 4, 6, 64)) for i in range(3)]
    f0, g0, d0, n0 = _port_grads(_port(False, 0.2), x, ws)
    f1, g1, d1, n1 = _port_grads(_port(True, 0.2), x, ws)
    assert n0 == n1 == len(d0) > 0
    # the recompute drew each block's numbers once more (the blocks in the
    # backward's order): every draw of the forward, bit for bit
    assert len(d1) == 2 * n1
    left = list(d1[:n1])
    for y in d1[n1:]:
        hit = [i for i, x in enumerate(left)
               if x.shape == y.shape and torch.equal(x, y)]
        assert hit, "the recompute drew a number the forward did not"
        left.pop(hit[0])
    assert any(bool((m < 0.7).any()) and bool((m >= 0.7).any())
               for m in d1 if m.shape[1:] == (1, 1))  # a path dropped
    for a, b in zip(f0, f1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert g0.keys() == g1.keys()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=0,
                                   msg=n)


def test_remat_matches_jax():
    """The port with remat against the JAX ViT, drop-path 0.3, from one
    variables tree: the port's keep masks are fed to
    ``jax.random.bernoulli`` in calling order. Features atol 1e-5; every
    parameter gradient within 1e-6 of the largest. The JAX ViT built with
    ``remat=True`` raises (module docstring), so the JAX side runs
    without it."""
    lora = dict(r=4, lora_alpha=8, target_modules=["qkv", "fc1"],
                lora_dropout=0.0)
    jremat = jbuild(backbone=dict(TOY, remat=True), Lora_config=lora)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jremat.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    jmodel = jbuild(backbone=dict(TOY), Lora_config=lora)
    x = _np(1, HW)
    ws = [_np(2 + i, (2, 4, 6, 64)) for i in range(3)]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables = {"params": _fill(dict(shapes["params"]),
                                 np.random.RandomState(4))}
    model = _port(True, 0.0, variables)
    feats, grads, draws, n = _port_grads(model, x, ws)
    # two drop-path draws a block, at the block's keep probability; block 0
    # has rate 0 and draws none
    depth = TOY["depth"]
    keep = [1.0 - TOY["drop_path_rate"] * i / (depth - 1)
            for i in range(1, depth) for _ in range(2)]
    assert n == len(keep)
    keeps = [(d < k).numpy() for d, k in zip(draws[:n], keep)]
    assert not all(k.all() for k in keeps)
    calls = itertools.count()

    def bernoulli(key, p, shape):
        return jnp.asarray(keeps[next(calls)].reshape(shape))

    def loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(a * w) for a, w in zip(out, ws)), out

    with mock.patch("jax.random.bernoulli", bernoulli):
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    for a, b in zip(feats, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=0)
    want_g = {k: v.numpy() for k, v in
              state_dict_from_flax({"params": jgrads}, model).items()}
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    assert want_g.keys() == grads.keys()
    for k, v in want_g.items():
        np.testing.assert_allclose(grads[k].numpy(), v, atol=1e-6 * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("family", ["dinov2", "eva02", "sam"])
def test_every_vit_builds_and_trains_with_remat(family):
    """``remat=True`` builds on each ViT family of the toy configs (the
    builders refused it before) and one training forward and backward of
    the whole segmentor runs, with the same loss as without remat."""
    losses = []
    for remat in (False, True):
        cfg = toy_config(family=family)
        cfg["model"]["backbone"]["backbone"]["remat"] = remat
        model = init_params(build_segmentor(cfg["model"], device="cpu"), 2)
        assert model.backbone.cfg.remat is remat
        rs = np.random.RandomState(3)
        img = torch.from_numpy(rs.standard_normal((2, 128, 128, 3)).astype(
            np.float32))
        lab = torch.from_numpy(rs.randint(0, 19, (2, 128, 128)))
        with rng.streams(step_generators(0, 0, torch.device("cpu"))):
            out = model(img, lab)
        loss = sum(v for k, v in out.items() if "loss" in k)
        loss.backward()
        losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
