"""The torch port's SAM ``attn_impl="pallas_bias"`` route against the JAX
package's, on the CPU.

B5's bias variant: the plain twins (``attention_plain`` /
``attention_fwd_lse_plain`` / ``attention_bwd_plain`` with ``bias=``) and the
autograd Function ``HeadMajorAttention`` with a bias, against
``flash_attention(q, k, v, bias=)`` (the Pallas kernels _fwd_kernel,
_bwd_dq_kernel and _bwd_dkv_kernel with has_bias, in TPU interpret mode, as
tests/test_ops.py runs them) and its custom VJP: forward, dq, dk, dv and
dbias, at head dims 16 and 80, ragged lengths, Nq != Nk and a bias
broadcast over heads. Then a toy SAM ViT and one train step of the toy SAM
segmentor on the bias route, against JAX on the same route in interpret
mode and against the port's own B7 route. Inputs come from numpy seeds; the
port's CPU tensors take the plain versions through the same dispatch that
launches the kernels on a card.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_models import _fill, jax_model_and_variables, port_model
from test_torch_train import _batch, _check_train_step, deterministic_config
from vfmseg_tpu.models.backbones import sam as jax_sam
from vfmseg_tpu.models.backbones.adapters import LoRASpec as JaxLoRASpec
from vfmseg_tpu.ops.attention import xla_attention
from vfmseg_tpu.ops.flash_attention import flash_attention
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.backbones import sam
from vfmseg_tpu_torch.models.backbones.adapters import LoRASpec
from vfmseg_tpu_torch.ops.attention import (
    attention_hm_bwd,
    attention_hm_fwd,
    attention_plain,
    multi_head_attention_headmajor,
)
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step
from vfmseg_tpu_torch.weights import state_dict_from_flax


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


# (head dim, Nq, Nk): SAM's 80 and a narrow 16, both at the ragged 77 (one
# real row in the last 64-row tile), and Nq != Nk
BIAS_CASES = [(16, 77, 77), (80, 77, 77), (16, 77, 130)]


@pytest.mark.parametrize("d,nq,nk", BIAS_CASES)
def test_bias_attention_and_grads_match_pallas(d, nq, nk):
    """Forward (the plain twin, no grad) and dq, dk, dv, dbias
    (HeadMajorAttention on the CPU twins under autograd) against
    flash_attention(bias=) in interpret mode and xla_attention, with a
    [B, 1, Nq, Nk] bias broadcast over the heads, whose gradient autograd
    sums over them as jax.grad does; fp32, atol 2e-4 (the repo's attention
    budget)."""
    b, h = 2, 2
    q = _np(30, (b, nq, h, d))
    k, v = _np(31, (b, nk, h, d)), _np(32, (b, nk, h, d))
    bias = _np(33, (b, 1, nq, nk), 0.5)
    w = _np(34, (b, nq, h, d))
    jin = [jnp.asarray(t) for t in (q, k, v, bias)]

    def f(q, k, v, bias):
        return jnp.sum(flash_attention(q, k, v, bias=bias) * w)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_attention(*jin[:3], bias=jin[3]))
        want_g = jax.grad(f, argnums=(0, 1, 2, 3))(*jin)
    want_xla = np.asarray(xla_attention(*jin[:3], bias=jin[3]))

    def hm(t):
        return t.transpose(1, 2)

    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    counts = kernels.launch_counts()
    with torch.no_grad():
        got = hm(multi_head_attention_headmajor(hm(tq), hm(tk), hm(tv),
                                                bias=tb)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=2e-4, rtol=0)
    np.testing.assert_allclose(
        attention_plain(tq, tk, tv, bias=tb).numpy(), got, atol=1e-6, rtol=0)

    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv, tb)]
    out = multi_head_attention_headmajor(*map(hm, ts[:3]), bias=ts[3])
    assert "HeadMajorAttention" in type(out.grad_fn).__name__
    (hm(out) * torch.from_numpy(w)).sum().backward()
    assert kernels.launch_counts() == counts
    np.testing.assert_allclose(hm(out).detach().numpy(), want, atol=2e-4,
                               rtol=0)
    for name, t, g in zip(("dq", "dk", "dv", "dbias"), ts, want_g):
        assert t.grad.shape == g.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4,
                                   rtol=0, err_msg=name)


def test_bias_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 8, 80, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 8)
    bias = torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)
    dbias = torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention_hm_fwd(q, q, q, 0.1, bias=bias)
    with pytest.raises(ValueError, match="CUDA"):
        attention_hm_bwd(q, q, q, q, rows, rows, 0.1, q, q, q, bias=bias,
                         dbias=dbias)


LORA = dict(rank=4, alpha=8.0, targets=("qkv",))
TOY_SAM = dict(img_size=64, embed_dim=32, depth=4, num_heads=2, window_size=2,
               global_attn_indexes=(1, 3), out_indices=(0, 1, 2, 3),
               pretrain_img_size=128)


@pytest.fixture(scope="module")
def toy_vits():
    """The toy SAM ViT of tests/test_torch_sam.py with LoRA on qkv: JAX on
    the bias route, and the port on the bias route and on B7's, all from one
    seeded variables tree."""
    jmodel = jax_sam.build_sam(lora=JaxLoRASpec(**LORA),
                               attn_impl="pallas_bias", **TOY_SAM)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img))
    variables = {"params": _fill(dict(shapes["params"]),
                                 np.random.RandomState(7))}
    ports = {}
    for impl in ("pallas_bias", "auto"):
        model = sam.build_sam(lora=LoRASpec(**LORA), attn_impl=impl,
                              **TOY_SAM)
        model.load_state_dict(state_dict_from_flax(variables, model),
                              strict=True)
        ports[impl] = model
    assert all(blk.attn.bias_route for blk in ports["pallas_bias"].blocks)
    assert not any(blk.attn.bias_route for blk in ports["auto"].blocks)
    return jmodel, variables, ports


def test_vit_bias_route_matches_jax(toy_vits):
    """Training mode (dropout 0) at 80 px (a 5x5 grid: windows padded to
    6x6, the global tables resized): features and the gradient of a weighted
    sum with respect to the image on the port's bias route (autograd through
    the materialised bias into q and the tables) against jax.grad through
    the Pallas bias kernels in interpret mode, atol 1e-4 in fp32; and the
    port's two routes against each other, in eval and under grad, atol
    1e-5 (only the summation order of the bias differs)."""
    jmodel, variables, ports = toy_vits
    x = _np(41, (2, 80, 80, 3))
    ws = [_np(42 + i, (2, 5, 5, 32)) for i in range(4)]

    def f(img):
        feats = jmodel.apply(variables, img, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(a * w) for a, w in zip(feats, ws)), feats

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(x))
    got, grads = {}, {}
    for impl, model in ports.items():
        model.train()
        tx = torch.from_numpy(x).requires_grad_(True)
        got[impl] = model(tx)
        sum((a * torch.from_numpy(w)).sum()
            for a, w in zip(got[impl], ws)).backward()
        grads[impl] = tx.grad.numpy()
        model.eval()
    for g, b7, w in zip(got["pallas_bias"], got["auto"], want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(g.detach().numpy(), b7.detach().numpy(),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(grads["pallas_bias"], np.asarray(want_g),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(grads["pallas_bias"], grads["auto"],
                               atol=1e-5, rtol=0)
    with torch.no_grad():
        evals = [ports[i](torch.from_numpy(x)) for i in ("pallas_bias",
                                                         "auto")]
    for a, b in zip(*evals):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def _port_step(attn_impl, seed=3):
    """One port train step of the deterministic toy SAM segmentor on
    ``attn_impl``; returns its metrics and trainable gradients."""
    cfg = deterministic_config("sam")
    cfg["compute"]["attn_impl"] = attn_impl
    _, variables = jax_model_and_variables(cfg, seed=seed)
    model = port_model(cfg, variables)
    cfg["optimizer"]["lr"] = 1e-4
    state = create_train_state(model, cfg, max_iters=100)
    with mock.patch.object(rng, "randint", side_effect=[1, 0]):
        _, metrics = make_train_step()(state, _batch(), 0)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.requires_grad})


def test_train_step_on_the_bias_route_matches_jax_and_b7():
    """One whole train step of the toy SAM segmentor with
    compute.attn_impl = "pallas_bias" on both sides (the JAX step through
    the Pallas bias kernels and the heads' flash kernels in interpret mode)
    with the bounds of tests/test_torch_train.py's step; then the port's
    bias route against its B7 route: loss entries and grad_norm within
    rtol 1e-5, every trainable gradient within 1e-5 of the largest (fp32
    noise: the two routes sum the bias in another order)."""
    with pltpu.force_tpu_interpret_mode():
        _check_train_step("sam", seed=3, attn_impl="pallas_bias")
    bias_m, bias_g = _port_step("pallas_bias")
    b7_m, b7_g = _port_step("auto")
    for key, want in b7_m.items():
        np.testing.assert_allclose(bias_m[key], want, rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    scale = max(float(g.abs().max()) for g in b7_g.values())
    for name, want in b7_g.items():
        np.testing.assert_allclose(bias_g[name].numpy(), want.numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=name)
