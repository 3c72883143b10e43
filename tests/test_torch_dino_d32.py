"""DINOhead at its default head dim 32, and the attention route the port
takes for it.

The JAX package takes its fused-qkv kernel only for matched shapes with an
even head count and 2*D a multiple of 128 (vfmseg_tpu/ops/attention.py:
289-307); DINOhead's decoder, 8 heads of 32 on the card, falls to
``flash_attention`` (B5). The port mirrors that: ``takes_qkv_kernel``
sends matched D 64 to B2/B3 and every other head dim, D 32 among them, to
B5 (``HeadMajorAttention`` under autograd, whose CPU twins run here; on the
card B5's D-32 instantiations, held to the plain versions by
chip_smoke.py). The JAX side runs its plain reference (``attn_impl="xla"``,
``xla_attention``).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_more_heads import _multiscale_cfg
from test_torch_rein import _pair, batch_of
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.ops import attention
from vfmseg_tpu_torch.train.step import step_generators
from vfmseg_tpu_torch.weights import state_dict_from_flax


def _jax_takes_qkv_kernel(shape_q, shape_k, shape_v):
    """The JAX dispatcher's condition for its fused-qkv kernel
    (vfmseg_tpu/ops/attention.py:292-293), without a bias."""
    return (shape_q == shape_k == shape_v and shape_q[2] % 2 == 0
            and (2 * shape_q[3]) % 128 == 0)


@pytest.mark.parametrize("q,k", [
    ((2, 256, 8, 32), (2, 256, 8, 32)),     # DINOhead on the card: B5
    ((2, 1024, 8, 64), (2, 1024, 8, 64)),   # VFMHead: B2/B3
    ((2, 100, 4, 32), (2, 77, 4, 32)),      # unmatched: B5
    ((2, 100, 4, 64), (2, 77, 4, 64)),
    ((1, 16, 2, 80), (1, 16, 2, 80)),       # D 80 matched: B5 in both
])
def test_route_is_jax_condition(q, k):
    """``takes_qkv_kernel`` agrees with the JAX condition wherever the head
    count is even."""
    tq, tk = torch.zeros(q), torch.zeros(k)
    assert attention.takes_qkv_kernel(tq, tk, tk) == _jax_takes_qkv_kernel(
        q, k, k)


def test_route_odd_heads_at_d64_stay_on_the_qkv_kernel():
    """The one stated divergence: matched D 64 with an odd head count stays
    on B2/B3 (the same function), where JAX takes ``flash_attention``."""
    t = torch.zeros(2, 64, 3, 64)
    assert attention.takes_qkv_kernel(t, t, t)
    assert not _jax_takes_qkv_kernel(t.shape, t.shape, t.shape)


def test_multiscale_dinohead_d32_matches_jax():
    """The tiny ``MultiScaleEncoderDecoder`` under a DINOhead at its
    defaults, 8 heads of 32 (the JAX builder passes neither), the HR crop
    at (0, 32) on both sides: every loss entry (rtol 1e-4; accuracy within
    2 pixels) and every parameter's gradient of the total loss (atol 1e-4
    of the largest) against JAX; the decoder's self- and cross-attention
    of the HR pass took the head-major route (B5's autograd Function), not
    the qkv kernel's."""
    cfg = _multiscale_cfg()
    jmodel, variables, model = _pair(cfg, cfg, 6, (128, 128))
    batch = batch_of(35, (128, 128))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        draws = [0, 1]
        with mock.patch("jax.random.randint", lambda *a, **k: jnp.asarray(
                draws.pop(0), jnp.int32)):
            out = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jbatch["img"], jbatch["label"],
                rngs={"crop": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)})
        return sum(v for k, v in out.items() if "loss" in k), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    model.train()
    for p in model.parameters():
        p.requires_grad_(True)
    real_hm = attention.HeadMajorAttention.apply
    real_qkv = attention.QKVAttention.apply
    with rng.streams(step_generators(0, 0, torch.device("cpu"))), \
            mock.patch.object(rng, "randint", side_effect=[0, 1]), \
            mock.patch.object(attention.HeadMajorAttention, "apply",
                              side_effect=real_hm) as hm, \
            mock.patch.object(attention.QKVAttention, "apply",
                              side_effect=real_qkv) as qkv:
        got = model(torch.from_numpy(batch["img"]),
                    torch.from_numpy(batch["label"]))
    assert hm.call_count == 2 and qkv.call_count == 0
    assert model.decode_head.refine.block[0].attn1.dim_head == 32
    sum(v for k, v in got.items() if "loss" in k).backward()
    pixels = batch["label"].size
    assert sorted(got) == sorted(want)
    for key in got:
        if "acc" in key:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       atol=2 * 100.0 / pixels, err_msg=key)
        else:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-4, err_msg=key)
    want_g = {k: v.numpy() for k, v in
              state_dict_from_flax({"params": jgrads}, model).items()}
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name],
                                   atol=1e-4 * scale, rtol=0, err_msg=name)
