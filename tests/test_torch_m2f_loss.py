"""The torch port's Mask2Former set-prediction loss against the JAX
package's (vfmseg_tpu/models/heads/m2f_loss.py), on the CPU.

Both sides take the same numpy inputs in fp32. The random draws of the
point sampling are fed to both: ``jax.random.uniform`` there and the port's
``models/rng.uniform`` here are patched to return the same arrays, in the
order and shapes both losses draw them (the matching points, then per stage
the oversampled pool and the fresh points).
"""

import contextlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfmseg_tpu.models.heads import m2f_loss as jloss
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.heads import m2f_loss


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _labels(seed, b, hw, num_classes, absent=(3,)):
    """Labels with some classes absent and a band of ignored pixels."""
    lab = np.random.RandomState(seed).randint(0, num_classes, (b,) + hw)
    for k in absent:
        lab[lab == k] = (k + 1) % num_classes
    lab[:, :, :3] = 255
    return lab.astype(np.int32)


def draws(seed, b, k, num_points, num_stages, oversample=3.0,
          importance=0.75):
    """The loss's uniform draws in order: [P, 2], then per stage
    [B*K, 3P, 2] and [B*K, P - 0.75P, 2]."""
    rs = np.random.RandomState(seed)
    n_unc = int(importance * num_points)
    shapes = [(num_points, 2)] + [
        s for _ in range(num_stages)
        for s in ((b * k, int(num_points * oversample), 2),
                  (b * k, num_points - n_unc, 2))]
    return [rs.uniform(0, 1, s).astype(np.float32) for s in shapes]


@contextlib.contextmanager
def fed(values, side):
    """Patch ``side``'s uniform ("jax": ``jax.random.uniform`` as the JAX
    loss calls it, "torch": ``rng.uniform``) to return ``values`` in turn,
    each checked against the shape asked for, and check that every value
    was drawn."""
    vals = list(values)
    real_uniform = jax.random.uniform

    def jax_uniform(key, shape=(), *args, **kwargs):
        # only the loss's draws; flax also calls uniform on parameter
        # initialisers to check their shapes
        if sys._getframe(1).f_globals["__name__"] != jloss.__name__:
            return real_uniform(key, shape, *args, **kwargs)
        v = vals.pop(0)
        assert v.shape == tuple(shape)
        return jnp.asarray(v)

    def torch_uniform(name, shape, device):
        assert name == "mask"
        v = vals.pop(0)
        assert v.shape == tuple(shape)
        return torch.from_numpy(v).to(device)

    patch = (mock.patch("jax.random.uniform", jax_uniform) if side == "jax"
             else mock.patch.object(rng, "uniform", torch_uniform))
    with patch:
        yield
    assert not vals, "draws left over"


def test_semantic_to_targets_equal():
    lab = _labels(0, 2, (9, 11), 5)
    want_m, want_e = jloss.semantic_to_targets(jnp.asarray(lab), 5)
    got_m, got_e = m2f_loss.semantic_to_targets(torch.from_numpy(lab), 5)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert not got_e[:, 3].any()


@pytest.mark.parametrize("nq,k", [(10, 19), (12, 5)])
def test_hungarian_host_equals_jax(nq, k):
    """Random costs with absent-class columns at _DUMMY_COST, NaN and inf
    entries; the assignment equals the JAX function's, dummy columns
    included (Nq < K leaves columns at query 0)."""
    cost = _np(1, (4, nq, k))
    cost[:, :, ::4] = jloss._DUMMY_COST
    cost[0, 1, 1] = np.nan
    cost[1, 2, 2] = np.inf
    cost[2, 0, 1] = -np.inf
    np.testing.assert_array_equal(m2f_loss._hungarian_host(cost),
                                  jloss._hungarian_host(cost))


def test_match_cost_matches_jax():
    """The batched cost against jax.vmap of the JAX per-sample one at fixed
    coordinates; masks at 8x8 against labels at 16x16; fp32, rtol 1e-5
    (atol 1e-5 for entries near 0)."""
    b, nq, k = 2, 7, 5
    cls = _np(2, (b, nq, k + 1))
    mask = _np(3, (b, nq, 8, 8), 2.0)
    lab = _labels(4, b, (16, 16), k)
    coords = np.random.RandomState(5).uniform(0, 1, (40, 2)).astype(
        np.float32)
    gt, exists = jloss.semantic_to_targets(jnp.asarray(lab), k)
    want = jax.jit(jax.vmap(lambda c, m, g, e: jloss._match_cost(
        c, m, g, e, jnp.asarray(coords))))(jnp.asarray(cls),
                                          jnp.asarray(mask), gt, exists)
    tgt, texists = m2f_loss.semantic_to_targets(torch.from_numpy(lab), k)
    got = m2f_loss._match_cost(torch.from_numpy(cls), torch.from_numpy(mask),
                               tgt, texists, torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got[:, :, 3] == m2f_loss._DUMMY_COST).all()


def test_uncertain_points_match_jax():
    """The per-mask point coordinates from the same draws: the most
    uncertain 0.75P of each mask's 3P pool, then the fresh points. The
    sampled logits are continuous, so no two tie at the cut."""
    b, k, p = 2, 3, 32
    logits = _np(6, (b, k, 8, 8), 2.0)
    vals = draws(7, b, k, p, 1)[1:]
    with fed(vals, "jax"):
        want = jloss._uncertain_points(jnp.asarray(logits),
                                       jax.random.PRNGKey(0), p, 3.0, 0.75)
    with fed(vals, "torch"):
        got = m2f_loss._uncertain_points(torch.from_numpy(logits), p, 3.0,
                                         0.75)
    want, got = np.asarray(want), got.numpy()
    n_unc = int(0.75 * p)
    # the chosen set; lax.top_k and torch.topk both sort it, descending
    np.testing.assert_array_equal(np.sort(got[:, :, :n_unc], axis=2),
                                  np.sort(want[:, :, :n_unc], axis=2))
    np.testing.assert_array_equal(got[:, :, n_unc:], want[:, :, n_unc:])


@pytest.mark.parametrize("nq,k", [(10, 19), (12, 5)])
def test_loss_and_grads_match_jax(nq, k):
    """Three stages of predictions (masks 8x8, labels 16x16, 64 points)
    through both losses from the same draws: every entry at rtol 1e-5, and
    d(total)/d(cls_preds, mask_preds) against jax.grad at atol 1e-5. At
    Nq 10 < K 19 some gt slots stay at query 0 and the no-object scatter
    resolves them last-slot-first on both sides."""
    b, stages, p = 2, 3, 64
    cls = [_np(10 + s, (b, nq, k + 1)) for s in range(stages)]
    mask = [_np(20 + s, (b, nq, 8, 8), 2.0) for s in range(stages)]
    lab = _labels(30, b, (16, 16), k)
    kw = dict(num_classes=k, num_points=p)

    def jtotal(c, m):
        out = jloss.mask2former_loss(c, m, jnp.asarray(lab),
                                     jax.random.PRNGKey(0), **kw)
        return sum(out.values()), out

    with fed(draws(31, b, k, p, stages), "jax"):
        (_, want), want_g = jax.jit(jax.value_and_grad(
            jtotal, argnums=(0, 1), has_aux=True))(
            [jnp.asarray(c) for c in cls], [jnp.asarray(m) for m in mask])
    tc = [torch.from_numpy(c).requires_grad_(True) for c in cls]
    tm = [torch.from_numpy(m).requires_grad_(True) for m in mask]
    counts = kernels.launch_counts()
    with fed(draws(31, b, k, p, stages), "torch"):
        got = m2f_loss.mask2former_loss(tc, tm, torch.from_numpy(lab), **kw)
    sum(got.values()).backward()
    assert kernels.launch_counts() == counts
    assert sorted(got) == sorted(want)   # jax returns the dict key-sorted
    assert list(got)[:3] == ["d0.loss_cls", "d0.loss_mask", "d0.loss_dice"]
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    for t, g in zip(tc + tm, want_g[0] + want_g[1]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0)


def test_query_labels_resolve_shared_queries_last_slot_first():
    """The scatter the JAX loss does with ``.at[].set`` on the CPU: where
    several gt slots name one query the last slot's value stands."""
    assign = np.array([[0, 0, 1, 0, 2], [3, 3, 0, 1, 3]])
    exists = np.array([[1, 1, 1, 0, 1], [1, 0, 1, 1, 1]], bool)
    value = np.where(exists, np.arange(5)[None], 5)
    want = np.asarray(jnp.full((2, 4), 5).at[
        jnp.arange(2)[:, None], jnp.asarray(assign)].set(jnp.asarray(value)))
    got = m2f_loss._query_labels(torch.from_numpy(assign),
                                 torch.from_numpy(exists), 4)
    np.testing.assert_array_equal(got.numpy(), want)
