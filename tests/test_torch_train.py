"""The torch port's training slice against the JAX package's, on the CPU.

Both sides start from the same seeded weights (``test_torch_models``) at toy
width, in fp32. The JAX Pallas kernels of the training attention (the
forward with LSE and the qkv-direct backward) run in TPU interpret mode, as
tests/test_ops.py runs them; the port's CPU tensors take the plain versions
through the same autograd Functions that launch the CUDA kernels on a card.
Random draws are fed to both sides: the JAX ``jax.random`` calls and the
port's ``models/rng.py`` functions are patched to return the same numbers.
"""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from test_torch_models import jax_model_and_variables, port_model, toy_config
from vfmseg_tpu.models.backbones.adapters import LoRADense
from vfmseg_tpu.models.heads.linear_head import LinearHead as JaxLinearHead
from vfmseg_tpu.models.heads.transformer import (
    TransformerDecoder as JaxDecoder,
)
from vfmseg_tpu.models.losses import cross_entropy_loss as jax_ce
from vfmseg_tpu.models.losses import seg_accuracy as jax_acc
from vfmseg_tpu.ops.attention import xla_attention
from vfmseg_tpu.ops.flash_attention import flash_attention_qkv_tm
from vfmseg_tpu.ops.norm import _ln, _ln_reference
from vfmseg_tpu.train import checkpoint as jax_ckpt
from vfmseg_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
    partition_params,
    poly_schedule as jax_poly_schedule,
    trainable_predicate as jax_trainable_predicate,
)
from vfmseg_tpu.train.optim import decay_mask, merge_params
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.data.loader import InfiniteLoader
from vfmseg_tpu_torch.data.synthetic import SyntheticDataset
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.backbones.adapters import LoRALinear
from vfmseg_tpu_torch.models.heads.linear_head import LinearHead
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.models.heads.transformer import TransformerDecoder
from vfmseg_tpu_torch.models.losses import cross_entropy_loss, seg_accuracy
from vfmseg_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_fwd_lse_plain,
    multi_head_attention,
    multi_head_attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.norm import layer_norm
from vfmseg_tpu_torch.train.checkpoint import CheckpointManager
from vfmseg_tpu_torch.train.loop import train_loop
from vfmseg_tpu_torch.train.optim import (
    decays,
    partition,
    poly_schedule,
    trainable_predicate,
)
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step, step_generators
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    flax_name,
    init_params,
    state_dict_from_flax,
)

LORA_ONLY = tuple(toy_config()["peft"]["adapter_keywords"])


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def deterministic_config(family="dinov2"):
    """The toy config with every dropout, drop-path and the mask ratio at
    0."""
    cfg = toy_config(family=family)
    m = cfg["model"]
    m["backbone"]["Lora_config"]["lora_dropout"] = 0.0
    m["backbone"]["backbone"]["drop_path_rate"] = 0.0
    m["decode_head"]["dropout_ratio"] = 0.0
    m["aux_head"]["dropout_ratio"] = 0.0
    m["aux_head"]["transformer"].update(dropout=0.0, mask_ratio=0.0)
    return cfg


class TestAttentionTraining:
    B, N, H, D = 2, 37, 2, 16   # ragged N: one real row in the last tile

    def _qkv(self):
        return _np(60, (self.B, self.N, 3 * self.H * self.D))

    def test_fwd_lse_and_bwd_plain_match_jax(self):
        """The LSE twins against xla_attention, jax.nn.logsumexp and
        jax.vjp of xla_attention; fp32, atol 2e-4 (the repo's attention
        budget)."""
        b, n, h, d = self.B, self.N, self.H, self.D
        q, k, v = (_np(61 + i, (b, n, h, d)) for i in range(3))
        dout = _np(64, (b, n, h, d))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        want, vjp = jax.vjp(xla_attention, jq, jk, jv)
        want_grads = vjp(jnp.asarray(dout))
        logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * d ** -0.5
        want_lse = jax.nn.logsumexp(logits, axis=-1)

        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        out, lse = attention_fwd_lse_plain(tq, tk, tv)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=2e-4, rtol=0)
        grads = attention_bwd_plain(tq, tk, tv, out, lse,
                                    torch.from_numpy(dout))
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                       rtol=0)

    def test_fused_qkv_grad_matches_pallas_and_xla(self):
        """d(qkv) of the port's fused route (FusedQKVAttention: forward with
        LSE, the LSE/delta backward written into d(qkv)'s thirds) against
        jax.grad through the TPU kernels _fwd_kernel_qkv and
        _bwd_dq/_bwd_dkv_kernel_qkv in interpret mode, and through
        xla_attention; atol 2e-4."""
        b, n, h, d = self.B, self.N, self.H, self.D
        qkv = self._qkv()
        w = _np(65, (b, n, h * d))

        def f_flash(x):
            return jnp.sum(flash_attention_qkv_tm(x, h) * w)

        def f_xla(x):
            r = x.reshape(b, n, 3, h, d)
            return jnp.sum(xla_attention(r[:, :, 0], r[:, :, 1], r[:, :, 2])
                           .reshape(b, n, h * d) * w)

        with pltpu.force_tpu_interpret_mode():
            g_pallas = np.asarray(jax.grad(f_flash)(jnp.asarray(qkv)))
        g_xla = np.asarray(jax.grad(f_xla)(jnp.asarray(qkv)))

        t = torch.from_numpy(qkv).requires_grad_(True)
        counts = kernels.launch_counts()
        (multi_head_attention_qkv_tm(t, h) * torch.from_numpy(w)).sum() \
            .backward()
        assert kernels.launch_counts() == counts
        np.testing.assert_allclose(t.grad.numpy(), g_pallas, atol=2e-4,
                                   rtol=0)
        np.testing.assert_allclose(t.grad.numpy(), g_xla, atol=2e-4, rtol=0)

    def test_separate_qkv_grads_match_xla(self):
        """The decoder's route (QKVAttention, three gradients) against
        jax.grad of xla_attention; atol 2e-4."""
        b, n, h, d = self.B, self.N, self.H, self.D
        q, k, v = (_np(66 + i, (b, n, h, d)) for i in range(3))
        w = _np(69, (b, n, h, d))

        def f(q, k, v):
            return jnp.sum(xla_attention(q, k, v) * w)

        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        (multi_head_attention(*ts) * torch.from_numpy(w)).sum().backward()
        for t, g in zip(ts, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       atol=2e-4, rtol=0)


def test_layer_norm_backward_matches_jax():
    """The port's LayerNorm backward (``_ln_bwd_rule``) against jax.grad
    through the custom VJP of the TPU kernel (interpret mode) and through
    the reference; fp32, atol 1e-5."""
    x = _np(70, (2, 37, 96))
    w = _np(71, (96,), 0.1) + 1.0
    b = _np(72, (96,), 0.1)
    g = _np(73, (2, 37, 96))

    def f(fn):
        return lambda x, w, b: jnp.sum(fn(x, w, b, 1e-5) * g)

    args = tuple(map(jnp.asarray, (x, w, b)))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f(_ln), argnums=(0, 1, 2))(*args)
    ref = jax.grad(f(_ln_reference), argnums=(0, 1, 2))(*args)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    (layer_norm(*ts, 1e-5) * torch.from_numpy(g)).sum().backward()
    for t, wg, rg in zip(ts, want, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(rg), atol=1e-5,
                                   rtol=0)


def test_losses_count_ignored_pixels_in_the_mean():
    """cross_entropy_loss divides by all pixels, ignored ones included
    (avg_non_ignore=False), and accuracy counts only the valid ones; both
    against the JAX package at atol 1e-5. F.cross_entropy's mean over
    valid pixels gives another number."""
    logits = _np(80, (2, 9, 11, 19), 2.0)
    labels = np.random.RandomState(81).randint(0, 19, (2, 9, 11))
    labels[:, :3] = 255
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    ce = float(cross_entropy_loss(tl, tlab))
    acc = float(seg_accuracy(tl, tlab))
    np.testing.assert_allclose(ce, float(jax_ce(jnp.asarray(logits),
                                                jnp.asarray(labels))),
                               atol=1e-5)
    np.testing.assert_allclose(acc, float(jax_acc(jnp.asarray(logits),
                                                  jnp.asarray(labels))),
                               atol=1e-5)
    mean_valid = float(F.cross_entropy(tl.permute(0, 3, 1, 2), tlab,
                                       ignore_index=255))
    assert abs(mean_valid - ce) > 0.1 * ce


def test_linear_head_batch_stats_match_flax():
    """Training-mode LinearHead: output and the running statistics moved
    by momentum 0.9 towards the batch mean and biased variance, against
    flax's mutable=["batch_stats"]; fp32, atol 1e-4 (output) and 1e-5
    (statistics)."""
    c = 32
    jhead = JaxLinearHead(in_channels=(c,) * 4, channels=8, num_classes=5,
                          dropout_ratio=0.0)
    feats = tuple(_np(90 + i, (2, 4, 5, c)) for i in range(4))
    variables = jax.jit(jhead.init)(jax.random.PRNGKey(0),
                                    tuple(map(jnp.asarray, feats)))
    rs = np.random.RandomState(95)
    variables = jax.tree_util.tree_map(
        lambda a: (rs.standard_normal(a.shape) * 0.3).astype(np.float32)
        + (1.0 if a.ndim == 1 else 0.0), variables)
    want, new_state = jhead.apply(variables, tuple(map(jnp.asarray, feats)),
                                  train=True, mutable=["batch_stats"])

    head = LinearHead(in_channels=(c,) * 4, num_classes=5, dropout_ratio=0.0)
    head.load_state_dict(state_dict_from_flax(variables, head))
    head.train()
    got = head(tuple(map(torch.from_numpy, feats)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    bn = new_state["batch_stats"]["up_bn"]
    np.testing.assert_allclose(head.up_bn.running_mean.numpy(),
                               np.asarray(bn["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(head.up_bn.running_var.numpy(),
                               np.asarray(bn["var"]), atol=1e-5, rtol=0)


def test_lora_gradients_match_jax():
    """The sequential LoRA form: output and the gradients of x, W, b, A and
    B against jax.grad of LoRADense in training mode; fp32, atol 1e-5."""
    lin = LoRALinear(12, 10, rank=3, alpha=6.0)
    with torch.no_grad():
        for i, p in enumerate(lin.parameters()):
            p.copy_(torch.from_numpy(_np(100 + i, tuple(p.shape), 0.3)))
    params = flax_from_state_dict(dict(lin.named_parameters()), lin)["params"]
    x = _np(110, (4, 12))
    g = _np(111, (4, 10))
    jlin = LoRADense(features=10, rank=3, alpha=6.0, lora_dropout=0.0)

    def f(p, x):
        return jnp.sum(jlin.apply({"params": p}, x, deterministic=False) * g)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    lin.train()
    (lin(tx) * torch.from_numpy(g)).sum().backward()
    got = flax_from_state_dict({n: p.grad for n, p in
                                lin.named_parameters()}, lin)["params"]
    for (path, a), (_, b) in zip(sorted(_flat(got)),
                                 sorted(_flat(want_p))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=path)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               atol=1e-5, rtol=0)
    lin.eval()
    with torch.no_grad():
        folded = lin(tx)
    lin.train()
    torch.testing.assert_close(folded, lin(tx).detach(), atol=1e-5, rtol=0)


def _check_trainable_set_and_decay_mask(family):
    cfg = toy_config(family=family)
    _jmodel, variables = jax_model_and_variables(cfg)
    trainable, _frozen = partition_params(
        variables["params"], jax_trainable_predicate(
            adapter_keywords=LORA_ONLY))
    jax_mask = dict(_flat(decay_mask(trainable)))
    model = port_model(cfg, variables)
    ours = partition(model, trainable_predicate(adapter_keywords=LORA_ONLY))
    ours_paths = {flax_name(n, p.dim()): decays(n, p) for n, p in ours}
    assert ours_paths == {k: bool(v) for k, v in jax_mask.items()}
    assert any(ours_paths.values()) and not all(ours_paths.values())
    assert all("lora" in k for k in ours_paths if k.startswith("backbone/"))


def test_trainable_set_and_decay_mask_equal_jax():
    """partition() and decays() select what partition_params and decay_mask
    select on the same tree (the headline's lora-only PEFT)."""
    _check_trainable_set_and_decay_mask("dinov2")


def _check_flax_round_trip(family):
    cfg = toy_config(family=family)
    _jmodel, variables = jax_model_and_variables(cfg)
    model = port_model(cfg, variables)
    back = flax_from_state_dict(state_dict_from_flax(variables, model), model)
    for col in ("params", "batch_stats"):
        want = dict(_flat(variables[col]))
        got = dict(_flat(back[col]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "aux_head/transformer_decoder/mask_token" in dict(
        _flat(variables["params"]))
    return dict(_flat(variables["params"]))


def test_flax_round_trip_is_exact():
    """flax_from_state_dict inverts state_dict_from_flax on the training
    init's whole tree (mask_token included), leaf for leaf."""
    _check_flax_round_trip("dinov2")


def test_flax_round_trip_is_exact_eva02():
    """As the headline's, on the EVA02 tree: split q/k/v projections with
    their LoRA factors (k without bias), the SwiGLU's w1/w2/w3 and its
    ffn_ln, and no LayerScale."""
    params = _check_flax_round_trip("eva02")
    blk = "backbone/blocks_0/"
    for leaf in ("attn/q_proj/lora_a", "attn/k_proj/lora_b",
                 "attn/v_proj/bias", "attn/proj/lora_a", "mlp/w1/kernel",
                 "mlp/w2/bias", "mlp/ffn_ln/scale", "mlp/w3/kernel"):
        assert blk + leaf in params, leaf
    assert blk + "attn/k_proj/bias" not in params
    assert not any("/ls1/" in k or "/ls2/" in k for k in params)


def test_poly_schedule_matches_jax():
    for warm in (0, 5):
        ours = poly_schedule(1e-4, 0.9, 40, warmup_steps=warm)
        want = jax_poly_schedule(1e-4, 0.9, 40, warmup_steps=warm)
        for step in (0, 1, 3, 5, 20, 39, 40, 50):
            np.testing.assert_allclose(ours(step), float(want(step)),
                                       rtol=1e-6, atol=1e-12)


def _batch(seed=3, hw=(128, 128)):
    rs = np.random.RandomState(seed)
    img = rs.standard_normal((2,) + hw + (3,)).astype(np.float32)
    label = rs.randint(0, 19, (2,) + hw).astype(np.int32)
    label[:, :, :9] = 255
    return {"img": img, "label": label}


def _patched_randint(values):
    vals = list(values)
    return lambda *args, **kwargs: jnp.asarray(vals.pop(0), jnp.int32)


def _check_train_step(family, seed=2, attn_impl="auto"):
    """One train step of the toy ``family`` segmentor, both packages on the
    ``attn_impl`` route, held to each other; returns the port's metrics."""
    cfg = deterministic_config(family)
    cfg["compute"]["attn_impl"] = attn_impl
    jmodel, variables = jax_model_and_variables(cfg, seed=seed)
    batch = _batch()
    trainable, frozen = partition_params(
        variables["params"], jax_trainable_predicate(
            adapter_keywords=LORA_ONLY))
    lr = 1e-4
    tx = jax_make_optimizer(trainable, base_lr=lr, max_steps=100)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                           frozen=frozen,
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(trainable))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(t):
        out, _ = jmodel.apply(
            {"params": merge_params(t, frozen),
             "batch_stats": variables["batch_stats"]},
            jbatch["img"], jbatch["label"],
            rngs={n: jax.random.PRNGKey(i) for i, n in
                  enumerate(("crop", "mask", "dropout"))},
            mutable=["batch_stats"])
        return sum(v for k, v in out.items() if "loss" in k)

    with mock.patch("jax.random.randint", _patched_randint([1, 0] * 2)):
        new_jstate, jmetrics = jax_make_train_step(jmodel, tx, donate=False)(
            jstate, jbatch, jax.random.PRNGKey(0))
        jgrads = jax.jit(jax.grad(loss_fn))(trainable)

    model = port_model(cfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg["optimizer"]["lr"] = lr
    state = create_train_state(model, cfg, max_iters=100)
    counts = kernels.launch_counts()
    with mock.patch.object(rng, "randint", side_effect=[1, 0]):
        state, metrics = make_train_step()(state, batch, 0)
    assert kernels.launch_counts() == counts
    assert state.step == 1 and int(new_jstate.step) == 1

    pixels = 2 * 64 * 64
    for key, want in jmetrics.items():
        got = float(metrics[key])
        if "acc" in key:
            np.testing.assert_allclose(got, float(want),
                                       atol=2 * 100.0 / pixels, err_msg=key)
        else:
            np.testing.assert_allclose(got, float(want), rtol=1e-4,
                                       err_msg=key)

    want_g = {k: v.numpy() for k, v in
              state_dict_from_flax({"params": jgrads}, model).items()}
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    own = model.state_dict()
    want_p = state_dict_from_flax({"params": new_jstate.trainable,
                                   "batch_stats": new_jstate.batch_stats},
                                  model)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and torch.equal(own[name], before[name])
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[name],
                                   atol=1e-4 * scale, rtol=0, err_msg=name)
        got_u = (own[name] - before[name]).numpy()
        want_u = (want_p[name] - before[name]).numpy()
        signal = np.abs(want_g[name]) > 1e-6 * scale
        np.testing.assert_allclose(got_u[signal], want_u[signal], atol=2e-6,
                                   rtol=0, err_msg=name)
        bound = lr * (1 + 1e-3) + lr * 0.05 * np.abs(before[name].numpy())
        assert (np.abs(got_u) <= bound).all(), name
        assert (np.abs(want_u) <= bound).all(), name
    for name, want in want_p.items():
        if "running" in name:
            np.testing.assert_allclose(own[name].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)
    return metrics


def test_train_step_matches_jax():
    """One whole train step from the same weights against the JAX
    make_train_step, with dropout and the mask ratio at 0 and the crop box
    fixed at (y1, x1) = (32, 0) on both sides: loss entries and grad_norm
    (rtol 1e-4; accuracy within 2 pixels), every trainable gradient (atol
    1e-4 of the largest) and the BatchNorm statistics (atol 1e-5). The
    parameter updates agree within 2e-6 (2% of one Adam step at lr 1e-4)
    wherever the gradient stands above 1e-6 of the largest; below that it
    is rounding noise (a bias ahead of a one-channel GroupNorm group has an
    exact gradient of 0), which Adam's first step scales to +-lr on either
    side, so there both updates are only held to |update| <= lr (+ decay)."""
    _check_train_step("dinov2")


def test_train_step_matches_jax_eva02():
    """As the headline's, on the EVA02 backbone with drop-path at 0: the
    training route (per-slot projections, RoPE in PyTorch, the head-major
    attention's autograd Function on its CPU twins) against JAX's
    head-major route with the _flash_hm custom VJP; same bounds."""
    _check_train_step("eva02")


class TestRandomStreams:
    def _decoder_pair(self):
        kw = dict(query_dim=32, img_feat_dim=32, n_heads=2, d_head=16,
                  depth=1, dropout=0.1, mask_ratio=0.2)
        jdec = JaxDecoder(**kw)
        q = _np(120, (2, 4, 4, 32))
        ctx = _np(121, (2, 4, 4, 32))
        rngs = {n: jax.random.PRNGKey(i)
                for i, n in enumerate(("params", "mask", "dropout"))}
        variables = jdec.init(rngs, jnp.asarray(q), jnp.asarray(ctx),
                              train=True)
        variables = jax.tree_util.tree_map(
            lambda a: a + 0.1 * _np(122, a.shape), variables)
        dec = TransformerDecoder(**kw)
        dec.load_state_dict(state_dict_from_flax(variables, dec))
        return jdec, variables, dec, q, ctx

    def test_mask_swap_and_dropout_given_one_keep_mask(self):
        """The training decoder (mask-token swap, then dropout after both
        to_out projections and the GEGLU) with the same keep masks on both
        sides; fp32, atol 1e-4."""
        jdec, variables, dec, q, ctx = self._decoder_pair()
        rs = np.random.RandomState(123)
        u_mask = rs.uniform(size=(2, 4, 4, 1)).astype(np.float32)
        shapes = [(2, 16, 32), (2, 16, 32), (2, 16, 128)]
        keeps = [rs.uniform(size=s) < 0.9 for s in shapes]

        jkeeps = [jnp.asarray(k) for k in keeps]
        with mock.patch("jax.random.uniform",
                        lambda *a, **k: jnp.asarray(u_mask)), \
                mock.patch("jax.random.bernoulli",
                           lambda *a, **k: jkeeps.pop(0)):
            want = jdec.apply(variables, jnp.asarray(q), jnp.asarray(ctx),
                              train=True, mask_enable=True,
                              rngs={"mask": jax.random.PRNGKey(0),
                                    "dropout": jax.random.PRNGKey(1)})
        assert not jkeeps

        draws = [u_mask] + [np.where(k, 0.0, 0.95).astype(np.float32)
                            for k in keeps]

        def uniform(name, shape, device):
            u = draws.pop(0)
            assert tuple(u.shape) == tuple(shape)
            assert name == ("mask" if u is u_mask else "dropout")
            return torch.from_numpy(u)

        dec.train()
        with mock.patch.object(rng, "uniform", uniform):
            got = dec(torch.from_numpy(q), torch.from_numpy(ctx),
                      mask_enable=True)
        assert not draws
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
        assert float((u_mask <= 0.2).mean()) > 0

    def test_seeded_draw_rates(self):
        """From the step's seeded generators: dropout at rate 0.1 zeroes
        10% and scales the rest by 1/0.9; the mask rule keeps 80%; the crop
        offsets cover their range; within 5 sigma of 4e5 draws."""
        gens = step_generators(0, 7, torch.device("cpu"))
        x = torch.ones(400_000)
        with rng.streams(gens):
            y = rng.dropout(x, 0.1, training=True)
            keep = rng.uniform("mask", (400_000,), x.device) > 0.2
            offsets = {rng.randint("crop", 4) for _ in range(200)}
        sigma = (0.09 / 4e5) ** 0.5
        assert abs(float((y == 0).float().mean()) - 0.1) < 5 * sigma
        assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
        assert abs(float(keep.float().mean()) - 0.8) < 5 * (0.16 / 4e5) ** 0.5
        assert offsets == {0, 1, 2, 3}
        with pytest.raises(RuntimeError, match="stream"):
            rng.dropout(x, 0.1, training=True)

    def test_step_generators_depend_on_seed_step_and_name(self):
        a = step_generators(0, 3, torch.device("cpu"))
        b = step_generators(0, 3, torch.device("cpu"))
        c = step_generators(0, 4, torch.device("cpu"))
        draw = {n: torch.rand(4, generator=g) for n, g in a.items()}
        assert all(torch.equal(draw[n], torch.rand(4, generator=g))
                   for n, g in b.items())
        assert not any(torch.equal(draw[n], torch.rand(4, generator=g))
                       for n, g in c.items())
        assert not torch.equal(draw["mask"], draw["dropout"])


def _toy_state(cfg, seed=0):
    model = init_params(build_segmentor(cfg["model"], device="cpu"), seed)
    cfg = dict(cfg, optimizer=dict(cfg["optimizer"], lr=1e-3))
    return create_train_state(model, cfg, max_iters=10)


def test_resume_is_exact(tmp_path):
    """2 steps, save, a fresh state restored, 2 more steps equals 4 unbroken
    steps, bit for bit: dropout, LoRA dropout and the mask ratio on, one
    loader worker, the resumed loader advanced past the 2 batches used. The
    fresh state's trainable parameters and statistics are zeroed first, so
    only the checkpoint can bring them back; its frozen backbone is the
    seeded one, as a light checkpoint expects."""
    cfg = toy_config()
    ds = SyntheticDataset(n=6, hw=(128, 128), num_classes=19, seed=0)
    quiet = dict(log_interval=1)

    def loader():
        return InfiniteLoader(ds, batch_size=2, num_workers=1, seed=0)

    full = loader()
    state_a = train_loop(_toy_state(cfg), make_train_step(), full,
                         max_iters=4, work_dir=str(tmp_path / "a"), seed=5,
                         checkpoint_interval=0, **quiet)
    full.close()

    first = loader()
    train_loop(_toy_state(cfg), make_train_step(), first, max_iters=2,
               work_dir=str(tmp_path / "b"), seed=5, checkpoint_interval=2,
               **quiet)
    first.close()
    second = loader()
    next(second), next(second)
    fresh = _toy_state(cfg)
    with torch.no_grad():
        for name, t in fresh.model.state_dict(keep_vars=True).items():
            if getattr(t, "requires_grad", False) or "running" in name:
                t.zero_()
    state_b = train_loop(fresh, make_train_step(), second,
                         max_iters=4, work_dir=str(tmp_path / "b"), seed=5,
                         checkpoint_interval=0, resume=True, **quiet)
    second.close()

    assert state_a.step == state_b.step == 4
    sd_a, sd_b = state_a.model.state_dict(), state_b.model.state_dict()
    trained = [n for n, p in state_a.model.named_parameters()
               if p.requires_grad] + [n for n in sd_a if "running" in n]
    for name in trained:
        assert torch.equal(sd_a[name], sd_b[name]), name

    def lines(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f]
        return [{k: v for k, v in r.items() if k != "steps_per_sec"}
                for r in recs]

    assert lines(tmp_path / "a")[2:] == lines(tmp_path / "b")[2:]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port's checkpoint files are read by the JAX CheckpointManager,
    and JAX-written trainable/batch_stats npz files load into the port,
    leaf for leaf."""
    cfg = toy_config()
    jmodel, variables = jax_model_and_variables(cfg, seed=4)
    pred = jax_trainable_predicate(adapter_keywords=LORA_ONLY)
    trainable, frozen = partition_params(variables["params"], pred)

    # JAX -> port
    jdir = tmp_path / "jax"
    (jdir / "checkpoints").mkdir(parents=True)
    jax_ckpt.save_pytree(str(jdir / "checkpoints/iter_0000005.trainable.npz"),
                         {"t": trainable})
    jax_ckpt.save_pytree(
        str(jdir / "checkpoints/iter_0000005.batch_stats.npz"),
        {"b": variables["batch_stats"]})
    state = _toy_state(cfg, seed=9)
    state = CheckpointManager(str(jdir)).restore(state)
    assert state.step == 5
    want = state_dict_from_flax({"params": trainable,
                                 "batch_stats": variables["batch_stats"]},
                                state.model)
    own = state.model.state_dict()
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(own[name], w, atol=0, rtol=0)

    # port -> JAX
    state.step = 7
    CheckpointManager(str(tmp_path / "port")).save(state)
    tx = jax_make_optimizer(trainable)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, trainable)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), trainable=zeros,
                           frozen=frozen,
                           batch_stats=jax.tree_util.tree_map(
                               jnp.zeros_like, variables["batch_stats"]),
                           opt_state=tx.init(trainable))
    restored = jax_ckpt.CheckpointManager(str(tmp_path / "port")).restore(
        jstate)
    assert int(restored.step) == 7
    for col, tree in (("t", trainable), ("b", variables["batch_stats"])):
        got = dict(_flat(restored.trainable if col == "t"
                         else restored.batch_stats))
        for k, w in _flat(tree):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
