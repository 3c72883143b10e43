"""The torch port's models against the JAX package's, on the CPU.

Both sides build the headline structure (or, through ``toy_config(family=
"eva02")``, the EVA02 one) at toy width from one config dict,
and the port loads the JAX variables through ``state_dict_from_flax``. The
variables are drawn from a numpy seed so that LoRA B, the BatchNorm
statistics and every other leaf are non-trivial. fp32; the JAX
side takes its plain paths on the CPU (xla_attention, _ln_reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.models.segmentors.ms_vfm import MsVFMSegmentor as JaxMsVFM
from vfmseg_tpu_torch.models.backbones.adapters import LoRALinear
from vfmseg_tpu_torch.models.build import build_segmentor, compute_attn_impl
from vfmseg_tpu_torch.models.presets import config
from vfmseg_tpu_torch.weights import init_params, state_dict_from_flax

ATOL = 1e-4
# the ported configs by backbone family
CONFIGS = {"dinov2": "dg_lora_dinov2_ms_masked",
           "eva02": "dg_lora_eva02_ms_masked",
           "sam": "dg_lora_sam_ms_masked"}


def toy_config(embed=64, depth=4, heads=4, rank=4, channels=32,
               family="dinov2"):
    """A ported config (the headline by default) with its widths cut: same
    structure, same types. EVA02's RoPE keeps its pretraining grid equal to
    the toy image's (64 / 16). SAM gets windows of 3 (so 4x4 and 4x8 grids
    pad them), global blocks 1 and 3, and rel-pos tables for a 128-pixel
    pretraining grid (15 rows, resized for the 4-row side of a grid)."""
    cfg = config(CONFIGS[family])
    m = cfg["model"]
    bb = m["backbone"]
    bb["backbone"].update(embed_dim=embed, depth=depth, num_heads=heads,
                          img_size=64, out_indices=list(range(depth))[-4:])
    if family == "eva02":
        bb["backbone"]["pt_hw_seq_len"] = 4
    if family == "sam":
        bb["backbone"].update(window_size=3, global_attn_indexes=[1, 3],
                              pretrain_img_size=128)
    bb["Lora_config"].update(r=rank, lora_alpha=2 * rank)
    m["decode_head"].update(in_channels=[embed] * 4, channels=channels)
    m["aux_head"].update(in_channels=[embed] * 4, channels=channels)
    m["aux_head"]["transformer"].update(query_dim=channels, n_heads=2,
                                        d_head=16)
    m["hr_crop_size"] = (64, 64)
    return cfg


def _leaf(path, shape, rng):
    """A seeded value for one JAX leaf, scaled by its role."""
    name = path[-1]
    n = rng.standard_normal(shape).astype(np.float32)
    if name == "kernel":
        return n * np.float32(np.prod(shape[:-1]) ** -0.5)
    if name == "scale":
        return 1.0 + 0.1 * n
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "lora_a":
        bound = shape[0] ** -0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if name == "gamma":
        return 0.1 + 0.02 * n
    if name in ("cls_token", "pos_embed"):
        return 0.02 * n
    if name == "mask_token":
        return n
    return 0.1 * n  # bias, BN mean, lora_b


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    return _leaf(path, tree.shape, rng)


def jax_model_and_variables(cfg, seed=0):
    """The JAX segmentor and seeded variables of its shapes: LoRA B, the
    BatchNorm statistics and LayerScale are all non-trivial. The model takes
    the config's ``compute.attn_impl``."""
    model = jax_build_segmentor(cfg["model"], dtype=jnp.float32,
                                attn_impl=cfg["compute"]["attn_impl"])
    img = jnp.zeros((1, 128, 128, 3), jnp.float32)
    lab = jnp.zeros((1, 128, 128), jnp.int32)
    rngs = {name: jax.random.PRNGKey(i) for i, name in
            enumerate(("params", "crop", "mask", "dropout"))}
    shapes = jax.eval_shape(lambda: model.init(rngs, img, lab))
    rng = np.random.RandomState(seed)
    return model, {col: _fill(dict(shapes[col]), rng)
                   for col in ("params", "batch_stats")}


def port_model(cfg, variables):
    model = build_segmentor(cfg["model"], dtype=torch.float32,
                            device="cpu", attn_impl=compute_attn_impl(cfg))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    cfg = toy_config()
    jmodel, variables = jax_model_and_variables(cfg)
    return cfg, jmodel, variables, port_model(cfg, variables)


def _img(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_vit_features(pair, hw):
    """Backbone features at the pos-embed's own grid and at an
    interpolated one (bicubic with the +0.1 trick)."""
    _cfg, jmodel, variables, model = pair
    x = _img(1, (2,) + hw + (3,))
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, x: m.backbone(x, deterministic=True)))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_lr_forward(pair):
    _cfg, jmodel, variables, model = pair
    x = _img(2, (1, 64, 128, 3))
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxMsVFM.lr_forward))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.lr_forward(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_hr_forward(pair):
    """Refine path with the decoder mask off, as stage 2 runs it."""
    _cfg, jmodel, variables, model = pair
    x = _img(3, (3, 64, 64, 3))
    ctx = _img(4, (3, 64, 64, 19)) * 2.0
    want = jax.jit(lambda v, x, c: jmodel.apply(
        v, x, c, False, False, method=JaxMsVFM.hr_forward))(
            variables, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = model.hr_forward(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_state_dict_covers_every_leaf(pair):
    """Every JAX leaf lands on a port tensor of the same size, and every
    port tensor comes from one."""
    _cfg, _jmodel, variables, model = pair
    sd = state_dict_from_flax(variables)
    own = model.state_dict()
    assert set(sd) == set(own)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_bn = len(variables["batch_stats"])
    assert len(sd) == n_leaves + n_bn  # + num_batches_tracked per BN
    for k, v in sd.items():
        assert v.shape == own[k].shape, k


def test_lora_fold_tracks_parameter_writes():
    """The folded LoRA weight is W + (alpha / r) B A, and a parameter
    written in place (as load_state_dict does) refreshes it."""
    lin = LoRALinear(8, 6, rank=2, alpha=4.0)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn(3, 8, generator=gen)

    def want():
        w = lin.weight + 2.0 * lin.lora_b @ lin.lora_a
        return x @ w.T + lin.bias

    with torch.no_grad():
        torch.testing.assert_close(lin(x), want())
        lin.lora_b.mul_(-3.0)
        torch.testing.assert_close(lin(x), want())


def test_init_params_is_seeded_and_nontrivial():
    cfg = toy_config()
    a = init_params(build_segmentor(cfg["model"], device="cpu"),
                    7).state_dict()
    b = init_params(build_segmentor(cfg["model"], device="cpu"),
                    7).state_dict()
    c = init_params(build_segmentor(cfg["model"], device="cpu"),
                    8).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k])
    assert any(not torch.equal(a[k], c[k]) for k in a if k.endswith("weight"))
    lora_b = [v for k, v in a.items() if k.endswith("lora_b")]
    assert lora_b and all(v.abs().sum() > 0 for v in lora_b)
    assert all(v.abs().sum() > 0 for k, v in a.items()
               if k.endswith("running_mean"))


# ------------------------------------------------- the builders' surface ----

def _with(cfg, path, value):
    """``cfg`` with ``value`` set at the ``/``-joined ``path`` of its model
    section."""
    node = cfg["model"]
    *parents, leaf = path.split("/")
    for part in parents:
        node = node[part]
    node[leaf] = value
    return cfg


@pytest.mark.parametrize("family,path,value,error", [
    ("dinov2", "backbone/backbone/not_a_key", 1, TypeError),
    ("sam", "backbone/backbone/use_checkpoint", True, TypeError),
    ("eva02", "backbone/backbone/xattn", True, TypeError),
    ("dinov2", "decode_head/not_a_key", 1, TypeError),
    ("dinov2", "aux_head/transformer/not_a_key", 1, TypeError),
    ("dinov2", "not_a_key", 1, TypeError),
    ("dinov2", "backbone/backbone/remat", True, NotImplementedError),
    ("sam", "backbone/backbone/remat", True, NotImplementedError),
])
def test_builders_refuse_keys_they_do_not_take(family, path, value, error):
    """A key that no builder uses or names as ignored raises, and so does
    the option the port does not implement (remat), where the builders used
    to drop them silently. The keys the JAX builders ignore
    by name build: DINOv2's block_chunks, a head's in_index."""
    with pytest.raises(error):
        build_segmentor(_with(toy_config(family=family), path, value)["model"],
                        device="cpu")
    cfg = _with(toy_config(), "backbone/backbone/block_chunks", 4)
    build_segmentor(_with(cfg, "decode_head/in_index", [0, 1, 2, 3])["model"],
                    device="cpu")


def test_attn_impl_is_taken_and_checked():
    """``compute.attn_impl`` reaches the backbone: "pallas_bias" puts every
    SAM block on the bias route and leaves DINOv2 on its one route (equal
    features to "auto"); "auto", "pallas" and "xla" take the default route;
    any other value raises."""
    cfg = toy_config(family="sam")
    for impl in ("auto", "pallas", "xla", "pallas_bias"):
        model = build_segmentor(cfg["model"], device="cpu", attn_impl=impl)
        assert [blk.attn.bias_route for blk in model.backbone.blocks] == (
            [impl == "pallas_bias"] * 4)
    with pytest.raises(ValueError, match="attn_impl"):
        build_segmentor(cfg["model"], device="cpu", attn_impl="flash")
    cfg = toy_config()
    img = torch.from_numpy(_img(5, (1, 64, 64, 3)))
    feats = []
    for impl in ("auto", "pallas_bias"):
        model = init_params(build_segmentor(cfg["model"], device="cpu",
                                            attn_impl=impl), 3)
        with torch.no_grad():
            feats.append(model.backbone(img))
    for a, b in zip(*feats):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_dinov2_drop_path_rate_reaches_the_blocks():
    """DINOv2's drop_path_rate goes to the ViT as in the JAX builder: each
    block's rate grows linearly over the depth to the configured one."""
    cfg = _with(toy_config(), "backbone/backbone/drop_path_rate", 0.3)
    model = build_segmentor(cfg["model"], device="cpu")
    rates = [blk.drop_path_rate for blk in model.backbone.blocks]
    np.testing.assert_allclose(rates, [0.0, 0.1, 0.2, 0.3], atol=1e-12)
    assert model.backbone.cfg.drop_path_rate == 0.3
