"""The torch port's MiT backbone and DAFormer head against the JAX package's,
on the CPU.

Both sides are built from one seeded flax variables tree
(``state_dict_from_flax``), in fp32, atol 1e-4. Covered: MiT at
``smoke_tiny_daformer``'s dims (widths 8/16/32/64, one block a stage, heads
1/2/2/2, sr 4/2/1/1) at 64 x 96 and at 72 x 88, where stage 2's 9 x 11
map takes flax's asymmetric "SAME" padding before its stride-2 ``sr``
conv; DAFormer's head with ``fusion="aspp"`` (dilations 1/6/12/18, wider
than the map) and ``fusion="conv1"``; the dilated convolution's
space-to-batch form against the dilated ``F.conv2d``; MiT's gradients of
every parameter and of the image against ``jax.grad``; and the jax-free
``convert_mit`` against tools/convert_mit.py, bit-equal.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_clip import _close, _np
from test_torch_convert import _flat, _to_torch
from test_torch_rein import _variables
from vfmseg_tpu.models.backbones.mit import MixVisionTransformer as JaxMiT
from vfmseg_tpu.models.heads.daformer import DAFormerHead as JaxDAFormer
from vfmseg_tpu_torch.models.backbones.mit import MixVisionTransformer
from vfmseg_tpu_torch.models.common import Conv2d
from vfmseg_tpu_torch.models.heads.daformer import DAFormerHead
from vfmseg_tpu_torch.tools import convert_mit
from vfmseg_tpu_torch.train.checkpoint import load_pytree
from vfmseg_tpu_torch.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1),
            num_heads=(1, 2, 2, 2), sr_ratios=(4, 2, 1, 1))


@pytest.mark.parametrize("hw", [(64, 96), (72, 88)])
def test_mit_matches_jax(hw):
    jmit = JaxMiT(drop_path_rate=0.0, attn_impl="xla", **TINY)
    x = _np(1, (2,) + hw + (3,))
    variables = _variables(jmit, 2, jnp.asarray(x))
    want = jax.jit(jmit.apply)(variables, jnp.asarray(x))
    mit = MixVisionTransformer(drop_path_rate=0.0, **TINY).eval()
    mit.load_state_dict(state_dict_from_flax(variables, mit), strict=True)
    with torch.no_grad():
        got = mit(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"stage {i + 1} at {hw}")


@pytest.mark.parametrize("fusion", ["aspp", "conv1"])
def test_daformer_head_matches_jax(fusion):
    """Four maps of widths 8/16/32/64 at /4 .. /32 of a 64 x 96 image; 16
    channels, 5 classes; ASPP's 3x3 branches at dilations 6, 12 and 18 over
    a 16 x 24 map."""
    shapes = [(2, 16, 24, 8), (2, 8, 12, 16), (2, 4, 6, 32), (2, 2, 3, 64)]
    feats = tuple(_np(10 + i, s) for i, s in enumerate(shapes))
    kw = dict(in_channels=(8, 16, 32, 64), channels=16, num_classes=5,
              fusion=fusion, dropout_ratio=0.0)
    jhead = JaxDAFormer(**kw)
    jf = tuple(map(jnp.asarray, feats))
    variables = _variables(jhead, 3, jf)
    want = jax.jit(jhead.apply)(variables, jf)
    head = DAFormerHead(**kw)
    head.load_state_dict(state_dict_from_flax(variables, head), strict=True)
    assert (head.fuse_aspp is not None) == (fusion == "aspp")
    with torch.no_grad():
        got = head(tuple(map(torch.from_numpy, feats)))
    _close(got, want, 1e-4, fusion)


@pytest.mark.parametrize("d", [2, 12, 18])
@pytest.mark.parametrize("hw", [(16, 24), (13, 7)])
def test_dilated_conv_space_to_batch(d, hw):
    """A dilated "SAME" convolution runs as an undilated one over the d x d
    phases of the map (``Conv2d._space_to_batch``): equal to the dilated
    ``F.conv2d`` with padding d, also where d does not divide the map or
    exceeds it; fp32, atol 1e-6."""
    conv = Conv2d(5, 4, 3, padding="SAME", dilation=d)
    x = torch.from_numpy(_np(d, (2,) + hw + (5,)))
    with torch.no_grad():
        got = conv(x)
        want = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, 1,
                        d, d).permute(0, 2, 3, 1)
    _close(got, want.numpy(), 1e-6, f"d={d} {hw}")


def test_mit_gradients_match_jax():
    """The tiny MiT's gradients (every parameter and the image) of a fixed
    linear function of its four maps against ``jax.grad`` of the JAX
    module, at 72 x 88 (the asymmetric padding included): atol 1e-4 of the
    largest."""
    jmit = JaxMiT(drop_path_rate=0.0, attn_impl="xla", **TINY)
    x = _np(5, (2, 72, 88, 3))
    variables = _variables(jmit, 6, jnp.asarray(x))
    outs = jax.eval_shape(jmit.apply, variables, jnp.asarray(x))
    cot = [_np(20 + i, o.shape) for i, o in enumerate(outs)]

    def f(params, img):
        maps = jmit.apply({"params": params}, img)
        return sum(jnp.sum(m * c) for m, c in zip(maps, cot))

    jgrad, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))
    mit = MixVisionTransformer(drop_path_rate=0.0, **TINY).train()
    mit.load_state_dict(state_dict_from_flax(variables, mit), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    sum((m * torch.from_numpy(c)).sum()
        for m, c in zip(mit(tx), cot)).backward()
    want = state_dict_from_flax({"params": jgrad}, mit)
    scale = max(float(v.abs().max()) for v in want.values())
    assert want.keys() == {n for n, _ in mit.named_parameters()}
    for name, p in mit.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4 * scale, rtol=0, err_msg=name)
    _close(tx.grad, jgx, 1e-4 * float(np.abs(np.asarray(jgx)).max()), "x")


def _mit_sd(rs, dims=(8, 16, 32, 64), depths=(2, 1, 1, 1), srs=(4, 2, 1, 1)):
    sd = {"head.weight": rs.randn(5, dims[-1]), "head.bias": rs.randn(5)}
    cin = 3
    for i, (c, n, sr) in enumerate(zip(dims, depths, srs), start=1):
        k = 7 if i == 1 else 3
        p = f"patch_embed{i}."
        sd.update({p + "proj.weight": rs.randn(c, cin, k, k),
                   p + "proj.bias": rs.randn(c),
                   p + "norm.weight": rs.randn(c),
                   p + "norm.bias": rs.randn(c),
                   f"norm{i}.weight": rs.randn(c),
                   f"norm{i}.bias": rs.randn(c)})
        for j in range(n):
            b = f"block{i}.{j}."
            for ln in ("norm1", "norm2"):
                sd.update({b + ln + ".weight": rs.randn(c),
                           b + ln + ".bias": rs.randn(c)})
            for lin, out in (("attn.q", c), ("attn.kv", 2 * c),
                             ("attn.proj", c), ("mlp.fc1", 4 * c)):
                sd.update({b + lin + ".weight": rs.randn(out, c),
                           b + lin + ".bias": rs.randn(out)})
            sd.update({b + "mlp.fc2.weight": rs.randn(c, 4 * c),
                       b + "mlp.fc2.bias": rs.randn(c),
                       b + "mlp.dwconv.dwconv.weight": rs.randn(4 * c, 1, 3,
                                                                3),
                       b + "mlp.dwconv.dwconv.bias": rs.randn(4 * c)})
            if sr > 1:
                sd.update({b + "attn.sr.weight": rs.randn(c, c, sr, sr),
                           b + "attn.sr.bias": rs.randn(c),
                           b + "attn.norm.weight": rs.randn(c),
                           b + "attn.norm.bias": rs.randn(c)})
        cin = c
    return sd


def test_convert_mit_matches_jax_tool(tmp_path):
    """A MiT state dict (two blocks in stage 1, sr convs in stages 1-2, a
    classifier the converters drop) through both command lines: the same
    keys and every array equal bit for bit."""
    sd = _mit_sd(np.random.RandomState(7))
    src = str(tmp_path / "mit.pth")
    torch.save(_to_torch(sd), src)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert_mit.main([src, ours])
    argv = sys.argv
    sys.argv = ["convert_mit.py", src, theirs]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "convert_mit.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    got, want = _flat(load_pytree(ours)), _flat(load_pytree(theirs))
    assert got.keys() == want.keys()
    assert len(got) == 4 * 6 + 5 * 16 + 3 * 4
    for key, val in want.items():
        assert got[key].dtype == val.dtype and got[key].shape == val.shape
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert got["stage1_block0/mlp/dwconv/kernel"].shape == (3, 3, 1, 32)
