"""The port's weight converters against tools/convert_*.py (the JAX
package's), on the CPU.

Each side converts one synthetic torch checkpoint at toy widths (3 blocks,
width 32, a 14-pixel patch and a 5 x 5 position grid resized to 16 and
4 x 4) through its command line, writing the ``.npz`` in the JAX layout;
the files hold the same keys, the bicubic-resized arrays agree within atol
1e-5 and every other array is equal.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from vfmseg_tpu_torch.tools import convert_dinov2, convert_eva2, convert_sam
from vfmseg_tpu_torch.train.checkpoint import load_pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, BLOCKS, PATCH, GRID = 32, 3, 14, 5
TARGET_IMG = 64  # 4 x 4 patches of 16


def _dinov2_sd(rs):
    sd = {"cls_token": rs.randn(1, 1, DIM),
          "pos_embed": rs.randn(1, 1 + GRID * GRID, DIM),
          "mask_token": rs.randn(1, DIM),
          "patch_embed.proj.weight": rs.randn(DIM, 3, PATCH, PATCH),
          "patch_embed.proj.bias": rs.randn(DIM),
          "norm.weight": rs.randn(DIM), "norm.bias": rs.randn(DIM)}
    for i in range(BLOCKS):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": rs.randn(DIM),
                   b + "norm1.bias": rs.randn(DIM),
                   b + "norm2.weight": rs.randn(DIM),
                   b + "norm2.bias": rs.randn(DIM),
                   b + "ls1.gamma": rs.randn(DIM),
                   b + "ls2.gamma": rs.randn(DIM),
                   b + "attn.qkv.weight": rs.randn(3 * DIM, DIM),
                   b + "attn.qkv.bias": rs.randn(3 * DIM),
                   b + "attn.proj.weight": rs.randn(DIM, DIM),
                   b + "attn.proj.bias": rs.randn(DIM),
                   b + "mlp.fc1.weight": rs.randn(4 * DIM, DIM),
                   b + "mlp.fc1.bias": rs.randn(4 * DIM),
                   b + "mlp.fc2.weight": rs.randn(DIM, 4 * DIM),
                   b + "mlp.fc2.bias": rs.randn(DIM)})
    return sd


def _eva02_sd(rs):
    sd = {"cls_token": rs.randn(1, 1, DIM),
          "pos_embed": rs.randn(1, 1 + GRID * GRID, DIM),
          "patch_embed.proj.weight": rs.randn(DIM, 3, PATCH, PATCH),
          "patch_embed.proj.bias": rs.randn(DIM),
          "rope.freqs_cos": rs.randn(GRID * GRID, 8)}
    hidden = 86
    for i in range(BLOCKS):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": rs.randn(DIM),
                   b + "norm1.bias": rs.randn(DIM),
                   b + "norm2.weight": rs.randn(DIM),
                   b + "norm2.bias": rs.randn(DIM),
                   b + "attn.q_proj.weight": rs.randn(DIM, DIM),
                   b + "attn.k_proj.weight": rs.randn(DIM, DIM),
                   b + "attn.v_proj.weight": rs.randn(DIM, DIM),
                   b + "attn.q_bias": rs.randn(DIM),
                   b + "attn.v_bias": rs.randn(DIM),
                   b + "attn.proj.weight": rs.randn(DIM, DIM),
                   b + "attn.proj.bias": rs.randn(DIM),
                   b + "attn.rope.freqs_sin": rs.randn(GRID * GRID, 8),
                   b + "mlp.w1.weight": rs.randn(hidden, DIM),
                   b + "mlp.w1.bias": rs.randn(hidden),
                   b + "mlp.w2.weight": rs.randn(hidden, DIM),
                   b + "mlp.w2.bias": rs.randn(hidden),
                   b + "mlp.ffn_ln.weight": rs.randn(hidden),
                   b + "mlp.ffn_ln.bias": rs.randn(hidden),
                   b + "mlp.w3.weight": rs.randn(DIM, hidden),
                   b + "mlp.w3.bias": rs.randn(DIM)})
    return {"module": sd}


def _sam_sd(rs):
    sd = {"image_encoder.pos_embed": rs.randn(1, GRID, GRID, DIM),
          "image_encoder.patch_embed.proj.weight": rs.randn(DIM, 3, 16, 16),
          "image_encoder.patch_embed.proj.bias": rs.randn(DIM),
          "image_encoder.neck.0.weight": rs.randn(8, DIM, 1, 1),
          "prompt_encoder.pe_layer.gaussian": rs.randn(2, 8)}
    for i in range(BLOCKS):
        b = f"image_encoder.blocks.{i}."
        sd.update({b + "norm1.weight": rs.randn(DIM),
                   b + "norm1.bias": rs.randn(DIM),
                   b + "norm2.weight": rs.randn(DIM),
                   b + "norm2.bias": rs.randn(DIM),
                   b + "attn.qkv.weight": rs.randn(3 * DIM, DIM),
                   b + "attn.qkv.bias": rs.randn(3 * DIM),
                   b + "attn.proj.weight": rs.randn(DIM, DIM),
                   b + "attn.proj.bias": rs.randn(DIM),
                   b + "attn.rel_pos_h": rs.randn(27, 16),
                   b + "attn.rel_pos_w": rs.randn(27, 16),
                   b + "mlp.lin1.weight": rs.randn(4 * DIM, DIM),
                   b + "mlp.lin1.bias": rs.randn(4 * DIM),
                   b + "mlp.lin2.weight": rs.randn(DIM, 4 * DIM),
                   b + "mlp.lin2.bias": rs.randn(DIM)})
    return sd


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32))


CASES = {"dinov2": (_dinov2_sd, convert_dinov2, ["--target-patch", "16"]),
         "eva2": (_eva02_sd, convert_eva2, ["--target-patch", "16"]),
         "sam": (_sam_sd, convert_sam, [])}
RESIZED = ("pos_embed", "patch_embed/kernel")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("family", sorted(CASES))
def test_converter_matches_jax_tool(family, tmp_path):
    make, port_tool, flags = CASES[family]
    sd = make(np.random.RandomState(len(family)))
    src = str(tmp_path / "ckpt.pth")
    torch.save(_to_torch(sd), src)
    flags = [*flags, "--target-img", str(TARGET_IMG)]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port_tool.main([src, ours, *flags])
    argv = sys.argv
    sys.argv = [f"convert_{family}.py", src, theirs, *flags]
    try:
        runpy.run_path(os.path.join(REPO, "tools", f"convert_{family}.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    got, want = _flat(load_pytree(ours)), _flat(load_pytree(theirs))
    assert got.keys() == want.keys()
    assert len(got) == (3 if family == "sam" else 4) + BLOCKS * {
        "dinov2": 14, "eva2": 19, "sam": 14}[family]
    for key, val in want.items():
        assert got[key].dtype == val.dtype and got[key].shape == val.shape
        if key in RESIZED and family != "sam" or key == "pos_embed":
            np.testing.assert_allclose(got[key], val, atol=1e-5, rtol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)
    side = TARGET_IMG // 16
    if family == "sam":
        assert got["pos_embed"].shape == (1, side, side, DIM)
    else:
        assert got["pos_embed"].shape == (1, 1 + side * side, DIM)
        assert got["patch_embed/kernel"].shape == (16, 16, 3, DIM)
