"""The port's jax-free tools:
``vfmseg_tpu_torch/tools/generate_full_weights.py`` against
tools/generate_full_weights.py (the same ``.npz``, key for key and bit for
bit), and ``vfmseg_tpu_torch/utils/profiling.py``'s trace and NaN
debugging (its ranges: tests/test_torch_spans.py)."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from vfmseg_tpu_torch.tools import generate_full_weights as gfw
from vfmseg_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(paths, seed):
    rs = np.random.RandomState(seed)
    return {p: rs.standard_normal(shape).astype(np.float32)
            for p, shape in paths.items()}


BACKBONE = {"patch_embed/kernel": (16, 16, 3, 8), "blocks_0/attn/qkv/kernel":
            (8, 24), "blocks_0/attn/qkv/bias": (24,), "cls_token": (1, 1, 8)}
# a trainable tree: LoRA under the backbone, and a head; one LoRA leaf path
# is also a backbone path, which the checkpoint must win
HEAD = {"decode_head/conv_seg/kernel": (1, 1, 8, 19),
        "decode_head/conv_seg/bias": (19,)}
LORA = {"blocks_0/attn/qkv/lora_a": (8, 4), "blocks_0/attn/qkv/lora_b":
        (4, 24), "blocks_0/attn/qkv/bias": (24,)}


def _case(root, wrapper, with_lora):
    """Write a checkpoint (under ``t/``, optionally nested under the
    DomainGeneral ``model/``) and a converted backbone; return their
    paths."""
    pre = "model/" if wrapper else ""
    t = dict(_leaves({f"{pre}{k}": v for k, v in HEAD.items()}, 1))
    if with_lora:
        t.update(_leaves({f"{pre}backbone/{k}": v for k, v in LORA.items()},
                         2))
    ckpt = os.path.join(root, "ckpt.trainable.npz")
    np.savez(ckpt, **{f"t/{k}": v for k, v in t.items()})
    bb = os.path.join(root, "backbone.npz")
    np.savez(bb, **_leaves(BACKBONE, 3))
    return ckpt, bb


@pytest.mark.parametrize("wrapper,with_lora", [
    (False, True), (True, True), (True, False)])
def test_generate_full_weights_equals_jax_tool(tmp_path, wrapper, with_lora,
                                               monkeypatch):
    """A bare segmentor's checkpoint; a DomainGeneral one (everything
    under ``model/``); and a DomainGeneral one whose trainable part holds
    no backbone entry (the backbone still nests under ``model/``): the
    port's file equals the JAX tool's bit for bit, the checkpoint's leaves
    winning where both hold a path."""
    ckpt, bb = _case(str(tmp_path), wrapper, with_lora)
    want_path = str(tmp_path / "jax.npz")
    monkeypatch.setattr(sys, "argv", [
        "generate_full_weights.py", "--checkpoint", ckpt, "--backbone", bb,
        "--out", want_path])
    runpy.run_path(os.path.join(REPO, "tools", "generate_full_weights.py"),
                   run_name="__main__")
    got_path = gfw.main(["--checkpoint", ckpt, "--backbone", bb, "--out",
                         str(tmp_path / "port.npz")])
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        pre = "model/backbone/" if wrapper else "backbone/"
        assert f"{pre}patch_embed/kernel" in got.files
        if with_lora:
            with np.load(ckpt) as c:
                np.testing.assert_array_equal(
                    got[f"{pre}blocks_0/attn/qkv/bias"],
                    c[f"t/{pre}blocks_0/attn/qkv/bias"])


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` profiles the enclosed code into ``trace.json``."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_nan_debugging_names_the_backward():
    """``enable_nan_debugging`` turns autograd's anomaly detection on (a
    NaN out of a backward function raises) and off again."""
    x = torch.zeros(1, requires_grad=True)
    try:
        profiling.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()

