"""The port's train CLI against tools/train.py (the JAX package's), on the
CPU.

Both CLIs train ``smoke_tiny_ms_masked`` for 3 steps over one PNG dataset
in the GTA layout (tools/make_synthetic_dataset.py), with Rare-Class
Sampling and photometric distortion on, one loader worker, a checkpoint and
a validation (``save_best synth_mIoU``) at step 2. Dropout, LoRA dropout
and the mask ratio are 0, the hr-crop box is fixed on both sides (as in
tests/test_torch_train.py), and the port's model starts from the JAX
CLI's initial variables (``port_model``). The batches are bit-equal
(tests/test_torch_train_data.py), so the steps' losses and ``grad_norm``,
the val line and the checkpoints agree.
"""

import itertools
import json
import os
import runpy
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_models import port_model
from vfmseg_tpu.train import checkpoint as jax_ckpt
from vfmseg_tpu.train import loop as jax_loop
from vfmseg_tpu.train.optim import merge_params
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.tools import train as port_cli
from vfmseg_tpu_torch.weights import flax_from_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# the hr crop's (y, x) offsets in units of crop_coord_divisible
CROP_YX = (1, 0)


def _overrides(root):
    val = [{"type": "GTADataset", "data_root": root, "key": "synth"}]
    return [f"data.source.data_root={root}", f"data.val={val}",
            "compute.data_parallel=1", "data.num_workers=1",
            "data.val_max_images=2", "schedule.log_interval=1",
            "schedule.checkpoint_interval=2", "schedule.val_interval=2",
            "schedule.save_best=synth_mIoU",
            "model.backbone.Lora_config.lora_dropout=0.0",
            "model.decode_head.dropout_ratio=0.0",
            "model.aux_head.dropout_ratio=0.0",
            "model.aux_head.transformer.dropout=0.0",
            "model.aux_head.transformer.mask_ratio=0.0"]


def _records(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _jax_randint(*args, **kwargs):
    return jnp.asarray(next(_jax_randint.values), jnp.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' work dirs, the JAX CLI's initial variables and the
    config's overrides."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "synth_gta")
    argv = sys.argv
    try:
        sys.argv = ["make_synthetic_dataset.py", root, "--n", "8", "--size",
                    "256"]
        runpy.run_path(os.path.join(REPO, "tools",
                                    "make_synthetic_dataset.py"),
                       run_name="__main__")
        overrides = _overrides(root)
        jdir, pdir = str(tmp / "jax"), str(tmp / "port")
        sys.argv = ["train.py", "smoke_tiny_ms_masked", "--work-dir", jdir,
                    "--max-iters", str(STEPS), "--cfg-options", *overrides]
        initial = {}
        real_loop = jax_loop.train_loop

        def capture(state, *args, **kwargs):
            params = merge_params(state.trainable, state.frozen)
            initial.update(jax.tree_util.tree_map(
                np.asarray, {"params": params,
                             "batch_stats": state.batch_stats}))
            return real_loop(state, *args, **kwargs)

        _jax_randint.values = itertools.cycle(CROP_YX)
        with mock.patch.object(jax_loop, "train_loop", capture), \
                mock.patch("jax.random.randint", _jax_randint):
            runpy.run_path(os.path.join(REPO, "tools", "train.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv

    def build_model(cfg, device, amp):
        assert device == "cpu" and not amp
        return port_model(cfg, initial)

    crop = itertools.cycle(CROP_YX)
    with mock.patch.object(port_cli, "build_model", build_model), \
            mock.patch.object(rng, "randint",
                              side_effect=lambda *a, **k: next(crop)):
        state = port_cli.main(["smoke_tiny_ms_masked", "--work-dir", pdir,
                               "--max-iters", str(STEPS), "--device", "cpu",
                               "--cfg-options", *overrides])
    return dict(jax=jdir, port=pdir, state=state, initial=initial,
                overrides=overrides, root=root, tmp=tmp)


def test_steps_match_jax_cli(runs):
    """Each step's loss entries and grad_norm at rtol 1e-4 (accuracies
    within 2 pixels of the 64 x 64 hr crop), every step logged."""
    want = [r for r in _records(runs["jax"]) if r["prefix"] == "train"]
    got = [r for r in _records(runs["port"]) if r["prefix"] == "train"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        keys = {k for k in w if k not in ("step", "prefix", "steps_per_sec")}
        assert keys == {k for k in g if k not in ("step", "prefix",
                                                  "steps_per_sec")}
        for k in keys:
            if "acc" in k:
                np.testing.assert_allclose(g[k], w[k],
                                           atol=2 * 100.0 / (2 * 64 * 64),
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert runs["state"].step == STEPS


def test_validation_matches_jax_cli(runs):
    """The step-2 val line (mIoU and aAcc of 2 images, and the mean)."""
    want = [r for r in _records(runs["jax"]) if r["prefix"] == "val"]
    got = [r for r in _records(runs["port"]) if r["prefix"] == "val"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2]
    assert got[0] == want[0]
    assert "synth_mIoU" in got[0]


# Conv biases that feed a normalisation over each channel alone in training
# mode (BatchNorm, or GroupNorm with one channel a group at these widths):
# the loss does not depend on them, so both sides' gradients there are fp32
# rounding residue, and AdamW turns residue of any size into steps of about
# lr. Each side's value is bounded by those steps instead.
NORM_FED_BIASES = ("t/aux_head/embed_conv1/bias", "t/aux_head/embed_conv2/bias",
                   "t/aux_head/embed_conv3/bias", "t/aux_head/fuse_conv/bias",
                   "t/decode_head/fusion_conv/bias", "t/decode_head/up1/bias")
LR = 1e-3  # smoke_tiny_ms_masked's


@pytest.mark.parametrize("name", ["iter_0000002.trainable.npz",
                                  "best.trainable.npz"])
def test_checkpoints_match_jax_cli(runs, name):
    """The step-2 checkpoint and the best one (step 2's) within atol 1e-5;
    the biases whose gradient is zero within 2 AdamW steps of their zero
    start on both sides."""
    want = _npz(os.path.join(runs["jax"], "checkpoints", name))
    got = _npz(os.path.join(runs["port"], "checkpoints", name))
    assert got.keys() == want.keys()
    assert set(NORM_FED_BIASES) <= want.keys()
    for k in want:
        if k in NORM_FED_BIASES:
            for side in (got[k], want[k]):
                assert np.abs(side).max() <= 2 * LR * 1.01, k
            continue
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)  # a copy, not a view of p
    return out


def _trainable_tree(model):
    return flax_from_state_dict(
        {n: p for n, p in model.named_parameters() if p.requires_grad}, model)


def test_resume_continues_at_the_checkpoint(runs):
    """--resume restores step 2 (trainable parameters bit-equal to the
    checkpoint) and trains step 3 only."""
    wdir = str(runs["tmp"] / "resumed")
    shutil.copytree(os.path.join(runs["port"], "checkpoints"),
                    os.path.join(wdir, "checkpoints"))
    ckpt = _npz(os.path.join(wdir, "checkpoints",
                             "iter_0000002.trainable.npz"))
    seen = {}
    make = port_cli.make_train_step

    def make_step():
        step = make()

        def first(state, batch, seed):
            if not seen:
                seen["step"] = state.step
                seen["t"] = _flat({"t": _trainable_tree(state.model)[
                    "params"]})
            return step(state, batch, seed)

        return first

    with mock.patch.object(port_cli, "make_train_step", make_step):
        state = port_cli.main(["smoke_tiny_ms_masked", "--work-dir", wdir,
                               "--resume", "--max-iters", str(STEPS),
                               "--device", "cpu",
                               "--cfg-options", *runs["overrides"]])
    assert seen["step"] == 2
    assert seen["t"].keys() == ckpt.keys()
    for k in ckpt:
        np.testing.assert_array_equal(seen["t"][k], ckpt[k], err_msg=k)
    assert [r["step"] for r in _records(wdir)
            if r["prefix"] == "train"] == [3]
    assert state.step == STEPS


def test_backbone_init_reads_a_jax_layout_npz(runs):
    """A backbone tree written by the JAX package's save_pytree lands in the
    frozen backbone, which training leaves as it was."""
    tree = jax.tree_util.tree_map(lambda x: 0.5 * x + 0.25,
                                  runs["initial"]["params"]["backbone"])
    path = str(runs["tmp"] / "backbone.npz")
    jax_ckpt.save_pytree(path, tree)
    state = port_cli.main(["smoke_tiny_ms_masked", "--work-dir",
                           str(runs["tmp"] / "bb"), "--max-iters", "1",
                           "--device", "cpu", "--backbone-init", path,
                           "--list-params",
                           "--cfg-options", *runs["overrides"]])
    frozen = {n: p for n, p in state.model.named_parameters()
              if n.startswith("backbone.") and not p.requires_grad}
    got = _flat(flax_from_state_dict(frozen, state.model)["params"][
        "backbone"])
    want = _flat(tree)
    assert len(got) > 10 and set(got) <= set(want)
    assert not any("lora" in k for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


