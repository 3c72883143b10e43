"""The torch port's DACS step, its EMA checkpoint and its train CLI against
the JAX package's, on the CPU.

Both packages start from one seeded flax variables tree, in fp32, with
dropout off; the augment stream's draws (ClassMix scores, the jitter coin
and factors, the blur coin and sigma) are fed to both
(``test_torch_algorithms.fed_augment``): JAX's jitted step draws them once
at its trace, so the port's steps draw the same numbers every step. Two
steps of each package's DACS step:

* on the batched path (``smoke_tiny_uda``: exactly ``EncoderDecoder``, the
  source and mixed images through one 2B forward, one BatchNorm moment)
  and on the sequential one (``smoke_tiny_hrda``: two forwards, the mixed
  one pixel-weighted, the HR crop's weight cut from the same box, the crop
  origins fed to both);
* at a ``pseudo_threshold`` set between two of the teacher's top
  probabilities near their median, so that ``0 < pseudo_weight < 1``;
* held to: every loss entry at rtol 1e-4 (accuracies within 2 pixels),
  ``pseudo_weight`` within one pixel's share, each step's trainable
  gradients within 2e-4 of the largest, the BatchNorm statistics at atol
  1e-5, and the EMA head after two steps at rtol 1e-5 wherever both steps'
  gradients stand above 4e-4 of the largest (elsewhere the gradient is
  rounding noise, which AdamW turns into steps of +-lr of either sign, so
  there the two EMAs are held to within those steps of each other).

Then the debug function's tensors, the EMA's first two moves, the ``ema``
checkpoint crossing both ways, and the port's train CLI
against tools/train.py on ``smoke_tiny_uda`` for 2 steps (losses rtol 1e-4,
the step-2 EMA checkpoints), and the port's CLI training
``smoke_tiny_dg_maskloss`` with ``--backbone-init`` under ``model/``.
"""

import itertools
import json
import os
import runpy
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_algorithms import (
    check_metrics,
    fed_augment,
    jax_state,
    pair,
    scalars,
)
from test_torch_clip import _deterministic
from test_torch_models import port_model
from vfmseg_tpu.core.config import load_config as jax_load_config
from vfmseg_tpu.train import checkpoint as jax_ckpt
from vfmseg_tpu.train import loop as jax_loop
from vfmseg_tpu.train.optim import merge_params
from vfmseg_tpu.train.uda import DACSConfig as JaxDACSConfig
from vfmseg_tpu.train.uda import make_dacs_debug_fn as jax_debug_fn
from vfmseg_tpu.train.uda import make_dacs_train_step as jax_dacs_step
from vfmseg_tpu_torch.core.config import load_config
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import EncoderDecoder
from vfmseg_tpu_torch.models.segmentors.hrda import HRDAEncoderDecoder
from vfmseg_tpu_torch.tools import train as port_cli
from vfmseg_tpu_torch.train.checkpoint import CheckpointManager
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.uda import (
    DACSConfig,
    init_ema,
    make_dacs_debug_fn,
    make_dacs_train_step,
    teacher_logits,
)
from vfmseg_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
HW = (128, 128)


def uda_batch(seed, hw=HW):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (2,) + hw).astype(np.int32)
    label[label == 7] = 8          # an absent class
    label[:, :, :5] = 255
    return {"img": rs.standard_normal((2,) + hw + (3,)).astype(np.float32),
            "label": label,
            "target_img": rs.standard_normal((2,) + hw + (3,)).astype(
                np.float32)}


def step_draws(seed):
    """One DACS step's augment draws: the ClassMix scores, the jitter coin
    (on), the four factors, the blur coin (on) and sigma."""
    return [np.random.RandomState(seed).uniform(size=(2, 19)).astype(
        np.float32)] + scalars(0.7, 0.8, 0.3, 0.6, 0.9, 0.9, 0.4)


def calibrated_threshold(model, batch):
    """A threshold between two of the teacher's top probabilities on the
    target (the EMA head equal to the student's), near their median, in
    the widest gap between the 40th and 60th percentiles."""
    with torch.no_grad():
        probs = torch.softmax(teacher_logits(
            model, init_ema(model), torch.from_numpy(batch["target_img"])),
            dim=-1)
    top = np.sort(probs.amax(-1).numpy().ravel())
    lo, hi = int(0.4 * top.size), int(0.6 * top.size)
    i = lo + int(np.argmax(np.diff(top[lo:hi])))
    return float((top[i] + top[i + 1]) / 2)


def _configs(name):
    jcfg, cfg = jax_load_config(name), load_config(name)
    for c in (jcfg, cfg):
        _deterministic(c["model"])
        heads = [c["model"]["decode_head"]]
        if "seg_head" in heads[0]:
            heads = [heads[0]["seg_head"], heads[0]["single_scale_head"]]
        for head in heads:
            head["dropout_ratio"] = 0.0
    return jcfg, cfg


def _grads(model, tree):
    return {k: v.numpy() for k, v in
            state_dict_from_flax({"params": tree}, model).items()}


def _check_state(model, state, jstate, jgrads, scale):
    """The BatchNorm statistics (atol 1e-5) and the EMA head: rtol 1e-5
    where every gradient so far stands above 4e-4 of the largest; within
    two AdamW steps elsewhere."""
    own = model.state_dict()
    for n, want in state_dict_from_flax(
            {"batch_stats": jstate.batch_stats}, model).items():
        if "running" in n:
            np.testing.assert_allclose(own[n].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0, err_msg=n)
    want_ema = state_dict_from_flax({"params": {"decode_head": jstate.ema}},
                                    model)
    assert want_ema.keys() == state.ema.keys()
    for n, want in want_ema.items():
        got, want = state.ema[n].numpy(), want.numpy()
        if n not in jgrads[0]:          # a frozen head parameter
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=n)
            continue
        signal = np.all([np.abs(g[n]) > 4e-4 * scale for g in jgrads],
                        axis=0)
        np.testing.assert_allclose(got[signal], want[signal], rtol=1e-5,
                                   atol=1e-7, err_msg=n)
        np.testing.assert_allclose(got, want, atol=2 * LR * 1.01, rtol=0,
                                   err_msg=n)


def _synced(jstate, model, state):
    """The JAX state with the port's trainable parameters, BatchNorm
    statistics and EMA (its Adam moments its own)."""
    trainable = flax_from_state_dict(
        {n: p for n, p in model.named_parameters() if p.requires_grad},
        model)["params"]
    stats = flax_from_state_dict(
        {n: b for n, b in model.named_buffers() if "running" in n},
        model)["batch_stats"]
    ema = flax_from_state_dict(state.ema, model)["params"]["decode_head"]
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    assert (jax.tree_util.tree_structure(as_jax(trainable))
            == jax.tree_util.tree_structure(jstate.trainable))
    return jstate.replace(trainable=as_jax(trainable),
                          batch_stats=as_jax(stats), ema=as_jax(ema))


@pytest.mark.parametrize("name,crops", [("smoke_tiny_uda", []),
                                        ("smoke_tiny_hrda", [3, 5, 3, 5])])
def test_dacs_steps_match_jax(name, crops):
    """Two DACS steps of each package (module doc); ``smoke_tiny_uda``
    takes the batched path, ``smoke_tiny_hrda`` the sequential one. Before
    step 2 the JAX state takes the port's parameters, statistics and EMA
    after step 1 (its Adam moments stay its own), so that step 2 starts
    from one state: AdamW turns the rounding noise of a gradient that is
    zero in exact arithmetic (a bias ahead of a BatchNorm) into a step of
    +-lr of either sign, and the teacher, in eval mode, reads such a bias
    through the running statistics, which moves top probabilities across
    the threshold."""
    jcfg, cfg = _configs(name)
    batch = uda_batch(40)
    jmodel, variables, model = pair(jcfg, cfg, 41, HW,
                                    ("crop", "mask", "dropout"))
    assert (type(model) is EncoderDecoder) == (name == "smoke_tiny_uda")
    kw = dict(pseudo_threshold=calibrated_threshold(model, batch),
              psweight_ignore_top=4, psweight_ignore_bottom=8)
    draws = step_draws(42)

    tx, jstate = jax_state(jcfg, variables, LR)
    head = merge_params(jstate.trainable, jstate.frozen)["decode_head"]
    jstate = jstate.replace(ema=jax.tree_util.tree_map(jnp.array, head))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax_dacs_step(jmodel, tx, JaxDACSConfig(**kw), donate=False)
    cfg["optimizer"]["lr"] = LR
    state = create_train_state(model, cfg, max_iters=100)
    state.ema = init_ema(model)
    step = make_dacs_train_step(DACSConfig(**kw))
    pixels = batch["label"].size
    jcrops = list(crops) * 2  # JAX traces once, or twice at most
    jgrads = []
    for i in range(2):
        # JAX draws at its trace (the first call); the port every step
        with fed_augment(draws, "jax", repeat=2, drawn_all=False), \
                mock.patch("jax.random.randint", lambda *a, **k: jnp.asarray(
                    jcrops.pop(0), jnp.int32)):
            jstate, want = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        jgrads.append(_grads(model, jstate.opt_state[0]))
        scale = max(float(np.abs(g).max()) for g in jgrads[0].values())
        with fed_augment(draws, "torch"), mock.patch.object(
                rng, "randint", side_effect=list(crops)):
            state, metrics = step(state, batch, 0)
        pw = float(want["pseudo_weight"])
        assert 0.0 < pw < 1.0
        assert abs(float(metrics["pseudo_weight"]) - pw) <= 1.0 / pixels
        assert any(k.startswith("mix.") and "loss" in k and float(v) > 0
                   for k, v in metrics.items())
        check_metrics(metrics, want, pixels)
        assert jgrads[-1].keys() == {n for n, p in model.named_parameters()
                                     if p.requires_grad}
        for n, p in model.named_parameters():
            if p.requires_grad:
                np.testing.assert_allclose(p.grad.numpy(), jgrads[-1][n],
                                           atol=2e-4 * scale, rtol=0,
                                           err_msg=n)
        _check_state(model, state, jstate, jgrads, scale)
        if i == 0:
            jstate = _synced(jstate, model, state)
    assert state.step == 2


def test_debug_fn_matches_jax():
    """``make_dacs_debug_fn``: the teacher's pseudo-labels, the ClassMix
    mask, the mixed image, labels and weights and the teacher's entropy,
    the draws fed to both, against JAX's ``make_dacs_debug_fn`` (atol
    1e-5; labels and masks exactly)."""
    jcfg, cfg = _configs("smoke_tiny_uda")
    batch = uda_batch(47)
    jmodel, variables, model = pair(jcfg, cfg, 48, HW,
                                    ("crop", "mask", "dropout"))
    kw = dict(pseudo_threshold=calibrated_threshold(model, batch),
              psweight_ignore_top=4, psweight_ignore_bottom=8)
    draws = step_draws(49)
    _, jstate = jax_state(jcfg, variables, LR)
    head = merge_params(jstate.trainable, jstate.frozen)["decode_head"]
    jstate = jstate.replace(ema=head)
    with fed_augment(draws, "jax"):
        want = jax_debug_fn(jmodel, JaxDACSConfig(**kw))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
    state = create_train_state(model, cfg, max_iters=10)
    state.ema = init_ema(model)
    with fed_augment(draws, "torch"):
        got = make_dacs_debug_fn(DACSConfig(**kw))(state, batch, 0)
    assert got.keys() == want.keys()
    for k in ("mixed_lbl", "pseudo_label", "mix_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("mixed_img", "mixed_weight", "pseudo_weight", "entropy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert 0.0 < float(got["pseudo_weight"]) < 1.0


def test_first_steps_move_the_ema():
    """Step 0 copies the updated head into the EMA (alpha 0); step 1
    averages it with the next head (alpha 0.5); the EMA is a copy, never
    the head's storage."""
    cfg = load_config("smoke_tiny_uda")
    _, _, model = pair(jax_load_config("smoke_tiny_uda"), cfg, 43, HW,
                       ("crop", "mask", "dropout"))
    state = create_train_state(model, cfg, max_iters=100)
    state.ema = init_ema(model)
    head = dict(model.decode_head.named_parameters())
    assert all(state.ema[f"decode_head.{n}"].data_ptr() != p.data_ptr()
               for n, p in head.items())
    step = make_dacs_train_step(DACSConfig(pseudo_threshold=0.0))
    batch = uda_batch(44)
    state, _ = step(state, batch, 0)
    after0 = {n: p.detach().clone() for n, p in head.items()}
    for n, p in after0.items():
        assert torch.equal(state.ema[f"decode_head.{n}"], p), n
    state, _ = step(state, batch, 0)
    for n, p in head.items():
        want = after0[n] * 0.5 + p.detach() * 0.5
        torch.testing.assert_close(state.ema[f"decode_head.{n}"], want,
                                   rtol=1e-6, atol=1e-7)


def _jax_uda_state(seed=45):
    jcfg = jax_load_config("smoke_tiny_uda")
    _, variables, model = pair(jcfg, load_config("smoke_tiny_uda"), seed,
                               HW, ("crop", "mask", "dropout"))
    tx, jstate = jax_state(jcfg, variables, LR)
    head = merge_params(jstate.trainable, jstate.frozen)["decode_head"]
    ema = jax.tree_util.tree_map(lambda x: jnp.asarray(x) * 0.5 + 0.125,
                                 head)
    return jstate.replace(ema=ema), model


def test_ema_checkpoint_crosses_both_ways(tmp_path):
    """A JAX checkpoint's ``iter_N.ema.npz`` restores into the port's
    ``state.ema``, and the port's, written in the JAX layout, restores into
    the JAX ``TrainState.ema``, leaf for leaf."""
    jstate, model = _jax_uda_state()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.CheckpointManager(jdir).save(jstate.replace(
        step=jnp.asarray(3, jnp.int32)))
    state = create_train_state(model, load_config("smoke_tiny_uda"),
                               max_iters=10)
    state.ema = init_ema(model)
    state = CheckpointManager(jdir).restore(state)
    assert state.step == 3
    want = state_dict_from_flax({"params": {"decode_head": jstate.ema}},
                                model)
    assert want.keys() == state.ema.keys()
    for n, v in want.items():
        assert torch.equal(state.ema[n], v), n

    with torch.no_grad():
        for v in state.ema.values():
            v.mul_(2.0)
    CheckpointManager(pdir).save(state)
    back = jax_ckpt.CheckpointManager(pdir).restore(jstate)
    assert int(back.step) == 3
    mine = flax_from_state_dict(state.ema, model)["params"]["decode_head"]
    got = jax.tree_util.tree_leaves_with_path(back.ema)
    assert len(got) == len(jax.tree_util.tree_leaves(mine))
    for path, leaf in got:
        ref = mine
        for p in path:
            ref = ref[p.key]
        np.testing.assert_array_equal(np.asarray(leaf), ref)


# ---------------------------------------------------------- the CLIs ----

def _records(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uda_cli")
    roots = {}
    argv = sys.argv
    try:
        for name, seed in (("source", 0), ("target", 1)):
            roots[name] = str(tmp / name)
            sys.argv = ["make_synthetic_dataset.py", roots[name], "--n", "4",
                        "--size", "256", "--seed", str(seed)]
            runpy.run_path(os.path.join(REPO, "tools",
                                        "make_synthetic_dataset.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    return tmp, roots


# LinearHead's conv biases ahead of its GroupNorm and its BatchNorm: the
# loss does not depend on them, their gradients are rounding residue on both
# sides, and AdamW (lr 1e-3) turns that into steps of about lr of either
# sign from their zero start; each side's EMA is bounded by two such steps
NORM_FED = ("e/fusion_conv/bias", "e/up1/bias")


def test_uda_cli_matches_jax_cli(synth):
    """Both CLIs train ``smoke_tiny_uda`` for 2 steps over a synthetic
    source and target (one loader worker, dropout off, pseudo_threshold 0
    so every target pixel carries weight; the augment draws fed to both):
    each step's loss entries and pseudo_weight at rtol 1e-4, the source
    accuracy within 2 pixels and the mixed one within 16 (see below); the
    step-1 EMA checkpoints at atol 1e-5 and the step-2 ones within one
    AdamW step (lr 1e-3): the flipped pseudo-labels below change step 2's
    gradients a little, and Adam's normalisation turns a small change of a
    small gradient into a visible change of its step (``NORM_FED`` within
    two AdamW steps of zero on both sides)."""
    tmp, roots = synth
    overrides = [f"data.source.data_root={roots['source']}",
                 f"data.target.data_root={roots['target']}",
                 "compute.data_parallel=1", "data.num_workers=1",
                 "schedule.log_interval=1", "schedule.checkpoint_interval=1",
                 "model.decode_head.dropout_ratio=0.0",
                 "uda.pseudo_threshold=0.0"]
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")
    draws = step_draws(46)
    initial = {}
    real_loop = jax_loop.train_loop

    def capture(state, *args, **kwargs):
        params = merge_params(state.trainable, state.frozen)
        initial.update(jax.tree_util.tree_map(
            np.asarray, {"params": params,
                         "batch_stats": state.batch_stats}))
        return real_loop(state, *args, **kwargs)

    argv = sys.argv
    try:
        sys.argv = ["train.py", "smoke_tiny_uda", "--work-dir", jdir,
                    "--max-iters", "2", "--cfg-options", *overrides]
        # draws cycle: JAX traces its step once, or again if the state's
        # types change after the first step
        with mock.patch.object(jax_loop, "train_loop", capture), \
                fed_augment(itertools.islice(itertools.cycle(draws), 16),
                            "jax", drawn_all=False):
            runpy.run_path(os.path.join(REPO, "tools", "train.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv

    def build_model(cfg, device, amp):
        assert device == "cpu" and not amp
        return port_model(cfg, initial)

    with mock.patch.object(port_cli, "build_model", build_model), \
            fed_augment(draws, "torch", repeat=2):
        state = port_cli.main(["smoke_tiny_uda", "--work-dir", pdir,
                               "--max-iters", "2", "--device", "cpu",
                               "--cfg-options", *overrides])
    assert state.step == 2 and state.ema is not None
    want = [r for r in _records(jdir) if r["prefix"] == "train"]
    got = [r for r in _records(pdir) if r["prefix"] == "train"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    pixels = 2 * 128 * 128
    drop = ("step", "prefix", "steps_per_sec", "mix.decode.acc_seg")
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        check_metrics({k: v for k, v in g.items() if k not in drop},
                      {k: v for k, v in w.items() if k not in drop}, pixels)
        # against the teacher's pseudo-labels: at step 2 the teacher reads
        # a bias ahead of a BatchNorm that AdamW moved by +-lr on rounding
        # noise (test_dacs_steps_match_jax), and its near-tied argmax may
        # flip at a few of these pixels
        np.testing.assert_allclose(g["mix.decode.acc_seg"],
                                   w["mix.decode.acc_seg"],
                                   atol=16 * 100.0 / pixels)
        assert g["mix.decode.loss_ce"] > 0
    for step, atol in ((1, 1e-5), (2, 1e-3 * 1.01)):
        name = f"iter_{step:07d}.ema.npz"
        want_e = _npz(os.path.join(jdir, "checkpoints", name))
        got_e = _npz(os.path.join(pdir, "checkpoints", name))
        assert got_e.keys() == want_e.keys()
        assert set(NORM_FED) < want_e.keys()
        for k in want_e:
            if k in NORM_FED:
                for side in (got_e[k], want_e[k]):
                    assert np.abs(side).max() <= 2 * 1e-3 * 1.01, k
                continue
            np.testing.assert_allclose(got_e[k], want_e[k], atol=atol,
                                       rtol=0, err_msg=k)


def test_cli_trains_dg_with_backbone_under_the_wrapper(synth):
    """``smoke_tiny_dg_maskloss`` through the port's train CLI for 2 steps,
    the converted backbone loaded under ``model/backbone``: every step
    logged with a finite, nonzero ``mask.*`` loss."""
    tmp, roots = synth
    cfg = load_config("smoke_tiny_dg_maskloss")
    from vfmseg_tpu_torch.models.build import build_segmentor
    from vfmseg_tpu_torch.weights import init_params

    model = init_params(build_segmentor(cfg["model"], device="cpu"), 7)
    tree = flax_from_state_dict(
        {n: p for n, p in model.named_parameters()
         if n.startswith("model.backbone.")}, model)["params"]["model"][
             "backbone"]
    path = str(tmp / "backbone.npz")
    jax_ckpt.save_pytree(path, tree)
    wdir = str(tmp / "dg")
    with mock.patch("builtins.print") as printed:
        port_cli.main(["smoke_tiny_dg_maskloss", "--work-dir", wdir,
                       "--max-iters", "2", "--device", "cpu",
                       "--backbone-init", path, "--cfg-options",
                       f"data.source.data_root={roots['source']}",
                       "data.num_workers=1", "schedule.log_interval=1"])
    assert any("-> model/backbone" in str(c) for c in printed.call_args_list)
    recs = [r for r in _records(wdir) if r["prefix"] == "train"]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert np.isfinite(r["mask.decode.loss_ce"]) and r[
            "mask.decode.loss_ce"] > 0
