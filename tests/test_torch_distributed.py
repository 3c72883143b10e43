"""Data parallelism of the port (``vfmseg_tpu_torch/parallel/mesh.py``) on
two gloo ranks of the CPU against one process on the same global batch.

The JAX package runs one SPMD step over the global batch, so its
gradients, BatchNorm moments and every other batch-wide reduction are the
global batch's (vfmseg_tpu/parallel/mesh.py:1-8). The port's ranks each
take their rows and reduce those quantities over the group; these tests
hold that to the port's own single process, and the headline's step also
to the JAX single-process step (tests/test_distributed.py's tolerances).

Two ranks are started once for the file (``torch_dist_worker.py``, torch
only); each runs every case of ``torch_dist_cases.py`` and writes its
results, which the tests read. Every wait and collective has a timeout,
and the workers are killed when the fixture ends.
"""

import json
import os
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from test_torch_eval import _write_png_set
from test_torch_slice import _midpoint_gap
from vfmseg_tpu.core.config import load_config as jax_load_config
from vfmseg_tpu.models.build import build_segmentor as jax_build_segmentor
from vfmseg_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
    partition_params,
    trainable_predicate as jax_trainable_predicate,
)
from vfmseg_tpu_torch.data import datasets, transforms
from vfmseg_tpu_torch.eval import evaluator
from vfmseg_tpu_torch.eval.compact import window_confidence
from vfmseg_tpu_torch.eval.slide import compute_slide_grid
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.tools import test as port_cli
from vfmseg_tpu_torch.train.checkpoint import save_pytree
from vfmseg_tpu_torch.train.uda import init_ema, teacher_logits
from vfmseg_tpu_torch.weights import flax_from_state_dict, init_params

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
# the ranks take ~13 s alone and several times that beside the parallel
# suite's other workers; a stuck collective raises after its own 90 s
WAIT_S = 240
CASES = ["msvfm", "msvfm_fixed", "m2f", "dacs_linear", "dacs_segformer",
         "dacs_m2f", "eval"]
EVAL_SHAPES = [(96, 160), (96, 160), (96, 160), (128, 128), (128, 128)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _threshold(spec, seed, batch_seed):
    """A pseudo-label threshold near the median of the teacher's top
    probabilities on the global target batch, so the pseudo-weight is
    neither 0 nor 1 and each rank's local mean differs from the global."""
    cfg, model = cases.build(spec, seed)
    target = torch.from_numpy(cases.global_batch(batch_seed, True)[
        "target_img"])
    with torch.no_grad():
        probs = torch.softmax(teacher_logits(model, init_ema(model), target),
                              dim=-1)
    return _midpoint_gap(probs.amax(-1).numpy().ravel(), 0.4, 0.6)


def _eval_setup(root):
    """smoke_tiny_ms_masked with seeded weights in one trainable file, a
    5-image PNG set of two sizes and a gate calibrated on the port's stage
    1 so that the compact engine skips some windows and refines others."""
    cfg = presets.config("smoke_tiny_ms_masked")
    model = init_params(build_segmentor(cfg["model"], device="cpu"), 7)
    ckpt = os.path.join(root, "iter_0000001.trainable.npz")
    save_pytree(ckpt, {"t": flax_from_state_dict(model.state_dict(),
                                                 model)["params"]})
    data = os.path.join(root, "synth")
    _write_png_set(data, EVAL_SHAPES, seed=9)
    # the model as the CLI loads it: the statistics are not in the file
    model = port_cli.load_weights(
        build_segmentor(cfg["model"], device="cpu"), ckpt, None)
    engine = evaluator.make_compact_ms_slide(model, cfg["test_cfg"])
    pipe = transforms.TestPipeline((128, 128), True)
    fulls = []
    for item in datasets.gta_dataset(data):
        img = torch.from_numpy(pipe(item["img"], None)["img"])[None]
        with torch.inference_mode():
            fulls.append(engine._stage1_impl(model, img,
                                             tuple(img.shape[1:3]))[0])
    threshold = _midpoint_gap(np.concatenate(
        [torch.softmax(f, -1).amax(-1).numpy().ravel() for f in fulls]),
        0.4, 0.6)
    confs = [window_confidence(f, compute_slide_grid(
        tuple(f.shape[1:3]), (64, 64), (32, 32)), (64, 64),
        threshold).numpy() for f in fulls]
    conf = _midpoint_gap(np.concatenate(confs), 0.3, 0.7)
    options = [f"data.test=[{{'type': 'GTADataset', 'data_root': {data!r}, "
               f"'key': 'synth'}}]", f"test_cfg.threshold={threshold!r}",
               f"test_cfg.conf={conf!r}"]
    return dict(ckpt=ckpt, data=data, options=options)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch work in one intra-op thread, as the ranks':
    beside a loaded parallel suite, a process of many threads waits at
    each small op's barrier for threads the other workers hold, which
    stretched the set loss's one-process steps from seconds to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks on every case; return (task, out_dir)."""
    out = str(tmp_path_factory.mktemp("ranks"))
    task = dict(cases=CASES, **_eval_setup(out), threshold={
        f"dacs_{k}": _threshold(spec, 7, 8)
        for k, spec in cases.DACS.items()})
    task_path = os.path.join(out, "task.json")
    with open(task_path, "w") as f:
        json.dump(task, f)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         str(r), str(WORLD), port, task_path, out], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=WAIT_S)
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        err = os.path.join(out, f"error.rank{r}.txt")
        assert not os.path.exists(err), open(err).read()
        assert p.returncode == 0, p.stderr.read().decode()[-3000:]
    return task, out


def _ranks(out, name):
    return [dict(np.load(os.path.join(out, f"{name}.rank{r}.npz")))
            for r in range(WORLD)]


def _check_against_one_process(got, want, lr=cases.LR):
    """Every rank's losses (rtol 1e-5; accuracy from the summed counts,
    exact), grad_norm (rtol 1e-4), reduced gradients (atol 5e-6 of the
    largest), BatchNorm statistics and EMA (atol 1e-6) against one
    process's. The updated parameters (and the EMA head, which the first
    step copies from them) agree within 1e-6 where the gradient stands
    above 1e-6 of the largest; below that it is rounding noise (a bias
    ahead of a normalisation has an exact gradient of 0), which Adam's
    first step turns into +-lr, so there both updates are held to lr
    (+ decay)."""
    grads = [k for k in want if k.startswith("g/")]
    scale = max(float(np.abs(want[k]).max()) for k in grads)
    for r, g in enumerate(got):
        assert g.keys() - {"a/matching"} == want.keys() - {"a/matching"}
        for k, v in want.items():
            msg = f"rank {r} {k}"
            if k == "a/matching":
                continue
            if k.startswith("m/") and k.endswith("grad_norm"):
                np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=msg)
            elif k.startswith("m/") and "acc" in k:
                np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=msg)
            elif k.startswith("m/"):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=msg)
            elif k.startswith("g/"):
                np.testing.assert_allclose(g[k], v, atol=5e-6 * scale,
                                           rtol=0, err_msg=msg)
            elif k.startswith("s/") or "g/" + k[2:] not in want:
                np.testing.assert_allclose(g[k], v, atol=1e-6, rtol=0,
                                           err_msg=msg)
            else:  # an updated parameter, or the EMA of one
                signal = np.abs(want["g/" + k[2:]]) > 1e-6 * scale
                np.testing.assert_allclose(g[k][signal], v[signal],
                                           atol=1e-6, rtol=0, err_msg=msg)
                assert np.abs(g[k] - v).max() <= 2.2 * lr, msg


def test_msvfm_step_equals_one_process(ranks):
    """The tiny headline (LoRA DINOv2, LinearHead with BatchNorm, VFMHead),
    every random stream on (LoRA and head dropout, drop-path over the LR
    views and HR crops in one ViT call, the decoder's mask tokens): the two
    ranks' step equals one process's on the global batch of 4, the
    BatchNorm moments and running statistics included. The ranks' draws
    are their rows of the one process's (``rng.batch_blocks``: the ViT's
    batch is two of them)."""
    task, out = ranks
    want = cases.run("msvfm", task, out)
    assert any(k.startswith("s/") for k in want)
    _check_against_one_process(_ranks(out, "msvfm"), want)


def test_msvfm_step_equals_jax_single_process(ranks):
    """With every draw off and the crop fixed, the two ranks' loss and
    grad_norm equal the JAX ``make_train_step`` on the global batch in one
    process, from the same weights (tests/test_distributed.py's bounds:
    loss rtol 1e-5, grad_norm rtol 1e-3), and the one-process port's."""
    task, out = ranks
    got = _ranks(out, "msvfm_fixed")
    _check_against_one_process(got, cases.run("msvfm_fixed", task, out))
    name, options = cases.MSVFM_FIXED
    jcfg = jax_load_config(name, options)
    jmodel = jax_build_segmentor(jcfg.model, dtype=jnp.float32,
                                 attn_impl=jcfg.compute.attn_impl)
    _, model = cases.build(cases.MSVFM_FIXED, 3)
    variables = flax_from_state_dict(
        {k: v.detach() for k, v in model.state_dict().items()}, model)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    trainable, frozen = partition_params(
        variables["params"], jax_trainable_predicate(
            adapter_keywords=tuple(jcfg.peft.adapter_keywords)))
    tx = jax_make_optimizer(trainable, base_lr=cases.LR, max_steps=100)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                           frozen=frozen,
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(trainable))
    batch = {k: jnp.asarray(v) for k, v in cases.global_batch(5).items()}
    crops = list(cases.FIXED_CROPS)
    with mock.patch("jax.random.randint", lambda *a, **k: jnp.asarray(
            crops.pop(0), jnp.int32)):
        _, jmetrics = jax_make_train_step(jmodel, tx, donate=False)(
            jstate, batch, jax.random.PRNGKey(0))
    for g in got:
        np.testing.assert_allclose(g["m/loss"], float(jmetrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(g["m/grad_norm"],
                                   float(jmetrics["grad_norm"]), rtol=1e-3)


def _with_ranks_matchings(name, task, out):
    """The ranks' results of case ``name`` and one process's, which takes
    the ranks' set-loss matchings as they were solved (seeded weights
    leave near-tied costs that batch-size rounding can flip, which is not
    what these tests are about)."""
    got = _ranks(out, name)
    if "a/matching" not in got[0]:
        return got, cases.run(name, task, out)
    matching = np.concatenate([g["a/matching"] for g in got], axis=1)
    want = cases.run(name, dict(task, matching=matching), out)
    np.testing.assert_array_equal(want["a/matching"], matching)
    return got, want


def test_mask2former_step_equals_one_process(ranks):
    """``smoke_tiny_rein_m2f``: the set loss's normalisers (the number of
    present classes and the class-weight sum) count the global batch, and
    each rank's loss is scaled by the world size, so the averaged gradient
    is the global batch's. Each rank solves its images' matchings; the one
    process takes them (``_with_ranks_matchings``)."""
    task, out = ranks
    got, want = _with_ranks_matchings("m2f", task, out)
    _check_against_one_process(got, want)


@pytest.mark.parametrize("head", sorted(cases.DACS))
def test_dacs_step_equals_one_process(ranks, head):
    """One DACS step: on an EncoderDecoder the batched 2B student pass
    (source and mixed images in one forward, the ranks' rows of each),
    with the LinearHead (BatchNorm over the 2B batch) and a SegFormer head;
    on ``smoke_tiny_rein_m2f`` the two passes, the mixed one's set losses
    scaled by the mixed weight's mean over the global batch (ClassMix
    gives each rank's images their own). The pseudo-weight is the global
    batch's mean (strictly inside (0, 1) at the calibrated threshold), the
    EMA moves alike on every rank."""
    task, out = ranks
    got, want = _with_ranks_matchings(f"dacs_{head}", task, out)
    assert 0.0 < float(want["m/pseudo_weight"]) < 1.0
    _check_against_one_process(got, want)


def test_sharded_eval_equals_one_process(ranks):
    """The eval CLI at ``--data-parallel 2`` on two gloo ranks (images
    i = rank mod 2; 5 images of two sizes, so the ranks hold 3 and 2 and
    each compact stream flushes its own groups) writes the metrics JSON of
    one process, dense and through the compact stream, and the ranks'
    ``--show-dir`` PNGs make up one process's set. The compact gate's
    windows and refined windows, summed over the ranks, equal one
    process's, with windows skipped (refined < total).

    Divergence from the JAX package, stated: its mesh mode shards one
    image's crop batch and counts the shard-pad windows in the forced-bucket
    stats (vfmseg_tpu/eval/compact.py:481). The port shards images and
    keeps each engine whole, so no pad window exists: its counts equal the
    JAX engine's unsharded ones."""
    task, out = ranks
    want = cases.run("eval", task, out)
    got = _ranks(out, "eval")
    windows, refined = want["gate"]
    assert 0 < refined < windows
    for g in got:
        np.testing.assert_array_equal(g["gate"], want["gate"])
    for gate in ("dense", "compact"):
        with open(os.path.join(out, f"single_{gate}.json")) as f:
            single = json.load(f)
        with open(os.path.join(out, f"dp_{gate}.json")) as f:
            assert json.load(f) == single
        assert set(single) == {"synth_mIoU", "synth_aAcc", "mean_mIoU"}
        assert (sorted(os.listdir(os.path.join(out, f"show_dp_{gate}",
                                               "synth")))
                == sorted(os.listdir(os.path.join(
                    out, f"show_single_{gate}", "synth")))
                == [f"f{i}.png" for i in range(len(EVAL_SHAPES))])
