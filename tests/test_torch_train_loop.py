"""The port's optimizer clipping, asynchronous checkpoints and loop hooks
against the JAX package's, on the CPU.

``grad_clip`` is held to optax's ``clip_by_global_norm`` chained before
``adamw`` over a few updates; an asynchronous save writes what the state
held when ``save`` returned, though the next step updates it in place;
``save_pytree`` files cross both ways; ``train_loop`` writes
``best.trainable.npz`` only when ``save_best`` improves and calls
``debug_fn`` every ``debug_interval`` steps, as the JAX loop does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vfmseg_tpu.train import checkpoint as jax_ckpt
from vfmseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from vfmseg_tpu_torch.train import checkpoint
from vfmseg_tpu_torch.train.loop import train_loop
from vfmseg_tpu_torch.train.optim import make_optimizer
from vfmseg_tpu_torch.train.state import TrainState


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.decode_head = nn.Module()
        self.decode_head.conv_seg = nn.Linear(6, 5)
        self.decode_head.up_bn = nn.BatchNorm2d(5)


def _toy(seed=0):
    model = _Toy()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.dtype.is_floating_point:
                t.copy_(torch.randn(t.shape, generator=gen))
    return model


@pytest.mark.parametrize("clip", [0.5, 1e3])
def test_grad_clip_matches_optax(clip):
    """Three AdamW updates with the gradients clipped to global norm
    ``clip`` (binding at 0.5, not at 1e3), against optax."""
    rs = np.random.RandomState(1)
    w = rs.randn(6, 5).astype(np.float32)
    b = rs.randn(5).astype(np.float32)
    grads = [(rs.randn(6, 5).astype(np.float32),
              rs.randn(5).astype(np.float32)) for _ in range(3)]
    pw = nn.Parameter(torch.from_numpy(w.T.copy()))
    pb = nn.Parameter(torch.from_numpy(b.copy()))
    opt, sched = make_optimizer([("decode_head.conv_seg.weight", pw),
                                 ("decode_head.conv_seg.bias", pb)],
                                base_lr=1e-2, max_steps=10, grad_clip=clip)
    params = {"conv_seg": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    tx = jax_make_optimizer(params, base_lr=1e-2, max_steps=10,
                            grad_clip=clip)
    opt_state = tx.init(params)
    for step, (gw, gb) in enumerate(grads):
        pw.grad = torch.from_numpy(gw.T.copy())
        pb.grad = torch.from_numpy(gb.copy())
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        g = {"conv_seg": {"kernel": jnp.asarray(gw), "bias": jnp.asarray(gb)}}
        updates, opt_state = tx.update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    np.testing.assert_allclose(pw.detach().numpy().T,
                               params["conv_seg"]["kernel"], atol=1e-6)
    np.testing.assert_allclose(pb.detach().numpy(),
                               params["conv_seg"]["bias"], atol=1e-6)


def _state(model):
    trainable = [(n, p) for n, p in model.named_parameters()]
    opt, sched = make_optimizer(trainable, max_steps=10)
    return TrainState(model=model, optimizer=opt, schedule=sched)


def _step(state):
    loss = state.model.decode_head.conv_seg(torch.ones(2, 6)).square().sum()
    loss.backward()
    state.optimizer.step()
    state.optimizer.zero_grad()
    state.step += 1


def test_async_save_snapshots_before_returning(tmp_path):
    """The state is changed in place right after save() returns; the files
    hold the values of the moment of the save."""
    state = _state(_toy())
    _step(state)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    want_opt = {k: v["exp_avg"].clone()
                for k, v in state.optimizer.state_dict()["state"].items()}
    ckpt = checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(state)
    with torch.no_grad():
        for t in state.model.state_dict().values():
            if t.dtype.is_floating_point:
                t.add_(1.0)
    _step(state)
    ckpt.wait()
    fresh = _state(_toy(seed=5))
    fresh = checkpoint.CheckpointManager(str(tmp_path)).restore(fresh)
    assert fresh.step == 1
    got = fresh.model.state_dict()
    for k in want:
        if "num_batches" not in k:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for k, v in fresh.optimizer.state_dict()["state"].items():
        torch.testing.assert_close(v["exp_avg"], want_opt[k], rtol=0,
                                   atol=0)
    assert sorted(os.listdir(ckpt.dir)) == [
        "iter_0000001.batch_stats.npz", "iter_0000001.torch_opt.pt",
        "iter_0000001.trainable.npz"]


def test_pytree_files_cross_both_ways(tmp_path):
    tree = {"backbone": {"blocks_0": {"attn": {"qkv": {
        "kernel": np.arange(6, dtype=np.float32).reshape(2, 3)}}}},
        "pos_embed": np.ones((1, 5, 4), np.float32)}
    checkpoint.save_pytree(str(tmp_path / "a" / "port.npz"), tree)
    jax_ckpt.save_pytree(str(tmp_path / "jax.npz"), tree)
    for path in ("a/port.npz", "jax.npz"):
        ours = checkpoint.load_pytree(str(tmp_path / path))
        theirs = jax_ckpt.load_pytree(str(tmp_path / path))
        for got in (ours, theirs):
            np.testing.assert_array_equal(
                got["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"],
                tree["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"])
            np.testing.assert_array_equal(got["pos_embed"],
                                          tree["pos_embed"])


def test_loop_save_best_and_debug_hook(tmp_path):
    """best.trainable.npz follows the best val result (3 rounds: 5, 9, 7),
    the val lines are logged, debug_fn runs every 2 steps with the step's
    batch, and the last async save is on disk when the loop returns."""
    state = _state(_toy())
    scores = iter([5.0, 9.0, 7.0])
    biases, debug = [], []

    def step_fn(st, batch, seed):
        _step(st)
        return st, {"loss": torch.tensor(float(batch["x"]))}

    def val_fn(st):
        biases.append(st.model.decode_head.conv_seg.bias.detach().clone())
        return {"synth_mIoU": next(scores)}

    batches = iter({"x": np.float32(i)} for i in range(100))
    state = train_loop(state, step_fn, batches, max_iters=6,
                       work_dir=str(tmp_path), seed=0, log_interval=1,
                       checkpoint_interval=3, val_interval=2, val_fn=val_fn,
                       save_best="synth_mIoU", debug_interval=2,
                       debug_fn=lambda st, b, s: debug.append((s, b["x"])))
    assert debug == [(2, 1.0), (4, 3.0), (6, 5.0)]
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["synth_mIoU"] for r in recs if r["prefix"] == "val"] == [
        5.0, 9.0, 7.0]
    best = checkpoint.load_pytree(str(tmp_path / "checkpoints" /
                                      "best.trainable.npz"))
    np.testing.assert_array_equal(
        best["t"]["decode_head"]["conv_seg"]["bias"], biases[1].numpy())
    assert "iter_0000006.trainable.npz" in os.listdir(tmp_path /
                                                     "checkpoints")
