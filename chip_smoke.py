#!/usr/bin/env python3
"""Drive the PyTorch port's two main paths once on one CUDA card and check
them: the headline gated inference and the headline two-scale train step.

Usage, from the root of the repository: ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN so fp32 comparisons
   are fp32.
2. build: the CUDA kernels of ``vfmseg_tpu_torch/csrc`` built by nvcc, one
   process per source started together (or loaded from the build cache),
   with the build seconds.
3. kernels: each inference kernel against its plain PyTorch version on the
   card, at the shapes the inference path gives it, from seeded bf16 inputs
   (the plain version runs in fp32), plus one fp32 LayerNorm and one
   odd-head attention case off the path; and each one's time beside the
   plain one's (CUDA events around 10 back-to-back calls, median of 10 such
   windows, after warm-up).
4. kernels_train: the training attention kernels at the train path's shapes
   plus one ragged odd-head case: the forward with LSE (B3) against
   ``attention_fwd_lse_plain``, and dq, dk, dv of the two backward kernels
   (B4) against autograd through the fp32 plain attention, with a random
   dO; times as in phase 3.
5. main_path: the headline model (LoRA DINOv2-L, LinearHead, VFMHead with a
   3-block decoder) at full width with seeded weights in bf16, through
   ``predict`` on 3 synthetic 1024x2048 images; launch counts per kernel
   (no training kernel may launch), latency, images/s and peak memory.
6. card_vs_cpu: one 512x1024 image through the gated slide logits on the
   card (bf16) and on the CPU (fp32, plain path), same seeded weights.
7. train_path: the headline model at full width in training mode (bf16
   compute, fp32 master weights, LoRA on qkv, both heads), batch 2 of
   synthetic 1024x1024 crops through ``InfiniteLoader`` and ``train_loop``
   for 8 steps with checkpoints at steps 4 and 8, then a fresh state
   restored from step 8; launch counts per step, per-step latency, steady
   steps/s and peak memory.
8. train_breakdown: one more step split by CUDA events into forward,
   backward and optimizer, and a ``torch.profiler`` pass over one step for
   the kernels' device time.
9. train_card_vs_cpu: one train step of the full-width model at 256x256
   (HR crop 128) on the card in bf16 and on the CPU in fp32, same seeded
   weights and crop box, dropout and mask ratio 0: loss entries, the cosine
   of the flattened LoRA gradients, and the LoRA gradient norm and
   ``grad_norm``.

Then the nvidia-smi line, one JSON line of per-kernel results, and as the
last line ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Any failure raises, so the exit code is non-zero and no result line
is printed; so does a machine without a CUDA card.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.data.loader import InfiniteLoader, collate
from vfmseg_tpu_torch.data.synthetic import SyntheticDataset
from vfmseg_tpu_torch.eval.evaluator import (
    make_logits_fn,
    make_shape_aware_predict_fn,
)
from vfmseg_tpu_torch.eval.slide import (
    compute_slide_grid,
    confident_mask,
    extract_crops,
)
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.build import build_segmentor, compute_dtype
from vfmseg_tpu_torch.models.presets import PREPROCESSOR, headline_config
from vfmseg_tpu_torch.ops.attention import (
    attention_bwd_dkv_tm,
    attention_bwd_dq_tm,
    attention_bwd_plain,
    attention_delta,
    attention_fwd_lse_plain,
    attention_fwd_lse_tm,
    attention_plain,
    attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.norm import layer_norm_cuda, layer_norm_plain
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.train.checkpoint import CheckpointManager
from vfmseg_tpu_torch.train.loop import train_loop
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import (
    make_train_step,
    step_generators,
    sum_losses,
)
from vfmseg_tpu_torch.weights import init_params

SEED = 0
N_IMAGES = 3
IMAGE_HW = (1024, 2048)
CHECK_HW = (512, 1024)
REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_WORK_DIR = os.path.join(REPO, "work_dirs", "chip_smoke_train")
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_CHECK_HW = (256, 256)
TRAIN_CHECK_CROP = (128, 128)

# the main path's calls per 1024x2048 image: stage-1 ViT (24 blocks), refine
# ViT over all 18 crops in one batch (24 blocks), VFMHead decoder (3 blocks)
LN_PER_IMAGE = 48 + 48 + 9
ATTN_PER_IMAGE = 24 + 24 + 6
# the train path's calls per step: one ViT pass over the 2B batch of both
# scale views (24 blocks), the VFMHead decoder (3 blocks); every attention
# has a backward, every LayerNorm backward is plain torch
LN_PER_STEP = 48 + 9
ATTN_PER_STEP = 24 + 6

# (shape, eps, dtype) of every LayerNorm on the path, then the fp32 input
# the kernel also takes
LN_CASES = [((1, 2049, 1024), 1e-6, torch.bfloat16),
            ((18, 1025, 1024), 1e-6, torch.bfloat16),
            ((18, 1024, 256), 1e-5, torch.bfloat16),
            ((18, 1025, 1024), 1e-6, torch.float32)]
# (B, N, H, fused qkv?) of every attention on the path, then an odd head
# count with both tiles ragged; head dim 64
ATTN_SHAPES = [(1, 2049, 16, True), (18, 1025, 16, True),
               (18, 1024, 8, False), (2, 77, 3, True)]
# (atol, rtol): bf16 output rounding and another summation order; in fp32
# only the summation order
LN_TOL = {torch.bfloat16: (3e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
# P rounds to bf16 before P.V, and the accumulation order differs
ATTN_ATOL = 1e-2
# (B, N, H, fused qkv?) of the training attention: the ViT over both scale
# views, the decoder, and one ragged odd-head case off the path
TRAIN_ATTN_SHAPES = [(4, 1025, 16, True), (2, 1024, 8, False),
                     (3, 77, 3, True)]
# LSE: fp32 sums in another order, exp2f/log2f against exp/log
LSE_ATOL = 1e-3
# dq/dk/dv, as max abs error over max |reference|: P and dS round to bf16
# before their products (2^-9 each), the outputs are bf16, and delta comes
# from the bf16 O, against an fp32 autograd reference
GRAD_REL = 2e-2
# PARITY.md's bf16 feature budget (2e-2), widened for 24 blocks + two heads
DRIFT_Q99 = 5e-2
ARGMAX_AGREE = 0.98
# one train step, bf16 card vs fp32 CPU: each loss entry within 3e-2
# relative (the same bf16 drift through 24 blocks and two heads); the
# flattened LoRA gradient within cosine 0.98 of the CPU's (bf16 activations
# and bf16 attention gradients through 24 blocks of backward), and its norm
# and the step's grad_norm within 5e-2 relative (a uniform scale, which the
# cosine cannot see)
TRAIN_LOSS_REL = 3e-2
TRAIN_GRAD_COS = 0.98
TRAIN_GRAD_NORM_REL = 5e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call, by CUDA events: the median over ``reps``
    windows of ``inner`` back-to-back calls each, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], tf32_matmul=False, tf32_cudnn=False)
    return dict(smi=smi)


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.library()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kernels.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(secs, 3), ptxas=ptxas)


def phase_kernels(dev) -> list:
    rng = np.random.RandomState(SEED)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    ln_rows, worst_ln = [], 0.0
    for shape, eps, dtype in LN_CASES:
        c = shape[-1]
        atol, rtol = LN_TOL[dtype]
        x = randn(*shape).to(dtype)
        w = randn(c) * 0.1 + 1.0
        b = randn(c) * 0.1
        got = layer_norm_cuda(x, w, b, eps).float()
        want = layer_norm_plain(x.float(), w, b, eps)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= atol + rtol * want.abs()).all())
        max_abs = float(err.max())
        row = dict(shape=list(shape), dtype=str(dtype), max_abs_err=max_abs,
                   ok=ok,
                   ms=time_ms(lambda: layer_norm_cuda(x, w, b, eps)),
                   plain_ms=time_ms(lambda: layer_norm_plain(x, w, b, eps)))
        emit("kernel_layer_norm", atol=atol, rtol=rtol, **row)
        if not ok:
            raise AssertionError(f"layer_norm kernel disagrees at {shape}: "
                                 f"max abs err {max_abs}")
        ln_rows.append(row)
        worst_ln = max(worst_ln, max_abs)

    attn_rows, worst_attn = [], 0.0
    for b_, n, h, fused in ATTN_SHAPES:
        e = h * 64
        scale = 64 ** -0.5
        if fused:
            qkv = randn(b_, n, 3 * e).to(torch.bfloat16)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            q, k, v = (randn(b_, n, e).to(torch.bfloat16) for _ in range(3))

        def heads(t):
            return t.reshape(b_, n, h, 64)

        got = attention_qkv_tm(q, k, v, h, scale).float()
        want = attention_plain(heads(q.float()), heads(k.float()),
                               heads(v.float()), scale=scale).reshape(b_, n, e)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        ok = max_abs <= ATTN_ATOL
        row = dict(
            shape=[b_, n, h, 64], fused_qkv=fused, max_abs_err=max_abs, ok=ok,
            ms=time_ms(lambda: attention_qkv_tm(q, k, v, h, scale)),
            plain_ms=time_ms(lambda: attention_plain(
                heads(q), heads(k), heads(v), scale=scale)))
        emit("kernel_attention_qkv", atol=ATTN_ATOL, **row)
        if not ok:
            raise AssertionError(f"attention kernel disagrees at "
                                 f"{(b_, n, h)}: max abs err {max_abs}")
        attn_rows.append(row)
        worst_attn = max(worst_attn, max_abs)
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # the per-kernel summary times the largest shape on the path (the
    # refine batch); every shape's numbers are on the lines above
    return [
        dict(name="layer_norm", route="cuda",
             source="vfmseg_tpu_torch/csrc/layer_norm.cu",
             replaces="vfmseg_tpu/ops/norm.py:28",
             max_abs_err=worst_ln, ms=ln_rows[1]["ms"],
             plain_ms=ln_rows[1]["plain_ms"], shape=ln_rows[1]["shape"]),
        dict(name="attention_qkv", route="cuda",
             source="vfmseg_tpu_torch/csrc/attention_qkv.cu",
             replaces="vfmseg_tpu/ops/flash_attention.py:873",
             max_abs_err=worst_attn, ms=attn_rows[1]["ms"],
             plain_ms=attn_rows[1]["plain_ms"], shape=attn_rows[1]["shape"]),
    ]


def phase_kernels_train(dev) -> list:
    rng_np = np.random.RandomState(SEED + 3)

    def randn(*shape):
        return torch.from_numpy(rng_np.standard_normal(shape).astype(
            np.float32)).to(dev)

    rows = []
    for b_, n, h, fused in TRAIN_ATTN_SHAPES:
        e = h * 64
        scale = 64 ** -0.5
        if fused:
            qkv = randn(b_, n, 3 * e).to(torch.bfloat16)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
            dqkv = torch.empty_like(qkv)
            dq, dk, dv = dqkv[..., :e], dqkv[..., e:2 * e], dqkv[..., 2 * e:]
        else:
            q, k, v = (randn(b_, n, e).to(torch.bfloat16) for _ in range(3))
            dq, dk, dv = torch.empty((3, b_, n, e), dtype=torch.bfloat16,
                                     device=dev)
        dout = randn(b_, n, e).to(torch.bfloat16)

        def heads(t):
            return t.reshape(b_, n, h, 64)

        out, lse = attention_fwd_lse_tm(q, k, v, h, scale)
        delta = attention_delta(out, dout, h)
        attention_bwd_dq_tm(q, k, v, dout, lse, delta, h, scale, dq)
        attention_bwd_dkv_tm(q, k, v, dout, lse, delta, h, scale, dk, dv)

        ref = [heads(t.float()).requires_grad_(True) for t in (q, k, v)]
        want_out, want_lse = attention_fwd_lse_plain(*ref, scale=scale)
        want_out.backward(heads(dout.float()))
        torch.cuda.synchronize()
        want_out, want_lse = want_out.detach(), want_lse.detach()
        out_err = float((out.float() - want_out.reshape(b_, n, e)).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        grad_err = {}
        for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            want = r.grad.reshape(b_, n, e)
            grad_err[name] = float((got.float() - want).abs().max()
                                   / want.abs().max())
        ok = (out_err <= ATTN_ATOL and lse_err <= LSE_ATOL
              and max(grad_err.values()) <= GRAD_REL)
        plain_in = [heads(t) for t in (q, k, v)]
        p_out, p_lse = attention_fwd_lse_plain(*plain_in, scale=scale)
        row = dict(
            shape=[b_, n, h, 64], fused_qkv=fused, out_max_abs_err=out_err,
            lse_max_abs_err=lse_err, grad_rel_err=grad_err, ok=ok,
            fwd_ms=time_ms(lambda: attention_fwd_lse_tm(q, k, v, h, scale)),
            fwd_plain_ms=time_ms(lambda: attention_fwd_lse_plain(
                *plain_in, scale=scale)),
            dq_ms=time_ms(lambda: attention_bwd_dq_tm(
                q, k, v, dout, lse, delta, h, scale, dq)),
            dkv_ms=time_ms(lambda: attention_bwd_dkv_tm(
                q, k, v, dout, lse, delta, h, scale, dk, dv)),
            bwd_plain_ms=time_ms(lambda: attention_bwd_plain(
                *plain_in, p_out, p_lse, heads(dout), scale=scale)))
        emit("kernel_attention_train", out_atol=ATTN_ATOL, lse_atol=LSE_ATOL,
             grad_rel=GRAD_REL, **row)
        if not ok:
            raise AssertionError(f"training attention kernels disagree at "
                                 f"{(b_, n, h)}: {row}")
        rows.append(row)
        del q, k, v, dq, dk, dv, dout, out, lse, delta, ref, plain_in
        torch.cuda.empty_cache()

    path = rows[0]  # the ViT's shape, the largest on the path
    worst_grad = max(max(r["grad_rel_err"].values()) for r in rows)
    return [
        dict(name="attention_fwd_lse", route="cuda",
             source="vfmseg_tpu_torch/csrc/attention_qkv.cu",
             replaces="vfmseg_tpu/ops/flash_attention.py:684",
             max_abs_err=max(r["out_max_abs_err"] for r in rows),
             lse_max_abs_err=max(r["lse_max_abs_err"] for r in rows),
             ms=path["fwd_ms"], plain_ms=path["fwd_plain_ms"],
             shape=path["shape"]),
        dict(name="attention_bwd_dq", route="cuda",
             source="vfmseg_tpu_torch/csrc/attention_qkv_bwd.cu",
             replaces="vfmseg_tpu/ops/flash_attention.py:1397",
             max_abs_err=max(r["grad_rel_err"]["dq"] for r in rows),
             err_kind="max abs err / max |ref|", ms=path["dq_ms"],
             plain_ms=path["bwd_plain_ms"], plain_computes="dq, dk, dv",
             shape=path["shape"]),
        dict(name="attention_bwd_dkv", route="cuda",
             source="vfmseg_tpu_torch/csrc/attention_qkv_bwd.cu",
             replaces="vfmseg_tpu/ops/flash_attention.py:1444",
             max_abs_err=max(max(r["grad_rel_err"]["dk"],
                                 r["grad_rel_err"]["dv"]) for r in rows),
             err_kind="max abs err / max |ref|", ms=path["dkv_ms"],
             plain_ms=path["bwd_plain_ms"], plain_computes="dq, dk, dv",
             shape=path["shape"], worst_grad_rel_err=worst_grad),
    ]


def _trainable_snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def phase_train_path(dev, cfg) -> tuple:
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    dtype = compute_dtype(cfg)
    model = init_params(build_segmentor(cfg["model"], dtype=dtype), SEED)
    model = model.to(dev)
    state = create_train_state(model, cfg)
    build_secs = time.perf_counter() - t0
    before = _trainable_snapshot(model)
    last = len(model.backbone.blocks) - 1
    frozen_names = ["backbone.patch_embed.weight", "backbone.pos_embed",
                    "backbone.blocks.0.attn.qkv.weight",
                    "backbone.blocks.0.norm1.weight",
                    f"backbone.blocks.{last}.mlp.fc2.weight"]
    params = dict(model.named_parameters())
    frozen = {n: params[n].detach().clone() for n in frozen_names}
    n_train = sum(p.numel() for p in before.values())
    n_total = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    dataset = SyntheticDataset(n=4, hw=tuple(cfg["crop_size"]),
                               num_classes=cfg["num_classes"], seed=SEED)
    data_secs = time.perf_counter() - t0
    loader = InfiniteLoader(dataset, batch_size=cfg["batch_size"],
                            num_workers=2, seed=SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state = train_loop(state, make_train_step(), loader,
                           max_iters=TRAIN_STEPS, work_dir=TRAIN_WORK_DIR,
                           seed=SEED, log_interval=1,
                           checkpoint_interval=TRAIN_CKPT_EVERY,
                           max_keep_ckpts=2)
    finally:
        loader.close()
    torch.cuda.synchronize()
    loop_secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = {"layer_norm": TRAIN_STEPS * LN_PER_STEP, "attention_qkv": 0,
            "attention_fwd_lse": TRAIN_STEPS * ATTN_PER_STEP,
            "attention_bwd_dq": TRAIN_STEPS * ATTN_PER_STEP,
            "attention_bwd_dkv": TRAIN_STEPS * ATTN_PER_STEP}
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != {want}")
    with open(os.path.join(TRAIN_WORK_DIR, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError("train_loop did not log every step")
    losses = {k: [r[k] for r in records] for k in records[0]
              if "loss" in k or k in ("grad_norm",)}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite train metrics {losses}")
    after = _trainable_snapshot(model)
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    if unchanged:
        raise AssertionError(f"trainable parameters did not move: "
                             f"{unchanged[:5]}")
    if not any("lora" in n for n in before) or not any(
            n.startswith("aux_head") for n in before):
        raise AssertionError("LoRA or head parameters are not trainable")
    moved = [n for n in frozen if not torch.equal(frozen[n], params[n])]
    if moved or any(p.grad is not None for n, p in params.items()
                    if n not in before):
        raise AssertionError(f"frozen parameters moved or got gradients: "
                             f"{moved}")

    # a fresh state from the same seed, restored from the last checkpoint
    fresh = create_train_state(init_params(
        build_segmentor(cfg["model"], dtype=dtype), SEED).to(dev), cfg)
    fresh = CheckpointManager(TRAIN_WORK_DIR).restore(fresh)
    got = dict(fresh.model.state_dict())
    mismatch = [n for n, t in model.state_dict().items()
                if (n in before or "running" in n)
                and not torch.equal(t, got[n])]
    opt_a = state.optimizer.state_dict()["state"]
    opt_b = fresh.optimizer.state_dict()["state"]
    opt_same = opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i]["exp_avg"], opt_b[i]["exp_avg"])
        and torch.equal(opt_a[i]["exp_avg_sq"], opt_b[i]["exp_avg_sq"])
        for i in opt_a)
    if fresh.step != TRAIN_STEPS or mismatch or not opt_same:
        raise AssertionError(f"restore: step {fresh.step}, mismatched "
                             f"{mismatch[:5]}, optimizer equal {opt_same}")
    ckpts = sorted(os.listdir(os.path.join(TRAIN_WORK_DIR, "checkpoints")))
    del fresh, got
    torch.cuda.empty_cache()

    latency = [1.0 / r["steps_per_sec"] for r in records]
    steady = latency[1:]
    emit("train_path", steps=TRAIN_STEPS, batch=cfg["batch_size"],
         crop_hw=list(cfg["crop_size"]), model_build_s=build_secs,
         data_build_s=data_secs, loop_s=loop_secs,
         trainable_params=n_train, total_params=n_total,
         step_latency_s=latency, median_steady_step_s=float(
             np.median(steady)), steps_per_s=1.0 / float(np.median(steady)),
         peak_mem_bytes=peak, launches=counts,
         launches_per_step={k: v // TRAIN_STEPS for k, v in counts.items()},
         losses=losses, checkpoints=ckpts, restored_step=TRAIN_STEPS)
    return state, counts


def _device_kernel_ms(prof) -> tuple:
    """Device time by kernel group, and the 12 largest kernels, from a
    profiler run (both empty when it recorded no device time)."""
    from torch.autograd import DeviceType

    groups, by_name = {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        name = evt.key
        if name.startswith(("Optimizer.", "ProfilerStep")):
            continue  # annotation ranges on the device timeline, not kernels
        ms = getattr(evt, "self_device_time_total", 0.0) / 1e3
        for tag in ("attention_bwd_dkv", "attention_bwd_dq",
                    "attention_qkv_kernel", "layer_norm"):
            if tag in name:
                break
        else:
            tag = "gemm" if any(s in name.lower() for s in (
                "gemm", "nvjet", "cutlass", "xmma")) else "other"
        groups[tag] = groups.get(tag, 0.0) + ms
        by_name[name[:90]] = (by_name.get(name[:90], (0.0, 0))[0] + ms,
                              by_name.get(name[:90], (0.0, 0))[1]
                              + evt.count)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return groups, [dict(kernel=k, ms=v[0], calls=v[1]) for k, v in top]


def phase_train_breakdown(dev, cfg, state) -> None:
    """Forward / backward / optimizer of one more step (CUDA events, median
    of 3 steps), and the kernels' device time over one profiled step."""
    model, opt = state.model, state.optimizer
    ds = SyntheticDataset(n=2, hw=tuple(cfg["crop_size"]),
                          num_classes=cfg["num_classes"], seed=SEED + 5)
    batch = collate([ds[0], ds[1]])
    img = torch.from_numpy(batch["img"]).to(dev)
    label = torch.from_numpy(batch["label"]).to(dev)
    model.train()

    def one_step(events=None):
        opt.zero_grad(set_to_none=True)
        with rng.streams(step_generators(SEED, state.step, dev)):
            if events:
                events[0].record()
            loss = sum_losses(model(img, label))
            if events:
                events[1].record()
            loss.backward()
            if events:
                events[2].record()
            opt.step()
            if events:
                events[3].record()

    parts = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        one_step(ev)
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, optim = (float(np.median([p[i] for p in parts]))
                       for i in range(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = _device_kernel_ms(prof)
    device_ms = sum(groups.values())
    attn = sum(v for k, v in groups.items() if k.startswith("attention"))
    step_ms = fwd + bwd + optim
    # idle against the unprofiled, event-timed step (the profiled wall time
    # carries the profiler's own overhead)
    emit("train_breakdown", forward_ms=fwd, backward_ms=bwd,
         optimizer_ms=optim, step_ms=step_ms, profiled_wall_ms=wall_ms,
         kernel_ms=groups or "not measured (no device time in the profile)",
         top_kernels=top, device_ms=device_ms if groups else None,
         attention_share=attn / device_ms if groups else None,
         idle_share=max(1 - device_ms / step_ms, 0.0) if groups else None)


def _train_check_config(cfg) -> dict:
    c = copy.deepcopy(cfg)
    m = c["model"]
    m["hr_crop_size"] = TRAIN_CHECK_CROP
    m["backbone"]["Lora_config"]["lora_dropout"] = 0.0
    m["decode_head"]["dropout_ratio"] = 0.0
    m["aux_head"]["dropout_ratio"] = 0.0
    m["aux_head"]["transformer"].update(dropout=0.0, mask_ratio=0.0)
    return c


def phase_train_card_vs_cpu(dev, cfg) -> None:
    c = _train_check_config(cfg)
    ds = SyntheticDataset(n=2, hw=TRAIN_CHECK_HW,
                          num_classes=c["num_classes"], seed=SEED + 7)
    batch = collate([ds[0], ds[1]])

    def one_step(device, dtype):
        model = init_params(build_segmentor(c["model"], dtype=dtype), SEED)
        state = create_train_state(model.to(device), c)
        t0 = time.perf_counter()
        _, metrics = make_train_step()(state, batch, SEED)
        metrics = {k: float(v) for k, v in metrics.items()}
        secs = time.perf_counter() - t0
        grad = torch.cat([p.grad.float().flatten().cpu()
                          for n, p in state.model.named_parameters()
                          if "lora" in n])
        return metrics, grad, secs

    card, card_g, card_s = one_step(dev, compute_dtype(cfg))
    cpu, cpu_g, cpu_s = one_step(torch.device("cpu"), torch.float32)
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-9)
           for k in cpu if "loss" in k}
    cos = float(F.cosine_similarity(card_g.double(), cpu_g.double(), dim=0))
    norm_rel = {
        "lora": abs(float(card_g.norm()) / float(cpu_g.norm()) - 1),
        "grad_norm": abs(card["grad_norm"] / cpu["grad_norm"] - 1)}
    ok = (all(np.isfinite(list(card.values())))
          and max(rel.values()) <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
          and max(norm_rel.values()) <= TRAIN_GRAD_NORM_REL)
    emit("train_card_vs_cpu", image_hw=list(TRAIN_CHECK_HW),
         hr_crop=list(TRAIN_CHECK_CROP), card=card, cpu=cpu,
         loss_rel_err=rel, loss_rel_limit=TRAIN_LOSS_REL,
         lora_grad_cosine=cos, cosine_limit=TRAIN_GRAD_COS,
         grad_norm_rel_err=norm_rel, grad_norm_rel_limit=TRAIN_GRAD_NORM_REL,
         lora_grad_norm_card=float(card_g.norm()),
         lora_grad_norm_cpu=float(cpu_g.norm()), card_step_s=card_s,
         cpu_step_s=cpu_s, ok=ok)
    if not ok:
        raise AssertionError(f"train card vs CPU: loss rel {rel}, LoRA "
                             f"gradient cosine {cos}, norms {norm_rel}")


def synthetic_images(n: int, hw, seed: int) -> torch.Tensor:
    """Preprocessed NHWC float32 images: blocky colour fields plus noise,
    normalised with the config's mean and std."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (n, hw[0] // 32, hw[1] // 32, 3))
    img = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2).astype(
        np.float32)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
    mean = np.asarray(PREPROCESSOR["mean"], np.float32)
    std = np.asarray(PREPROCESSOR["std"], np.float32)
    return torch.from_numpy(((img - mean) / std).astype(np.float32))


@torch.inference_mode()
def refined_windows(model, img: torch.Tensor, test_cfg: dict) -> int:
    """How many slide windows the gate sends to the refine head."""
    h, w = img.shape[1:3]
    crop = tuple(test_cfg["crop_size"])
    full = resize(model.lr_forward(resize(img, size=test_cfg["lr_img_size"])),
                  size=(h, w))
    ctx = extract_crops(full, compute_slide_grid(
        (h, w), crop, tuple(test_cfg["stride"])), crop)
    conf = confident_mask(ctx, test_cfg["threshold"]).mean(dim=(1, 2))
    return int((conf < test_cfg["conf"]).sum())


def phase_main_path(dev, cfg) -> tuple:
    t0 = time.perf_counter()
    model = init_params(build_segmentor(cfg["model"],
                                        dtype=compute_dtype(cfg)), SEED)
    model = model.to(dev)
    build_secs = time.perf_counter() - t0
    test_cfg = cfg["test_cfg"]
    predict = make_shape_aware_predict_fn(model, test_cfg)
    imgs = synthetic_images(N_IMAGES, IMAGE_HW, SEED + 1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    latencies, preds = [], []
    kernels.reset_launch_counts()
    for i in range(N_IMAGES):
        img = imgs[i:i + 1].to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds.append(predict(model, img, IMAGE_HW))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = {"layer_norm": N_IMAGES * LN_PER_IMAGE,
            "attention_qkv": N_IMAGES * ATTN_PER_IMAGE,
            "attention_fwd_lse": 0, "attention_bwd_dq": 0,
            "attention_bwd_dkv": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for p in preds:
        if tuple(p.shape) != (1,) + IMAGE_HW or not bool(
                ((p >= 0) & (p < cfg["num_classes"])).all()):
            raise AssertionError("predict returned labels of the wrong shape "
                                 "or range")
    with torch.inference_mode():
        logits = make_logits_fn(model, test_cfg, test_cfg["mode"])(
            model, imgs[:1].to(dev))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("main-path logits are not finite")
    refined = [refined_windows(model, imgs[i:i + 1].to(dev), test_cfg)
               for i in range(N_IMAGES)]
    steady = latencies[1:]
    emit("main_path", images=N_IMAGES, image_hw=list(IMAGE_HW),
         model_build_s=build_secs, latency_s=latencies,
         steady_latency_s=steady, images_per_s=len(steady) / sum(steady),
         peak_mem_bytes=peak, launches=counts,
         launches_per_image={k: v // N_IMAGES for k, v in counts.items()},
         refined_windows=refined,
         windows=len(compute_slide_grid(IMAGE_HW, tuple(test_cfg["crop_size"]),
                                        tuple(test_cfg["stride"]))),
         logits_shape=list(logits.shape))
    return model, counts


def phase_card_vs_cpu(model, dev, cfg) -> None:
    test_cfg = cfg["test_cfg"]
    logits_fn = make_logits_fn(model, test_cfg, test_cfg["mode"])
    img = synthetic_images(1, CHECK_HW, SEED + 2)
    with torch.inference_mode():
        card = logits_fn(model, img.to(dev)).float().cpu()
    cpu_model = init_params(build_segmentor(cfg["model"],
                                            dtype=torch.float32), SEED)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = logits_fn(cpu_model, img)
    cpu_secs = time.perf_counter() - t0
    if not bool(torch.isfinite(card).all()):
        raise AssertionError("card logits are not finite")
    err = (card - cpu).abs().numpy().ravel()
    scale = float(np.quantile(np.abs(cpu.numpy()).ravel(), 0.99))
    drift = float(np.quantile(err, 0.99)) / max(scale, 1e-9)
    agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
    ok = drift < DRIFT_Q99 and agree >= ARGMAX_AGREE
    emit("card_vs_cpu", image_hw=list(CHECK_HW), q99_rel_drift=drift,
         drift_limit=DRIFT_Q99, argmax_agreement=agree,
         agreement_limit=ARGMAX_AGREE, max_abs_err=float(err.max()),
         cpu_seconds=cpu_secs, ok=ok)
    if not ok:
        raise AssertionError(f"card vs CPU: q99 drift {drift}, argmax "
                             f"agreement {agree}")


def main() -> None:
    dev_info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    summary = phase_kernels(dev) + phase_kernels_train(dev)
    cfg = headline_config()
    model, counts = phase_main_path(dev, cfg)
    phase_card_vs_cpu(model, dev, cfg)
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(dev, cfg)
    phase_train_breakdown(dev, cfg, state)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    phase_train_card_vs_cpu(dev, cfg)
    for row in summary:
        # each kernel's count from the path that runs it
        row["launches"] = counts[row["name"]] or train_counts[row["name"]]
        row["launches_by_path"] = dict(inference=counts[row["name"]],
                                       train=train_counts[row["name"]])
    print(dev_info["smi"], flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
