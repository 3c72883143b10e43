#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Usage, from the root of the repository: ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN so fp32 comparisons
   are fp32.
2. build: the CUDA kernels of ``vfmseg_tpu_torch/csrc`` built by nvcc (or
   loaded from the build cache), with the build seconds.
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, from seeded bf16 inputs (the plain version
   runs in fp32), plus one fp32 LayerNorm and one odd-head attention case
   off the path; and each one's time beside the plain one's (CUDA events
   around 10 back-to-back calls, median of 10 such windows, after warm-up).
4. main_path: the headline model (LoRA DINOv2-L, LinearHead, VFMHead with a
   3-block decoder) at full width with seeded weights in bf16, through
   ``predict`` on 3 synthetic 1024x2048 images; launch counts per kernel,
   latency, images/s and peak memory.
5. card_vs_cpu: one 512x1024 image through the gated slide logits on the
   card (bf16) and on the CPU (fp32, plain path), same seeded weights.

Then the nvidia-smi line, one JSON line of per-kernel results, and as the
last line ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Any failure raises, so the exit code is non-zero and no result line
is printed; so does a machine without a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.eval.evaluator import (
    make_logits_fn,
    make_shape_aware_predict_fn,
)
from vfmseg_tpu_torch.eval.slide import (
    compute_slide_grid,
    confident_mask,
    extract_crops,
)
from vfmseg_tpu_torch.models.build import build_segmentor, compute_dtype
from vfmseg_tpu_torch.models.presets import PREPROCESSOR, headline_config
from vfmseg_tpu_torch.ops.attention import attention_plain, attention_qkv_tm
from vfmseg_tpu_torch.ops.norm import layer_norm_cuda, layer_norm_plain
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.weights import init_params

SEED = 0
N_IMAGES = 3
IMAGE_HW = (1024, 2048)
CHECK_HW = (512, 1024)

# the main path's calls per 1024x2048 image: stage-1 ViT (24 blocks), refine
# ViT over all 18 crops in one batch (24 blocks), VFMHead decoder (3 blocks)
LN_PER_IMAGE = 48 + 48 + 9
ATTN_PER_IMAGE = 24 + 24 + 6

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
# PARITY.md's bf16 feature budget (2e-2), widened for 24 blocks + two heads
DRIFT_Q99 = 5e-2
ARGMAX_AGREE = 0.98


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
            "attention_qkv": N_IMAGES * ATTN_PER_IMAGE}
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
    summary = phase_kernels(dev)
    cfg = headline_config()
    model, counts = phase_main_path(dev, cfg)
    phase_card_vs_cpu(model, dev, cfg)
    for row in summary:
        row["launches"] = counts[row["name"]]
    print(dev_info["smi"], flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
