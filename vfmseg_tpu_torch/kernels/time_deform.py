"""Device time of the deformable sampler (B8) at the pixel decoder's eval
level, and of the fused core (``csrc/deform_attn.cu``) at Rein's slide.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_deform``

For the eval level (chip_smoke.py's ``DEFORM_SHAPE``: 18 crops x 8 heads,
a 32x32 level of 32 channels, 4 points x 3072 queries a row) in bf16 and in
fp32, the same seeded inputs in every checkout (coordinates in [-0.1, 1.1],
so some taps fall outside the plane):

* ``ms``: CUDA events around 10 back-to-back ``sample_cuda`` calls, the
  median of 10 such windows after warm-up (host gaps included);
* ``device_ms``: the device time of one call from ``torch.profiler`` over
  10 calls, and ``device_ms_by_kernel``;
* ``grid_sample_device_ms``: the same for one ``F.grid_sample`` call
  (bilinear, zero padding, align_corners=False) on the value as
  ``[B, C, H, W]`` and the grid in the value's dtype, built outside the
  timing: the library call, which the port never makes;
* ``bound_ms``: the value read once, both fp32 coordinates read and the
  output written once over 3.35 TB/s (an H100 SXM's published peak at
  700 W); ~7 fp32 operations a channel of a sample are far below the card's
  rate;
* ``max_abs_err``: against ``sample_plain`` in fp32.

For the fused core, one encoder layer at Rein's slide (``FUSED``: 18 crops,
8 heads of 32, levels 16^2, 32^2 and 64^2, 4 points, 5376 queries) in bf16
and fp32, from seeded GEMM outputs (offsets of a few pixels, some far
outside) and the pixel decoder's reference points (``fused_inputs``):

* ``ms``, ``device_ms``, ``device_ms_by_kernel``: as above, for one
  ``ms_deform_attn_cuda`` call;
* ``bound_ms``: the value, offsets, logits and reference points read once
  and the output written once over 3.35 TB/s (0.155 GB a layer in bf16);
* ``plain_ms``: CUDA events around the plain twin;
* ``chain_ms``, ``chain_device_ms``, ``chain_device_ms_by_kernel``: the
  training route from the same projections' outputs under ``no_grad``
  (``ms_deform_attn_levels``: the layouts, softmax and locations, B8 a
  level, the samples' copies, the batched gemv and the level sums), which
  the eval route ran before the fused core;
* ``max_abs_err``: against the twin in fp32.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card (parent, change, change, parent) compares their
kernels. It prints the card's nvidia-smi name and power limit, then one
JSON line per case.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms, median_ms
from vfmseg_tpu_torch.models.heads.mask2former import _reference_points
from vfmseg_tpu_torch.ops.deform_attn import (
    ms_deform_attn_cuda,
    ms_deform_attn_levels,
    ms_deform_attn_plain,
    sample_cuda,
    sample_plain,
)

# (B, H, W, C, N) of B8 at the pixel decoder's eval level
SHAPE = (144, 32, 32, 32, 12288)
# (B, levels, heads, d, points) of the fused core at Rein's slide
FUSED = (18, ((16, 16), (32, 32), (64, 64)), 8, 32, 4)
HBM_BYTES_PER_S = 3.35e12


def time_case(dtype, dev) -> dict:
    b, h, w, c, n = SHAPE
    gen = torch.Generator(device="cpu").manual_seed(0)
    value = torch.randn((b, h, w, c), generator=gen).to(dev, dtype)
    xn, yn = ((torch.rand((b, n), generator=gen) * 1.2 - 0.1).to(dev)
              for _ in range(2))
    want = sample_plain(value.float(), xn, yn)
    err = float((sample_cuda(value, xn, yn).float() - want).abs().max())
    del want
    vnchw = value.permute(0, 3, 1, 2)
    grid = torch.stack([xn * 2 - 1, yn * 2 - 1], -1)[:, None].to(dtype)

    def ours():
        return sample_cuda(value, xn, yn)

    def library():
        return F.grid_sample(vnchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)

    item = value.element_size()
    moved = value.numel() * item + 2 * b * n * 4 + b * n * c * item
    dev_ours = device_ms(ours)
    return dict(shape=[b, h, w, c], samples=n, dtype=str(dtype),
                max_abs_err=err, ms=median_ms(ours),
                device_ms=dev_ours["device_ms"],
                device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
                grid_sample_device_ms=device_ms(library)["device_ms"],
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def fused_inputs(dtype, dev) -> tuple:
    """One encoder layer's seeded GEMM outputs at ``FUSED``, the arguments
    of ``ms_deform_attn_cuda``: the value, offsets of a few pixels (every
    seventh query's forty times as far, so whole samples fall off the
    planes), logits, and the pixel decoder's reference points (each level's
    pixel centres in raster order, so neighbouring queries sample
    neighbouring places)."""
    b, shapes, heads, d, points = FUSED
    nq = sum(h * w for h, w in shapes)
    lp = len(shapes) * points
    gen = torch.Generator(device="cpu").manual_seed(1)
    value = torch.randn((b, nq, heads * d), generator=gen).to(dev, dtype)
    off = torch.randn((b, nq, heads * lp * 2), generator=gen) * 3
    off[:, ::7] *= 40
    offsets = off.to(dev, dtype)
    logits = (torch.randn((b, nq, heads * lp), generator=gen) * 2).to(
        dev, dtype)
    ref_x, ref_y = _reference_points(shapes, dev)
    return value, offsets, logits, ref_x, ref_y, shapes, heads, points


def time_fused(dtype, dev) -> dict:
    b, shapes, heads, d, points = FUSED
    nq = sum(h * w for h, w in shapes)
    args = fused_inputs(dtype, dev)
    value, offsets, logits, ref_x, ref_y = args[:5]
    want = ms_deform_attn_plain(*(t.float() for t in args[:3]), *args[3:])
    err = float((ms_deform_attn_cuda(*args).float() - want).abs().max())
    del want
    levels, start = [], 0
    for h, w in shapes:
        levels.append(value[:, start:start + h * w].reshape(b, h, w, -1))
        start += h * w

    def ours():
        return ms_deform_attn_cuda(*args)

    def chain():
        with torch.no_grad():
            return ms_deform_attn_levels(
                levels, offsets, logits, ref_x, ref_y, heads, points)

    def plain():
        return ms_deform_attn_plain(*args)

    moved = sum(t.numel() * t.element_size() for t in args[:5]) + (
        value.numel() * value.element_size())
    dev_ours, dev_chain = device_ms(ours), device_ms(chain)
    return dict(case="fused", batch=b, levels=[list(s) for s in shapes],
                heads=heads, head_dim=d, points=points, queries=nq,
                dtype=str(dtype), max_abs_err=err, ms=median_ms(ours),
                device_ms=dev_ours["device_ms"],
                device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
                plain_ms=median_ms(plain), chain_ms=median_ms(chain),
                chain_device_ms=dev_chain["device_ms"],
                chain_device_ms_by_kernel=dev_chain["device_ms_by_kernel"],
                bound_gb=moved / 1e9, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    for case in (time_fused, time_case):
        for dtype in (torch.bfloat16, torch.float32):
            print(json.dumps(case(dtype, dev)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
