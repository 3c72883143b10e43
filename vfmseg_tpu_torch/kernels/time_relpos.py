"""Device time of the rel-pos attention kernel (B7) at SAM's path shapes.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_relpos``

For each shape (chip_smoke.py's ``RELPOS_SHAPES``: the windowed and global
blocks of stage 1, of the refine batch and of the train step; head dim 80,
q, k, v strided views of one fused qkv tensor), the same seeded inputs in
every checkout:

* ``ms``: CUDA events around 10 back-to-back ``attention_relpos_hm`` calls,
  the median of 10 such windows after warm-up (host gaps included);
* ``device_ms``: the device time of one call, summed over its kernels from
  ``torch.profiler`` over 10 calls, and ``device_ms_by_kernel``;
* ``sdpa_device_ms``: the same for one ``F.scaled_dot_product_attention``
  call with the ``[B, H, N, N]`` bf16 bias ``rel_h[..., :, None] +
  rel_w[..., None, :]`` as its float ``attn_mask`` (the library call, which
  the port never makes), and ``b5_bias_device_ms`` for B5's bias forward
  (``attention_hm_fwd`` with that bias, SAM's ``pallas_bias`` route): the
  bias is built outside both timings;
* ``bound_ms``: q, k, v, out and the rel terms read or written once over
  3.35 TB/s, or the two products' 4*B*H*N^2*D operations over 989 TFLOP/s,
  whichever is larger (an H100 SXM's published peaks at 700 W);
* ``max_abs_err``: against ``attention_decomposed_plain`` in fp32.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card (parent, change, change, parent) compares their
kernels. It prints the card's nvidia-smi name and power limit, then one
JSON line per shape.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms, median_ms
from vfmseg_tpu_torch.ops.attention import (
    attention_decomposed_plain,
    attention_hm_fwd,
    attention_relpos_hm,
)

# (path, B, H, (kh, kw)) of B7 on SAM's paths, head dim 80: stage 1 (a
# 32x64 grid: 15 windows of 14x14 after padding to 42x70, and the whole
# grid), the refine batch (18 crops of 32x32: 162 windows, 18 grids) and the
# train step (4 views of 32x32: 36 windows, 4 grids)
SHAPES = [("stage1_window", 15, 16, (14, 14)),
          ("stage1_global", 1, 16, (32, 64)),
          ("refine_window", 162, 16, (14, 14)),
          ("refine_global", 18, 16, (32, 32)),
          ("train_window", 36, 16, (14, 14)),
          ("train_global", 4, 16, (32, 32))]
HEAD_DIM = 80
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def bound_ms(b, h, n, d, grid) -> tuple:
    moved = 2 * b * h * n * (4 * d + grid[0] + grid[1])
    ops = 4.0 * b * h * n * n * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_shape(path, b, h, grid, dev) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(0)
    n, d = grid[0] * grid[1], HEAD_DIM
    qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dev, torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    rel_h, rel_w = ((torch.randn((b, h, n, c), generator=gen) * 0.5).to(
        dev, torch.bfloat16) for c in grid)
    scale = d ** -0.5
    want = attention_decomposed_plain(q.float(), k.float(), v.float(), rel_h,
                                      rel_w, scale=scale)
    got = attention_relpos_hm(q, k, v, rel_h, rel_w, scale)
    err = float((got.float() - want).abs().max())
    del want, got
    bias = (rel_h.float().reshape(b, h, n, grid[0], 1)
            + rel_w.float().reshape(b, h, n, 1, grid[1])).reshape(
                b, h, n, n).to(torch.bfloat16)

    def ours():
        return attention_relpos_hm(q, k, v, rel_h, rel_w, scale)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                              scale=scale)

    def b5_bias():
        return attention_hm_fwd(q, k, v, scale, with_lse=False, bias=bias)

    dev_ours = device_ms(ours)
    bms, by = bound_ms(b, h, n, d, grid)
    return dict(path=path, shape=[b, h, n, d], grid=list(grid),
                max_abs_err=err, ms=median_ms(ours),
                device_ms=dev_ours["device_ms"],
                device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
                sdpa_device_ms=device_ms(sdpa)["device_ms"],
                b5_bias_device_ms=device_ms(b5_bias)["device_ms"],
                bound_ms=bms, bound_by=by)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    for path, b, h, grid in SHAPES:
        print(json.dumps(time_shape(path, b, h, grid, dev)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
