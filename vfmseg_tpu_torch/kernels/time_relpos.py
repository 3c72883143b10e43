"""Device time of the rel-pos attention kernel (B7) at SAM's path shapes.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_relpos``

For each shape (chip_smoke.py's ``RELPOS_SHAPES``: the windowed and global
blocks of stage 1, of the refine batch and of the train step; head dim 80,
q, k, v strided views of one fused qkv tensor), the same seeded inputs in
every checkout:

* ``eager_ms`` and ``graph_ms`` of ``attention_relpos_hm``, measured as
  ``time_layer_norm.py`` measures the LayerNorm: CUDA events around 10
  eager calls, and the same calls replayed from a CUDA graph;
* ``max_abs_err`` against ``attention_decomposed_plain`` in fp32.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card compares their kernels. It prints the card's
nvidia-smi name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import json
import subprocess

import torch

from vfmseg_tpu_torch.kernels.time_layer_norm import eager_and_graph_ms
from vfmseg_tpu_torch.ops.attention import (
    attention_decomposed_plain,
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
    del want
    return dict(path=path, shape=[b, h, n, d], grid=list(grid),
                max_abs_err=err, **eager_and_graph_ms(
                    lambda: attention_relpos_hm(q, k, v, rel_h, rel_w, scale),
                    dev))


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


if __name__ == "__main__":
    main()
