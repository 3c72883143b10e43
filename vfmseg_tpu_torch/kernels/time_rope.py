"""Device time of B2-RoPE, EVA02's inference attention, at its path shapes,
beside B2 on the same views without the rotation and one PyTorch call that
computes that attention.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_rope``

For each shape (``SHAPES``: EVA02's stage-1 image and refine batch, each
off one fused qkv tensor, with the ViT's RoPE tables in the evens|odds
layout and the cls token's identity row), the same seeded inputs in every
checkout, and

* ``ms``: ``attention_qkv_rope_tm``, CUDA events around 10 back-to-back
  calls, the median of 10 such windows after warm-up (host gaps included);
* ``device_ms``: the device time of one call, summed over its kernels from
  ``torch.profiler`` over 10 calls, and ``device_ms_by_kernel``;
  ``rotate_device_ms`` is the rotation pass's share (kernels named
  ``rope_rotate``; 0 where the checkout rotates inside the attention);
* ``host_us``: the host's time to issue one call, the least over 5 windows
  of 200 calls issued back to back;
* ``b2_ms``, ``b2_device_ms``: ``attention_qkv_tm`` on the same q, k, v
  without the rotation; ``library_ms``, ``library_device_ms``: one
  ``F.scaled_dot_product_attention`` call on their ``[B, H, N, 64]`` views,
  also without the rotation (no single PyTorch call rotates), a yardstick
  the port never calls;
* ``bound_ms``: q, k, v read, out written and the two fp32 tables read once
  over 3.35 TB/s, or the two products' 4*B*H*N^2*64 operations over 989
  TFLOP/s, whichever is larger; ``rotate_bound_ms``: the rotation alone (q
  and k read and written once, the tables read once over 3.35 TB/s; its 3
  fp32 operations an element are far below 67 TFLOP/s);
* ``max_abs_err``: against the fp32 plain attention on the twin's rotated
  values (``attention_qkv_rope_plain``'s rotation, rounded to bf16).

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card (parent, change, change, parent) compares them. It
prints the card's nvidia-smi name and power limit, then one JSON line per
shape.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms, median_ms
from vfmseg_tpu_torch.kernels.time_qkv_fwd import host_us, inputs
from vfmseg_tpu_torch.ops.attention import (
    _heads_hm,
    attention_plain,
    attention_qkv_rope_tm,
    attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.rope import (
    apply_rope_permuted,
    permuted_rope_tables,
    vit_rope_tables,
)

# (B, N, H, (gh, gw)): EVA02's stage 1 (one 512x1024 image, a 32x64 grid)
# and refine batch (18 crops of 512, 32x32), a cls token each
SHAPES = [(1, 2049, 16, (32, 64)), (18, 1025, 16, (32, 32))]
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def tables(grid, dev):
    """The ViT's fp32 [N, 64] cos/sin in the evens|odds layout."""
    cos, sin = permuted_rope_tables(*vit_rope_tables(grid[0], grid[1], 64, 1,
                                                     16, True))
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                 for t in (cos, sin))


def time_shape(b, n, h, grid, dev) -> dict:
    scale = 64 ** -0.5
    e = h * 64
    q, k, v = inputs(b, n, h, True, dev)
    cos, sin = tables(grid, dev)
    hq, hk, hv = (_heads_hm(t, h) for t in (q, k, v))

    def ours():
        return attention_qkv_rope_tm(q, k, v, cos, sin, h, scale)

    def b2():
        return attention_qkv_tm(q, k, v, h, scale)

    def library():
        return F.scaled_dot_product_attention(hq, hk, hv, scale=scale)

    c, s = cos[None, :, None, :], sin[None, :, None, :]
    qr, kr = (apply_rope_permuted(t.float().reshape(b, n, h, 64), c, s)
              .to(torch.bfloat16).float() for t in (q, k))
    want = attention_plain(qr, kr, v.float().reshape(b, n, h, 64),
                           scale=scale).reshape(b, n, e)
    err = float((ours().float() - want).abs().max())
    del qr, kr, want
    table_bytes = 2 * n * 64 * 4
    moved = 4 * b * n * e * 2 + table_bytes
    ops = 4.0 * b * h * n * n * 64
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    rot_moved = 2 * 2 * b * n * e * 2 + table_bytes
    dev_ours = device_ms(ours)
    return dict(
        shape=[b, n, h, 64], grid=list(grid), max_abs_err=err,
        ms=median_ms(ours), device_ms=dev_ours["device_ms"],
        device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
        rotate_device_ms=sum(ms for name, ms in
                             dev_ours["device_ms_by_kernel"].items()
                             if "rope_rotate" in name),
        host_us=host_us(ours), b2_ms=median_ms(b2),
        b2_device_ms=device_ms(b2)["device_ms"],
        library_ms=median_ms(library),
        library_device_ms=device_ms(library)["device_ms"],
        library_call="F.scaled_dot_product_attention (no rotation)",
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        rotate_bound_ms=rot_moved / HBM_BYTES_PER_S * 1e3,
        rotate_bound_by="bytes")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    for shape in SHAPES:
        print(json.dumps(time_shape(*shape, dev)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
