"""Device time of the deformable sampler (B8) at the pixel decoder's eval
level.

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
from vfmseg_tpu_torch.ops.deform_attn import sample_cuda, sample_plain

# (B, H, W, C, N) of B8 at the pixel decoder's eval level
SHAPE = (144, 32, 32, 32, 12288)
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


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        print(json.dumps(time_case(dtype, dev)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
