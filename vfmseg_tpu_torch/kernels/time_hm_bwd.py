"""Device time of B5's backward at its path shapes, through the autograd
Function the training paths take.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_hm_bwd``

For each shape (``SHAPES``: EVA02's head-major training attention over both
scale views; SAM's train-step global and windowed blocks on the
``pallas_bias`` route, q, k, v views of one fused qkv tensor with a bf16
``[B, H, N, N]`` bias; a ragged Nq != Nk case off the path with a bf16 bias
broadcast over the heads), the same seeded inputs in every checkout: one
forward through ``multi_head_attention_headmajor`` (``HeadMajorAttention``)
with q, k, v and the bias requiring grad, then

* ``bwd_ms``: ``torch.autograd.grad(out, inputs, dout, retain_graph=True)``,
  CUDA events around 10 back-to-back calls, the median of 10 such windows
  after warm-up: the checkout's backward kernels with all the Function does
  around them (delta, the gradients' allocation, dbias);
* ``bwd_device_ms``: the device time of one such call, summed over its
  kernels from ``torch.profiler`` over 10 calls, and
  ``bwd_device_ms_by_kernel``: the same by kernel. ``bwd_ms`` counts the
  host's gaps between kernels too: at the small shapes the host's work
  (autograd, the wrapper's checks) outlasts the device's;
* ``bwd_launches``: the kernel entries one such call launched;
* ``library_ms``, ``library_device_ms``: the same through autograd of one
  ``F.scaled_dot_product_attention`` call (the bias as a float
  ``attn_mask``), a yardstick the port never calls;
* ``grad_rel_err``: each gradient's max abs error over max |reference|,
  against autograd through the fp32 plain attention on the same values.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card (parent, change, change, parent) compares their
backward. It prints the card's nvidia-smi name and power limit, then one
JSON line per shape.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.ops.attention import (
    attention_plain,
    multi_head_attention_headmajor,
)

# (path, B, H, Nq, Nk, head dim, bias): EVA02's ViT over both scale views of
# the train step; SAM's train step (4 global blocks over 4 views of 32x32,
# 28 windowed blocks over 36 windows of 14x14); a ragged case off the path
SHAPES = [("eva02_train", 4, 16, 1025, 1025, 64, None),
          ("sam_train_global", 4, 16, 1024, 1024, 80, "bf16"),
          ("sam_train_window", 36, 16, 196, 196, 80, "bf16"),
          ("ragged_heads_bias", 3, 3, 77, 130, 80, "bf16_heads")]
INNER = 10
REPS = 10


def median_ms(fn) -> float:
    """CUDA events around INNER calls of fn, the median over REPS windows,
    after warm-up; ms per call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return float(np.median(times))


def device_ms(fn) -> dict:
    """Device time of one call of fn: its kernels' time summed by
    torch.profiler over INNER calls, in total and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(INNER):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total", 0.0) / 1e3 / INNER
        if ms > 0:
            by_kernel[evt.key[:80]] = by_kernel.get(evt.key[:80], 0.0) + ms
    return dict(device_ms=sum(by_kernel.values()), device_ms_by_kernel=by_kernel)


def views(leaves, b, h, nq, nk, d, bias_kind):
    """The [B, H, N, D] q, k, v views and the bias view the paths hand to
    the attention, from the leaves: SAM's one fused [B, N, 3, H, D] qkv
    tensor (``bias_kind`` "bf16") or three token-major [B, N, H*D]
    projections, then the bias's [B, H or 1, Nq, Nk] tensor."""
    if bias_kind == "bf16":
        q, k, v = leaves[0].permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (t.reshape(b, t.shape[1], h, d).transpose(1, 2)
                   for t in leaves[:3])
    bias = None if bias_kind is None else leaves[-1].expand(b, h, nq, nk)
    return q, k, v, bias


def leaves_and_dout(b, h, nq, nk, d, bias_kind, dev):
    """Seeded bf16 leaves requiring grad (``views`` reads them) and dO."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            dev, torch.bfloat16).requires_grad_(True)

    if bias_kind == "bf16":
        leaves = [randn(b, nq, 3, h, d), randn(b, h, nq, nk, scale=0.5)]
    else:
        leaves = [randn(b, n, h * d) for n in (nq, nk, nk)]
        if bias_kind == "bf16_heads":
            leaves.append(randn(b, 1, nq, nk, scale=0.5))
    return leaves, randn(b, h, nq, d).detach()


def time_shape(path, b, h, nq, nk, d, bias_kind, dev) -> dict:
    scale = d ** -0.5
    shape = (b, h, nq, nk, d, bias_kind)
    leaves, dout = leaves_and_dout(*shape, dev)
    q, k, v, bias = views(leaves, *shape)
    out = multi_head_attention_headmajor(q, k, v, scale=scale, bias=bias)
    before = kernels.launch_counts()
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    after = kernels.launch_counts()
    launches = {n: after[n] - before[n] for n in after
                if after[n] != before[n]}

    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    rq, rk, rv, rbias = views(ref, *shape)
    want = attention_plain(*(t.transpose(1, 2) for t in (rq, rk, rv)),
                           scale=scale, bias=rbias)
    want_g = torch.autograd.grad(want, ref, dout.float().transpose(1, 2))
    errs = [float((g.float() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want_g)]
    del ref, rq, rk, rv, rbias, want, want_g

    lib = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                         scale=scale)

    def ours():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    def library():
        return torch.autograd.grad(lib, leaves, dout, retain_graph=True)

    dev_ours, dev_lib = device_ms(ours), device_ms(library)
    return dict(
        path=path, shape=[b, h, nq, nk, d], bias=bias_kind,
        grad_rel_err=errs, bwd_launches=launches, bwd_ms=median_ms(ours),
        bwd_device_ms=dev_ours["device_ms"],
        bwd_device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
        library_ms=median_ms(library),
        library_device_ms=dev_lib["device_ms"])


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
