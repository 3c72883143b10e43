"""Device time of B2 and B3, the fused-qkv attention forwards, at their path
shapes, beside B5's forward on the same views and one PyTorch call that
computes the same function.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_qkv_fwd``

For each shape (``SHAPES``: B2 over DINOv2's stage-1 image and refine batch
off the fused qkv and the decoder's three separate tensors; B3 over the
train step's two scale views off the fused qkv and the decoder's three
tensors), the same seeded inputs in every checkout, and

* ``ms``: the entry (``attention_qkv_tm`` for B2, ``attention_fwd_lse_tm``
  for B3), CUDA events around 10 back-to-back calls, the median of 10 such
  windows after warm-up (host gaps included);
* ``device_ms``: the device time of one call, summed over its kernels from
  ``torch.profiler`` over 10 calls, and ``device_ms_by_kernel``;
* ``host_us``: the host's time to issue one call (the wrapper's checks and,
  in a checkout that encodes TMA maps, the encodes), the least over 5
  windows of 200 calls issued back to back;
* ``b5_ms``, ``b5_device_ms``: B5's forward entry (``attention_hm_fwd``,
  with the LSE for B3) on the ``[B, H, N, 64]`` views of the same tensors,
  the route the token-major entries could take instead;
* ``library_ms``, ``library_device_ms``: for B2 one
  ``F.scaled_dot_product_attention`` call on those views; for B3 the faster
  (by device time) of the two single calls that also return the LSE
  (``LSE_LIBRARY_CALLS``: FlashAttention-2's and cuDNN's), each of which is
  also reported under ``libraries`` with its times and its LSE's agreement
  with ours (a call whose LSE differs by more than ``LSE_ATOL`` computes
  another function and is not picked); a yardstick the port never calls;
* ``bound_ms``: q, k, v read and out (and the LSE) written once over 3.35
  TB/s, or the two products' 4*B*H*N^2*64 operations over 989 TFLOP/s,
  whichever is larger (an H100 SXM's published peaks at 700 W);
* ``max_abs_err`` and ``lse_max_abs_err``: against the fp32 plain attention
  on the same values.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card (parent, change, change, parent) compares them. It
prints the card's nvidia-smi name and power limit, then one JSON line per
shape.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms, median_ms
from vfmseg_tpu_torch.ops.attention import (
    _heads_hm,
    attention_fwd_lse_plain,
    attention_fwd_lse_tm,
    attention_hm_fwd,
    attention_qkv_tm,
)

# (entry, B, N, H, fused qkv?): B2 at DINOv2's stage 1 (one 512x1024 image)
# and refine batch (18 crops of 512), and the decoder's three tensors; B3 at
# the train step's ViT over both scale views and the decoder's tensors
SHAPES = [("b2", 1, 2049, 16, True), ("b2", 18, 1025, 16, True),
          ("b2", 18, 1024, 8, False), ("b3", 4, 1025, 16, True),
          ("b3", 2, 1024, 8, False)]
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
HOST_CALLS = 200
HOST_REPS = 5
# the LSE a library call must agree with ours within to compute the same
# function (chip_smoke.py's tolerance of the kernel's LSE)
LSE_ATOL = 1e-3


def lse_library_calls(hq, hk, hv, scale) -> dict:
    """The single PyTorch calls that compute the attention forward and its
    natural-log LSE over [B, H, N, 64] views, by name; each returns
    ``(out, lse)``. Yardsticks the port never calls."""
    aten = torch.ops.aten
    return {
        "torch.ops.aten._scaled_dot_product_flash_attention":
            lambda: aten._scaled_dot_product_flash_attention(
                hq, hk, hv, scale=scale)[:2],
        "torch.ops.aten._scaled_dot_product_cudnn_attention":
            lambda: aten._scaled_dot_product_cudnn_attention(
                hq, hk, hv, None, True, scale=scale)[:2],
    }


def lse_agreement(call, lse) -> dict:
    """Runs one of ``lse_library_calls`` once: its LSE's largest difference
    from ``lse`` and whether that is within LSE_ATOL."""
    diff = float((call()[1].float().reshape(lse.shape) - lse).abs().max())
    return dict(same_function=diff <= LSE_ATOL, lse_max_abs_diff=diff)


def inputs(b, n, h, fused, dev):
    """Seeded bf16 [B, N, H*64] q, k, v: the thirds of one fused qkv
    tensor, or three tensors."""
    e = h * 64
    x = np.random.RandomState(0).standard_normal((b, n, 3 * e))
    qkv = torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)
    if fused:
        return qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    return tuple(qkv[..., i * e:(i + 1) * e].contiguous() for i in range(3))


def bound_ms(b, n, h, with_lse) -> tuple:
    moved = 4 * b * n * h * 64 * 2 + 4 * b * h * n * with_lse
    ops = 4.0 * b * h * n * n * 64
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def host_us(fn) -> float:
    """Host time to issue one call: HOST_CALLS calls back to back, the least
    over HOST_REPS such windows (the host's own noise only adds)."""
    best = float("inf")
    for _ in range(HOST_REPS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / HOST_CALLS * 1e6


def time_shape(entry, b, n, h, fused, dev) -> dict:
    scale = 64 ** -0.5
    with_lse = entry == "b3"
    q, k, v = inputs(b, n, h, fused, dev)
    hq, hk, hv = (_heads_hm(t, h) for t in (q, k, v))

    def ours():
        if with_lse:
            return attention_fwd_lse_tm(q, k, v, h, scale)
        return attention_qkv_tm(q, k, v, h, scale), None

    def b5():
        return attention_hm_fwd(hq, hk, hv, scale, with_lse=with_lse)

    def library():
        return F.scaled_dot_product_attention(hq, hk, hv, scale=scale)

    got, got_lse = ours()
    want, want_lse = attention_fwd_lse_plain(
        *(t.float().reshape(b, n, h, 64) for t in (q, k, v)), scale=scale)
    err = float((got.float() - want.reshape(b, n, h * 64)).abs().max())
    row = dict(entry=entry, shape=[b, n, h, 64], fused_qkv=fused,
               max_abs_err=err)
    libraries = {"F.scaled_dot_product_attention": dict(same_function=True)}
    calls = {"F.scaled_dot_product_attention": library}
    if with_lse:
        row["lse_max_abs_err"] = float((got_lse - want_lse).abs().max())
        calls = lse_library_calls(hq, hk, hv, scale)
        libraries = {name: lse_agreement(call, got_lse)
                     for name, call in calls.items()}
    del got, got_lse, want, want_lse
    for name, lib in libraries.items():
        lib.update(ms=median_ms(calls[name]),
                   device_ms=device_ms(calls[name])["device_ms"])
    same = [name for name, lib in libraries.items() if lib["same_function"]]
    if not same:
        raise RuntimeError(f"no library call computes the same function: "
                           f"{libraries}")
    fastest = min(same, key=lambda name: libraries[name]["device_ms"])
    dev_ours, dev_b5 = device_ms(ours), device_ms(b5)
    bms, by = bound_ms(b, n, h, with_lse)
    row.update(
        ms=median_ms(ours), device_ms=dev_ours["device_ms"],
        device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
        host_us=host_us(ours), b5_ms=median_ms(b5),
        b5_device_ms=dev_b5["device_ms"], b5_host_us=host_us(b5),
        library_ms=libraries[fastest]["ms"],
        library_device_ms=libraries[fastest]["device_ms"],
        library_call=fastest, libraries=libraries, bound_ms=bms, bound_by=by)
    return row


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
