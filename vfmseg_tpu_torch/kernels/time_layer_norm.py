"""Device time of the LayerNorm kernel at the paths' shapes, measured two ways.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_layer_norm``

* ``eager_ms``: CUDA events around 10 back-to-back calls of
  ``layer_norm_cuda``, the median of 10 such windows after warm-up
  (chip_smoke.py's method). When a call's host time (checks, allocation,
  the ctypes launch) exceeds the kernel's, the card waits on the host
  between launches and the window counts that wait.
* ``graph_ms``: the same 10 calls captured once in a CUDA graph and
  replayed, the median of 10 replays: the kernels back to back with no host
  work between them.
* ``device_ms``: the kernel's device time a call, summed by
  ``torch.profiler`` over 10 calls, with ``device_ms_by_kernel``.
* ``library_device_ms``: the same for one ``F.layer_norm`` call (weight and
  bias in x's dtype, as it takes them), a yardstick the port never calls.
* ``bound_ms``: x read and y written once, fp32 weight and bias read once,
  over 3.35 TB/s; ``copy_device_ms``: the device time of one
  ``Tensor.copy_`` of x into a tensor like it, the same bytes at the rate
  the card reaches for a plain copy.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card compares their kernels. It prints the card's
nvidia-smi name and power limit, then one JSON line per shape; a shape the
checkout's wrapper refuses is printed with the refusal.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

import torch.nn.functional as F

from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms
from vfmseg_tpu_torch.ops.norm import layer_norm_cuda

# (shape, dtype): the DINOv2 path's LayerNorms (stage 1, refine batch,
# decoder), an fp32 input, and EVA02's 2730-wide sub-LN at the refine
# batch, stage 1 and the train batch
SHAPES = [((1, 2049, 1024), torch.bfloat16),
          ((18, 1025, 1024), torch.bfloat16),
          ((18, 1024, 256), torch.bfloat16),
          ((18, 1025, 1024), torch.float32),
          ((18 * 1025, 2730), torch.bfloat16),
          ((2049, 2730), torch.bfloat16),
          ((4 * 1025, 2730), torch.bfloat16)]
HBM_BYTES_PER_S = 3.35e12
INNER = 10
REPS = 10


def _median_ms(run) -> float:
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return float(np.median(times))


def eager_and_graph_ms(call, dev) -> dict:
    """``eager_ms`` and ``graph_ms`` (module doc) of ``call``, a function
    that launches the kernel once."""
    def eager():
        for _ in range(INNER):
            call()

    for _ in range(3):
        eager()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager()  # warm the allocator's pool on the capture stream
        with torch.cuda.graph(graph, stream=side):
            eager()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize(dev)
    return dict(eager_ms=_median_ms(eager), graph_ms=_median_ms(graph.replay))


def time_shape(shape, dtype, dev) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, generator=gen).to(dev, dtype)
    w = (torch.randn(c, generator=gen) * 0.1 + 1.0).to(dev)
    b = (torch.randn(c, generator=gen) * 0.1).to(dev)
    moved = 2 * x.numel() * x.element_size() + 2 * c * 4
    row = dict(shape=list(shape), dtype=str(dtype),
               bound_ms=moved / HBM_BYTES_PER_S * 1e3)
    try:
        layer_norm_cuda(x, w, b, 1e-6)
    except ValueError as err:
        return dict(row, refused=str(err))
    ours = device_ms(lambda: layer_norm_cuda(x, w, b, 1e-6))
    y = torch.empty_like(x)
    wl, bl = w.to(dtype), b.to(dtype)
    return dict(row, **eager_and_graph_ms(
        lambda: layer_norm_cuda(x, w, b, 1e-6), dev),
        device_ms=ours["device_ms"],
        device_ms_by_kernel=ours["device_ms_by_kernel"],
        library_device_ms=device_ms(lambda: F.layer_norm(
            x, (c,), wl, bl, 1e-6))["device_ms"],
        copy_device_ms=device_ms(lambda: y.copy_(x))["device_ms"])


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    for shape, dtype in SHAPES:
        print(json.dumps(time_shape(shape, dtype, dev)), flush=True)


if __name__ == "__main__":
    main()
