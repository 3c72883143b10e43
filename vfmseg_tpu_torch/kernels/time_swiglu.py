"""Device time of EVA02-L's SwiGLU eval route, unpadded against padded, at
the dense path's two shapes.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_swiglu``

For M tokens (the refine call's 18 x 1025 and stage 1's 2049) of E 1024 at
H 2730, in bf16 with fp32 parameters:

* ``unpadded``: the route as the training route computes it: each of w1,
  w2 and w3 cast to bf16 and applied alone (output and K 2730 wide), then
  ``F.silu``, the multiply, and B1 (``layer_norm_cuda``) on the product;
* ``padded`` at each Hp of ``PADS``: one cached ``[2 Hp, E]`` w1|w2
  product, the gate-and-sub-LN kernel (``swiglu_gate_ln_cuda``) and w3 at
  K = Hp.

Each prints, per route, ``device_ms`` (torch.profiler's kernel time a call,
summed over 10 calls), ``gemm_ms`` (the kernels named like a GEMM) and
``other_ms`` (the rest), ``device_ms_by_kernel``, ``graph_ms`` (10 calls
captured in a CUDA graph, the median replay a call) and the GEMMs' rate
against the 989 TFLOP/s bf16 peak; for the padded route also the kernel's
own ``kernel_device_ms`` beside its byte bound (g read, y written, weight
and bias read once, over 3.35 TB/s) and the largest difference from the
unpadded route's output. The script first prints the card's nvidia-smi
name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms
from vfmseg_tpu_torch.kernels.time_layer_norm import eager_and_graph_ms
from vfmseg_tpu_torch.ops.norm import layer_norm_cuda
from vfmseg_tpu_torch.ops.swiglu import swiglu_gate_ln_cuda

E, H = 1024, 2730
ROWS = (18 * 1025, 2049)
# a multiple of 8 (the route's) and of 64
PADS = (2736, 2752)
EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def _params(dev):
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return dict(w1=randn(H, E, scale=E ** -0.5), b1=randn(H, scale=0.02),
                w2=randn(H, E, scale=E ** -0.5), b2=randn(H, scale=0.02),
                w3=randn(E, H, scale=H ** -0.5), b3=randn(E, scale=0.02),
                ln_w=1 + randn(H, scale=0.1), ln_b=randn(H, scale=0.1))


def unpadded(x, p):
    bf = torch.bfloat16
    a = F.linear(x, p["w1"].to(bf), p["b1"].to(bf))
    b = F.linear(x, p["w2"].to(bf), p["b2"].to(bf))
    h = layer_norm_cuda((F.silu(a) * b).contiguous(), p["ln_w"], p["ln_b"],
                        EPS)
    return F.linear(h, p["w3"].to(bf), p["b3"].to(bf))


def padded_params(p, hp):
    pad = hp - H
    w12 = torch.cat([F.pad(p["w1"], (0, 0, 0, pad)),
                     F.pad(p["w2"], (0, 0, 0, pad))])
    b12 = torch.cat([F.pad(p["b1"], (0, pad)), F.pad(p["b2"], (0, pad))])
    return tuple(t.to(torch.bfloat16).contiguous() for t in (
        w12, b12, F.pad(p["w3"], (0, pad)), p["b3"]))


def padded(x, p, cached):
    w12, b12, w3, b3 = cached
    y = swiglu_gate_ln_cuda(F.linear(x, w12, b12), H, p["ln_w"], p["ln_b"],
                            EPS)
    return F.linear(y, w3, b3)


def _times(fn, dev, flops) -> dict:
    prof = device_ms(fn)
    by = prof["device_ms_by_kernel"]
    gemm = sum(ms for k, ms in by.items()
               if any(n in k.lower() for n in GEMM_NAMES))
    return dict(device_ms=prof["device_ms"], gemm_ms=gemm,
                other_ms=prof["device_ms"] - gemm,
                gemm_tflops=flops / (gemm * 1e-3) / 1e12 if gemm else None,
                gemm_peak_share=(flops / (gemm * 1e-3) / PEAK_BF16_FLOPS
                                 if gemm else None),
                graph_ms=eager_and_graph_ms(fn, dev)["graph_ms"],
                device_ms_by_kernel=by)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    p = _params(dev)
    for m in ROWS:
        x = torch.randn(m, E, generator=torch.Generator().manual_seed(m)).to(
            dev, torch.bfloat16)
        flops = 6.0 * m * E * H
        base = unpadded(x, p)
        print(json.dumps(dict(route="unpadded", rows=m, hidden=H,
                              **_times(lambda: unpadded(x, p), dev, flops))),
              flush=True)
        for hp in PADS:
            cached = padded_params(p, hp)
            out = padded(x, p, cached)
            g = F.linear(x, cached[0], cached[1])
            kernel = device_ms(lambda: swiglu_gate_ln_cuda(
                g, H, p["ln_w"], p["ln_b"], EPS))["device_ms"]
            moved = 3 * m * hp * 2 + 2 * H * 4
            print(json.dumps(dict(
                route="padded", rows=m, hidden=H, padded=hp,
                kernel_device_ms=kernel,
                kernel_bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                max_abs_diff=float((out.float() - base.float()).abs().max()),
                **_times(lambda: padded(x, p, cached), dev, flops))),
                flush=True)


if __name__ == "__main__":
    main()
