"""Device time of B5's forward at its path shapes, through
``multi_head_attention_headmajor``, the entry the head-major paths call.

Usage, from the root of a checkout with a CUDA card:
``python3 -m vfmseg_tpu_torch.kernels.time_hm_fwd``

For each shape (``SHAPES``: EVA02's head-major training attention over both
scale views, forward with the LSE as the training route runs it; B6's
function, the forward without the LSE, over ViT-L's refine batch; SAM's six
blocks on the ``pallas_bias`` route, q, k, v views of one fused qkv tensor
with a bf16 ``[B, H, N, N]`` bias, the train step's two with the LSE and the
four inference ones without; a ragged Nq != Nk case off the path with a
bf16 bias broadcast over the heads), the same seeded inputs in every
checkout, one call of the entry (under autograd, inputs requiring grad,
where the path trains: the forward with the LSE, whose graph is dropped),
and

* ``fwd_ms``: CUDA events around 10 back-to-back calls, the median of 10
  such windows after warm-up (host gaps included);
* ``fwd_device_ms``: the device time of one call, summed over its kernels
  from ``torch.profiler`` over 10 calls, and ``fwd_device_ms_by_kernel``;
* ``fwd_launches``: the kernel entries one call launched;
* ``library_ms``, ``library_device_ms``: the same for one
  ``F.scaled_dot_product_attention`` call (the bias as a float
  ``attn_mask``), a yardstick the port never calls;
* ``bound_ms``: q, k, v and out read or written once, the bias's storage
  read once and the LSE written where it is, over 3.35 TB/s, or the two
  products' 4*B*H*Nq*Nk*D operations over 989 TFLOP/s, whichever is larger
  (an H100 SXM's published peaks at 700 W);
* ``max_abs_err``: against the fp32 plain attention on the same values.

The script imports the package of the checkout it runs in, so running it in
two checkouts on one card (parent, change, change, parent) compares their
forward. It prints the card's nvidia-smi name and power limit, then one
JSON line per shape.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms, median_ms
from vfmseg_tpu_torch.ops.attention import (
    attention_plain,
    multi_head_attention_headmajor,
)

# (path, B, H, Nq, Nk, head dim, bias, with the LSE under autograd)
SHAPES = [("eva02_train", 4, 16, 1025, 1025, 64, None, True),
          ("b6_refine", 18, 16, 1025, 1025, 64, None, False),
          ("sam_stage1_window", 15, 16, 196, 196, 80, "bf16", False),
          ("sam_stage1_global", 1, 16, 2048, 2048, 80, "bf16", False),
          ("sam_refine_window", 162, 16, 196, 196, 80, "bf16", False),
          ("sam_refine_global", 18, 16, 1024, 1024, 80, "bf16", False),
          ("sam_train_window", 36, 16, 196, 196, 80, "bf16", True),
          ("sam_train_global", 4, 16, 1024, 1024, 80, "bf16", True),
          ("ragged_heads_bias", 3, 3, 77, 130, 80, "bf16_heads", False)]
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def inputs(b, h, nq, nk, d, bias_kind, train, dev):
    """Seeded bf16 [B, H, N, D] q, k, v views (SAM's: of one fused
    [B, N, 3, H, D] qkv tensor; else of token-major [B, N, H*D] tensors)
    and the bias view, requiring grad with ``train``."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            dev, torch.bfloat16).requires_grad_(train)

    if bias_kind == "bf16":
        q, k, v = randn(b, nq, 3, h, d).permute(2, 0, 3, 1, 4)
        return q, k, v, randn(b, h, nq, nk, scale=0.5)
    q, k, v = (randn(b, n, h * d).reshape(b, n, h, d).transpose(1, 2)
               for n in (nq, nk, nk))
    bias = None
    if bias_kind == "bf16_heads":
        bias = randn(b, 1, nq, nk, scale=0.5).expand(b, h, nq, nk)
    return q, k, v, bias


def bound_ms(b, h, nq, nk, d, bias, with_lse) -> tuple:
    moved = 2 * b * h * d * (2 * nq + 2 * nk) + 4 * b * h * nq * with_lse
    if bias is not None:
        moved += bias.untyped_storage().nbytes()
    ops = 4.0 * b * h * nq * nk * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_shape(path, b, h, nq, nk, d, bias_kind, train, dev) -> dict:
    scale = d ** -0.5
    q, k, v, bias = inputs(b, h, nq, nk, d, bias_kind, train, dev)

    def ours():
        with torch.set_grad_enabled(train):
            return multi_head_attention_headmajor(q, k, v, scale=scale,
                                                  bias=bias)

    before = kernels.launch_counts()
    got = ours()
    after = kernels.launch_counts()
    launches = {n: after[n] - before[n] for n in after
                if after[n] != before[n]}
    ref = [t.detach().float() for t in (q, k, v)]
    bd = None if bias is None else bias.detach()
    want = attention_plain(*(t.transpose(1, 2) for t in ref), scale=scale,
                           bias=None if bd is None else bd.float())
    err = float((got.detach().float() - want.transpose(1, 2)).abs().max())
    del got, ref, want

    qd, kd, vd = (t.detach() for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=bd,
                                              scale=scale)

    bms, by = bound_ms(b, h, nq, nk, d, bd, train)
    dev_ours, dev_lib = device_ms(ours), device_ms(library)
    return dict(
        path=path, shape=[b, h, nq, nk, d], bias=bias_kind, with_lse=train,
        max_abs_err=err, fwd_launches=launches, fwd_ms=median_ms(ours),
        fwd_device_ms=dev_ours["device_ms"],
        fwd_device_ms_by_kernel=dev_ours["device_ms_by_kernel"],
        library_ms=median_ms(library),
        library_device_ms=dev_lib["device_ms"], bound_ms=bms, bound_by=by)


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
