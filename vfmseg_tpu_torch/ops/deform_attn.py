"""Multi-scale deformable attention sampling on a hand-written CUDA kernel.

Port of vfmseg_tpu/ops/deform_attn.py:39-67 (``_sample_nhwc_xy``),
:107-209 (``_sample_pallas_xy`` and its VJP ``_sample_pallas``) and :231-257
(``ms_deform_attn_core``). Semantics follow mmcv's MSDeformAttn: sampling
locations normalised to [0, 1], bilinear sampling with align_corners=False
and zero padding, per-head softmaxed weights over the levels and points.

* :func:`sample_plain` is the plain PyTorch version: four gathers and the
  lerp, in the value's dtype, as the JAX gather computes it.
* :func:`sample_cuda` launches B8 (``csrc/deform_sample.cu``): a thread
  takes 16 bytes of a sample's channels (narrower where C or the data's
  alignment asks), persistent blocks over contiguous runs of samples, fp32
  weights and sums rounded once.
* :class:`DeformSample` is the autograd Function around the two: the kernel
  on CUDA tensors and the plain version on CPU tensors forward; the backward
  recomputes through the plain version under autograd, as the JAX VJP
  recomputes through its matmul formulation (the two agree in fp32).
* :func:`ms_deform_attn_core` samples every level once with the heads folded
  into the batch, then weights the samples and sums over levels and points.

Layouts are the JAX package's: a level's value ``[B, H, W, C]`` (NHWC),
coordinates as separate ``[B, N]`` x and y arrays.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vfmseg_tpu_torch.kernels import DEFORM_SAMPLE

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sample_plain(value: torch.Tensor, xn: torch.Tensor,
                 yn: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling (the twin of ``_sample_nhwc_xy``).
    value: [B, H, W, C]; xn, yn: [B, N] normalised (pixel centres at
    (i + 0.5) / size). Returns [B, N, C] in value's dtype."""
    b, h, w, c = value.shape
    x = xn * w - 0.5
    y = yn * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None].to(value.dtype)
    fy = (y - y0)[..., None].to(value.dtype)
    flat = value.reshape(b, h * w, c)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        out = torch.gather(flat, 1, idx[..., None].expand(b, idx.shape[1], c))
        return torch.where(inside[..., None], out, torch.zeros_like(out))

    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def sample_cuda(value: torch.Tensor, xn: torch.Tensor,
                yn: torch.Tensor) -> torch.Tensor:
    """Launch B8 on a contiguous fp32 or bf16 CUDA value ``[B, H, W, C]``
    and contiguous fp32 ``[B, N]`` coordinates on the same card. Returns a
    new contiguous ``[B, N, C]`` tensor in value's dtype."""
    fn = "sample_cuda"
    for t in (value, xn, yn):
        if not t.is_cuda:
            raise ValueError(f"{fn} needs CUDA tensors, got one on {t.device}")
    if value.dim() != 4 or value.dtype not in _DTYPES or not (
            value.is_contiguous()):
        raise ValueError(f"{fn} takes a contiguous fp32 or bf16 [B, H, W, C] "
                         f"value, got {value.dtype} {tuple(value.shape)}")
    b, h, w, c = value.shape
    for name, t in (("xn", xn), ("yn", yn)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != b
                or t.shape != xn.shape or not t.is_contiguous()
                or t.device != value.device):
            raise ValueError(f"{fn} needs contiguous fp32 [B, N] {name} of "
                             f"one shape on {value.device}")
    n = xn.shape[1]
    if max(b * n, value.numel()) >= 2**31:
        raise ValueError(f"{fn}: {b} x {n} samples exceed the launch limits")
    out = torch.empty((b, n, c), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    DEFORM_SAMPLE(value.data_ptr(), xn.data_ptr(), yn.data_ptr(),
                  out.data_ptr(), b, n, h, w, c, _DTYPES[value.dtype],
                  torch.cuda.current_stream(value.device).cuda_stream)
    return out


class DeformSample(torch.autograd.Function):
    """Bilinear sampling with the JAX rule's VJP (``_sample_pallas``): B8
    (CUDA) or :func:`sample_plain` (CPU) forward, the backward through
    :func:`sample_plain` for the value and both coordinates."""

    @staticmethod
    def forward(ctx, value, xn, yn):
        ctx.save_for_backward(value, xn, yn)
        if value.is_cuda:
            return sample_cuda(value.contiguous(), xn.contiguous(),
                               yn.contiguous())
        return sample_plain(value, xn, yn)

    @staticmethod
    def backward(ctx, dout):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = sample_plain(*inputs)
        return torch.autograd.grad(out, inputs, dout)


def ms_deform_attn_core(value_list: Sequence[torch.Tensor],
                        loc_x: torch.Tensor, loc_y: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """value_list: per level [B, H_l, W_l, heads, d]; loc_x, loc_y:
    [B, heads, L, P, Nq] normalised fp32; attention_weights:
    [B, heads, L, P, Nq], softmaxed over (L, P) jointly. Returns
    [B, Nq, heads*d] in the values' dtype."""
    b, heads, _, num_points, nq = loc_x.shape
    out = None
    for lvl, value in enumerate(value_list):
        _, h, w, _, d = value.shape
        # fold the heads into the batch: each head samples its own plane
        v = value.permute(0, 3, 1, 2, 4).reshape(b * heads, h, w, d)
        x = loc_x[:, :, lvl].reshape(b * heads, num_points * nq)
        y = loc_y[:, :, lvl].reshape(b * heads, num_points * nq)
        sampled = DeformSample.apply(v, x, y).reshape(b, heads, num_points,
                                                      nq, d)
        wts = attention_weights[:, :, lvl].to(sampled.dtype)
        o = torch.einsum("bhpnd,bhpn->bnhd", sampled, wts)
        out = o if out is None else out + o
    return out.reshape(b, nq, heads * d)
