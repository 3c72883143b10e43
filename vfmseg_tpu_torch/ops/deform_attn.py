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
  into the batch, then weights the samples and sums over levels and points;
  :func:`ms_deform_attn_levels` brings the projections' outputs to it. The
  training route, whose backward goes through :class:`DeformSample`.
* :func:`ms_deform_attn` is the whole core where nothing needs a gradient,
  from the projections' outputs as they are: the softmax of the attention
  logits, the locations, every sample and the weighted sum over levels and
  points, kept in fp32 and rounded once. On CUDA tensors it launches
  ``csrc/deform_attn.cu`` (:func:`ms_deform_attn_cuda`), on CPU tensors it
  runs :func:`ms_deform_attn_plain`, the same arithmetic in plain PyTorch.

Layouts are the JAX package's: a level's value ``[B, H, W, C]`` (NHWC),
coordinates as separate ``[B, N]`` x and y arrays; the fused core takes the
value token stream ``[B, sum(H W), C]`` with the levels back to back.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from vfmseg_tpu_torch.kernels import DEFORM_ATTN, DEFORM_SAMPLE

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


def ms_deform_attn_levels(values: Sequence[torch.Tensor],
                          offsets: torch.Tensor, logits: torch.Tensor,
                          ref_x: torch.Tensor, ref_y: torch.Tensor,
                          heads: int, points: int) -> torch.Tensor:
    """The training route from the projections' outputs: values per level
    ``[B, H, W, heads*d]``; offsets, logits, ref_x and ref_y as
    :func:`ms_deform_attn` takes them. The softmax in the logits' dtype,
    fp32 locations laid out with Nq last, then :func:`ms_deform_attn_core`.
    Returns ``[B, Nq, heads*d]`` in the values' dtype."""
    b, nq, _ = offsets.shape
    levels, d = len(values), values[0].shape[-1] // heads
    vals = [v.reshape(v.shape[:3] + (heads, d)) for v in values]
    # every coordinate and weight tensor keeps Nq as its last dimension
    off = offsets.transpose(1, 2).reshape(b, heads, levels, points, 2,
                                          nq).float()
    attn = logits.transpose(1, 2).reshape(b, heads, levels * points, nq)
    attn = torch.softmax(attn, dim=2).reshape(b, heads, levels, points, nq)
    # fp32 locations: the reference point plus the offset in units of each
    # level's pixels (1/W, 1/H)
    loc_x, loc_y = (torch.stack(
        [ref + off[:, :, lvl, :, axis] * np.float32(1.0 / v.shape[2 - axis])
         for lvl, v in enumerate(vals)], dim=2)
        for axis, ref in ((0, ref_x), (1, ref_y)))
    return ms_deform_attn_core(vals, loc_x, loc_y, attn)


def fused_supported(levels: int, points: int) -> bool:
    """Whether ``csrc/deform_attn.cu`` takes these counts: 1 to 4 levels and
    levels x points up to 32 (a query's softmax in a warp's lanes)."""
    return 1 <= levels <= 4 and points >= 1 and levels * points <= 32


def ms_deform_attn_plain(value: torch.Tensor, offsets: torch.Tensor,
                         logits: torch.Tensor, ref_x: torch.Tensor,
                         ref_y: torch.Tensor,
                         shapes: Sequence[Tuple[int, int]], heads: int,
                         points: int) -> torch.Tensor:
    """The fused core's plain twin: value ``[B, Nv, heads*d]`` with the
    levels' ``shapes`` back to back; offsets ``[B, Nq, heads*L*P*2]`` and
    logits ``[B, Nq, heads*L*P]`` in (head, level, point, axis) order;
    ref_x, ref_y fp32 ``[Nq]``. The softmax, locations (the offset times
    the fp32 ``1 / W``, then the reference point added), samples and the
    sum over levels and points in fp32; returns ``[B, Nq, heads*d]``
    rounded once to the value's dtype."""
    b, nv, c = value.shape
    nq = offsets.shape[1]
    levels, d = len(shapes), c // heads
    off = offsets.float().reshape(b, nq, heads, levels, points, 2)
    wts = torch.softmax(logits.float().reshape(b, nq, heads, levels * points),
                        dim=-1).reshape(b, nq, heads, levels, points)
    v = value.float()
    out, start = None, 0
    for lvl, (h, w) in enumerate(shapes):
        plane = v[:, start:start + h * w].reshape(b, h, w, heads, d).permute(
            0, 3, 1, 2, 4).reshape(b * heads, h, w, d)
        # [B, Nq, heads, P] -> [B heads, P Nq], as B8's batch rows
        xn, yn = ((ref[:, None, None] + off[:, :, :, lvl, :, axis]
                   * np.float32(1.0 / size)).permute(0, 2, 3, 1).reshape(
                       b * heads, points * nq)
                  for axis, ref, size in ((0, ref_x, w), (1, ref_y, h)))
        sampled = sample_plain(plane, xn, yn).reshape(b, heads, points, nq, d)
        o = torch.einsum("bhpnd,bnhp->bnhd", sampled, wts[:, :, :, lvl])
        out = o if out is None else out + o
        start += h * w
    return out.reshape(b, nq, c).to(value.dtype)


def ms_deform_attn_cuda(value: torch.Tensor, offsets: torch.Tensor,
                        logits: torch.Tensor, ref_x: torch.Tensor,
                        ref_y: torch.Tensor,
                        shapes: Sequence[Tuple[int, int]], heads: int,
                        points: int) -> torch.Tensor:
    """Launch ``csrc/deform_attn.cu`` on contiguous CUDA tensors laid out
    as :func:`ms_deform_attn_plain` takes them (value, offsets and logits
    all fp32 or all bf16). Returns a new contiguous ``[B, Nq, heads*d]``
    tensor in the value's dtype."""
    fn = "ms_deform_attn_cuda"
    levels = len(shapes)
    if not fused_supported(levels, points):
        raise ValueError(f"{fn}: fused_supported refuses "
                         f"{levels} levels of {points} points")
    if value.dim() != 3 or value.dtype not in _DTYPES:
        raise ValueError(f"{fn} takes an fp32 or bf16 [B, Nv, C] value, got "
                         f"{value.dtype} {tuple(value.shape)}")
    b, nv, c = value.shape
    nq = offsets.shape[1] if offsets.dim() == 3 else -1
    lp = levels * points
    want = {"offsets": (offsets, value.dtype, (b, nq, heads * lp * 2)),
            "logits": (logits, value.dtype, (b, nq, heads * lp)),
            "ref_x": (ref_x, torch.float32, (nq,)),
            "ref_y": (ref_y, torch.float32, (nq,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{fn} needs {name} of {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (value, offsets, logits, ref_x, ref_y):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{fn} needs CUDA tensors on one card, got one "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} needs contiguous tensors")
    if c % heads or sum(h * w for h, w in shapes) != nv:
        raise ValueError(f"{fn}: {c} channels over {heads} heads, levels "
                         f"{tuple(shapes)} for {nv} value tokens")
    if max(b * nq, value.numel(), offsets.numel()) >= 2**31:
        raise ValueError(f"{fn}: {b} x {nq} queries exceed the launch limits")
    out = torch.empty((b, nq, c), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    geometry, inv, start = [], [], 0
    for h, w in shapes:
        geometry += [h, w, start]
        inv += [np.float32(1.0 / w), np.float32(1.0 / h)]
        start += h * w
    DEFORM_ATTN(value.data_ptr(), offsets.data_ptr(), logits.data_ptr(),
                ref_x.data_ptr(), ref_y.data_ptr(), out.data_ptr(),
                (ctypes.c_int * len(geometry))(*geometry),
                (ctypes.c_float * len(inv))(*inv), b, nq, nv, heads,
                c // heads, levels, points, _DTYPES[value.dtype],
                torch.cuda.current_stream(value.device).cuda_stream)
    return out


def ms_deform_attn(value: torch.Tensor, offsets: torch.Tensor,
                   logits: torch.Tensor, ref_x: torch.Tensor,
                   ref_y: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   heads: int, points: int) -> torch.Tensor:
    """The fused core (no gradient): the kernel on CUDA tensors, the plain
    twin on CPU tensors."""
    if value.is_cuda:
        return ms_deform_attn_cuda(value, offsets, logits, ref_x, ref_y,
                                   shapes, heads, points)
    return ms_deform_attn_plain(value, offsets, logits, ref_x, ref_y, shapes,
                                heads, points)
