"""LayerNorm with fp32 statistics, on a hand-written CUDA kernel.

Port of vfmseg_tpu/ops/norm.py:28-180. The numerics are those of
``_ln_reference`` there: fp32 mean, then the mean of the centred squares,
``rsqrt(var + eps)``, an fp32 affine, and the result in the input's dtype.

* :func:`layer_norm_plain` is the plain PyTorch version.
* :func:`layer_norm_cuda` launches ``csrc/layer_norm.cu``.
* :func:`layer_norm` picks by the tensor's device: CPU tensors take the plain
  version, CUDA tensors the kernel, and nothing falls back from one to the
  other. Under autograd it goes through :class:`LayerNormFunction`, whose
  backward ports ``_ln_bwd_rule`` (norm.py:135-150) as plain torch on either
  device: the JAX package's backward is a jnp formula, not a Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from vfmseg_tpu_torch.kernels import LAYER_NORM

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def empty_at_offset_of(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor shaped like contiguous ``x`` whose address is
    x's modulo 16 bytes, so that the kernel cuts x's and y's rows at the
    same 16-byte boundaries (a view into a buffer one 16-byte step longer
    when x starts off a boundary)."""
    off = x.data_ptr() % 16
    if off == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    item = x.element_size()
    buf = torch.empty(x.numel() + 16 // item, dtype=x.dtype, device=x.device)
    start = ((off - buf.data_ptr()) % 16) // item
    return buf[start:start + x.numel()].view(x.shape)


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Launch the LayerNorm kernel on contiguous bf16/fp32 CUDA ``x`` (last
    axis C >= 1, any alignment) with fp32 ``weight``/``bias`` [C]. The
    result lies at x's address modulo 16 bytes
    (:func:`empty_at_offset_of`)."""
    if not x.is_cuda:
        raise ValueError(f"layer_norm_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"layer_norm_cuda takes bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_cuda needs a contiguous x")
    c = x.shape[-1]
    if c == 0 or x.numel() // c > 2**31 - 1:
        raise ValueError(f"layer_norm_cuda: shape {tuple(x.shape)} is outside "
                         f"the kernel's range")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (c,) or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(f"layer_norm_cuda needs a contiguous fp32 {name} "
                             f"of shape ({c},) on {x.device}")
    y = empty_at_offset_of(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    LAYER_NORM(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
               rows, c, float(eps), _DTYPE_CODE[x.dtype],
               torch.cuda.current_stream(x.device).cuda_stream)
    return y


def _layer_norm_forward(x, weight, bias, eps):
    if x.device.type == "cuda":
        return layer_norm_cuda(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    raise NotImplementedError(f"layer_norm on {x.device}")


def layer_norm_backward(x: torch.Tensor, weight: torch.Tensor,
                        dy: torch.Tensor, eps: float):
    """``_ln_bwd_rule``: fp32 statistics recomputed from x; returns dx in
    x's dtype and fp32 dweight, dbias."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gf = dy.float()
    dyf = gf * weight.float()
    dx = rstd * (dyf - dyf.mean(dim=-1, keepdim=True)
                 - xhat * (dyf * xhat).mean(dim=-1, keepdim=True))
    red = tuple(range(x.dim() - 1))
    return (dx.to(x.dtype), (gf * xhat).sum(dim=red).to(weight.dtype),
            gf.sum(dim=red).to(weight.dtype))


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with the JAX package's custom VJP (``_ln``): the forward is
    the kernel (CUDA) or the plain version (CPU), the backward
    :func:`layer_norm_backward`."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _layer_norm_forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x, weight, dy, ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32-stat LayerNorm over the last axis; returns x.dtype."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return _layer_norm_forward(x, weight, bias, eps)


class LayerNorm(nn.Module):
    """Last-axis affine LayerNorm (flax ``LayerNorm`` of the JAX package).

    ``weight``/``bias`` stay fp32; the input is cast to ``dtype`` first, as
    the JAX module casts to its compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.dtype).contiguous(), self.weight,
                          self.bias, self.eps)
