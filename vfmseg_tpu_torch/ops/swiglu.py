"""EVA02's SwiGLU gate and sub-LN on a padded hidden, on a hand-written
CUDA kernel.

The eval route of ``SwiGLUEva`` (``models/backbones/vit.py``) pads the
hidden width H to :func:`padded_width` with zero weights, so that its GEMMs
have 16-byte-aligned extents and leading dimensions, and runs w1 and w2 as
one product whose output ``g`` is ``[..., 2 Hp]``: a in columns ``[0, H)``,
b in ``[Hp, Hp + H)``, exact zeros between. The gate and the sub-LN take
``g`` to the ``[..., Hp]`` input of the padded w3:

    h = silu(a) * b in fp32, over the H true columns;
    LayerNorm over those H columns with ``_ln_reference``'s numerics
    (vfmseg_tpu/ops/norm.py): the fp32 mean, then the mean of the centred
    squares, ``rsqrt(var + eps)``, an fp32 affine, the result in g's dtype;
    exact zeros in the Hp - H pad columns.

* :func:`swiglu_gate_ln_plain` is the plain PyTorch version.
* :func:`swiglu_gate_ln_cuda` launches ``csrc/swiglu_gate_ln.cu``.
* :func:`swiglu_gate_ln` picks by the tensor's device: CPU tensors take the
  plain version, CUDA tensors the kernel, and nothing falls back from one
  to the other. It has no backward: the training route keeps the unpadded
  layers under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.kernels import SWIGLU_GATE_LN

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the padded hidden is a multiple of 8 elements: 16 bytes of bf16, the
# alignment cuBLAS's Hopper GEMM kernels take
PAD_MULTIPLE = 8


def padded_width(h: int) -> int:
    """H rounded up to a multiple of :data:`PAD_MULTIPLE` (2730 -> 2736)."""
    return -(-h // PAD_MULTIPLE) * PAD_MULTIPLE


def swiglu_gate_ln_plain(g: torch.Tensor, h: int, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    hp = g.shape[-1] // 2
    a = g[..., :h].float()
    x = F.silu(a) * g[..., hp:hp + h].float()
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return F.pad(y, (0, hp - h)).to(g.dtype)


def swiglu_gate_ln_cuda(g: torch.Tensor, h: int, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on contiguous, 16-byte-aligned bf16/fp32 CUDA ``g``
    (last axis 2 Hp, Hp a multiple of 16 bytes' elements, 1 <= h <= Hp)
    with fp32 ``weight``/``bias`` [h]."""
    if not g.is_cuda:
        raise ValueError(f"swiglu_gate_ln_cuda needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"swiglu_gate_ln_cuda takes bf16 or fp32, got "
                        f"{g.dtype}")
    hp = g.shape[-1] // 2
    vec = 16 // g.element_size()
    if (not g.is_contiguous() or g.shape[-1] != 2 * hp or hp % vec
            or not 1 <= h <= hp or g.data_ptr() % 16
            or g.numel() // (2 * hp) > 2**31 - 1):
        raise ValueError(f"swiglu_gate_ln_cuda: g of shape {tuple(g.shape)} "
                         f"at h {h} is not a contiguous, 16-byte-aligned "
                         f"[..., 2 Hp] with Hp a multiple of {vec} and "
                         f"1 <= h <= Hp")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (h,) or p.device != g.device
                or not p.is_contiguous()):
            raise ValueError(f"swiglu_gate_ln_cuda needs a contiguous fp32 "
                             f"{name} of shape ({h},) on {g.device}")
    y = torch.empty(g.shape[:-1] + (hp,), dtype=g.dtype, device=g.device)
    rows = g.numel() // (2 * hp)
    if rows == 0:
        return y
    SWIGLU_GATE_LN(g.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                   y.data_ptr(), rows, h, hp, float(eps), _DTYPE_CODE[g.dtype],
                   torch.cuda.current_stream(g.device).cuda_stream)
    return y


def swiglu_gate_ln(g: torch.Tensor, h: int, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``[..., 2 Hp]`` gate input -> ``[..., Hp]`` normalised gate product,
    zeros past ``h``; returns g.dtype."""
    if g.device.type == "cuda":
        return swiglu_gate_ln_cuda(g, h, weight, bias, eps)
    if g.device.type == "cpu":
        return swiglu_gate_ln_plain(g, h, weight, bias, eps)
    raise NotImplementedError(f"swiglu_gate_ln on {g.device}")
