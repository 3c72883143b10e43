"""Shared model helpers.

``gn_groups`` ports vfmseg_tpu/models/common.py. :func:`not_ported` is the
error the builders raise for a config type the port does not build, naming
the ROADMAP Queue A item that ports it where there is one (none is left:
``QUEUE_ITEMS`` is empty). The layers below hold fp32
parameters and compute in a ``dtype`` given at construction, as the flax
layers of the JAX package do with ``dtype=``; the convolutions, the norms
and the pooling take and return NHWC tensors and go NCHW only inside.
``padding="SAME"`` is flax's: the output is ``ceil(in / stride)`` and an odd
total padding puts the extra row and column after the input (TensorFlow's
rule), which a symmetric PyTorch ``padding`` cannot express at stride 2.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vfmseg_tpu_torch.parallel import mesh


# config type -> the ROADMAP Queue A item that ports it
QUEUE_ITEMS: dict = {}


def not_ported(what: str, kind: str) -> NotImplementedError:
    """``NotImplementedError`` for the ``what`` type ``kind``, naming its
    queue item where it has one."""
    item = QUEUE_ITEMS.get(kind)
    where = f" yet (ROADMAP {item})" if item else ""
    return NotImplementedError(f"{what} type {kind!r} is not ported{where}")


def same_padding(in_hw: Sequence[int], kernel: Tuple[int, int],
                 stride: Tuple[int, int], dilation: Tuple[int, int] = (1, 1)
                 ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """flax ``"SAME"`` padding ((top, bottom), (left, right)) for an input
    of spatial size ``in_hw``."""
    pads = []
    for n, k, s, d in zip(in_hw, kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def gn_groups(channels: int, preferred: int = 32) -> int:
    """GroupNorm group count: 32 where it divides the channels (all real
    configs); for small test widths the largest divisor <= preferred."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        _cast(self.bias, self.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors, computing in ``dtype``; an int
    ``padding`` zero-pads every side, ``"SAME"`` pads as flax does
    (:func:`same_padding`, from the input's size at each call).

    A dilated "SAME" convolution at stride 1 (DAFormer's ASPP branches)
    runs as an undilated one over the d x d phases of the map stacked into
    the batch (space-to-batch, as TensorFlow's ``atrous_conv2d``): on an
    H100, at dilation 12 and 18 over a channels-last bf16 [1, 128, 256,
    1024] map cuDNN took 0.28 s a call on a direct kernel, against 0.23 ms
    at dilation 6 on its implicit-GEMM one. Each output still sums the same
    products."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True,
                 padding: Union[int, str] = 0, dilation: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        self.same = padding == "SAME"
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0 if self.same else padding,
                         dilation=dilation, groups=groups, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if (self.same and self.dilation != (1, 1) and self.stride == (1, 1)
                and self.dilation[0] == self.dilation[1]):
            return self._space_to_batch(x)
        x = x.permute(0, 3, 1, 2)
        padding = self.padding
        if self.same:
            (t, b), (l, r) = same_padding(x.shape[2:], self.kernel_size,
                                          self.stride, self.dilation)
            if (t, l) == (b, r):
                padding = (t, l)
            else:
                x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.weight.to(self.dtype),
                     _cast(self.bias, self.dtype), self.stride, padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)

    def _space_to_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The dilated stride-1 "SAME" convolution of NHWC ``x``: the map
        zero-padded to a multiple of the dilation d, its d x d phases
        stacked into the batch, an undilated convolution with padding
        (k - 1) / 2 over each, and the phases interleaved back."""
        d = self.dilation[0]
        b, h, w, c = x.shape
        hp, wp = -(-h // d) * d, -(-w // d) * d
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        x = x.reshape(b, hp // d, d, wp // d, d, c).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b * d * d, hp // d, wp // d, c).permute(0, 3, 1, 2)
        kh, kw = self.kernel_size
        y = F.conv2d(x, self.weight.to(self.dtype),
                     _cast(self.bias, self.dtype), 1,
                     ((kh - 1) // 2, (kw - 1) // 2), 1, self.groups)
        y = y.permute(0, 2, 3, 1).reshape(b, d, d, hp // d, wp // d, -1)
        y = y.permute(0, 3, 1, 4, 2, 5).reshape(b, hp, wp, -1)
        return y[:, :h, :w]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on NHWC tensors, computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype),
                               _cast(self.bias, self.dtype), self.stride)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` on NHWC tensors: statistics and affine in fp32, the
    result in ``dtype``. A group of one value (one channel a group over a
    1x1 map), which ``F.group_norm`` refuses, normalises to 0 as in flax:
    the result is the bias."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if xf[0].numel() == self.num_groups:
            return ((xf - xf) * self.weight + self.bias).to(self.dtype)
        y = F.group_norm(xf.permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(self.dtype)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` over the last axis of NHWC tensors: in training
    mode it normalises with the fp32 batch mean and *biased* variance over
    every other axis and moves the running statistics by ``momentum`` (flax's
    convention: 0.9 keeps 90%; PyTorch's momentum 0.1) towards them, the
    biased variance included (``F.batch_norm(training=True)`` would store the
    unbiased one); in eval mode it uses the running statistics. The result
    is in ``dtype``.

    Under data parallelism (a process group of several) the training
    moments are the global batch's, as under the JAX mesh: the fp32
    per-channel sums are summed over the group with autograd for the mean,
    then the centred sums of squares for the biased variance (two passes,
    as ``torch.var_mean`` takes them; ``nn.SyncBatchNorm`` is NCHW and
    refuses CPU tensors), over a count of the local one times the world
    size (every rank holds an equal share of the batch). Eval mode stays
    local."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=eps)
        self.flax_momentum = momentum
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if mesh.world_size() > 1:
                count = xf.new_tensor(float(
                    xf.numel() // xf.shape[-1] * mesh.world_size()))
                mean = mesh.all_reduce_sum(xf.sum(dim=dims)) / count
                var = mesh.all_reduce_sum(
                    (xf - mean).square().sum(dim=dims)) / count
            else:
                var, mean = torch.var_mean(xf, dim=dims, unbiased=False)
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (self.weight * torch.rsqrt(var + self.eps)) \
            + self.bias
        return y.to(self.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int,
             same: bool = False) -> torch.Tensor:
    """flax ``nn.max_pool`` of NHWC ``x``: ``window`` x ``window`` at
    ``stride``, unpadded or with flax's ``"SAME"`` padding (padded with
    -inf, so a pad never wins)."""
    x = x.permute(0, 3, 1, 2)
    if same:
        (t, b), (l, r) = same_padding(x.shape[2:], (window,) * 2,
                                      (stride,) * 2)
        x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, window, stride).permute(0, 2, 3, 1)
