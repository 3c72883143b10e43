"""Ordered in-place window blend, on a hand-written CUDA kernel (B9).

Port of vfmseg_tpu/ops/window_blend.py:81-120. The compact gated engine
(``eval/compact.py``) adds the pre-scaled refine deltas of its k selected
windows back over the stage-1 logit map: ``base[img_i[i], y:y+ch, x:x+cw] +=
delta[i]`` for i in ascending order, each add rounded to the base's dtype.

* :func:`blend_windows_plain` is the plain PyTorch version: that loop.
* :func:`blend_windows_cuda` launches ``csrc/window_blend.cu``, which computes
  the same chain in one launch and is bit-identical to the loop in fp32 (the
  TPU kernel's dtype) and in bf16 (the base under a bf16 model).
* :func:`blend_windows` picks by the base's device: CPU tensors take the plain
  version, CUDA tensors the kernel, and nothing falls back from one to the
  other.
"""

from __future__ import annotations

import torch

from vfmseg_tpu_torch.kernels import WINDOW_BLEND

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's window list lives in shared memory
MAX_WINDOWS = 1024


def blend_windows_plain(base: torch.Tensor, delta: torch.Tensor,
                        img_i: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor) -> torch.Tensor:
    """base [B, H, W, C] (modified in place and returned), delta [k, ch, cw,
    C] of the base's dtype, window origins (img_i, ys, xs) [k]."""
    ch, cw = delta.shape[1:3]
    for i, (b, y, x) in enumerate(zip(img_i.tolist(), ys.tolist(),
                                      xs.tolist())):
        base[b, y:y + ch, x:x + cw] += delta[i]
    return base


def blend_windows_cuda(base: torch.Tensor, delta: torch.Tensor,
                       img_i: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """Launch the blend kernel on a contiguous bf16/fp32 CUDA base; delta of
    its dtype, origins int32 on its device. The origins are not read back:
    the caller keeps each window inside the base, as the engine's slide grid
    does."""
    if not base.is_cuda:
        raise ValueError(f"blend_windows_cuda needs a CUDA tensor, got "
                         f"{base.device}")
    if base.dtype not in _DTYPE_CODE or delta.dtype != base.dtype:
        raise TypeError(f"blend_windows_cuda takes a bf16 or fp32 base and a "
                        f"delta of its dtype, got {base.dtype} and "
                        f"{delta.dtype}")
    if base.dim() != 4 or delta.dim() != 4 or delta.shape[3] != base.shape[3]:
        raise ValueError(f"blend_windows_cuda: base {tuple(base.shape)} and "
                         f"delta {tuple(delta.shape)} are not [B, H, W, C] "
                         f"and [k, ch, cw, C]")
    if not (base.is_contiguous() and delta.is_contiguous()):
        raise ValueError("blend_windows_cuda needs a contiguous base and delta")
    k, ch, cw, c = delta.shape
    b, h, w, _ = base.shape
    if k > MAX_WINDOWS or b > 65535 or ch > h or cw > w:
        raise ValueError(f"blend_windows_cuda: {k} windows of {ch}x{cw} over "
                         f"{tuple(base.shape)} are outside the kernel's range")
    for name, t in (("img_i", img_i), ("ys", ys), ("xs", xs)):
        if (t.dtype != torch.int32 or t.shape != (k,) or t.device != base.device
                or not t.is_contiguous()):
            raise ValueError(f"blend_windows_cuda needs {name} as a contiguous "
                             f"int32 [{k}] on {base.device}")
    if k == 0:
        return base
    WINDOW_BLEND(base.data_ptr(), delta.data_ptr(), img_i.data_ptr(),
                 ys.data_ptr(), xs.data_ptr(), b, h, w, c, k, ch, cw,
                 _DTYPE_CODE[base.dtype],
                 torch.cuda.current_stream(base.device).cuda_stream)
    return base


def blend_windows(base: torch.Tensor, delta: torch.Tensor, img_i: torch.Tensor,
                  ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """base with delta[i] added at each window in ascending i, in place."""
    if base.device.type == "cuda":
        return blend_windows_cuda(base, delta, img_i, ys, xs)
    if base.device.type == "cpu":
        return blend_windows_plain(base, delta, img_i, ys, xs)
    raise NotImplementedError(f"blend_windows on {base.device}")
