"""Hand-written CUDA kernels of the port and their launch counters.

Each kernel is a :class:`~vfmseg_tpu_torch.kernels.build.Kernel`: a C entry of
the library built from ``vfmseg_tpu_torch/csrc`` plus a count of its launches.
The wrappers that check tensors and launch them live beside their plain
PyTorch versions in ``vfmseg_tpu_torch/ops``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

from vfmseg_tpu_torch.kernels.build import (  # noqa: F401
    Kernel,
    KernelBuildError,
    KernelLaunchError,
    build_log,
    library,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# csrc/layer_norm.cu: x, weight, bias, y, rows, c, eps, dtype, stream
LAYER_NORM = Kernel("layer_norm", "vfmseg_layer_norm",
                    [_P, _P, _P, _P, _I, _I, _F, _I, _P])
# csrc/attention_qkv.cu: q, k, v, out, batch, n, heads, stride_b, stride_n,
# scale, stream
ATTENTION_QKV = Kernel("attention_qkv", "vfmseg_attention_qkv",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])
# csrc/attention_qkv_rope.cu: q, k, v, out, cos, sin, rot (a bf16
# [B, N, 2*H*64] workspace), strides (int64 array: batch, token of q, k, v),
# batch, n, heads, scale, stream; one call launches the rotation pass and
# B2's kernel
ATTENTION_QKV_ROPE = Kernel("attention_qkv_rope", "vfmseg_attention_qkv_rope",
                            [_P] * 8 + [_I, _I, _I, _F, _P])

# csrc/attention_qkv.cu: q, k, v, out, lse, batch, n, heads, stride_b,
# stride_n, scale, stream
ATTENTION_FWD_LSE = Kernel("attention_fwd_lse", "vfmseg_attention_qkv_fwd_lse",
                           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])
# csrc/attention_hm.cu: q, k, v, out, lse (or null), strides (int64 array:
# batch, head, token of q, k, v, out), batch, heads, nq, nk, head_dim (64 or
# 80), scale, stream
ATTENTION_HM_FWD = Kernel("attention_hm_fwd", "vfmseg_attention_hm_fwd",
                          [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])
# csrc/attention_hm.cu, the fused backward: q, k, v, dout, lse, delta, dq_acc
# (a zeroed fp32 [B, H, nq, D] workspace), dq, dk, dv, strides (q, k, v, dout,
# dq, dk, dv), batch, heads, nq, nk, head_dim, scale, stream; one call
# launches the backward and the kernel that rounds dq_acc into dq
ATTENTION_HM_BWD = Kernel("attention_hm_bwd", "vfmseg_attention_hm_bwd",
                          [_P] * 11 + [_I] * 5 + [_F, _P])
# csrc/attention_hm.cu, the same two entries at head dim 32 (DINOhead's
# heads; no bias), counted apart: same arguments, head_dim 32
ATTENTION_HM_FWD_D32 = Kernel("attention_hm_fwd_d32",
                              "vfmseg_attention_hm_fwd_d32",
                              ATTENTION_HM_FWD.argtypes)
ATTENTION_HM_BWD_D32 = Kernel("attention_hm_bwd_d32",
                              "vfmseg_attention_hm_bwd_d32",
                              ATTENTION_HM_BWD.argtypes)
# csrc/attention_hm.cu, with an additive bias: q, k, v, bias, out, lse (or
# null), strides (q, k, v, out, bias), bias_kind (1 bf16, 2 fp32), batch,
# heads, nq, nk, head_dim, scale, stream
ATTENTION_HM_BIAS_FWD = Kernel(
    "attention_hm_bias_fwd", "vfmseg_attention_hm_bias_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P])
# csrc/attention_hm.cu, the fused backward with a bias: q, k, v, dout, lse,
# delta, bias, dq_acc, dq, dk, dv, dbias (contiguous, the bias's dtype),
# strides (q, k, v, dout, dq, dk, dv, bias), bias_kind, batch, heads, nq, nk,
# head_dim, scale, stream
ATTENTION_HM_BIAS_BWD = Kernel(
    "attention_hm_bias_bwd", "vfmseg_attention_hm_bias_bwd",
    [_P] * 13 + [_I] * 6 + [_F, _P])

# csrc/attention_relpos.cu: q, k, v, rel_h, rel_w, out, strides (int64
# array: batch, head, token of q, k, v, out), batch, heads, n, kh, kw,
# head_dim, scale, stream
ATTENTION_RELPOS = Kernel("attention_relpos", "vfmseg_attention_relpos",
                          [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _P])

# csrc/window_blend.cu: base, delta, img_i, ys, xs, batch, h, w, c, k, ch,
# cw, dtype, stream
WINDOW_BLEND = Kernel("window_blend", "vfmseg_window_blend",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])

# csrc/deform_sample.cu: value, xn, yn, out, batch, n, h, w, c, dtype (0
# fp32, 1 bf16), stream
DEFORM_SAMPLE = Kernel("deform_sample", "vfmseg_deform_sample",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

KERNELS = (LAYER_NORM, ATTENTION_QKV, ATTENTION_QKV_ROPE, ATTENTION_FWD_LSE,
           ATTENTION_HM_FWD, ATTENTION_HM_BWD, ATTENTION_HM_FWD_D32,
           ATTENTION_HM_BWD_D32, ATTENTION_HM_BIAS_FWD, ATTENTION_HM_BIAS_BWD,
           ATTENTION_RELPOS, WINDOW_BLEND, DEFORM_SAMPLE)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()
