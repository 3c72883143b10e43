"""Window partitioning and SAM's decomposed relative positions.

Port of vfmseg_tpu/ops/window.py:19-110 (reference sam_vit.py:301-432):

* :func:`window_partition` zero-pads a ``[B, H, W, C]`` grid bottom-right to
  a window multiple and cuts it into ``[B*nH*nW, ws, ws, C]`` windows;
  :func:`window_unpartition` puts them back and crops the padding. The padded
  tokens are attended over like real ones, as in the reference SAM.
* :func:`get_rel_pos` picks the rows of a relative-position table for a
  (query, key) extent, first resizing the table linearly (the reference's
  ``F.interpolate(mode="linear", align_corners=False)``) when its length is
  not ``2 * extent - 1``: as the JAX package does, by an fp32 [out, in]
  interpolation matrix built in float64 (the port's copy of
  vfmseg_tpu/ops/resize.py:54's bilinear case), which ``F.interpolate``
  matches only to ~2e-6 because it computes its weights in fp32.
* :func:`decomposed_rel_pos_terms_hm` gives the two k-separable terms of
  the bias, ``rel_h [B, H, N, kh]`` and ``rel_w [B, H, N, kw]``, with
  ``bias[..., q, i*kw + j] = rel_h[..., q, i] + rel_w[..., q, j]``; the
  attention adds them to its logits (``ops/attention.py``), so no
  ``[B, H, N, N]`` bias exists. :func:`decomposed_rel_pos_bias_hm` builds
  that bias: the ``attn_impl="pallas_bias"`` route attends with it, and the
  library yardstick takes it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, ws: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> ([B*nH*nW, ws, ws, C], padded (H, W))."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.transpose(2, 3).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of :func:`window_partition`, cropping the padding."""
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.transpose(2, 3).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


@functools.lru_cache(maxsize=64)
def relative_coords(q_size: int, k_size: int) -> np.ndarray:
    """The [q_size, k_size] row index into a rel-pos table, with the
    reference's scaling of the shorter side."""
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return ((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).astype(
        np.int32)


@functools.lru_cache(maxsize=64)
def _linear_matrix(in_size: int, out_size: int, device: torch.device
                   ) -> torch.Tensor:
    """[out_size, in_size] fp32 linear interpolation weights (torch rules,
    align_corners=False, size-based) on ``device``; a normal tensor, as
    :func:`_coords_on`'s."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size
    src = np.clip(src - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, hi), frac.astype(np.float32))
    with torch.inference_mode(False):
        return torch.from_numpy(mat).to(device)


@functools.lru_cache(maxsize=64)
def _coords_on(q_size: int, k_size: int, device: torch.device
               ) -> torch.Tensor:
    """:func:`relative_coords` as an int64 tensor on ``device``, copied there
    once per shape (a normal tensor even when first made under
    ``torch.inference_mode``: a later training step saves it for its
    backward)."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_coords(q_size, k_size).astype(
            np.int64)).to(device)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """[L, D] table -> [q_size, k_size, D] rows. A table whose length is not
    ``2 * max(q_size, k_size) - 1`` is resized linearly in fp32 first (and
    the result stays fp32)."""
    length = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != length:
        rel_pos = _linear_matrix(rel_pos.shape[0], length,
                                 rel_pos.device) @ rel_pos.float()
    return rel_pos[_coords_on(q_size, k_size, rel_pos.device)]


def decomposed_rel_pos_terms_hm(q: torch.Tensor, rel_pos_h: torch.Tensor,
                                rel_pos_w: torch.Tensor,
                                hw: Tuple[int, int]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rel_h [B, heads, N, h] and rel_w [B, heads, N, w] in q's dtype from a
    head-major q [B, heads, N, hd] (N = h*w, any strides); the tables are
    taken in q's dtype, as the JAX module casts them."""
    h, w = hw
    b, heads, n, hd = q.shape
    rh = get_rel_pos(h, h, rel_pos_h).to(q.dtype)   # [h, h, hd]
    rw = get_rel_pos(w, w, rel_pos_w).to(q.dtype)   # [w, w, hd]
    rq = q.reshape(b, heads, h, w, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rh).reshape(b, heads, n, h)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rw).reshape(b, heads, n, w)
    return rel_h, rel_w


def decomposed_rel_pos_bias_hm(q: torch.Tensor, rel_pos_h: torch.Tensor,
                               rel_pos_w: torch.Tensor,
                               hw: Tuple[int, int]) -> torch.Tensor:
    """The whole bias [B, heads, N, N] from the two terms."""
    b, heads, n, _ = q.shape
    rel_h, rel_w = decomposed_rel_pos_terms_hm(q, rel_pos_h, rel_pos_w, hw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(b, heads, n, n)
