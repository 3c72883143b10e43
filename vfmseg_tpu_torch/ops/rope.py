"""2D axial rotary position embedding (EVA02's VisionRotaryEmbeddingFast).

Port of vfmseg_tpu/ops/rope.py:24-136. Per-axis frequencies
1/theta^(2i/d) over half the head dim; positions t = arange(n)/n * pt_seq_len
(interpolated) or arange(n); the per-dim frequency vector is the row-axis and
column-axis halves, each entry repeated twice; the rotation is
``x * cos + rotate_half(x) * sin`` with ``rotate_half`` acting on consecutive
pairs. Applied to q/k of patch tokens only: the ViT prepends identity rows
(cos=1, sin=0) for the cls token.

The inference attention kernel rotates q/k inside the kernel in the
*evens|odds* layout: the q/k projection columns of each head are permuted
once (:func:`evens_odds_perm`) so that pair partners sit d/2 columns apart,
the shuffle becomes a contiguous half swap (:func:`half_swap`), and the
tables are permuted to match (:func:`permuted_rope_tables`). Scores are
invariant because q and k permute alike.

Tables are numpy float64 maths, fp32 out, cached per shape.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def rope_2d_tables(gh: int, gw: int, head_dim: int, pt_seq_len: int = 16,
                   intp_freq: bool = True, theta: float = 10000.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [gh*gw, head_dim] (numpy, fp32)."""
    half = head_dim // 2  # per-axis rotary dim ("dim" in the reference)
    inv = 1.0 / theta ** (np.arange(0, half, 2, dtype=np.float64)[: half // 2]
                          / half)

    def axis_freqs(n: int) -> np.ndarray:
        t = np.arange(n, dtype=np.float64)
        t = t / n * pt_seq_len if intp_freq else t
        return np.repeat(np.outer(t, inv), 2, axis=-1)   # [n, half]

    fy = axis_freqs(gh)
    fx = axis_freqs(gw)
    grid = np.concatenate(
        [np.broadcast_to(fy[:, None, :], (gh, gw, half)),
         np.broadcast_to(fx[None, :, :], (gh, gw, half))], axis=-1
    ).reshape(gh * gw, head_dim)
    return np.cos(grid).astype(np.float32), np.sin(grid).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation on consecutive dims: (x0, x1, ...) -> (-x1, x0, ...)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., N, D]; cos/sin broadcastable to it."""
    return x * cos + rotate_half(x) * sin


@functools.lru_cache(maxsize=8)
def evens_odds_perm(num_heads: int, head_dim: int) -> np.ndarray:
    """Column permutation P with W[:, P] (rows of a torch [out, in] weight)
    mapping each head's dims to [evens | odds] order."""
    d = head_dim
    cols = np.empty(num_heads * d, np.int64)
    for h in range(num_heads):
        base = h * d
        cols[base:base + d // 2] = base + 2 * np.arange(d // 2)
        cols[base + d // 2:base + d] = base + 2 * np.arange(d // 2) + 1
    return cols


def permuted_rope_tables(cos, sin):
    """cos/sin [N, d] (pairwise convention, identity cls rows) -> (cosP,
    sinP) [N, d] for the evens|odds half-swap form. numpy or torch."""
    d = cos.shape[-1]
    even = 2 * np.arange(d // 2)
    idx = np.concatenate([even, even + 1])
    if isinstance(cos, np.ndarray):
        return cos[:, idx], np.concatenate([-sin[:, even], sin[:, even + 1]],
                                           axis=-1)
    even_t = torch.from_numpy(even).to(sin.device)
    return (cos[:, torch.from_numpy(idx).to(cos.device)],
            torch.cat([-sin[:, even_t], sin[:, even_t + 1]], dim=-1))


def half_swap(x: torch.Tensor) -> torch.Tensor:
    """Partner lookup in the evens|odds layout: swap the two halves of the
    last axis."""
    d = x.shape[-1]
    return torch.cat([x[..., d // 2:], x[..., :d // 2]], dim=-1)


def apply_rope_permuted(x: torch.Tensor, cosP: torch.Tensor,
                        sinP: torch.Tensor) -> torch.Tensor:
    """x: [..., N, d] in the evens|odds layout."""
    return x * cosP + half_swap(x) * sinP


def vit_rope_tables(gh: int, gw: int, head_dim: int, num_cls_tokens: int,
                    pt_seq_len: int, intp_freq: bool
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The ViT's tables over all its tokens: identity rows (cos=1, sin=0)
    for the cls tokens, then the grid's (vfmseg_tpu/models/backbones/
    vit.py:484-502)."""
    cos, sin = rope_2d_tables(gh, gw, head_dim, pt_seq_len=pt_seq_len,
                              intp_freq=intp_freq)
    p = num_cls_tokens
    return (np.concatenate([np.ones((p, head_dim), np.float32), cos]),
            np.concatenate([np.zeros((p, head_dim), np.float32), sin]))
