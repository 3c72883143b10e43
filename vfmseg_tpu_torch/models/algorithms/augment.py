"""Strong augmentations for DomainGeneral and DACS.

Port of vfmseg_tpu/models/algorithms/augment.py:26-179 (the reference's
rein/models/utils/dacs_transforms.py and masking_transforms.py):

* ``one_mix`` / ``class_mix_masks``: ClassMix, exactly ceil(n/2) of the n
  classes present in each label map, picked by the lowest iid scores;
* ``color_jitter``: brightness, contrast, saturation and hue, each factor
  ~ U(1 - s, 1 + s) (the hue shift ~ U(-s, s)), on [0, 1] NHWC images; the
  contrast's "gray" is the mean over H, W and C of each image;
* ``gaussian_blur``: separable, sigma ~ U(0.15, 1.15), kernel ~ 0.1 x the
  size, odd, capped at 23, zero padding;
* ``strong_transform``: jitter with probability 1 - p, then blur with
  probability 0.5 where blur is on;
* ``block_mask``: BlockMaskGenerator, a keep grid of about size / block
  cells (Python's ``round``), each kept with probability 1 - ratio,
  nearest-resized to the image.

Every random number comes from the ``augment`` stream (``models/rng.py``),
which lives on the host: each draw is a scalar or a tiny array. The draws
are made in the JAX package's order and with its shapes, all of them
whichever branch a coin picks, so one sequence of numbers fed to both
packages gives the same result; a coin then picks its branch in Python
where JAX computes both sides under ``jnp.where``. Arithmetic runs in the
image's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.ops.resize import resize

_HOST = torch.device("cpu")


def uniform(lo: float = 0.0, hi: float = 1.0) -> float:
    """One U[lo, hi) number from the ``augment`` stream, mapped as
    ``jax.random.uniform(minval=lo, maxval=hi)`` maps its fp32 draw."""
    u = rng.uniform("augment", (), _HOST)
    lo_t = torch.tensor(lo, dtype=torch.float32)
    hi_t = torch.tensor(hi, dtype=torch.float32)
    return float(torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t))


def denorm(img: torch.Tensor, mean: torch.Tensor,
           std: torch.Tensor) -> torch.Tensor:
    return (img * std + mean) / 255.0


def renorm(img: torch.Tensor, mean: torch.Tensor,
           std: torch.Tensor) -> torch.Tensor:
    return (img * 255.0 - mean) / std


def _rgb_to_hsv(rgb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), zero)
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, zero, h)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    sector = torch.remainder(i.to(torch.int64), 6)[..., None]
    # the six sectors' (r, g, b), picked by the sector index
    cands = [torch.stack(c, dim=-1) for c in ((v, q, p, p, t, v),
                                              (t, v, v, q, p, p),
                                              (p, p, t, v, v, q))]
    return torch.cat([c.gather(-1, sector) for c in cands], dim=-1)


def jitter_factors(strength: float = 0.25
                   ) -> Tuple[float, float, float, float]:
    """(brightness, contrast, saturation, hue shift), drawn in that order."""
    b = uniform(1 - strength, 1 + strength)
    c = uniform(1 - strength, 1 + strength)
    s = uniform(1 - strength, 1 + strength)
    hshift = uniform(-strength, strength)
    return b, c, s, hshift


def color_jitter(img01: torch.Tensor, strength: float = 0.25,
                 factors: Optional[Tuple[float, ...]] = None
                 ) -> torch.Tensor:
    """Random brightness, contrast, saturation and hue on [0, 1] NHWC
    images; ``factors`` from :func:`jitter_factors`, drawn here if None."""
    b, c, s, hshift = factors or jitter_factors(strength)
    x = (img01 * b).clamp(0.0, 1.0)
    mean_gray = x.mean(dim=(-1, -2, -3), keepdim=True)
    x = ((x - mean_gray) * c + mean_gray).clamp(0.0, 1.0)
    h, sat, v = _rgb_to_hsv(x)
    sat = (sat * s).clamp(0.0, 1.0)
    h = torch.remainder(h + hshift, 1.0)
    return _hsv_to_rgb(h, sat, v).clamp(0.0, 1.0)


def blur_kernel_size(n: int) -> int:
    """Taps for a side of ``n`` pixels: about 0.1 n, odd, in [3, 23]."""
    k = int(np.floor(np.ceil(0.1 * n) - 0.5 + np.ceil(0.1 * n) % 2))
    return max(min(k, 23), 3) | 1


def _kernel1d(k: int, sigma: float, dtype, device) -> torch.Tensor:
    r = torch.arange(k, dtype=torch.float32) - (k - 1) / 2.0
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    return (g / g.sum()).to(device=device, dtype=dtype)


def gaussian_blur(img: torch.Tensor,
                  sigma: Optional[float] = None) -> torch.Tensor:
    """Separable gaussian blur of NHWC ``img`` with zero padding, as two
    convolutions over [B * C, 1, H, W]; ``sigma`` ~ U(0.15, 1.15), drawn
    here if None."""
    if sigma is None:
        sigma = uniform(0.15, 1.15)
    bsz, h, w, c = img.shape
    ky, kx = blur_kernel_size(h), blur_kernel_size(w)
    gy = _kernel1d(ky, sigma, img.dtype, img.device)
    gx = _kernel1d(kx, sigma, img.dtype, img.device)
    x = img.permute(0, 3, 1, 2).reshape(-1, 1, h, w)
    x = F.conv2d(x, gy.view(1, 1, ky, 1), padding=(ky // 2, 0))
    x = F.conv2d(x, gx.view(1, 1, 1, kx), padding=(0, kx // 2))
    return x.view(bsz, c, h, w).permute(0, 2, 3, 1)


def strong_transform(img: torch.Tensor, mean: torch.Tensor,
                     std: torch.Tensor, color_jitter_s: float = 0.25,
                     color_jitter_p: float = 0.2,
                     blur_prob: float = 0.5) -> torch.Tensor:
    """Jitter (when its coin is above ``color_jitter_p``) then, with
    ``blur_prob`` > 0, blur (when its coin is above 0.5), on normalised
    NHWC images (dacs_transforms.py:11-30). Draws: the jitter coin, the
    four factors, then with blur on the blur coin and sigma."""
    img01 = denorm(img, mean, std)
    do_jitter = uniform() > color_jitter_p
    factors = jitter_factors(color_jitter_s)
    if do_jitter:
        img01 = color_jitter(img01, color_jitter_s, factors)
    out = renorm(img01, mean, std)
    if blur_prob > 0:
        do_blur = uniform() > 0.5
        sigma = uniform(0.15, 1.15)
        if do_blur:
            out = gaussian_blur(out, sigma)
    return out


def class_mix_masks(labels: torch.Tensor, num_classes: int = 19,
                    ignore_index: int = 255) -> torch.Tensor:
    """ClassMix masks [B, H, W] fp32 in {0, 1}: per sample, the pixels of a
    uniformly random ceil(n/2)-subset of its n present classes
    (dacs_transforms.py:96-126). Every class draws an iid score, absent
    classes score +inf, and the k lowest are picked; ignored pixels map to a
    slot that is never picked."""
    b = labels.shape[0]
    safe = torch.where(labels == ignore_index,
                       torch.full_like(labels, num_classes), labels).long()
    present = torch.zeros(b, num_classes + 1, dtype=torch.bool,
                          device=labels.device)
    present.scatter_(1, safe.reshape(b, -1), True)
    present = present[:, :num_classes]
    k = (present.sum(dim=1) + 1) // 2
    scores = rng.uniform("augment", rng.PerSample((b, num_classes)),
                         _HOST).to(labels.device)
    scores = torch.where(present, scores, torch.full_like(scores,
                                                          float("inf")))
    order = torch.argsort(scores, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    pick = (rank < k[:, None]) & present
    pick = torch.cat([pick, torch.zeros_like(pick[:, :1])], dim=1).float()
    return pick.gather(1, safe.reshape(b, -1)).reshape(labels.shape)


def one_mix(mask: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """mask * a + (1 - mask) * b, the mask broadcast over trailing axes."""
    while mask.dim() < a.dim():
        mask = mask[..., None]
    return mask * a + (1.0 - mask) * b


def block_mask(img: torch.Tensor, mask_ratio: float = 0.7,
               block_size: int = 64) -> torch.Tensor:
    """Zero blocks of NHWC ``img``: a [B, mh, mw] grid (mh = round(H /
    block_size), at least 1) kept where its draw is above ``mask_ratio``,
    nearest-resized to the image (masking_transforms.py:20-40)."""
    b, h, w, _ = img.shape
    mh = max(round(h / block_size), 1)
    mw = max(round(w / block_size), 1)
    keep = (rng.uniform("augment", rng.PerSample((b, mh, mw, 1)), _HOST)
            > mask_ratio)
    keep = resize(keep.to(device=img.device, dtype=img.dtype), size=(h, w),
                  method="nearest")
    return img * keep
