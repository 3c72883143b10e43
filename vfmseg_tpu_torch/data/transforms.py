"""Host-side data transforms (numpy, mmseg semantics).

Port of vfmseg_tpu/data/transforms.py: image and label loading, the mmcv
resize (half-pixel bilinear for images, floor-nearest for labels, no
antialias), the train pipeline (fixed resize or shortest-edge scale
jitter, RandomCrop with cat_max_ratio, RandomFlip, PhotoMetricDistortion,
normalise and pad) and the resize-and-normalise test pipeline. Every random
draw comes from the caller's ``np.random.Generator`` in the JAX package's
order, so the same seed gives the same samples. Images are RGB uint8 HWC;
labels uint8/int32 HW with 255 ignored.

The JAX pipeline converts RGB <-> HSV through PIL's ``HSV`` mode; here
:func:`rgb_to_hsv` and :func:`hsv_to_rgb` compute PIL's arithmetic in
numpy, bit for bit (its float and double steps, ``(int)`` truncation, C's
``round``), so no PIL is needed to train. PIL is imported only to read an
image file. The JAX package's native libpng/libjpeg loader is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = 255
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_label(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, dtype=np.uint8)


def resize_sample(img: np.ndarray, label: Optional[np.ndarray],
                  scale_wh: Tuple[int, int], keep_ratio: bool = False):
    """mmcv Resize to ``scale_wh`` (w, h), or with ``keep_ratio`` the largest
    size of the image's aspect inside it: bilinear image, nearest label."""
    w, h = scale_wh
    if keep_ratio:
        ih, iw = img.shape[:2]
        ratio = min(w / iw, h / ih)
        w, h = int(iw * ratio + 0.5), int(ih * ratio + 0.5)
    img = bilinear_resize_u8(img, (w, h))
    if label is not None:
        label = nearest_resize_u8(label, (w, h))
    return img, label


def bilinear_resize_u8(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """Half-pixel bilinear resize of a uint8 HWC image (cv2/torch semantics,
    no antialias), rounded to uint8."""
    w, h = wh
    ih, iw = img.shape[:2]
    if (iw, ih) == (w, h):
        return img
    sy = np.clip((np.arange(h) + 0.5) * ih / h - 0.5, 0, ih - 1)
    sx = np.clip((np.arange(w) + 0.5) * iw / w - 0.5, 0, iw - 1)
    y0 = np.floor(sy).astype(np.int64)
    x0 = np.floor(sx).astype(np.int64)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    fy = (sy - y0)[:, None, None]
    fx = (sx - x0)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - fx) + f[y0][:, x1] * fx
    bot = f[y1][:, x0] * (1 - fx) + f[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    return (out + 0.5).astype(np.uint8)


def nearest_resize_u8(label: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """torch/cv2 'nearest' (floor mapping) for uint8 labels."""
    w, h = wh
    ih, iw = label.shape[:2]
    yi = (np.arange(h) * ih // h).astype(np.int64)
    xi = (np.arange(w) * iw // w).astype(np.int64)
    return label[yi][:, xi]


def random_choice_resize_shortest_edge(
        img: np.ndarray, label: Optional[np.ndarray], scales: Sequence[int],
        max_size: int, rng: np.random.Generator):
    """mmseg RandomChoiceResize(resize_type=ResizeShortestEdge): one
    shortest-edge length drawn uniformly from ``scales``, the long edge
    capped at ``max_size``, aspect kept. Returns (img, label, scale)."""
    s = int(scales[int(rng.integers(len(scales)))])
    ih, iw = img.shape[:2]
    ratio = min(s / min(ih, iw), max_size / max(ih, iw))
    w, h = int(iw * ratio + 0.5), int(ih * ratio + 0.5)
    img = bilinear_resize_u8(img, (w, h))
    if label is not None:
        label = nearest_resize_u8(label, (w, h))
    return img, label, s


def random_crop(img: np.ndarray, label: np.ndarray, crop_size: Tuple[int, int],
                rng: np.random.Generator, cat_max_ratio: float = 1.0,
                ignore_index: int = IGNORE_INDEX):
    """mmseg RandomCrop: up to 10 redraws until no class covers
    ``cat_max_ratio`` or more of the crop's non-ignored pixels."""
    ch, cw = crop_size
    h, w = label.shape

    def _box():
        y = rng.integers(0, max(h - ch, 0) + 1)
        x = rng.integers(0, max(w - cw, 0) + 1)
        return int(y), int(x)

    y, x = _box()
    if cat_max_ratio < 1.0:
        for _ in range(10):
            patch = label[y:y + ch, x:x + cw]
            counts = np.bincount(patch.reshape(-1), minlength=256)
            counts = np.delete(counts, ignore_index)
            counts = counts[counts > 0]
            if len(counts) > 1 and counts.max() / counts.sum() < cat_max_ratio:
                break
            y, x = _box()
    return img[y:y + ch, x:x + cw], label[y:y + ch, x:x + cw]


def random_flip(img: np.ndarray, label: np.ndarray, rng: np.random.Generator,
                prob: float = 0.5):
    if rng.random() < prob:
        return img[:, ::-1], label[:, ::-1]
    return img, label


def _clip8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


def _c_round(x: np.ndarray) -> np.ndarray:
    """C's ``round`` of doubles: half away from zero (``np.round`` rounds
    half to even); exact, since ``x - trunc(x)`` is."""
    t = np.trunc(x)
    return t + np.sign(x) * (np.abs(x - t) >= 0.5)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("HSV")`` of an RGB uint8 image (Convert.c
    ``rgb2hsv_row``): float ratios, hue through double, truncated to the
    0..255 scale."""
    rgb = img.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    grey = maxc == minc
    cr = (maxc - minc).astype(np.float32)
    cr[grey] = 1.0
    s = cr / np.maximum(maxc, 1).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    rc64, gc64, bc64 = (c.astype(np.float64) for c in (rc, gc, bc))
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc, (2.0 + rc64) - bc64,
                          (4.0 + gc64) - rc64)).astype(np.float32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = _clip8(np.trunc(h.astype(np.float64) * 255.0))
    us = _clip8(np.trunc(s.astype(np.float64) * 255.0))
    uh[grey] = 0
    us[grey] = 0
    return np.stack([uh, us, maxc.astype(np.uint8)], -1)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of an ``HSV`` uint8 image (Convert.c
    ``hsv2rgb``): the sector ``floor(h * 6 / 255)``, the remainder and
    ``s / 255`` rounded to float, p, q, t in double rounded by C's
    ``round``."""
    h = img[..., 0].astype(np.float64)
    s = img[..., 1]
    v = img[..., 2]
    h6 = h * 6.0 / 255.0
    i = np.floor(h6).astype(np.int32)
    f = (h6 - i).astype(np.float32)
    fs = (s.astype(np.float64) / 255.0).astype(np.float32)
    vf = v.astype(np.float64)
    fs64 = fs.astype(np.float64)
    p = _clip8(_c_round(vf * (1.0 - fs64)))
    q = _clip8(_c_round(vf * (1.0 - (fs * f).astype(np.float64))))
    t = _clip8(_c_round(vf * (1.0 - fs64 * (1.0 - f.astype(np.float64)))))
    sector = i % 6
    choose = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
              (v, p, q)]
    out = np.empty(img.shape, np.uint8)
    for c in range(3):
        out[..., c] = np.select([sector == k for k in range(6)],
                                [channels[c] for channels in choose])
    grey = s == 0
    out[grey] = v[grey][:, None]
    return out


def photometric_distortion(
    img: np.ndarray, rng: np.random.Generator,
    brightness_delta: float = 32, contrast_range=(0.5, 1.5),
    saturation_range=(0.5, 1.5), hue_delta: int = 18,
) -> np.ndarray:
    """mmseg PhotoMetricDistortion: random brightness, contrast (before or
    after the rest, at random), saturation and hue, each with prob 0.5."""

    def _convert(x, alpha=1.0, beta=0.0):
        return np.clip(x.astype(np.float32) * alpha + beta, 0,
                       255).astype(np.uint8)

    if rng.integers(2):
        img = _convert(img, beta=rng.uniform(-brightness_delta,
                                             brightness_delta))
    contrast_first = bool(rng.integers(2))

    def _contrast(x):
        if rng.integers(2):
            return _convert(x, alpha=rng.uniform(*contrast_range))
        return x

    if contrast_first:
        img = _contrast(img)
    if rng.integers(2):
        hsv = rgb_to_hsv(img)
        hsv[..., 1] = _convert(hsv[..., 1],
                               alpha=rng.uniform(*saturation_range))
        img = hsv_to_rgb(hsv)
    if rng.integers(2):
        hsv = rgb_to_hsv(img)
        delta = int(rng.uniform(-hue_delta, hue_delta))
        # the HSV hue is on PIL's 0..255 scale (mmcv's cv2 uses 0..179)
        delta_pil = int(round(delta * 255.0 / 180.0))
        hsv[..., 0] = ((hsv[..., 0].astype(np.int32) + delta_pil)
                       % 256).astype(np.uint8)
        img = hsv_to_rgb(hsv)
    if not contrast_first:
        img = _contrast(img)
    return img


def normalize_pad(img: np.ndarray, label: Optional[np.ndarray],
                  size: Tuple[int, int],
                  mean: np.ndarray = IMAGENET_MEAN,
                  std: np.ndarray = IMAGENET_STD,
                  pad_val: float = 0.0, seg_pad_val: int = IGNORE_INDEX):
    """SegDataPreProcessor: (img - mean) / std, padded bottom-right to
    ``size``."""
    img = (img.astype(np.float32) - mean) / std
    h, w = img.shape[:2]
    th, tw = size
    if (h, w) != (th, tw):
        out = np.full((th, tw, 3), pad_val, np.float32)
        out[:h, :w] = img[:th, :tw]
        img = out
        if label is not None:
            lout = np.full((th, tw), seg_pad_val, label.dtype)
            lout[:h, :w] = label[:th, :tw]
            label = lout
    return img, label


@dataclasses.dataclass
class TrainPipeline:
    """The reference train pipeline for one (img, label) sample."""

    resize_scale_wh: Tuple[int, int] = (2560, 1440)
    crop_size: Tuple[int, int] = (1024, 1024)
    cat_max_ratio: float = 0.75
    flip_prob: float = 0.5
    photometric: bool = True
    # RandomChoiceResize scale jitter (the rein_* 512 bs1x4 recipe): when
    # set, it replaces the fixed resize
    scale_jitter_scales: Optional[Sequence[int]] = None
    scale_jitter_max_size: int = 2048

    def __call__(self, img: np.ndarray, label: np.ndarray,
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self.scale_jitter_scales:
            img, label, _ = random_choice_resize_shortest_edge(
                img, label, self.scale_jitter_scales,
                self.scale_jitter_max_size, rng)
        else:
            img, label = resize_sample(img, label, self.resize_scale_wh)
        img, label = random_crop(img, label, self.crop_size, rng,
                                 self.cat_max_ratio)
        img, label = random_flip(img, label, rng, self.flip_prob)
        if self.photometric:
            img = photometric_distortion(img, rng)
        img, label = normalize_pad(np.ascontiguousarray(img),
                                   np.ascontiguousarray(label),
                                   self.crop_size)
        return {"img": img, "label": label.astype(np.int32)}


@dataclasses.dataclass
class TestPipeline:
    """Resize-only eval pipeline (cityscapes_1024x1024.py:13-20).

    ``keep_ratio`` defaults True, as every reference test pipeline resizes.
    mIoU is computed at the original label resolution, so the label passes
    through untouched (as int32)."""

    # not a pytest test class, despite its name
    __test__ = False

    resize_scale_wh: Optional[Tuple[int, int]] = (2048, 1024)
    keep_ratio: bool = True

    def __call__(self, img: np.ndarray,
                 label: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        if self.resize_scale_wh is not None:
            img, _ = resize_sample(img, None, self.resize_scale_wh,
                                   self.keep_ratio)
        out = {"img": (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD}
        if label is not None:
            out["label"] = label.astype(np.int32)
        return out
