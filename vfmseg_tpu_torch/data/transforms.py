"""Host-side eval data transforms (numpy, mmseg semantics).

Port of the test side of vfmseg_tpu/data/transforms.py:24-112 and 248-273:
image and label loading, the mmcv resize (half-pixel bilinear for images,
floor-nearest for labels, no antialias) and the resize-and-normalise test
pipeline. Images are RGB uint8 HWC; labels uint8/int32 HW with 255 ignored.
The JAX package's native libpng/libjpeg loader is not ported: loading goes
through PIL, imported when a file is read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
