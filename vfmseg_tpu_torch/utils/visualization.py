"""Label maps in the Cityscapes palette and the training debug grids.

Port of vfmseg_tpu/utils/visualization.py: the palette and
``colorize_label`` (the eval CLI's ``--show-dir``), and the debug grids the
train CLI writes to ``<work_dir>/class_mix_debug`` (the reference's
``subplotimg`` dumps): ``denormalize_image``, ``subplotimg`` and
``save_debug_grid``. matplotlib is imported by the call that draws; without
it ``save_debug_grid`` writes nothing and returns None.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

CITYSCAPES_PALETTE = np.zeros((256, 3), np.uint8)
CITYSCAPES_PALETTE[:19] = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32],
], np.uint8)


def colorize_label(label: np.ndarray) -> np.ndarray:
    """[H, W] trainIds -> [H, W, 3] uint8 Cityscapes colours (255 black)."""
    return CITYSCAPES_PALETTE[np.asarray(label, np.int32) % 256]


def denormalize_image(img: np.ndarray,
                      mean=(123.675, 116.28, 103.53),
                      std=(58.395, 57.12, 57.375)) -> np.ndarray:
    """A normalised HWC (or NHWC) float image -> fp32 RGB in [0, 1]."""
    out = (np.asarray(img, np.float32) * np.asarray(std)
           + np.asarray(mean)) / 255.0
    return np.clip(out, 0.0, 1.0)


def subplotimg(ax, img: np.ndarray, title: str, cmap: Optional[str] = None):
    """An image, or with ``cmap="cityscapes"`` a palette-coloured label
    map, on a matplotlib axis, titled, without ticks."""
    if cmap == "cityscapes":
        img = colorize_label(img)
    ax.imshow(img)
    ax.set_title(title, fontsize=8)
    ax.axis("off")


def save_debug_grid(out_dir: str, step: int, panels: Dict[str, np.ndarray],
                    cols: int = 4) -> Optional[str]:
    """Write ``<out_dir>/<step:06d>.png``: one panel per ``{title: array}``
    entry, ``cols`` a row. A 2-D float array is a heat map (entropy, mix
    mask), a 2-D integer one a label map in the palette, anything else an
    RGB image. Returns the path, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    os.makedirs(out_dir, exist_ok=True)
    n = len(panels)
    rows = (n + cols - 1) // cols
    fig, axs = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                            squeeze=False)
    for ax in axs.flat:
        ax.axis("off")
    for ax, (title, img) in zip(axs.flat, panels.items()):
        img = np.asarray(img)
        if img.ndim == 2 and np.issubdtype(img.dtype, np.floating):
            ax.imshow(img, cmap="viridis")
            ax.set_title(title, fontsize=8)
            ax.axis("off")
        elif img.ndim == 2:
            subplotimg(ax, img, title, cmap="cityscapes")
        else:
            subplotimg(ax, img, title)
    path = os.path.join(out_dir, f"{step:06d}.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
