"""Label maps in the Cityscapes palette, for the eval CLI's ``--show-dir``.

Port of vfmseg_tpu/utils/visualization.py:16-29.
"""

from __future__ import annotations

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
