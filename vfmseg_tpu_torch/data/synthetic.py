"""Synthetic segmentation data for tests and smoke training.

Port of vfmseg_tpu/data/synthetic.py (numpy host code, the same draws from
the same seed): blobby class regions with correlated image colours, so a run
has a learnable signal. With a ``pipeline`` (``data/transforms.py``'s
``TrainPipeline``) each item goes through it with the dataset's own
generator (``seed + 1``); without one, it is normalised with the config's
mean and std (``models/presets.PREPROCESSOR``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vfmseg_tpu_torch.models.presets import PREPROCESSOR


def synthetic_sample(rng: np.random.Generator, hw: Tuple[int, int] = (128, 128),
                     num_classes: int = 5) -> Dict[str, np.ndarray]:
    """Blobby class regions with correlated image colours."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    label = np.zeros((h, w), np.int32)
    for c in range(1, num_classes):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(min(h, w) // 8, min(h, w) // 3)
        label[(yy - cy) ** 2 + (xx - cx) ** 2 < r**2] = c
    colors = np.linspace(30, 220, num_classes)[:, None].repeat(3, 1)
    colors += rng.normal(0, 10, colors.shape)
    img = colors[label] + rng.normal(0, 8, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return {"img": img, "label": label.astype(np.uint8)}


class SyntheticDataset:
    def __init__(self, n: int = 16, hw: Tuple[int, int] = (128, 128),
                 num_classes: int = 5, seed: int = 0, pipeline=None):
        rng = np.random.default_rng(seed)
        self._raw = [synthetic_sample(rng, hw, num_classes) for _ in range(n)]
        self.pipeline = pipeline
        self.num_classes = num_classes
        self.rng = np.random.default_rng(seed + 1)

    def __len__(self):
        return len(self._raw)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raw = self._raw[idx % len(self._raw)]
        if self.pipeline is not None:
            return self.pipeline(raw["img"], raw["label"], self.rng)
        mean = np.asarray(PREPROCESSOR["mean"], np.float32)
        std = np.asarray(PREPROCESSOR["std"], np.float32)
        img = (raw["img"].astype(np.float32) - mean) / std
        return {"img": img, "label": raw["label"].astype(np.int32)}
