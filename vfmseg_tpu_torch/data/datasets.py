"""Eval dataset indexes: Cityscapes, BDD100K, Mapillary and GTAV.

Port of the eval side of vfmseg_tpu/data/datasets.py:29-110: a folder-paired
image/label index and the per-dataset path conventions of mmseg's dataset
classes, which the reference configures. ``DATASETS`` maps a config's
``type`` to its constructor (the JAX package's registry), and
``build_dataset`` builds one from a config entry. Items are
``{"img", "img_path", "seg_map_path"}`` plus ``"label"`` where the label file
exists; images RGB uint8, labels trainId uint8 (255 ignored).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Sequence

import numpy as np

from vfmseg_tpu_torch.data.transforms import load_image, load_label
from vfmseg_tpu_torch.eval.metrics import CITYSCAPES_CLASSES


class SegDataset:
    """Generic folder-paired segmentation dataset index."""

    def __init__(self, data_root: str, img_dir: str, ann_dir: str,
                 img_suffix: str = ".png", seg_map_suffix: str = ".png",
                 classes: Sequence[str] = CITYSCAPES_CLASSES,
                 ignore_index: int = 255):
        self.data_root = data_root
        self.img_dir = osp.join(data_root, img_dir)
        self.ann_dir = osp.join(data_root, ann_dir)
        self.img_suffix = img_suffix
        self.seg_map_suffix = seg_map_suffix
        self.classes = list(classes)
        self.ignore_index = ignore_index
        self.samples = self._scan()

    def _scan(self) -> List[Dict[str, str]]:
        samples = []
        for root, _dirs, files in sorted(os.walk(self.img_dir)):
            for f in sorted(files):
                if not f.endswith(self.img_suffix):
                    continue
                img_path = osp.join(root, f)
                rel = osp.relpath(img_path, self.img_dir)
                seg_rel = rel[: -len(self.img_suffix)] + self.seg_map_suffix
                samples.append({"img_path": img_path,
                                "seg_map_path": osp.join(self.ann_dir,
                                                         seg_rel)})
        return samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.samples[idx]
        out = {"img": load_image(rec["img_path"]), **rec}
        if osp.exists(rec["seg_map_path"]):
            out["label"] = load_label(rec["seg_map_path"])
        return out


def cityscapes_dataset(data_root: str, img_dir: str = "leftImg8bit/train",
                       ann_dir: str = "gtFine/train", **kw) -> SegDataset:
    return SegDataset(data_root, img_dir, ann_dir,
                      img_suffix="_leftImg8bit.png",
                      seg_map_suffix="_gtFine_labelTrainIds.png", **kw)


def gta_dataset(data_root: str, img_dir: str = "images",
                ann_dir: str = "labels", **kw) -> SegDataset:
    return SegDataset(data_root, img_dir, ann_dir, img_suffix=".png",
                      seg_map_suffix="_labelTrainIds.png", **kw)


def bdd100k_dataset(data_root: str, img_dir: str = "images/10k/val",
                    ann_dir: str = "labels/sem_seg/masks/val",
                    **kw) -> SegDataset:
    return SegDataset(data_root, img_dir, ann_dir, img_suffix=".jpg",
                      seg_map_suffix=".png", **kw)


def mapillary_dataset(data_root: str, img_dir: str = "validation/images",
                      ann_dir: str = "cityscapes_trainIdLabel/val/label",
                      **kw) -> SegDataset:
    return SegDataset(data_root, img_dir, ann_dir, img_suffix=".jpg",
                      seg_map_suffix=".png", **kw)


DATASETS = {"SegDataset": SegDataset, "CityscapesDataset": cityscapes_dataset,
            "GTADataset": gta_dataset, "BDD100KDataset": bdd100k_dataset,
            "MapillaryDataset": mapillary_dataset}


def build_dataset(cfg: dict) -> SegDataset:
    """The dataset of a config entry ``{"type": ..., **kwargs}``."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in DATASETS:
        raise NotImplementedError(f"dataset type {kind!r} is not ported")
    return DATASETS[kind](**cfg)
