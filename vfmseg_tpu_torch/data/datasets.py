"""Dataset indexes: GTAV, Cityscapes, BDD100K and Mapillary, and the DG
and UDA wrappers with Rare-Class Sampling.

Port of vfmseg_tpu/data/datasets.py: a folder-paired image/label index and
the per-dataset path conventions of mmseg's dataset classes, which the
reference configures. Items are ``{"img", "img_path", "seg_map_path"}``
plus ``"label"`` where the label file exists; images RGB uint8, labels
trainId uint8 (255 ignored). ``DATASETS`` maps a config's ``type`` to its
constructor (the JAX package's registry), and ``build_dataset`` builds one
from a config entry.

Rare-Class Sampling (rein/datasets/uda_dataset.py): a class is drawn from a
temperature softmax over inverted pixel frequencies read from
``sample_class_stats.json``, then a file holding more than ``min_pixels``
of it from ``samples_with_class.json``, and the pipeline re-runs up to 10
times until the crop holds more than ``min_pixels * min_crop_ratio`` pixels
of the class. One ``np.random.default_rng(seed)`` per dataset makes every
draw; the loader's worker threads share it, so with more than one worker
the order of the draws, and so the batches, are not deterministic (as in
the JAX package).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Sequence

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


def rcs_class_probs(data_root: str, temperature: float):
    """(classes, probabilities): a temperature softmax over the inverted
    pixel frequencies of ``sample_class_stats.json`` (uda_dataset.py:16-38),
    classes in ascending order of frequency."""
    with open(osp.join(data_root, "sample_class_stats.json")) as f:
        stats = json.load(f)
    overall: Dict[int, int] = {}
    for s in stats:
        for c, n in s.items():
            if c != "file":
                overall[int(c)] = overall.get(int(c), 0) + n
    items = sorted(overall.items(), key=lambda kv: kv[1])
    classes = [k for k, _ in items]
    freq = np.array([v for _, v in items], np.float64)
    freq = 1.0 - freq / freq.sum()
    e = np.exp(freq / temperature - np.max(freq / temperature))
    return classes, e / e.sum()


class DGDataset:
    """A source dataset through ``pipeline(img, label, rng)``, with
    Rare-Class Sampling when ``rare_class_sampling`` is given (keys
    ``class_temp``, ``min_pixels``, ``min_crop_ratio``). ``source``: a
    dataset with ``data_root`` (where the RCS stats files are),
    ``samples`` (each with ``seg_map_path``) and items with ``img`` and
    ``label``."""

    def __init__(self, source, pipeline: Callable,
                 rare_class_sampling: Optional[dict] = None, seed: int = 0):
        self.source = source
        self.pipeline = pipeline
        self.rng = np.random.default_rng(seed)
        self.rcs_enabled = rare_class_sampling is not None
        if not self.rcs_enabled:
            return
        rcs = rare_class_sampling
        self.rcs_min_crop_ratio = rcs.get("min_crop_ratio", 0.5)
        self.rcs_min_pixels = rcs.get("min_pixels", 3000)
        self.rcs_classes, self.rcs_classprob = rcs_class_probs(
            source.data_root, rcs.get("class_temp", 0.01))
        with open(osp.join(source.data_root,
                           "samples_with_class.json")) as f:
            swc = json.load(f)
        self.samples_with_class = {}
        for c in self.rcs_classes:
            files = [file.split("/")[-1] for file, pixels in swc[str(c)]
                     if pixels > self.rcs_min_pixels]
            if not files:
                raise ValueError(f"no sample holds more than "
                                 f"{self.rcs_min_pixels} pixels of class {c}")
            self.samples_with_class[c] = files
        self.file_to_idx = {rec["seg_map_path"].split("/")[-1]: i
                            for i, rec in enumerate(source.samples)}

    def __len__(self):
        return len(self.source)

    def _run_pipeline(self, idx: int) -> Dict[str, np.ndarray]:
        raw = self.source[idx]
        return self.pipeline(raw["img"], raw["label"], self.rng)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if not self.rcs_enabled:
            return self._run_pipeline(idx % len(self.source))
        c = int(self.rng.choice(self.rcs_classes, p=self.rcs_classprob))
        i1 = self.file_to_idx[self.rng.choice(self.samples_with_class[c])]
        sample = self._run_pipeline(i1)
        if self.rcs_min_crop_ratio > 0:
            for _ in range(10):
                if (sample["label"] == c).sum() > (
                        self.rcs_min_pixels * self.rcs_min_crop_ratio):
                    break
                sample = self._run_pipeline(i1)
        return sample


class UDADataset(DGDataset):
    """:class:`DGDataset` plus a random unlabelled target sample per item
    (uda_dataset.py:110-186), the target passed explicitly. The DACS step
    that trains on it is not ported yet."""

    def __init__(self, source, target, pipeline: Callable,
                 target_pipeline: Optional[Callable] = None,
                 rare_class_sampling: Optional[dict] = None, seed: int = 0):
        super().__init__(source, pipeline, rare_class_sampling, seed)
        self.target = target
        self.target_pipeline = target_pipeline or pipeline

    def __len__(self):
        return len(self.source) * len(self.target)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        src = super().__getitem__(idx)
        raw = self.target[int(self.rng.integers(len(self.target)))]
        label = raw.get("label",
                        np.full(raw["img"].shape[:2], 255, np.uint8))
        tgt = self.target_pipeline(raw["img"], label, self.rng)
        return {"img": src["img"], "label": src["label"],
                "target_img": tgt["img"]}


DATASETS = {"SegDataset": SegDataset, "CityscapesDataset": cityscapes_dataset,
            "GTADataset": gta_dataset, "BDD100KDataset": bdd100k_dataset,
            "MapillaryDataset": mapillary_dataset, "DGDataset": DGDataset,
            "UDADataset": UDADataset}


def build_dataset(cfg: dict) -> SegDataset:
    """The dataset of a config entry ``{"type": ..., **kwargs}``."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in DATASETS:
        raise NotImplementedError(f"dataset type {kind!r} is not ported")
    return DATASETS[kind](**cfg)
