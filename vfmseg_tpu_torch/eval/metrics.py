"""Per-dataset mIoU evaluation.

Port of vfmseg_tpu/eval/metrics.py:23-112 (the reference's DGIoUMetric):
per-image intersect/union accumulated per dataset key (matched as a
substring of the path), per-dataset IoU and accuracy, and ``mean_mIoU`` over
``mean_used_keys``.

The per-image counts are one ``torch.bincount`` each, in int64 on the
prediction's device, and the running sums stay there until
:meth:`IoUAccumulator.compute`, so a streaming evaluation does not wait on
the device for every image. The JAX package sums one-hot fp32 rows, equal to
these counts wherever fp32 is exact (below 2^24 per class).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vfmseg_tpu_torch.parallel import mesh

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


def intersect_and_union(pred: torch.Tensor, label: torch.Tensor,
                        num_classes: int, ignore_index: int = 255):
    """Per-class int64 (intersect, union, pred_area, label_area), each
    [num_classes], for integer class maps of one shape. Pixels labelled
    ``ignore_index`` count nowhere; a label outside [0, num_classes) counts
    in no label bin (the JAX one-hot's all-zero row)."""
    label = label.to(pred.device).long()
    valid = label != ignore_index
    pred = torch.where(valid, pred.long(), num_classes)
    label = torch.where(valid, label, num_classes)

    def hist(x):
        return torch.bincount(x.reshape(-1),
                              minlength=num_classes + 1)[:num_classes]

    inter = hist(torch.where(pred == label, pred, num_classes))
    area_pred = hist(pred)
    area_label = hist(label)
    return inter, area_pred + area_label - inter, area_pred, area_label


class IoUAccumulator:
    """Streaming accumulator with dataset-key grouping."""

    def __init__(self, num_classes: int = 19,
                 dataset_keys: Optional[Sequence[str]] = None,
                 mean_used_keys: Optional[Sequence[str]] = None,
                 class_names: Optional[Sequence[str]] = None,
                 ignore_index: int = 255):
        self.num_classes = num_classes
        self.dataset_keys = list(dataset_keys or [])
        self.mean_used_keys = list(mean_used_keys or self.dataset_keys)
        self.class_names = list(class_names
                                or [str(i) for i in range(num_classes)])
        self.ignore_index = ignore_index
        self._acc: Dict[str, torch.Tensor] = {}

    def _key_for(self, path: str) -> str:
        for key in self.dataset_keys:
            if key in path:
                return key
        return "default"

    def update(self, pred, label, path: str = "") -> None:
        """Add one image: ``pred`` a tensor (any device) or array, ``label``
        an array or tensor of its shape, or None for an unannotated image."""
        if label is None:
            return
        pred = torch.as_tensor(pred)
        if isinstance(label, np.ndarray):
            label = torch.from_numpy(label)
        if pred.is_cuda and not label.is_cuda:
            label = label.pin_memory().to(pred.device, non_blocking=True)
        stats = torch.stack(intersect_and_union(
            pred, label, self.num_classes, self.ignore_index))
        key = self._key_for(path)
        self._acc[key] = self._acc[key] + stats if key in self._acc else stats

    def all_reduce(self, device: torch.device) -> None:
        """Sum the integer areas over the data group (images sharded over
        its ranks), so :meth:`compute` gives every rank the global results.
        A key that no rank saw stays out; the keys follow
        ``dataset_keys``, then ``default``. ``device``: where the group's
        backend takes tensors (the card under NCCL, the CPU under gloo)."""
        if mesh.world_size() == 1:
            return
        keys = self.dataset_keys + ["default"]
        width = 4 * self.num_classes
        flat = torch.zeros((len(keys), width + 1), dtype=torch.int64,
                           device=device)
        for i, key in enumerate(keys):
            if key in self._acc:
                flat[i, :width] = self._acc[key].reshape(-1).to(device)
                flat[i, width] = 1
        flat = mesh.all_reduce_sum(flat)
        self._acc = {key: flat[i, :width].reshape(4, self.num_classes)
                     for i, key in enumerate(keys) if flat[i, width] > 0}

    def _stats(self, key: str) -> np.ndarray:
        return self._acc[key].cpu().numpy().astype(np.float64)

    def compute(self) -> Dict[str, float]:
        """{"<key>_mIoU", "<key>_aAcc", ..., "mean_mIoU"}, in percent,
        rounded to 2 decimals."""
        results: Dict[str, float] = {}
        per_key_miou: List[float] = []
        for key in self._acc:
            inter, union, _apred, alabel = self._stats(key)
            iou = np.where(union > 0, inter / np.maximum(union, 1e-12), np.nan)
            miou = float(np.nanmean(iou) * 100.0)
            results[f"{key}_mIoU"] = round(miou, 2)
            results[f"{key}_aAcc"] = round(
                float(inter.sum() / max(alabel.sum(), 1e-12) * 100.0), 2)
            if not self.mean_used_keys or key in self.mean_used_keys:
                per_key_miou.append(miou)
        if per_key_miou:
            results["mean_mIoU"] = round(float(np.mean(per_key_miou)), 2)
        return results

    def per_class_iou(self, key: str = "default") -> Dict[str, float]:
        inter, union, _, _ = self._stats(key)
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), np.nan)
        return {name: round(float(v * 100.0), 2)
                for name, v in zip(self.class_names, iou)}
