"""Mask2Former set-prediction loss: Hungarian matching and point-sampled
mask and dice losses.

Port of vfmseg_tpu/models/heads/m2f_loss.py, the mmdet loss stack the
reference configures (configs/_base_/models/rein_dinov2_mask2former.py:
125-161):

* matching: ClassificationCost(2.0) + CrossEntropyLossCost(5.0, sigmoid) +
  DiceCost(5.0, naive, eps 1) over ``num_points`` uniform points, solved by
  ``scipy.optimize.linear_sum_assignment`` on the host;
* ``loss_cls``: CE over the queries with class weights [1] * K + [0.1] for
  no-object;
* ``loss_mask``: sigmoid BCE at uncertainty-sampled points (12544 points,
  oversample 3.0, importance 0.75); ``loss_dice``: naive dice at the same
  points;
* every decoder stage is supervised: keys ``loss_cls``, ``loss_mask``,
  ``loss_dice`` for the last stage and ``d{s}.`` before them for stage s.

The semantic labels become a fixed set of one slot per class with an
``exists`` flag, so each stage's matching is a ``[Nq, K]`` problem whose
absent classes carry a constant cost. All stages' costs are computed on the
device, copied to the host once, matched, and the assignment copied back:
one host sync a step, as the JAX loss makes one ``pure_callback``.

Random draws come from the ``mask`` stream (``models/rng.uniform``) in the
JAX shapes and order: the matching points ``[P, 2]``, then per stage the
oversampled pool ``[B*K, 3P, 2]`` and the fresh points ``[B*K, P - 0.75P,
2]``. Point sampling is ``ops/deform_attn.sample_plain`` under autograd
(JAX samples with its gather, outside any Pallas kernel). The predictions
are cast to fp32, so a bf16 head's stages are scored in fp32.

``torch.topk`` does not document which of equal elements it keeps, where
``lax.top_k`` keeps the lower index; the two choose the same points unless
two uncertainties tie at the cut, and the loss sums over the points, so
their order does not count.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.ops.deform_attn import sample_plain

_DUMMY_COST = 1e6


def semantic_to_targets(labels: torch.Tensor, num_classes: int,
                        ignore_index: int = 255):
    """[B, H, W] semantic labels -> per-class binary masks ``[B, K, H, W]``
    (fp32) and ``exists [B, K]`` (bool); slot k is class k."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = labels[:, None] == classes[None, :, None, None]
    valid = (labels != ignore_index)[:, None]
    gt_masks = (onehot & valid).float()
    return gt_masks, gt_masks.sum(dim=(2, 3)) > 0


def _sample_points_per(maps: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """Per-item bilinear sampling: maps [N, H, W], coords [N, P, 2] (x, y)
    in [0, 1] (grid_sample, align_corners=False, zeros outside) -> [N, P]."""
    return sample_plain(maps[..., None], coords[..., 0],
                        coords[..., 1])[..., 0]


def _sample_points(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """maps [..., H, W] sampled at the shared coords [P, 2] -> [..., P]."""
    lead, (h, w) = maps.shape[:-2], maps.shape[-2:]
    flat = maps.reshape(-1, h, w)
    loc = coords[None].expand((flat.shape[0],) + tuple(coords.shape))
    return _sample_points_per(flat, loc).reshape(
        tuple(lead) + (coords.shape[0],))


def _hungarian_host(cost: np.ndarray) -> np.ndarray:
    """cost [N, Nq, K] -> the query assigned to each gt [N, K] (int32); a
    gt column left unassigned (Nq < K) keeps query 0, as in JAX."""
    from scipy.optimize import linear_sum_assignment

    cost = np.nan_to_num(np.asarray(cost, np.float64), nan=_DUMMY_COST,
                         posinf=_DUMMY_COST, neginf=-_DUMMY_COST)
    n, _nq, k = cost.shape
    out = np.zeros((n, k), np.int32)
    for i in range(n):
        rows, cols = linear_sum_assignment(cost[i])
        out[i, cols] = rows.astype(np.int32)
    return out


def _match_cost(cls_pred, mask_pred, gt_masks, exists, coords,
                cls_weight=2.0, mask_weight=5.0, dice_weight=5.0):
    """The mmdet matching cost ``[B, Nq, K]`` at the points ``coords``
    ``[P, 2]`` (the JAX ``_match_cost`` over the batch): cls_pred [B, Nq,
    K+1], mask_pred [B, Nq, h, w], gt_masks [B, K, H, W], exists [B, K];
    absent classes cost ``_DUMMY_COST``."""
    num_classes = gt_masks.shape[1]
    p = coords.shape[0]
    probs = torch.softmax(cls_pred.float(), dim=-1)
    cls_cost = -probs[..., :num_classes]
    pred_pts = _sample_points(mask_pred.float(), coords)       # [B, Nq, P]
    gt_pts = _sample_points(gt_masks, coords)                   # [B, K, P]
    pos = F.softplus(-pred_pts)     # BCE(pred, 1)
    neg = F.softplus(pred_pts)      # BCE(pred, 0)
    mask_cost = (torch.einsum("bqp,bkp->bqk", pos, gt_pts)
                 + torch.einsum("bqp,bkp->bqk", neg, 1.0 - gt_pts)) / p
    sig = torch.sigmoid(pred_pts)
    numer = 2.0 * torch.einsum("bqp,bkp->bqk", sig, gt_pts)
    denom = sig.sum(-1)[:, :, None] + gt_pts.sum(-1)[:, None, :]
    dice_cost = 1.0 - (numer + 1.0) / (denom + 1.0)
    cost = (cls_weight * cls_cost + mask_weight * mask_cost
            + dice_weight * dice_cost)
    return torch.where(exists[:, None, :], cost,
                       torch.full_like(cost, _DUMMY_COST))


@torch.no_grad()
def _uncertain_points(mask_logits: torch.Tensor, num_points: int,
                      oversample: float, importance: float) -> torch.Tensor:
    """Per-mask point coords ``[B, K, P, 2]`` (mmdet
    get_uncertain_point_coords_with_randomness): each mask draws its own
    oversampled pool, keeps its most uncertain ``importance`` share
    (uncertainty ``-|logit|``) and pads with fresh uniform points."""
    b, k = mask_logits.shape[:2]
    hw = mask_logits.shape[2:]
    dev = mask_logits.device
    coords = rng.uniform("mask", (b * k, int(num_points * oversample), 2),
                         dev)
    pts = _sample_points_per(mask_logits.float().reshape(b * k, *hw), coords)
    n_unc = int(importance * num_points)
    top_idx = torch.topk(-pts.abs(), n_unc, dim=1).indices
    top = torch.gather(coords, 1, top_idx[..., None].expand(-1, -1, 2))
    rand = rng.uniform("mask", (b * k, num_points - n_unc, 2), dev)
    return torch.cat([top, rand], dim=1).reshape(b, k, num_points, 2)


def _query_labels(assign: torch.Tensor, exists: torch.Tensor,
                  num_queries: int) -> torch.Tensor:
    """Each query's target class ``[B, Nq]``: the class of the gt slot it
    was matched to if that class exists, else no-object (K). Where several
    slots name one query (Nq < K leaves slots at query 0) the last slot
    wins, as the JAX scatter resolves it on the CPU."""
    b, k = assign.shape
    slots = torch.arange(k, device=assign.device)
    hit = assign[:, :, None] == torch.arange(num_queries,
                                             device=assign.device)
    last = torch.where(hit, slots[None, :, None], -1).amax(dim=1)  # [B, Nq]
    value = torch.where(exists, slots[None], k)                     # [B, K]
    picked = torch.gather(value, 1, last.clamp(min=0))
    return torch.where(last >= 0, picked, torch.full_like(picked, k))


def mask2former_loss(
    cls_preds: List[torch.Tensor],
    mask_preds: List[torch.Tensor],
    labels: torch.Tensor,
    *,
    num_classes: int = 19,
    num_points: int = 12544,
    oversample: float = 3.0,
    importance: float = 0.75,
    cls_loss_weight: float = 2.0,
    mask_loss_weight: float = 5.0,
    dice_loss_weight: float = 5.0,
    bg_class_weight: float = 0.1,
    ignore_index: int = 255,
) -> Dict[str, torch.Tensor]:
    """The multi-stage loss. cls_preds / mask_preds: per stage [B, Nq,
    K+1] / [B, Nq, h, w]; labels [B, H, W] (masks are compared at the
    predictions' resolution through point sampling in [0, 1] coordinates).
    Needs the ``mask`` stream (``rng.streams``)."""
    b = labels.shape[0]
    num_stages = len(cls_preds)
    nq = cls_preds[0].shape[1]
    dev = labels.device
    gt_masks, exists = semantic_to_targets(labels, num_classes, ignore_index)

    # every stage's matching in one copy to the host and back
    match_coords = rng.uniform("mask", (num_points, 2), dev)
    with torch.no_grad():
        costs = torch.stack([
            _match_cost(cls_preds[s], mask_preds[s], gt_masks, exists,
                        match_coords, cls_loss_weight, mask_loss_weight,
                        dice_loss_weight) for s in range(num_stages)])
    assigned = torch.from_numpy(_hungarian_host(
        costs.reshape(num_stages * b, nq, num_classes).cpu().numpy()))
    assigned = assigned.to(dev, torch.long).reshape(num_stages, b,
                                                    num_classes)

    num_total = exists.float().sum().clamp(min=1.0)
    class_weight = torch.ones(num_classes + 1, device=dev)
    class_weight[num_classes] = bg_class_weight
    e = exists.float()

    losses: Dict[str, torch.Tensor] = {}
    for s in range(num_stages):
        cls_pred = cls_preds[s].float()
        mask_pred = mask_preds[s].float()
        assign = assigned[s]

        q_labels = _query_labels(assign, exists, nq)
        nll = -torch.gather(F.log_softmax(cls_pred, dim=-1), -1,
                            q_labels[..., None])[..., 0]
        w = class_weight[q_labels]
        loss_cls = cls_loss_weight * (nll * w).sum() / w.sum().clamp(min=1.0)

        hw = mask_pred.shape[2:]
        matched = torch.gather(mask_pred, 1, assign[:, :, None, None].expand(
            b, num_classes, *hw))                           # [B, K, h, w]
        coords = _uncertain_points(matched, num_points, oversample,
                                   importance).reshape(
            b * num_classes, num_points, 2)
        pred_pts = _sample_points_per(
            matched.reshape(b * num_classes, *hw), coords).reshape(
            b, num_classes, num_points)
        gt_pts = _sample_points_per(
            gt_masks.reshape(b * num_classes, *gt_masks.shape[2:]),
            coords).reshape(b, num_classes, num_points)

        bce = F.softplus(pred_pts) - pred_pts * gt_pts
        loss_mask = (mask_loss_weight * (bce * e[..., None]).sum()
                     / (num_total * num_points))
        sig = torch.sigmoid(pred_pts)
        numer = 2.0 * (sig * gt_pts).sum(-1)
        denom = sig.sum(-1) + gt_pts.sum(-1)
        dice = 1.0 - (numer + 1.0) / (denom + 1.0)
        loss_dice = dice_loss_weight * (dice * e).sum() / num_total

        prefix = "" if s == num_stages - 1 else f"d{s}."
        losses[f"{prefix}loss_cls"] = loss_cls
        losses[f"{prefix}loss_mask"] = loss_mask
        losses[f"{prefix}loss_dice"] = loss_dice
    return losses
