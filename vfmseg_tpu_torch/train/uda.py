"""The DACS self-training UDA step.

Port of vfmseg_tpu/train/uda.py:41-233 (reference rein/models/uda/dacs.py):

* The teacher is the student's current backbone (its trainable adapters
  included) with the EMA copy of the head (``TrainState.ema``, made by
  :func:`init_ema`) swapped in through ``torch.func.functional_call``. It
  runs ``encode_decode`` on the target batch without a graph and in eval
  mode, so BatchNorm normalises with the student's running statistics and
  moves none; the model's mode is restored after.
* Pseudo-labels are the teacher's argmax; their weight is one scalar a
  batch, the share of target pixels whose top probability is at least
  ``pseudo_threshold``, zeroed on the top ``psweight_ignore_top`` and
  bottom ``psweight_ignore_bottom`` rows of the map (dacs.py:253-279).
* ClassMix pastes about half of each source image's classes onto the
  target; image, labels and weights are mixed alike, and the mixed image
  is strong-transformed (jitter, blur) in fp32, then cast to the source's
  dtype (dacs.py:285-299).
* One optimizer step over the source CE plus the pixel-weighted mixed CE.
  Where the model's class is exactly ``EncoderDecoder`` the source and
  mixed images go through one 2B forward, as the JAX step does
  (uda.py:148): BatchNorm then takes one joint moment over 2B images.
  Every other class (``MaskFormerSegmentor``, which subclasses
  ``EncoderDecoder`` here but not in JAX, and ``HRDAEncoderDecoder``)
  takes two forwards, the mixed one with ``pixel_weight``; the second
  draws the same crop, mask and dropout numbers as the first, as JAX's two
  applies share their keys.
* After the optimizer step the EMA moves towards the updated head with
  ``alpha = min(1 - 1 / (step + 1), alpha)``, the step read before its
  increment, so the first step copies the head (dacs.py:131-143).

Randomness: the ``augment`` stream (``train/step.py``'s per-step
generators, on the host) gives the ClassMix scores and the jitter and blur
draws, in the JAX step's order; the student's ``crop``, ``mask`` and
``dropout`` streams are the plain step's. The metrics keep the JAX keys:
``src.*``, ``mix.*``, ``loss`` and ``pseudo_weight``.

Data parallelism: the pseudo-weight is the global batch's mean (an
all-reduce), the gradients and logged losses are averaged over the group
as in the plain step, and the 2B pass tells the streams that its batch
concatenates two (``rng.batch_blocks``). The EMA needs no collective:
after the gradient all-reduce every rank's student is the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.algorithms.augment import (
    class_mix_masks,
    one_mix,
    strong_transform,
)
from vfmseg_tpu_torch.models.losses import cross_entropy_loss, seg_accuracy
from vfmseg_tpu_torch.models.presets import IMAGENET_MEAN, IMAGENET_STD
from vfmseg_tpu_torch.models.segmentors.encoder_decoder import EncoderDecoder
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.parallel import mesh
from vfmseg_tpu_torch.train.state import TrainState
from vfmseg_tpu_torch.train.step import (
    reduced_gradients,
    step_generators,
    sum_losses,
)
from vfmseg_tpu_torch.utils.misc import add_prefix


@dataclasses.dataclass(frozen=True)
class DACSConfig:
    pseudo_threshold: float = 0.968
    psweight_ignore_top: int = 15
    psweight_ignore_bottom: int = 120
    color_jitter_strength: float = 0.25
    color_jitter_probability: float = 0.2
    blur: bool = True
    num_classes: int = 19
    alpha: float = 0.999  # EMA decay cap
    head_key: str = "decode_head"


def init_ema(model: nn.Module,
             head_key: str = "decode_head") -> Dict[str, torch.Tensor]:
    """An fp32 copy (not an alias) of the ``head_key`` submodule's
    parameters, under the model's names."""
    head = getattr(model, head_key)
    return {f"{head_key}.{n}": p.detach().float().clone()
            for n, p in head.named_parameters()}


class _EncodeDecode(nn.Module):
    """``model.encode_decode`` as a module's forward, for
    ``functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model.encode_decode(img)


@torch.no_grad()
def teacher_logits(model: nn.Module, ema: Mapping[str, torch.Tensor],
                   img: torch.Tensor) -> torch.Tensor:
    """``encode_decode(img)`` of ``model`` with the EMA head's parameters,
    in eval mode (the running statistics read, not moved)."""
    was_training = model.training
    model.eval()
    try:
        return torch.func.functional_call(
            _EncodeDecode(model), {f"model.{k}": v for k, v in ema.items()},
            (img,))
    finally:
        model.train(was_training)


def _tensors(batch: Mapping, device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(batch[k]).to(device, non_blocking=True)
                 for k in ("img", "label", "target_img"))


def dacs_mix(model: nn.Module, cfg: DACSConfig,
             ema: Mapping[str, torch.Tensor], src_img: torch.Tensor,
             src_lbl: torch.Tensor, tgt_img: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The DACS block before the loss (dacs.py:232-295): the teacher's
    pseudo-labels on the target, ClassMix, the pseudo-weight map and the
    strong transform. Draws from the ``augment`` stream."""
    b, h, w = src_lbl.shape
    probs = torch.softmax(teacher_logits(model, ema, tgt_img).float(),
                          dim=-1)
    max_prob = probs.amax(dim=-1)
    pseudo_label = probs.argmax(dim=-1)
    # a mean over the global batch under data parallelism (equal local
    # batches), as under the JAX mesh
    pweight = mesh.all_reduce_mean(
        (max_prob >= cfg.pseudo_threshold).float().mean())
    weight_map = pweight.expand(b, h, w).clone()
    if cfg.psweight_ignore_top > 0:
        weight_map[:, :cfg.psweight_ignore_top] = 0.0
    if cfg.psweight_ignore_bottom > 0:
        weight_map[:, -cfg.psweight_ignore_bottom:] = 0.0

    mix_mask = class_mix_masks(src_lbl, cfg.num_classes)
    mixed_img = one_mix(mix_mask, src_img.float(), tgt_img.float())
    mixed_lbl = torch.where(mix_mask > 0.5, src_lbl.long(), pseudo_label)
    mixed_weight = one_mix(mix_mask, torch.ones_like(weight_map),
                           weight_map)
    mean = torch.tensor(IMAGENET_MEAN, device=src_img.device)
    std = torch.tensor(IMAGENET_STD, device=src_img.device)
    mixed_img = strong_transform(
        mixed_img, mean, std, cfg.color_jitter_strength,
        cfg.color_jitter_probability, 1.0 if cfg.blur else 0.0
    ).to(src_img.dtype)
    # the teacher's normalised prediction entropy on the target
    entropy = -(probs * torch.log(probs + 1e-12)).sum(dim=-1) / math.log(
        probs.shape[-1])
    return {"mixed_img": mixed_img, "mixed_lbl": mixed_lbl,
            "mixed_weight": mixed_weight, "pseudo_weight": pweight,
            "pseudo_label": pseudo_label, "mix_mask": mix_mask,
            "entropy": entropy}


def make_dacs_debug_fn(cfg: DACSConfig = DACSConfig()) -> Callable:
    """``(state, batch, seed) -> dacs_mix`` tensors with the draws of the
    train step at ``state.step``, for the debug grids (dacs.py:310-362)."""

    def debug_tensors(state: TrainState, batch: Mapping, seed: int):
        device = next(state.model.parameters()).device
        src_img, src_lbl, tgt_img = _tensors(batch, device)
        with _streams(seed, state.step, device):
            return dacs_mix(state.model, cfg, state.ema, src_img, src_lbl,
                            tgt_img)

    return debug_tensors


def _streams(seed: int, step: int, device: torch.device):
    """Step ``step``'s generators for this rank of the data group."""
    return rng.streams(step_generators(seed, step, device), mesh.rank(),
                       mesh.world_size())


def ema_alpha(step: int, cap: float) -> float:
    """``min(1 - 1 / (step + 1), cap)`` in fp32, as the JAX step computes
    it."""
    one = np.float32(1.0)
    return float(min(one - one / np.float32(step + 1), np.float32(cap)))


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], model: nn.Module,
               alpha: float) -> None:
    """``ema <- alpha * ema + (1 - alpha) * head``, in place."""
    params = dict(model.named_parameters())
    for name, e in ema.items():
        e.copy_(e * alpha + params[name].detach().float() * (1.0 - alpha))


def student_losses(model: nn.Module, src_img: torch.Tensor,
                   src_lbl: torch.Tensor, mix: Mapping[str, torch.Tensor],
                   seed: int, step: int) -> Dict[str, torch.Tensor]:
    """The student's ``src.*`` and ``mix.*`` loss entries (with their
    graph) on the source batch and ``dacs_mix``'s mixed one: one 2B forward
    where the model's class is exactly ``EncoderDecoder``, else two, each
    drawing step ``step``'s ``crop``/``mask``/``dropout`` numbers from the
    start (JAX's two applies share their keys)."""
    device = src_img.device
    if type(model) is EncoderDecoder:
        b = src_img.shape[0]
        with _streams(seed, step, device), rng.batch_blocks(2):
            logits = model(torch.cat([src_img, mix["mixed_img"]], dim=0))
        logits = resize(logits, size=src_lbl.shape[1:3], method="bilinear",
                        align_corners=model.align_corners)
        src_logits, mix_logits = logits[:b], logits[b:]
        mixed_lbl = mix["mixed_lbl"]
        return {
            "src.decode.loss_ce": cross_entropy_loss(src_logits, src_lbl),
            "src.decode.acc_seg": seg_accuracy(src_logits, src_lbl),
            "mix.decode.loss_ce": cross_entropy_loss(
                mix_logits, mixed_lbl, pixel_weight=mix["mixed_weight"]),
            "mix.decode.acc_seg": seg_accuracy(mix_logits, mixed_lbl)}
    with _streams(seed, step, device):
        losses = add_prefix(model(src_img, src_lbl), "src")
    with _streams(seed, step, device):
        losses.update(add_prefix(model(
            mix["mixed_img"], mix["mixed_lbl"],
            pixel_weight=mix["mixed_weight"]), "mix"))
    return losses


def make_dacs_train_step(cfg: DACSConfig = DACSConfig()) -> Callable:
    """Build the DACS step ``(state, batch, seed) -> (state, metrics)`` for
    a segmentor whose ``forward(img, labels, pixel_weight)`` returns a loss
    dict. ``batch``: ``img``, ``label`` and ``target_img``; ``state.ema``:
    from :func:`init_ema`."""

    def train_step(state: TrainState, batch: Mapping, seed: int
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        src_img, src_lbl, tgt_img = _tensors(batch, device)
        model.train()
        opt.zero_grad(set_to_none=True)
        with _streams(seed, state.step, device):
            mix = dacs_mix(model, cfg, state.ema, src_img, src_lbl, tgt_img)
        losses = student_losses(model, src_img, src_lbl, mix, seed,
                                state.step)
        loss = sum_losses(losses)
        loss.backward()
        reduced_gradients(opt)
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        update_ema(state.ema, model, ema_alpha(state.step, cfg.alpha))
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics = mesh.average_losses(metrics)
        metrics["pseudo_weight"] = mix["pseudo_weight"]
        return state, metrics

    return train_step
