"""What the benchmark takes from the program (``vfmseg_tpu_torch``): the
segmentor built from a configuration file, its entry points as the eval and
train CLIs drive them, and the compact engine's gate counters. Nothing else
of the harness imports the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Tuple

import torch

from vfmseg_tpu_torch.eval.compact import window_confidence
from vfmseg_tpu_torch.eval.evaluator import (
    make_compact_ms_slide,
    make_shape_aware_predict_fn,
    stream_evaluate,
)
from vfmseg_tpu_torch.eval.slide import compute_slide_grid
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import make_train_step


def build(cfg: Dict, state: Dict[str, torch.Tensor],
          device) -> torch.nn.Module:
    """The configuration's segmentor on ``device`` (eval mode), its
    parameters the tensors of ``state``."""
    model = build_segmentor(cfg["model"], dtype=compute_dtype(cfg),
                            device="meta", attn_impl=compute_attn_impl(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


def set_classifier(model, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Write the decode head's classifier (the gate's logit scale)."""
    seg = model.decode_head.conv_seg
    with torch.no_grad():
        seg.weight.copy_(weight)
        seg.bias.copy_(bias)


def classifier(model) -> Tuple[torch.Tensor, torch.Tensor]:
    seg = model.decode_head.conv_seg
    return seg.weight.detach().clone(), seg.bias.detach().clone()


@torch.inference_mode()
def stage1_logits(model, test_cfg: Dict, img: torch.Tensor) -> torch.Tensor:
    """The program's stage-1 logits of ``img`` at ``lr_img_size``."""
    return model.lr_forward(resize(
        img, size=tuple(test_cfg["lr_img_size"]), method="bilinear"))


@torch.inference_mode()
def window_shares(test_cfg: Dict, logits: torch.Tensor,
                  hw: Tuple[int, int]) -> torch.Tensor:
    """Each window's confident-pixel share of stage-1 ``logits`` brought to
    the frame's size ``hw`` (window-major: window w is box w // B of image
    w % B)."""
    full = resize(logits, size=hw, method="bilinear")
    boxes = compute_slide_grid(hw, tuple(test_cfg["crop_size"]),
                               tuple(test_cfg["stride"]))
    return window_confidence(full, boxes, tuple(test_cfg["crop_size"]),
                             test_cfg["threshold"])


def stage1_confidence(model, test_cfg: Dict, img: torch.Tensor
                      ) -> torch.Tensor:
    """Each window's confident-pixel share after the program's stage 1."""
    return window_shares(test_cfg, stage1_logits(model, test_cfg, img),
                         tuple(img.shape[1:3]))


class CompactStream:
    """The eval CLI's throughput route: ``stream_evaluate`` through one
    compact gated engine."""

    def __init__(self, model, test_cfg: Dict, group: int, depth: int):
        self.model = model
        self.test_cfg = dict(test_cfg, gate="compact")
        self.engine = make_compact_ms_slide(model, self.test_cfg)
        self.group = group
        self.depth = depth

    def run(self, frames: Iterable[Tuple[torch.Tensor, Tuple[int, int]]]
            ) -> Iterator[torch.Tensor]:
        return stream_evaluate(self.model, self.test_cfg, frames,
                               group=self.group, depth=self.depth,
                               engine=self.engine)

    def counters(self) -> Dict[str, int]:
        e = self.engine
        return dict(windows=e.stat_windows, refined=e.stat_refined,
                    refine_rows=e.stat_refine_rows)


class DensePredictor:
    """The eval CLI's per-image route (``make_shape_aware_predict_fn``)
    with the configuration's test settings: the dense gated two-stage
    slide."""

    def __init__(self, model, test_cfg: Dict):
        self.model = model
        self.predict = make_shape_aware_predict_fn(model, test_cfg)

    def __call__(self, img: torch.Tensor, out_hw) -> torch.Tensor:
        return self.predict(self.model, img, out_hw)


class TrainStep:
    """The train CLI's step: ``make_train_step()`` on the ``TrainState``
    that ``create_train_state`` builds from the configuration (AdamW and
    PolyLR over LoRA and the heads), called as ``train_loop`` calls it."""

    def __init__(self, model, cfg: Dict):
        self.state = create_train_state(model, cfg)
        self.step_fn = make_train_step()

    def __call__(self, batch: Dict, seed: int) -> Dict:
        self.state, metrics = self.step_fn(self.state, batch, seed)
        return metrics

    def trainable(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.state.model.named_parameters()
                if p.requires_grad}

    def first_moment(self, p: torch.Tensor) -> torch.Tensor:
        """AdamW's running mean of ``p``'s gradient."""
        return self.state.optimizer.state[p]["exp_avg"]

    def betas(self):
        return self.state.optimizer.param_groups[0]["betas"]

