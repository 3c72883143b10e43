"""The comparison that decides ``correct`` in the slide cells: the
program's semantic scores of the sampled frames against the plain
reference's (``reference/rein_m2f.py``, float32 with TF32 off), measured
in units of what bf16 rounding alone moves them, and the program's masks
against the published mask rule.

The program's scores are those its slide predictor argmaxes (the loop
takes them from the same model object after the window, and holds the
window's labels to their argmax). A score is ``sum_q softmax(cls)[k]
sigmoid(mask)``, a continuous function of every layer, so a fault or a
coarser precision anywhere moves it even where it moves no label: on
seeded weights the decoder's queries lie close to one another and a frame
may take one class everywhere, where a check of labels reads 0 whatever
the program computes.

How far rounding moves the scores differs from seed to seed nearly as
much as the step from bf16 to float8 (on an H100, 0.6% to 5.8% of the
scores' norm for the bf16 program over 14 seeds, 7.3% to 31% for the
float8 control), so a fixed limit on the distance leaves little room on
either side. So for each frame the reference runs twice: in float32
(``R``) and with every product's operands rounded to bf16
(``Bf16Products``, ``B``), and the program's distance from ``R`` is
divided by ``B``'s, the rounding this frame's equations cannot avoid in
the precision the configuration states.

The program's masks are never handed to the reference: each side
thresholds its own mask logits, so a pair near 0.5 may flip, and what a
flip moves shows in the scores. Where the loop kept them, each frame also
reports the share of pairs on which the two sides' masks differ
(``mask_flips``, not compared) and the share on which the program's mask
differs from the published rule applied to the program's own mask logits
(``mask_rule``: ``sigmoid < 0.5``, a row hiding every key attends to all).

Per frame, with ``d`` the per-pixel norm over the classes of a score
difference and ``s`` the root mean square over the frame of ``R``'s
per-pixel norm:

* ``score_ratio_l2``: the program's ``|P - R| / |R|`` over the whole frame,
  over ``B``'s;
* ``score_ratio_q9999``: the 99.99th percentile of ``d / s``, the frame's
  worst pixels against its typical score, the program's over ``B``'s;
* ``window_mismatch``: the share of pixels whose kept label is not the
  argmax of the scores judged;
* ``mask_rule``: as above; 0 where no masks were kept.

Each number compared is the largest over the frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from cardbench.reference.model import Products
from cardbench.reference.rein_m2f import Bf16Products

NUMBERS = ("score_ratio_l2", "score_ratio_q9999", "window_mismatch",
           "mask_rule")


def errors(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``got`` against ``want``, both [H, W, K] scores."""
    diff = got.float() - want
    d = diff.norm(dim=-1)
    s = want.norm(dim=-1).square().mean().sqrt().clamp(min=1e-30)
    return dict(
        score_err_l2=float(diff.norm() / want.norm().clamp(min=1e-30)),
        score_err_q9999=float(torch.quantile(d.flatten() / s, 0.9999)))


def flips(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]
          ) -> float:
    """The share of (query, key) pairs on which two sides' masks differ,
    over every layer."""
    n = sum(g.numel() for g in got)
    return float(sum(int((g != w.to(g.device)).sum())
                     for g, w in zip(got, want)) / max(n, 1))


def judge_frames(model, test_cfg: Dict, frames: torch.Tensor,
                 scores: Dict[int, torch.Tensor],
                 labels: Dict[int, torch.Tensor],
                 masks: Optional[Dict[int, List[torch.Tensor]]] = None,
                 rule: Optional[Dict[int, float]] = None) -> Dict:
    """Judge the program's ``scores`` (pool index -> [H, W, K]) of the
    pool's ``frames``, and its ``labels`` against them; ``masks``: the
    program's decoder masks a frame, each [crops, Q, keys], in its layers'
    order; ``rule``: a frame's share of mask pairs off the mask rule.
    Returns the numbers compared and each frame's readings."""
    head = model.decode_head
    masks, rule = masks or {}, rule or {}
    per_frame = []
    for idx in sorted(scores):
        img = frames[idx:idx + 1]
        head.kept = [] if idx in masks else None
        want = model.slide_logits(img, test_cfg, Products())
        kept, head.kept = head.kept, None
        got = scores[idx].to(want.device)
        f = dict(frame=idx, **errors(got, want))
        bf16 = errors(model.slide_logits(img, test_cfg, Bf16Products()),
                      want)
        f.update({f"bf16_{k[6:]}": v for k, v in bf16.items()})
        for k in ("l2", "q9999"):
            f[f"score_ratio_{k}"] = (f[f"score_err_{k}"]
                                     / max(bf16[f"score_err_{k}"], 1e-30))
        f["window_mismatch"] = float(
            (got.argmax(-1) != labels[idx].to(want.device).long())
            .float().mean())
        f["classes"] = int(want.argmax(-1).unique().numel())
        f["mask_rule"] = float(rule.get(idx, 0.0))
        if kept is not None:
            f["mask_flips"] = flips(masks[idx], head.layer_masks(kept))
        per_frame.append(f)
        del want, got, kept
    return dict({name: max((f[name] for f in per_frame),
                           default=float("inf")) for name in NUMBERS},
                frames=per_frame)


def reference_scores(model, test_cfg: Dict, frames: torch.Tensor,
                     indices: Sequence[int], pr: Products
                     ) -> Dict[int, torch.Tensor]:
    """The scores the reference itself computes with products ``pr`` (the
    control, in float8, put in the program's place)."""
    return {idx: model.slide_logits(frames[idx:idx + 1], test_cfg, pr)
            for idx in indices}
