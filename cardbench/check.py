"""The comparison that decides ``correct``: the program's labels against the
plain reference's logits.

For each frame checked, the reference (``reference/model.py``, float32 with
TF32 off) computes the gated two-stage prediction again from the same
weights and frame: the stage-1 logits at full size, each window's share of
confident pixels, and the refined logits of the windows it sends on. A
label is judged by its gap: how far the reference's logit for the label
lies below the reference's best logit at that pixel. A right label has a
gap of 0, and a label that rounding moved across a near-tie has a small
one.

The gate is a threshold on a share of pixels, so rounding can move a window
whose share lies at the threshold to the other side. A window whose
reference share lies within ``gate_tolerance`` of the threshold may go
either way: each pixel takes the smaller gap over the compositions of the
undecided windows that cover it (at most four windows cover a pixel of the
slide grid). A window outside that band is held to the reference's
decision.

Each frame's gaps are divided by the 99th percentile of the magnitude of
its reference logits. The number compared, ``gap_rel_q9999``, is the
largest over the frames checked of the 99.99th percentile of a frame's
gaps (its 210 widest pixels of 2M lie above it); ``gap_rel_max``, the
widest gap of all, is reported beside it.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cardbench.reference import model as ref


def _coverage_inv(boxes, crop, hw, device) -> torch.Tensor:
    count = torch.zeros(hw, device=device)
    for y, x in boxes:
        count[y:y + crop[0], x:x + crop[1]] += 1
    return (1.0 / count.clamp(min=1))[..., None]


def _regions(boxes, crop, hw) -> List[Tuple[int, int, int, int, List[int]]]:
    """The rectangles of the image that one set of windows covers:
    (y0, y1, x0, x1, covering window ids)."""
    ys = sorted({0, hw[0]} | {y for y, _ in boxes}
                | {y + crop[0] for y, _ in boxes})
    xs = sorted({0, hw[1]} | {x for _, x in boxes}
                | {x + crop[1] for _, x in boxes})
    out = []
    for y0, y1 in zip(ys, ys[1:]):
        for x0, x1 in zip(xs, xs[1:]):
            cover = [w for w, (y, x) in enumerate(boxes)
                     if y <= y0 and y1 <= y + crop[0]
                     and x <= x0 and x1 <= x + crop[1]]
            out.append((y0, y1, x0, x1, cover))
    return out


class Judge:
    """The reference's view of one frame, and the gaps of labels on it."""

    def __init__(self, model: ref.MsVFM, test_cfg: Dict, img: torch.Tensor,
                 pr: ref.Products, gate_tolerance: float):
        self.crop = tuple(test_cfg["crop_size"])
        self.hw = tuple(img.shape[1:3])
        self.boxes = ref.slide_grid(self.hw, self.crop,
                                    tuple(test_cfg["stride"]))
        conf_thr = float(test_cfg["conf"])
        with torch.no_grad():
            lr = ref.resize(img, tuple(test_cfg["lr_img_size"]))
            self.full = ref.resize(model.lr_forward(lr, pr), self.hw)[0]
            ctx = torch.stack([self.full[y:y + self.crop[0],
                                         x:x + self.crop[1]]
                               for y, x in self.boxes])
            self.share = ref.confident_share(
                ctx, float(test_cfg["threshold"])).tolist()
            self.decided = [w for w, c in enumerate(self.share)
                            if c < conf_thr - gate_tolerance]
            self.open = [w for w, c in enumerate(self.share)
                         if abs(c - conf_thr) <= gate_tolerance]
            self.own = [w for w, c in enumerate(self.share) if c < conf_thr]
            need = sorted(set(self.decided) | set(self.open)
                          | set(self.own))
            self.refined = {}
            if need:
                crops = torch.stack([img[0, y:y + self.crop[0],
                                         x:x + self.crop[1]]
                                     for y, x in (self.boxes[w]
                                                  for w in need)])
                out = model.hr_forward(crops, ctx[need], pr)
                self.refined = dict(zip(need, out))
        self.inv = _coverage_inv(self.boxes, self.crop, self.hw,
                                 img.device)

    def _delta(self, w, y0, y1, x0, x1) -> torch.Tensor:
        y, x = self.boxes[w]
        r = self.refined[w][y0 - y:y1 - y, x0 - x:x1 - x]
        return self.inv[y0:y1, x0:x1] * (r - self.full[y0:y1, x0:x1])

    def logits(self, refined: Sequence[int]) -> torch.Tensor:
        """The composed logits [H, W, C] with the windows ``refined`` sent
        on: the stage-1 map plus each refined window's change, weighted by
        the inverse coverage (the overlap average)."""
        out = self.full.clone()
        for w in refined:
            y, x = self.boxes[w]
            ch, cw = self.crop
            out[y:y + ch, x:x + cw] += self.inv[y:y + ch, x:x + cw] * (
                self.refined[w] - self.full[y:y + ch, x:x + cw])
        return out

    def gaps(self, labels: torch.Tensor) -> torch.Tensor:
        """[H, W] gap of each label: the smallest, over the compositions
        the gate allows, of the best logit less the label's."""
        labels = labels.long()
        out = torch.empty(self.hw, device=self.full.device)
        for y0, y1, x0, x1, cover in _regions(self.boxes, self.crop,
                                              self.hw):
            base = self.full[y0:y1, x0:x1].clone()
            for w in cover:
                if w in self.decided:
                    base += self._delta(w, y0, y1, x0, x1)
            undecided = [w for w in cover if w in self.open]
            lab = labels[y0:y1, x0:x1, None]
            best = None
            for k in range(len(undecided) + 1):
                for chosen in itertools.combinations(undecided, k):
                    lg = base.clone()
                    for w in chosen:
                        lg += self._delta(w, y0, y1, x0, x1)
                    gap = lg.amax(-1) - lg.gather(-1, lab)[..., 0]
                    best = gap if best is None else torch.minimum(best, gap)
            out[y0:y1, x0:x1] = best
        return out

    def own_labels(self) -> torch.Tensor:
        """The reference's own prediction: its gate's decisions, argmax."""
        return self.logits(self.own).argmax(-1).to(torch.int32)

    def scale(self) -> float:
        """The 99th percentile of |logit| of the reference's own
        prediction (a sample of every 7th value)."""
        mag = self.logits(self.own).abs().flatten()[::7]
        return float(torch.quantile(mag, 0.99))


def judge_frames(model: ref.MsVFM, test_cfg: Dict, frames: torch.Tensor,
                 labels: Dict[int, torch.Tensor], gate_tolerance: float,
                 pr: ref.Products = None) -> Dict:
    """Judge the program's ``labels`` (pool index -> [H, W]) of the pool's
    ``frames``; returns the number compared and each frame's readings."""
    pr = pr or ref.Products()
    per_frame = []
    for idx in sorted(labels):
        judge = Judge(model, test_cfg, frames[idx:idx + 1], pr,
                      gate_tolerance)
        gaps = judge.gaps(labels[idx].to(frames.device))
        scale = judge.scale()
        widest = float(gaps.max())
        per_frame.append(dict(
            frame=idx, gap_max=widest, scale=scale,
            gap_rel_max=widest / max(scale, 1e-12),
            gap_rel_q9999=float(torch.quantile(gaps.flatten(), 0.9999))
            / max(scale, 1e-12),
            label_mismatch=float((judge.own_labels()
                                  != labels[idx].to(frames.device)
                                  ).float().mean()),
            refined=len(judge.own), undecided=len(judge.open),
            shares=judge.share))
        del judge, gaps
    return dict(gap_rel_max=max((f["gap_rel_max"] for f in per_frame),
                                default=float("inf")),
                gap_rel_q9999=max((f["gap_rel_q9999"] for f in per_frame),
                                  default=float("inf")),
                frames=per_frame)


def reference_labels(model: ref.MsVFM, test_cfg: Dict, frames: torch.Tensor,
                     indices: Sequence[int], pr: ref.Products
                     ) -> Dict[int, torch.Tensor]:
    """The labels the reference itself predicts with products ``pr`` (the
    control, in float8, put in the program's place)."""
    out = {}
    with torch.no_grad():
        for idx in indices:
            judge = Judge(model, test_cfg, frames[idx:idx + 1], pr, 0.0)
            out[idx] = judge.own_labels()
    return out


def sample(seed: int, pool: int, count: int) -> List[int]:
    """``count`` distinct pool indices drawn from ``seed``."""
    rs = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
    return sorted(int(i) for i in rs.choice(pool, size=min(count, pool),
                                            replace=False))
