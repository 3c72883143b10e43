"""One client, one image at a time, through the eval CLI's per-image
predictor on mode ``slide`` (``make_shape_aware_predict_fn``: the crops in
one batch through ``encode_decode``, the overlap average, the resize and
argmax) in a closed loop over the frame pool, for the Rein DINOv2 +
Mask2Former configuration.

The window, the warm-up and the traced span are ``per_image.py``'s, and
fill the same readings. What differs: the weights are
``weights_rein_m2f.py``'s, there is no gate to calibrate, and the check
judges scores, not labels, against ``reference/rein_m2f.py``
(``check_slide``). After the window, before the program is freed, the same
model object runs the predictor's own logits function
(``make_logits_fn`` on mode slide, which ``make_shape_aware_predict_fn``
wraps; the frames are at least a crop, so nothing is padded) over each
sampled frame and the resize to the frame's size that the predictor
argmaxes: those scores are judged, and the window's kept labels are held
to their argmax. The decoder's masks of that pass are kept, for the
check's count of pairs flipped against the reference, and each is held to
the published mask rule applied to its own logits.

The head counts its masks' hidden pairs only while a profiler runs; the
loop zeroes the counters as the traced span begins and reads them once,
before the program is freed.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import torch

from cardbench import check_slide, harness, program, weights_rein_m2f
from cardbench.reference import rein_m2f
from cardbench.reference.model import Products
from vfmseg_tpu_torch.eval.evaluator import make_logits_fn

_PerImage = harness.loop_class("per_image")


class Loop(_PerImage):
    head = None

    def state(self) -> Dict[str, torch.Tensor]:
        return weights_rein_m2f.make(self.cfg["model"], self.weight_seed(),
                                     self.device)

    def calibrate(self) -> None:
        """No gate: every crop goes through the model."""

    def drive_sample(self) -> None:
        self.drive()

    def span(self) -> None:
        self.head = self.model.decode_head
        # a program without the counters has nothing to zero
        if hasattr(self.head, "stat_hidden_pairs"):
            self.head.stat_hidden_pairs = self.head.stat_reset_rows = None
            self.head.stat_pairs = self.head.stat_rows = 0
        super().span()

    def scores(self) -> None:
        """The program's scores of the sampled frames and, where its head
        has ``_mask``, every decoder mask of each and the share of their
        pairs off the published rule applied to the mask's own logits."""
        head = self.model.decode_head
        own = getattr(head, "_mask", None)
        kept: List[torch.Tensor] = []
        off: List[torch.Tensor] = []

        def keep(logits: torch.Tensor) -> torch.Tensor:
            mask = own(logits)
            kept.append(mask)
            off.append((rein_m2f.attention_mask(logits.float()) != mask)
                       .sum())
            return mask

        logits_fn = make_logits_fn(self.model, self.test_cfg, "slide")
        self.scored, self.masks, self.rule = {}, {}, {}
        if own is not None:
            head._mask = keep
        try:
            with torch.inference_mode():
                for idx in self.sample:
                    kept.clear()
                    off.clear()
                    logits = logits_fn(self.model, self.frames[idx:idx + 1])
                    self.scored[idx] = program.resize(
                        logits, size=self.hw, method="bilinear")[0].float()
                    if own is not None:
                        self.masks[idx] = list(kept)
                        self.rule[idx] = float(sum(off)) / sum(
                            m.numel() for m in kept)
        finally:
            if own is not None:
                head._mask = own

    def release(self) -> None:
        self.scores()
        head, self.head = self.head, None
        # a program without the counters reads nothing
        if getattr(head, "stat_hidden_pairs", None) is not None:
            self.readings.counters = dict(
                hidden_pairs=int(head.stat_hidden_pairs),
                pairs=head.stat_pairs,
                reset_rows=int(head.stat_reset_rows), rows=head.stat_rows)
        del head
        super().release()

    def reference(self):
        """The float32 reference with this run's weights, TF32 off."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = rein_m2f.build(self.cfg["model"], self.device)
        model.load_state_dict(self.state(), strict=True)
        return model

    def check(self, scores: Optional[Dict[int, torch.Tensor]] = None
              ) -> Dict:
        """Judge the program's scores (or ``scores``, with their own argmax
        as the labels) against the reference."""
        model = self.reference()
        if scores is None:
            scores, labels = self.scored, self.kept
            masks, rule = self.masks, self.rule
        else:
            labels = {i: s.argmax(-1) for i, s in scores.items()}
            masks = rule = None
        missing = [i for i in self.sample if i not in labels]
        got = check_slide.judge_frames(
            model, self.test_cfg, self.frames,
            {i: s for i, s in scores.items() if i in labels}, labels,
            masks, rule)
        del model
        gc.collect()
        limits = self.cfg["check"]["inference"]
        numbers = {name: (got[name], float(limit))
                   for name, limit in limits.items()}
        correct = not missing and all(v <= lim for v, lim in numbers.values())
        # a frame fails where its own reading passes the limit
        failed = len(missing) + sum(
            1 for f in got["frames"]
            if any(f[name] > lim for name, (_, lim) in numbers.items()))
        return dict(correct=correct, numbers=numbers, failed=failed,
                    frames=got["frames"], missing=missing)

    def control(self) -> Dict:
        """The reference with its products in float8, put in the
        program's place on the sampled frames, judged as the program is."""
        model = self.reference()
        scores = check_slide.reference_scores(
            model, self.test_cfg, self.frames, self.sample,
            Products(fp8=True))
        del model
        return self.check(scores=scores)
