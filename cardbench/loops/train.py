"""The two-scale train step, called as ``train_loop`` calls it: one
``TrainState`` (the configuration's segmentor, AdamW and PolyLR over LoRA
and the heads) stepped by ``make_train_step()`` on a pool of batches made
on the card, the losses read back every ``log_interval`` steps; no
checkpoint and no validation.

Set-up builds the state and drives it through its first ``check_steps``
steps with the window's own call, on batches that all differ: the check's
readings (each step's loss, the first gradient as AdamW holds it, each
trainable tensor's change over the steps), and the warm-up of the window's
one shape. The same object then runs the window, which stops at the first
step after ``seconds`` and ends when the last step's work is done on the
device.

The check runs the reference's steps from the same weights, batches and
seed (``reference/train.py``) and compares, each by its worst case:

* ``loss_rel``: each step's loss against the reference's, relative;
* ``grad_norm_gap``: each trainable tensor's first-gradient norm against
  the reference's, the gap over the larger of the reference's norm of that
  tensor and the median tensor's;
* ``change_norm_gap``: the same for each tensor's change over the steps,
  leaving out the tensors whose reference gradient is under a thousandth
  of the median tensor's (Adam moves those by round-off alone).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from cardbench import program, traffic, weights
from cardbench.inference import Readings
from cardbench.reference import train as ref_train


def leaf_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             names) -> float:
    """The largest gap between the two sides' norms of a tensor, over the
    larger of the reference's norm of it and of the median tensor."""
    norms = {n: float(want[n].norm()) for n in want}
    median = float(np.median(list(norms.values())))
    return max(abs(float(prog[n].norm()) - norms[n]) / max(norms[n], median,
                                                            1e-30)
               for n in names)


class Loop:
    def __init__(self, cell, seed: int, device):
        self.cfg = cell.config
        self.mix = cell.mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.readings = Readings()
        self.readings.config = self.cfg
        self.readings.mix = self.mix
        self.log_interval = int(self.cfg["schedule"]["log_interval"])
        self.steps_done = 0
        # the steps' random streams: a whole number from the run's seed
        self.step_seed = weights.mix_seed(self.mix["seed"], self.seed, 1)

    def state(self) -> Dict[str, torch.Tensor]:
        return weights.make(self.cfg["model"],
                            weights.mix_seed(self.cfg["weights"]["seed"],
                                             self.seed), self.device)

    def setup(self) -> None:
        self.batches = traffic.train_batches(
            self.mix, self.cfg["preprocessor"],
            weights.mix_seed(self.mix["seed"], self.seed), self.device)
        self.model = program.build(self.cfg, self.state(), self.device)
        self.step = program.TrainStep(self.model, self.cfg)
        params = self.step.trainable()
        start = {n: p.detach().to("cpu", torch.float32, copy=True)
                 for n, p in params.items()}
        losses = []
        for k in range(int(self.mix["check_steps"])):
            metrics = self._one()
            losses.append(metrics["loss"].detach())
            if k == 0:
                b1 = self.step.betas()[0]
                self.first = {n: (self.step.first_moment(p) / (1 - b1))
                              .to("cpu", torch.float32)
                              for n, p in params.items()}
        self.losses = [float(x) for x in losses]
        self.change = {n: p.detach().to("cpu", torch.float32) - start[n]
                       for n, p in params.items()}
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one(self) -> Dict:
        batch = self.batches[self.steps_done % len(self.batches)]
        metrics = self.step(batch, self.step_seed)
        self.steps_done += 1
        if self.steps_done % self.log_interval == 0:
            float(metrics["loss"])  # the loop's log line reads the losses
        return metrics

    def drive_sample(self) -> None:
        """Outside a run (``limits.py``): nothing more to drive; set-up ran
        the check's steps through the window's own call."""

    def window(self, seconds: float) -> None:
        r = self.readings
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while time.perf_counter() < deadline:
            self._one()
            n += 1
        self._sync()
        r.window_s = time.perf_counter() - t0
        r.attempted = r.steps = n

    def span(self) -> None:
        for _ in range(int(self.mix["profile_steps"])):
            self._one()
        self._sync()
        self.readings.span_steps = int(self.mix["profile_steps"])

    def release(self) -> None:
        self.model = None
        self.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, fp8: bool = False) -> Dict:
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return ref_train.run(self.cfg, self.state(), self.batches,
                             self.step_seed, int(self.mix["check_steps"]), fp8)

    def numbers(self, losses, first, change, want) -> Dict[str, float]:
        grads = want["grads"]
        norms = {n: float(g.norm()) for n, g in grads.items()}
        median = float(np.median(list(norms.values())))
        moving = [n for n in grads if norms[n] >= 1e-3 * median]
        return dict(
            loss_rel=max(abs(a - b["loss"]) / abs(b["loss"])
                         for a, b in zip(losses, want["losses"])),
            grad_norm_gap=leaf_gap(first, {n: g.cpu() for n, g in
                                           grads.items()}, list(grads)),
            change_norm_gap=leaf_gap(change, {n: c.cpu() for n, c in
                                              want["change"].items()},
                                     moving))

    def check(self) -> Dict:
        want = self.reference()
        got = self.numbers(self.losses, self.first, self.change, want)
        limits = self.cfg["check"]["train"]
        numbers = {k: (got[k], float(limits[k])) for k in limits}
        bad = [k for k, (v, lim) in numbers.items() if v > lim]
        return dict(correct=not bad, numbers=numbers, failed=len(bad),
                    frames=[dict(losses=self.losses,
                                 reference=[x["loss"] for x in
                                            want["losses"]])],
                    missing=[])

    def control(self) -> Dict:
        """The control judged as the program is: the reference in float8
        put in the program's place, against the float32 reference."""
        want = self.reference()
        ctl = self.reference(fp8=True)
        got = self.numbers([x["loss"] for x in ctl["losses"]],
                           {n: g.cpu() for n, g in ctl["grads"].items()},
                           {n: c.cpu() for n, c in ctl["change"].items()},
                           want)
        limits = self.cfg["check"]["train"]
        return dict(numbers={k: (got[k], float(limits[k])) for k in limits},
                    frames=[dict(losses=[x["loss"] for x in ctl["losses"]])])
