"""What every inference cell shares: its set-up, the outputs it keeps for
the check, and the check.

Set-up (all of it counted in ``setup_s``): the weights made on the card
from the run's seed and the configuration's, the program's segmentor built
with them, the frame pool made on the card from the run's seed, the gate's
logit scale calibrated on the pool through the program's stage 1, and the
timed path warmed up on every shape the window will use.

After the window the program's state is freed, the reference model is
built in float32 from the same weights (TF32 off), and the labels that
the window produced for a sample of the pool's frames, drawn from the
seed, are judged (``check.py``). Each number compared is held to its limit
in the configuration file's ``check`` section.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import torch

from cardbench import calibrate, check, program, traffic, weights
from cardbench.reference import model as ref


class Readings:
    """What a run hands the metric readers."""

    def __init__(self):
        self.setup_s: float = 0.0
        self.window_s: float = 0.0
        self.attempted: int = 0
        self.images: int = 0
        self.steps: int = 0
        self.span_steps: int = 0
        self.frames_done: List[int] = []
        self.latencies_s: List[float] = []
        self.counters: Optional[Dict[str, int]] = None
        self.peak_bytes: int = 0
        self.trace = None
        self.span_frames: List[int] = []
        self.refined: List[int] = []
        self.config: Dict = {}
        self.mix: Dict = {}


class InferenceLoop:
    """Set-up, check and release of an inference cell; the subclasses
    drive the window."""

    def __init__(self, cell, seed: int, device):
        self.cfg = cell.config
        self.mix = cell.mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.test_cfg = dict(self.cfg["test_cfg"])
        self.hw = tuple(int(x) for x in self.mix["frame_hw"])
        self.readings = Readings()
        self.readings.config = self.cfg
        self.readings.mix = self.mix
        self.sample = check.sample(self.seed, int(self.mix["pool"]),
                                   int(self.mix["check_frames"]))
        self.kept: Dict[int, torch.Tensor] = {}
        self.program_shares: Dict[int, List[float]] = {}
        self.model = None
        self.scale = 1.0

    # -------------------------------------------------------------- set-up
    def weight_seed(self) -> int:
        return weights.mix_seed(self.cfg["weights"]["seed"], self.seed)

    def state(self) -> Dict[str, torch.Tensor]:
        sd = weights.make(self.cfg["model"], self.weight_seed(), self.device)
        weights.scale_classifier(sd, self.scale)
        return sd

    def setup(self) -> None:
        self.frames = traffic.frame_pool(
            self.mix, self.cfg["preprocessor"],
            weights.mix_seed(self.mix["seed"], self.seed), self.device)
        self.model = program.build(self.cfg, self.state(), self.device)
        self.calibrate()
        self.warm()

    def calibrate_batch(self) -> int:
        return 1

    def calibrate(self) -> None:
        w0, b0 = program.classifier(self.model)
        b = self.calibrate_batch()

        def logits_at(s: float) -> List[torch.Tensor]:
            program.set_classifier(self.model, w0 * s, b0 * s)
            return [program.stage1_logits(self.model, self.test_cfg,
                                          self.frames[i:i + b])
                    for i in range(0, self.frames.shape[0], b)]

        def shares_of(logits: torch.Tensor, k: float) -> torch.Tensor:
            return program.window_shares(self.test_cfg, logits * k,
                                         self.hw).reshape(-1, logits.shape[0])

        self.scale, self.skip, self.readings.refined = calibrate.calibrate(
            logits_at, shares_of, float(self.test_cfg["conf"]),
            float(self.mix["target_skip"]))
        program.set_classifier(self.model, w0 * self.scale, b0 * self.scale)

    def warm(self) -> None:
        raise NotImplementedError

    def keep(self, idx: int, labels: torch.Tensor) -> None:
        """The window's keep step: hold the labels of a sampled frame."""
        if idx in self.sample and idx not in self.kept:
            self.kept[idx] = labels

    def drive(self) -> None:
        """Run the timed path, as the window does, until every sampled
        frame's labels are kept."""
        raise NotImplementedError

    def drive_sample(self) -> None:
        """Outside a run (``limits.py``): drive the timed path over the
        check's sample, and keep the program's stage-1 window shares of
        those frames, which the check sets beside the reference's."""
        self.drive()
        self.program_shares = {
            idx: program.stage1_confidence(
                self.model, self.test_cfg,
                self.frames[idx:idx + 1]).tolist()
            for idx in self.sample}

    # --------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        self.path = None
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, pr: Optional[ref.Products] = None,
              labels: Optional[Dict[int, torch.Tensor]] = None) -> Dict:
        """Judge the kept labels (or ``labels``) against the reference."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = ref.build(self.cfg["model"], self.device)
        model.load_state_dict(self.state(), strict=True)
        labels = self.kept if labels is None else labels
        missing = [i for i in self.sample if i not in labels]
        got = check.judge_frames(model, self.test_cfg, self.frames, labels,
                                 float(self.mix["gate_tolerance"]), pr)
        limits = self.cfg["check"]["inference"]
        numbers = {name: (got[name], float(limit))
                   for name, limit in limits.items()}
        for f in got["frames"]:
            mine = self.program_shares.get(f["frame"])
            if mine:
                f["share_gap"] = max(abs(a - b)
                                     for a, b in zip(f["shares"], mine))
        correct = not missing and all(v <= lim for v, lim in numbers.values())
        # a frame fails where its own reading passes the limit
        failed = len(missing) + sum(
            1 for f in got["frames"]
            if any(f[name] > lim for name, (_, lim) in numbers.items()))
        return dict(correct=correct, numbers=numbers, failed=failed,
                    frames=got["frames"], missing=missing)

    def control(self) -> Dict:
        """The control judged as the program is: the reference with its
        products in float8, put in the program's place, on the sampled
        frames."""
        model = ref.build(self.cfg["model"], self.device)
        model.load_state_dict(self.state(), strict=True)
        labels = check.reference_labels(model, self.test_cfg, self.frames,
                                        self.sample, ref.Products(fp8=True))
        del model
        return self.check(labels=labels)
