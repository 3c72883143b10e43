"""The compact gated stream: ``stream_evaluate`` through one compact
engine, as the eval CLI streams a dataset, in a closed loop over the frame
pool.

Frames go in whole groups, cycling the pool in its order, so the window
sees the pool's groups and their refine batch sizes again and again; set-up
warms them up by one pass over the pool. After the gate's calibration the
pool is put in the order whose groups send on as even a number of windows
as the frames allow (``traffic.balanced_order``), so every seed gives the
same refine batch sizes. The window stops taking frames at
the first group boundary after ``seconds`` and ends when the last group's
labels are on the device, synchronised at both ends. The engine's gate
counters are read over the window.
"""

from __future__ import annotations

import time

import torch

from cardbench import program, traffic
from cardbench.inference import InferenceLoop


class Loop(InferenceLoop):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.group = int(self.mix["group"])
        self.depth = int(self.mix["depth"])
        if int(self.mix["pool"]) % self.group:
            raise ValueError("the pool must hold whole groups")

    def calibrate_batch(self) -> int:
        return self.group

    def calibrate(self) -> None:
        super().calibrate()
        order = traffic.balanced_order(self.readings.refined, self.group)
        self.frames = self.frames[order]
        self.readings.refined = [self.readings.refined[i] for i in order]

    def warm(self) -> None:
        self.path = program.CompactStream(self.model, self.test_cfg,
                                          self.group, self.depth)
        for _ in self._run(lambda i: i >= self.frames.shape[0]):
            pass
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, stop):
        """Yield (pool index, labels) for frames fed until ``stop(i)`` holds
        at a group boundary."""
        order = []

        def feed():
            i = 0
            while not (i % self.group == 0 and stop(i)):
                idx = i % self.frames.shape[0]
                order.append(idx)
                yield self.frames[idx], self.hw
                i += 1

        for k, labels in enumerate(self.path.run(feed())):
            yield order[k], labels

    def _kept(self, stop):
        """Yield the pool index of each frame done, its labels kept."""
        for idx, labels in self._run(stop):
            self.keep(idx, labels)
            yield idx

    def drive(self) -> None:
        for _ in self._kept(lambda i: i >= self.frames.shape[0]):
            pass
        self._sync()

    def window(self, seconds: float) -> None:
        r = self.readings
        before = self.path.counters()
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done = list(self._kept(lambda i: time.perf_counter() >= deadline))
        self._sync()
        r.window_s = time.perf_counter() - t0
        r.attempted = r.images = len(done)
        r.frames_done = done
        after = self.path.counters()
        r.counters = {k: after[k] - before[k] for k in after}

    def span(self) -> None:
        n = int(self.mix["profile_images"])
        done = [idx for idx, _ in self._run(lambda i: i >= n)]
        self._sync()
        self.readings.span_frames = done
